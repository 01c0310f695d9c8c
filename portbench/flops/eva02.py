"""EVA02 tagger (timm Eva, split q/k/v, SwiGLU): the count behind
``chip_smoke.GFLOP_PER_IMAGE`` = 723.5 (ARCHITECTURE.md section 7a) for
EVA02-Large at 448: T = 1025 tokens, D = 1024, 24 blocks, SwiGLU hidden
2730, 10,861 classes."""

from __future__ import annotations

from typing import List

from . import Call, attention, gemm


def forward_calls(m: dict, batch: int) -> List[Call]:
    d, hid, depth = m["embed_dim"], m["mlp_hidden_dim"], m["depth"]
    g = m["img_size"] // m["patch_size"]
    t = g * g + 1
    rows = batch * t
    calls = [gemm(batch * g * g, d, 3 * m["patch_size"] ** 2, group="conv")]
    for _ in range(depth):
        calls += [gemm(rows, d, d) for _ in range(3)]                 # q, k, v
        calls.append(attention(batch, m["num_heads"], t, d // m["num_heads"]))
        calls.append(gemm(rows, d, d))                                # out proj
        calls += [gemm(rows, hid, d), gemm(rows, hid, d), gemm(rows, d, hid)]  # SwiGLU
    calls.append(gemm(batch, m["num_classes"], d, elt=4))            # head, f32
    return calls


def gflop_per_image(m: dict) -> float:
    return sum(c.flops for c in forward_calls(m, 1)) / 1e9
