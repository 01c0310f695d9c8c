"""CAFormer (MetaFormer): the copy of ``chip_smoke.caformer_gflop`` (37.77
GFLOP a 384^2 image at the port's default CAFormerConfig(), 51.97 at
CAFormer-S36's), and its attention launches: stage 3 at (B, 10, 576, 32),
stage 4 at (B, 16, 144, 32)."""

from __future__ import annotations

from typing import List

from . import Call, attention, gemm


def _hidden(m: dict, key: str, ratio: str, stage: int, blk: int) -> int:
    if m.get(key) is not None:
        return m[key][stage][blk]
    return m[ratio] * m["dims"][stage]


def forward_calls(m: dict, batch: int) -> List[Call]:
    dims = m["dims"]
    side = m["img_size"] // 4
    calls = [gemm(batch * side * side, dims[0], 49 * 3, group="conv")]
    for s in range(4):
        c = dims[s]
        if s:
            side //= 2
            calls.append(gemm(batch * side * side, c, 9 * dims[s - 1], group="conv"))
        n = side * side
        rows = batch * n
        for b in range(m["depths"][s]):
            hid = _hidden(m, "mlp_hidden", "mlp_ratio", s, b)
            calls += [gemm(rows, hid, c), gemm(rows, c, hid)]
            if m["num_heads"][s]:
                calls += [gemm(rows, 3 * c, c), gemm(rows, c, c)]
                calls.append(attention(batch, m["num_heads"][s], n, c // m["num_heads"][s]))
            else:
                sh = _hidden(m, "sepconv_hidden", "sepconv_ratio", s, b)
                calls += [gemm(rows, sh, c), gemm(rows, c, sh)]
                # depthwise 7x7: 49 multiply-adds an output element
                calls.append(gemm(rows, sh, 49, group="conv"))
    d = dims[-1]
    hh = m["head_hidden"] or m["mlp_ratio"] * d
    calls += [gemm(batch, hh, d, elt=4), gemm(batch, m["feature_dim"], hh, elt=4)]
    return calls


def gflop_per_image(m: dict) -> float:
    return sum(c.flops for c in forward_calls(m, 1)) / 1e9
