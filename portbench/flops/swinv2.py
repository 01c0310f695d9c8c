"""SwinV2 tagger (timm SwinTransformerV2 as the WD SwinV2 tagger v3 runs it):
each forward's matmuls, window attention calls and window shift passes,
counted from the configuration's shapes. At img 448, patch 4, depths
2/2/18/2, widths 128-1024, windows of 14 and 10,861 classes: 130.78 GFLOP an
image, of which 120.87 in the GEMMs (qkv, proj, MLP, the merges' reductions,
the head), 9.76 in window attention and 0.15 in the patch conv.

- ``attention``: one call a block, B·nW·H problems of S = w² tokens at Dh,
  q·kᵀ and p·v (4 S² Dh FLOP each); q, k, v read and o written once, and the
  block's bias (1, nW·H, S, S), one tensor broadcast over the batch, read
  once.
- ``window``: the port's hand kernels around the attention, bytes only: the
  shift-and-partition kernel and its inverse (B·R²·C read and written by
  each; a block whose window is its whole map and does not shift runs
  neither, as stage 4 at 448), and the q/k/v preparation (the qkv projection,
  3·B·R²·C, read and written once), one a block.
"""

from __future__ import annotations

from typing import List

from . import Call, attention, gemm


def _stage(m: dict, s: int):
    """(map side, width, heads, window) of stage s."""
    res = m["img_size"] // m["patch_size"] // 2 ** s
    return res, m["embed_dim"] * 2 ** s, m["num_heads"][s], min(res, m["window_size"])


def forward_calls(m: dict, batch: int) -> List[Call]:
    p, c0 = m["patch_size"], m["embed_dim"]
    g = m["img_size"] // p
    calls = [gemm(batch * g * g, c0, 3 * p * p, group="conv")]
    for s, depth in enumerate(m["depths"]):
        res, c, heads, w = _stage(m, s)
        rows, n_win, hid = batch * res * res, (res // w) ** 2, int(c * m["mlp_ratio"])
        if s:
            calls.append(gemm(rows, c, 2 * c))                           # merge reduction
        for j in range(depth):
            shifted = j % 2 == 1 and res > w
            if n_win > 1 or shifted:
                calls += [Call("window", 0.0, 2.0 * rows * c * 2, "bf16")] * 2
            calls.append(gemm(rows, 3 * c, c))                           # qkv
            calls.append(Call("window", 0.0, 2.0 * rows * 3 * c * 2, "bf16"))    # unit q, k, v
            att = attention(batch * n_win, heads, w * w, c // heads)
            calls.append(Call("attention", att.flops,
                              att.nbytes + 2.0 * n_win * heads * (w * w) ** 2, att.peak))
            calls += [gemm(rows, c, c), gemm(rows, hid, c), gemm(rows, c, hid)]   # proj, MLP
    last = c0 * 2 ** (len(m["depths"]) - 1)
    calls.append(gemm(batch, m["num_classes"], last, elt=4))             # head, f32
    return calls


def gflop_per_image(m: dict) -> float:
    return sum(c.flops for c in forward_calls(m, 1)) / 1e9
