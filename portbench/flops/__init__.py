"""Operations and bytes of each configuration's work, counted from its shapes,
so that a roofline counts the same work whatever implements it.

Each architecture module has ``forward_calls(model, batch)``: one ``Call`` per
device operation of one forward that a roofline reads (the attention
launches, the matmuls by group), and ``gflop_per_image(model)``: every matmul
and convolution of one image, 2 FLOP per multiply-add."""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class Call:
    group: str       # the kernel group that runs it (kernel_groups/*.json)
    flops: float
    nbytes: float    # each input byte read once, each output byte written once
    peak: str        # key of the operations' peak in peaks.json


def attention(b: int, h: int, s: int, dh: int, elt: int = 2) -> Call:
    """One attention launch over (B, H, S, Dh): q k^T and p v on the tensor
    cores (4 B H S^2 Dh FLOP), q, k, v read and o written once. The copy of
    ``chip_smoke.attention_bound``'s FLOP and byte terms; its MUFU term is not
    part of this roofline."""
    return Call("attention", 4.0 * b * h * s * s * dh, 4.0 * b * h * s * dh * elt,
                "bf16" if elt == 2 else "f32")


def gemm(m: int, n: int, k: int, elt: int = 2, group: str = "gemm") -> Call:
    """(m, k) @ (k, n) with both operands and the output in ``elt`` bytes."""
    return Call(group, 2.0 * m * n * k, float(elt) * (m * k + k * n + m * n),
                "bf16" if elt == 2 else "f32")


def module(arch: str):
    return importlib.import_module(f"portbench.flops.{arch}")


def roofline_s(calls, peaks: dict) -> float:
    """Least seconds for ``calls``: each at the larger of its operations at
    its peak and its bytes at the memory rate."""
    return sum(max(c.flops / peaks[c.peak], c.nbytes / peaks["hbm_bytes_per_s"]) for c in calls)
