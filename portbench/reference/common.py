"""Pieces the plain references share: f32 with TF32 off, LayerNorm, and fp8
e4m3 rounding (a control's format below bf16)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """float32 matmuls and convolutions without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float8 e4m3 rounding with one scale per slice along ``dim``'s complement
    (absmax mapped to 448, the format's largest value), returned in f32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def dense(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """x @ w.T + b with w as (out, in)."""
    y = x @ w.t()
    return y if b is None else y + b
