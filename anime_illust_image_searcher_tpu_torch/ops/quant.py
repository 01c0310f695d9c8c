"""int8 matmuls with row and column scales (port of the JAX package's ops/quant.py, K11).

Opt-in (``AIIS_INT8=1`` or ``TaggerConfig.quant="int8"``): the block Linears
of EVA02 run as

  - weights:      symmetric per-output-channel int8 (absmax / 127), quantized
                  ONCE, at load, from the f32 weights (the JAX package
                  quantizes the same f32 values every step, to the same bits);
  - activations:  symmetric per-row (token) dynamic int8;
  - accumulation: int32, exact; then one f32 rescale by (row scale x column
                  scale), then ``+ bias`` in f32, then the cast to the output
                  dtype.

The int32 product is exact on either device, so a Linear's output is the JAX
package's bit for bit given the same input:

  - on the card, ``torch._int_mm`` (cuBLASLt on the int8 tensor cores). It
    needs K and N to be multiples of 8 and M > 16: ``Int8Linear`` zero-pads
    its weights once (EVA02's 2730-wide hidden becomes 2736) and its input's K
    per call; zero columns add nothing to an int32 sum. The padded output
    columns are sliced off before anything reads them;
  - on the CPU, the plain version: an f64 product of the int8 values, exact
    since |sum| <= K * 127^2 < 2^53.

Rounding is half to even in both packages (``torch.round``, ``jnp.round``);
``x / scale`` with a bf16 ``x`` and an f32 scale is f32 in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ALIGN = 8         # torch._int_mm: K and N multiples of 8
_MIN_ROWS = 17    # torch._int_mm: M > 16


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 in f32, a true division on either device (a
    Python-scalar divisor would become a multiply by 1/127 on the card, one
    ulp off in rare cases, and flip a quantized value)."""
    return amax.clamp_min(1e-8) / torch.full((1,), 127.0, device=amax.device)


def int8_quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last-axis) quantization: (q int8, scale f32 (..., 1))."""
    # max |x| in f32 in one pass (abs and max are exact, so this is the JAX
    # package's max(abs(x.astype(f32))))
    amax = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                    dtype=torch.float32)
    scale = _scale(amax)
    q = torch.div(x, scale)          # f32: bf16 / f32 promotes as jnp does
    q.round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def int8_quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Linear weight (N, K) f32 -> (int8 (N, K), scale f32 (N,)): per output
    channel, the JAX kernel (K, N)'s per-column absmax / 127."""
    w = weight.float()
    wscale = _scale(w.abs().amax(dim=1))
    wq = torch.div(w, wscale[:, None]).round_().clamp_(-127, 127)
    return wq.to(torch.int8), wscale


def plain_int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The exact product (M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32, in f64."""
    return torch.matmul(a.double(), b_t.double().t()).to(torch.int32)


def pad_int8_operands(a: torch.Tensor, b_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad (M, K) and (N, K') to what ``torch._int_mm`` takes: one K, a
    multiple of 8, for both (either may come padded already, as
    ``Int8Linear``'s weight does), N to a multiple of 8, M to more than 16.
    The product's first (M, N) block is unchanged: zero columns add nothing."""
    (m, ka), (n, kb) = a.shape, b_t.shape
    kp, np_, mp = round_up(max(ka, kb), ALIGN), round_up(n, ALIGN), max(m, _MIN_ROWS)
    if (mp, kp) != (m, ka):
        a = F.pad(a, (0, kp - ka, 0, mp - m))
    if (np_, kp) != (n, kb):
        b_t = F.pad(b_t, (0, kp - kb, 0, np_ - n))
    return a, b_t


def int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K')ᵀ int8 -> (M, N) int32, exact on either device,
    where the longer K of the two is the shorter one zero-padded: the operands
    are padded as ``torch._int_mm`` needs, then ``torch._int_mm`` runs on the
    card and the plain version on the CPU."""
    m, n = a.shape[0], b_t.shape[0]
    a, b_t = pad_int8_operands(a, b_t)
    if a.is_cuda:
        out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    else:
        out = plain_int8_mm(a, b_t)
    return out if out.shape == (m, n) else out[:m, :n]


def int8_rescale(acc: torch.Tensor, xscale: torch.Tensor, wscale: torch.Tensor,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """(acc f32 * xscale) * wscale, then + bias in f32, then the cast. The
    int32 * f32 product converts acc to f32 as ``acc.float()`` would, without
    a pass of its own."""
    y = torch.mul(acc, xscale)
    y.mul_(wscale)
    if bias is not None:
        y.add_(bias)
    return y.to(out_dtype)


def int8_dot(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32/bf16 @ kernel (K, N) f32 -> (..., N) f32 via int8: the
    JAX ``int8_dot`` (the weight quantized on every call, as there)."""
    wq, wscale = int8_quantize_weight(kernel.t())
    xq, xscale = int8_quantize_rows(x)
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = int8_rescale(acc, xscale.reshape(-1, 1), wscale, None, torch.float32)
    return y.reshape(*x.shape[:-1], kernel.shape[1])


class Int8Linear(nn.Module):
    """A Linear on the int8 path, in place of the JAX ``Int8Dense``.

    Holds the weight quantized (``weight_q`` (N', K') int8, zero-padded to
    multiples of 8, and ``weight_scale`` (N,) f32) and an f32 ``bias``. Loading
    a state dict that carries an f32 ``weight`` (N, K), as the timm and JAX
    converters write, quantizes it there; ``set_weight`` does the same for
    seeded weights. ``out_dtype`` is the output's dtype only."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 out_dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.out_dtype = out_dtype
        kp, np_ = round_up(in_features, ALIGN), round_up(out_features, ALIGN)
        self.register_buffer("weight_q", torch.zeros(np_, kp, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    @torch.no_grad()
    def set_weight(self, weight: torch.Tensor) -> None:
        """Quantize an (N, K) weight, at f32, into the padded buffers."""
        if tuple(weight.shape) != (self.out_features, self.in_features):
            raise ValueError(f"weight of shape {tuple(weight.shape)} for an Int8Linear "
                             f"({self.out_features}, {self.in_features})")
        wq, wscale = int8_quantize_weight(weight.to(self.weight_q.device))
        self.weight_q.zero_()
        self.weight_q[: self.out_features, : self.in_features] = wq
        self.weight_scale.copy_(wscale)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        weight = state_dict.pop(prefix + "weight", None)
        if weight is not None:
            self.set_weight(weight)
            state_dict[prefix + "weight_q"] = self.weight_q.clone()
            state_dict[prefix + "weight_scale"] = self.weight_scale.clone()
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward_quantized(self, xq: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
        """The layer on an input already quantized by ``int8_quantize_rows``
        (several layers reading one input quantize it once)."""
        lead, k = xq.shape[:-1], xq.shape[-1]
        if k != self.in_features:
            raise ValueError(f"input of width {k} for an Int8Linear of {self.in_features}")
        acc = int8_mm(xq.reshape(-1, k), self.weight_q)[:, : self.out_features]
        y = int8_rescale(acc, xscale.reshape(-1, 1), self.weight_scale, self.bias,
                         self.out_dtype)
        return y.reshape(*lead, self.out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_quantized(*int8_quantize_rows(x))

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, out_dtype={self.out_dtype}")
