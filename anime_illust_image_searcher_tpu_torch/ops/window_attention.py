"""SwinV2's scaled cosine attention over windows, with an additive bias.

For each window of S tokens and each head h (timm ``WindowAttention`` of
``swin_transformer_v2``):

    softmax(normalize(q) · normalize(k)ᵀ · exp(min(logit_scale_h, ln 100)) + bias) · v

where ``bias`` is the block's 16·sigmoid(cpb) position bias plus, in a
shifted block, the −100 region mask; it depends on no input and is built
once at load (models/swinv2.py), one (1, nW·H, S, S) tensor in the compute
dtype that broadcasts over the batch. The windows are folded into the heads
axis so that one bias serves every image: q, k and v become (B, nW·H, S, Dh),
and the per-head scale is folded into the normalized q, so the product takes
scale 1.

On the card the inputs are made in one pass over qkv by the hand kernel
``window_qkv_unit_kernel`` (``csrc/window_qkv.cu``): the unit q with the scale
folded in, the unit k and v, token-major, (B, S, nW·H, Dh) in memory, so that
SDPA's output comes back token-major as well and the proj reads it without a
copy; ``unit_qkv.launches`` counts it. On the CPU they are plain torch ops
(``unit_qkv_reference``), the same arithmetic: norm and product in f32,
rounded once.

On the card the product is ``torch.nn.functional.scaled_dot_product_attention``
restricted to its memory-efficient and cuDNN backends, the two that add a
bias inside the kernel without materialising the scores; the math backend is
never allowed, so a call that neither can take raises. On the CPU it is the
plain product (``attention_reference``). ``window_attention.launches`` counts
the card's calls by head dim, as ``mha_attention.launches`` does for the hand
kernel; ``reset_launches()`` (also called by ``flash_attention.reset_launches``)
zeroes it.

The PyTorch call is this port's yardstick and not one of its kernels: a
bias-capable hand kernel at Dh=32 is later work, measured by the tagging
cell's ``attn_roofline.swin``.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "window_qkv"
_lock = threading.Lock()
_fns: dict = {}
# the bias's rows are padded to this many elements so that every stride but
# the last is 16-byte aligned in bf16 and f32: the memory-efficient backend
# pads and copies a bias that is not, on every call
BIAS_ROW_MULTIPLE = 16
LOGIT_SCALE_MAX = math.log(100.0)
NORM_EPS = 1e-12  # F.normalize's


def reset_launches() -> None:
    with _lock:
        window_attention.launches = {}
        unit_qkv.launches = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ + bias) v with input-dtype operands, f32 products and
    softmax, p cast to v's dtype before p·v; output in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _sdpa(q, k, v, bias):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)


def unit_qkv_reference(qkv: torch.Tensor, scale: torch.Tensor, heads: int):
    """The plain route of ``unit_qkv``: contiguous (B, nW·H, S, Dh) outputs."""
    b, n_win, s, c3 = qkv.shape
    dh = c3 // 3 // heads
    parts = qkv.view(b, n_win, s, 3, heads, dh).permute(3, 0, 1, 4, 2, 5)   # (3, B, nW, H, S, Dh)

    def unit(t: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(t, dim=-1, keepdim=True, dtype=torch.float32)
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        torch.mul(t, factor / n.clamp_min_(NORM_EPS), out=out)
        return out.view(b, n_win * heads, s, dh)

    return (unit(parts[0], scale.view(heads, 1, 1)),
            unit(parts[1], torch.ones((), dtype=torch.float32, device=qkv.device)),
            parts[2].contiguous().view(b, n_win * heads, s, dh))


def _unit_kernel():
    fn = _fns.get(KERNEL)
    if fn is None:
        with _lock:
            fn = _fns.get(KERNEL)
            if fn is None:
                fn = _build.load(KERNEL).aiis_window_qkv_unit
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _fns[KERNEL] = fn
    return fn


def unit_qkv(qkv: torch.Tensor, scale: torch.Tensor, heads: int):
    """(q · scale / |q|, k / |k|, v) per head row of ``qkv`` (B, nW, S, 3C),
    each (B, nW·H, S, Dh); norms and products in f32, rounded once. On the
    card one kernel launch, and the three are token-major views of (B, S,
    nW·H, Dh) buffers; on the CPU, ``unit_qkv_reference``."""
    if qkv.device.type == "cpu":
        return unit_qkv_reference(qkv, scale, heads)
    b, n_win, s, c3 = qkv.shape
    dh = c3 // 3 // heads
    row_vec = dh * qkv.element_size() // 16
    if (qkv.dtype not in (torch.bfloat16, torch.float32) or not qkv.is_contiguous()
            or dh * qkv.element_size() % 16 or row_vec & (row_vec - 1) or row_vec > 32
            or qkv.data_ptr() % 16 or scale.dtype != torch.float32 or not scale.is_contiguous()
            or scale.numel() != heads or scale.device != qkv.device):
        raise ValueError(f"unit_qkv: qkv {tuple(qkv.shape)} {qkv.dtype} needs a contiguous "
                         "bf16 or f32 tensor with 16-byte aligned head rows of 1-32 vectors "
                         "(a power of two) and an f32 scale a head on its device")
    outs = [torch.empty((b, s, n_win * heads, dh), dtype=qkv.dtype, device=qkv.device)
            for _ in range(3)]
    err = _unit_kernel()(qkv.data_ptr(), *(o.data_ptr() for o in outs), scale.data_ptr(),
                         b, n_win, s, heads, dh, qkv.element_size(), NORM_EPS,
                         torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_qkv_unit kernel launch failed: CUDA error {err}")
    with _lock:
        unit_qkv.launches += 1
    return tuple(o.transpose(1, 2) for o in outs)


def window_attention(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """``qkv``: (B, nW, S, 3C), the qkv projection of the windows' tokens
    (q, k, v each C = heads · Dh wide, head-major); ``scale``: (heads,) f32,
    exp of the clamped logit scale; ``bias``: (1, nW·heads, S, S) in qkv's
    dtype. Returns (B, nW, S, C) in qkv's dtype: a view of the product's
    output when its layout allows, which on the card is token-major
    (``out.transpose(1, 2)`` is contiguous)."""
    b, n_win, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    q, k, v = unit_qkv(qkv, scale, heads)
    if qkv.device.type == "cpu":
        out = attention_reference(q, k, v, bias)
    else:
        out = _sdpa(q, k, v, bias)
        with _lock:
            window_attention.launches[dh] = window_attention.launches.get(dh, 0) + 1
    return out.view(b, n_win, heads, s, dh).transpose(2, 3).reshape(b, n_win, s, c)


reset_launches()
