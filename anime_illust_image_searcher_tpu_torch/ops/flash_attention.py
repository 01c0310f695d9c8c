"""Multi-head attention for the ViT encoder: a hand-written CUDA kernel for Hopper.

Port of the JAX package's ops/flash_attention.py (the Pallas TPU kernel
``mha_attention``). The kernel is ``csrc/flash_attention.cu``: an online softmax
over 64-key K/V tiles, 128 query rows per block (two warpgroups), both products
on Hopper's ``wgmma`` from 128-byte-swizzled shared-memory tiles that
``cp.async`` fills, f32 softmax and accumulation (the source notes its design
and bound).

``mha_attention`` launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version ``attention_reference`` only for tensors on the CPU.
There is no fallback to the plain version, to a library attention or to the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "flash_attention"
HEAD_DIMS = (64,)   # csrc/flash_attention.cu instantiates these


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention, the twin of the JAX package's ``attention_reference``
    (flash_attention.py:135-143): input-dtype products accumulated in f32, f32
    softmax, p cast to v's dtype before p·v, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.aiis_flash_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"mha_attention: expected (B, H, S, Dh), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"mha_attention: {name} is on {t.device}; q, k, v must "
                             "all be CUDA tensors (or all CPU tensors)")
        if t.device != q.device:
            raise ValueError("mha_attention: q, k, v are on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mha_attention: the CUDA kernel takes bfloat16, {name} is {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"mha_attention: shape mismatch {tuple(q.shape)} vs "
                             f"{name} {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"mha_attention: {name} needs a unit head-dim stride, "
                             "(B, H, S) strides that are multiples of 8 and a "
                             "16-byte aligned base")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"mha_attention: head dim {q.shape[-1]} not in {HEAD_DIMS}")


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ · Dh^-½) v over (B, H, S, Dh); S needs no padding.

    CPU tensors go through ``attention_reference``. CUDA tensors (bf16, Dh=64)
    go through the kernel, and each launch adds one to ``mha_attention.launches``.
    The output is a (B, H, S, Dh) view of a (B, S, H, Dh) buffer, so the
    caller's merge of heads back to (B, S, H*Dh) needs no copy.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v)
    _check_cuda_inputs(q, k, v)
    b, h, s, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _bind(_build.load(KERNEL))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, h, s, dh,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    mha_attention.launches += 1
    return out


mha_attention.launches = 0
