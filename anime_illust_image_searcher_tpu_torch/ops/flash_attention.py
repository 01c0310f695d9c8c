"""Multi-head attention for the ViT encoders: hand-written CUDA kernels for Hopper.

Port of the JAX package's ops/flash_attention.py (the Pallas TPU kernel
``mha_attention``), which takes bf16 or f32 q, k and v. Each dtype has a
kernel of its own, one template on the head dim, built at 64 (EVA02) and 32
(the CAFormer of CCIP); each source notes its design and bound:

- bf16: ``csrc/flash_attention.cu``, an online softmax over 64-key K/V tiles,
  128 query rows per block (two warpgroups), both products on Hopper's
  ``wgmma`` from swizzled shared-memory tiles that ``cp.async`` fills, f32
  softmax and accumulation, p rounded to bf16 before p·v.
- f32: ``csrc/flash_attention_f32.cu``, the same online softmax over 64-key
  K/V tiles and 128 query rows per block, both products on ``wgmma`` in split
  precision: each f32 operand split into two TF32 parts, each product taken
  as three TF32 products (lo·hi + hi·lo + hi·hi) summed in f32, p kept in f32.

``mha_attention`` launches the kernel of the inputs' dtype for CUDA tensors
and raises if it cannot; it takes the plain version ``attention_reference``
only for tensors on the CPU. There is no fallback to the plain version, to a
library attention or to the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, window_attention

KERNEL = "flash_attention"          # bf16
KERNEL_F32 = "flash_attention_f32"
HEAD_DIMS = (64, 32)   # both sources instantiate these
# per dtype: the kernel's source, its C entry and the stride multiple that
# keeps every row 16-byte aligned for cp.async
_KERNELS = {
    torch.bfloat16: (KERNEL, "aiis_flash_attention_bf16", 8),
    torch.float32: (KERNEL_F32, "aiis_flash_attention_f32", 4),
}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention, the twin of the JAX package's ``attention_reference``
    (flash_attention.py:135-143): input-dtype products accumulated in f32, f32
    softmax, p cast to v's dtype before p·v, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _bind(lib: ctypes.CDLL, entry: str):
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"mha_attention: expected (B, H, S, Dh), got {tuple(q.shape)}")
    if q.dtype not in _KERNELS:
        raise TypeError(f"mha_attention: the CUDA kernels take bfloat16 or float32, "
                        f"q is {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"mha_attention: q, k, v must have one dtype; q is "
                            f"{q.dtype}, {name} is {t.dtype}")
    multiple = _KERNELS[q.dtype][2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"mha_attention: {name} is on {t.device}; q, k, v must "
                             "all be CUDA tensors (or all CPU tensors)")
        if t.device != q.device:
            raise ValueError("mha_attention: q, k, v are on different devices")
        if t.shape != q.shape:
            raise ValueError(f"mha_attention: shape mismatch {tuple(q.shape)} vs "
                             f"{name} {tuple(t.shape)}")
        if (t.stride(-1) != 1 or any(st % multiple for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"mha_attention: {name} ({t.dtype}) needs a unit head-dim "
                             f"stride, (B, H, S) strides that are multiples of "
                             f"{multiple} and a 16-byte aligned base")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"mha_attention: head dim {q.shape[-1]} not in {HEAD_DIMS}")


_lock = threading.Lock()
_kernel_fns: dict = {}


def _kernel(dtype: torch.dtype):
    """The C entry point of ``dtype``'s kernel, built, loaded and bound once."""
    fn = _kernel_fns.get(dtype)
    if fn is None:
        with _lock:
            fn = _kernel_fns.get(dtype)
            if fn is None:
                name, entry, _ = _KERNELS[dtype]
                fn = _kernel_fns[dtype] = _bind(_build.load(name), entry)
    return fn


def reset_launches() -> None:
    """Set each head dim's launch count of both kernels to 0, and clear
    SwinV2's window attention count (``window_attention.launches``)."""
    with _lock:
        mha_attention.launches = dict.fromkeys(HEAD_DIMS, 0)
        mha_attention.launches_f32 = dict.fromkeys(HEAD_DIMS, 0)
    window_attention.reset_launches()


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ · Dh^-½) v over (B, H, S, Dh); S needs no padding.

    CPU tensors go through ``attention_reference``. CUDA tensors (Dh 64 or 32)
    go through the kernel of their dtype: bf16 or f32, one dtype for q, k and
    v. Each launch adds one to its head dim's entry of a dict keyed by head
    dim, ``mha_attention.launches`` for the bf16 kernel and
    ``mha_attention.launches_f32`` for the f32 one (under a lock: the web
    server's threads may run the CCIP encoder). The output is a (B, H, S, Dh)
    view of a (B, S, H, Dh) buffer, so the caller's merge of heads back to
    (B, S, H*Dh) needs no copy.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v)
    _check_cuda_inputs(q, k, v)
    b, h, s, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = _kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           b, h, s, dh,
                           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *out.stride()[:3],
                           dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_KERNELS[q.dtype][0]} kernel launch failed: CUDA error {err}")
    with _lock:
        counts = mha_attention.launches if q.dtype == torch.bfloat16 else mha_attention.launches_f32
        counts[dh] += 1
    return out


reset_launches()
