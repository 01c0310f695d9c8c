"""SwinV2's shifted-window partition and its inverse, one pass over the
activations each.

A SwinV2 block rolls its (B, R, R, C) tokens by ``-shift`` on both spatial
axes and cuts them into (R/w)² windows of S = w² tokens before attention,
then undoes both. The plain route is ``torch.roll`` and a permute copy each
way. On the card each direction is one kernel of ``csrc/window_shift.cu``
(``window_shift_partition_kernel``, ``window_shift_reverse_kernel``); on the
CPU it is a gather (``index_select``) or a scatter (``index_copy_``) of whole
token rows by ``_source_rows``, the index map the kernels compute. There is
no fallback from one device to the other.

``launches`` counts the kernels' launches by direction; ``reset_launches()``
zeroes it.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

KERNEL = "window_shift"
_lock = threading.Lock()
_fns: dict = {}
launches = {"partition": 0, "reverse": 0}


def reset_launches() -> None:
    with _lock:
        for key in launches:
            launches[key] = 0


def is_identity(res: int, window: int, shift: int) -> bool:
    """One window over the whole map and no shift: the partition is a view."""
    return window == res and shift == 0


@functools.lru_cache(maxsize=32)
def _source_rows(res: int, window: int, shift: int) -> torch.Tensor:
    """(nW * S,) int64 on the CPU: the token of an (R, R) map that lands at
    each (window, token) position of the partition: window (wh, ww), token
    (i, j) reads ((wh*w + i + shift) % R, (ww*w + j + shift) % R)."""
    per_side = res // window
    w = torch.arange(per_side * per_side).view(-1, 1)
    t = torch.arange(window * window).view(1, -1)
    r = (w // per_side * window + t // window + shift) % res
    c = (w % per_side * window + t % window + shift) % res
    return (r * res + c).reshape(-1)


def _check(res: int, window: int, shift: int) -> None:
    if res % window or not 0 <= shift < window:
        raise ValueError(f"window_shift: resolution {res} needs a multiple of the window "
                         f"{window} and 0 <= shift {shift} < window")


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        with _lock:
            fn = _fns.get(entry)
            if fn is None:
                fn = getattr(_build.load(KERNEL), entry)
                n_strides = 3 if entry.endswith("reverse") else 0
                fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                               + [ctypes.c_int] * 3 + [ctypes.c_longlong] * (1 + n_strides)
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _fns[entry] = fn
    return fn


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"window_shift_{name} kernel launch failed: CUDA error {err}")
    with _lock:
        launches[name] += 1


def window_partition(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """(B, R, R, C) contiguous -> (B, nW, S, C) contiguous, rolled by -shift
    and cut into windows (window-major, tokens row-major in a window)."""
    b, res, _, c = x.shape
    _check(res, window, shift)
    if not x.is_contiguous():
        raise ValueError("window_partition: x must be contiguous (B, R, R, C)")
    n_win = (res // window) ** 2
    if is_identity(res, window, shift):
        return x.view(b, 1, res * res, c)
    if x.device.type == "cpu":
        rows = _source_rows(res, window, shift)
        return x.view(b, res * res, c).index_select(1, rows).view(b, n_win, window * window, c)
    out = torch.empty((b, n_win, window * window, c), dtype=x.dtype, device=x.device)
    err = _kernel("aiis_window_shift_partition")(
        x.data_ptr(), out.data_ptr(), b, res, window, shift, c * x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("partition", err)
    return out


def window_reverse(y: torch.Tensor, res: int, window: int, shift: int) -> torch.Tensor:
    """(B, nW, S, C) with a unit channel stride (any other strides) -> (B, R, R,
    C) contiguous: the windows put back in place and rolled by +shift."""
    b, n_win, s, c = y.shape
    _check(res, window, shift)
    if n_win != (res // window) ** 2 or s != window * window or y.stride(-1) != 1:
        raise ValueError(f"window_reverse: {tuple(y.shape)} with strides {y.stride()} is not "
                         f"(B, nW, S, C) windows of {window} over {res}² with a unit "
                         "channel stride")
    if is_identity(res, window, shift):
        return y.reshape(b, res, res, c)
    if y.device.type == "cpu":
        rows = _source_rows(res, window, shift)
        out = torch.empty((b, res * res, c), dtype=y.dtype, device=y.device)
        return out.index_copy_(1, rows, y.reshape(b, n_win * s, c)).view(b, res, res, c)
    out = torch.empty((b, res, res, c), dtype=y.dtype, device=y.device)
    elt = y.element_size()
    err = _kernel("aiis_window_shift_reverse")(
        y.data_ptr(), out.data_ptr(), b, res, window, shift, c * elt,
        y.stride(0) * elt, y.stride(1) * elt, y.stride(2) * elt,
        torch.cuda.current_stream(y.device).cuda_stream)
    _launched("reverse", err)
    return out
