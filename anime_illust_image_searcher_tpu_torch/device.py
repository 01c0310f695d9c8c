"""Explicit device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu`` (the tests do).
Asking for ``cuda`` on a machine without a card raises: the port never carries
on quietly on the CPU, because a CPU run would then pass for a GPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``cpu`` or ``cuda`` device, or raises.

    On ``cuda`` this also pins float32 matmuls and convolutions to full f32
    (TF32 off): PyTorch enables TF32 for cuDNN convolutions by default, and the
    f32 reference paths must not silently lose ten mantissa bits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU explicitly")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def to_device(arr, device: DeviceLike, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` holding its own copy of the numpy array ``arr``
    (often a read-only memory map of an artifact, which torch must not
    share). On a card the copy goes up from pageable memory, which CUDA
    stages piece by piece while the host waits: fine for an artifact loaded
    once. A predictor's numpy batch takes ``parallel/mesh.PinnedStager``
    instead, whose copy into a page-locked buffer is the batch's own copy and
    goes up as one asynchronous DMA (``shard_rows``)."""
    return torch.from_numpy(np.array(arr, dtype=dtype, order="C", copy=True)).to(device)
