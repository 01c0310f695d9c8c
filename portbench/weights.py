"""Seeded weights: drawn on the device in one call a dtype, then cut into leaves.

A configuration's reference module lists its leaves as ``Leaf`` entries (name,
shape, the dtype the port serves the leaf in, and the affine map applied to a
standard normal draw). ``draw`` makes them all from one ``torch.Generator``:
one ``randn`` for the bf16 leaves and one for the f32 leaves, so the same seed
gives the same tensors on the same device, and making them costs two calls.
The checkpoint writers put those tensors into the files a user's
``--model-dir`` holds; the reference draws them again from the seed.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype      # the type the port serves it in
    scale: float            # value = shift + scale * N(0, 1)
    shift: float = 0.0


def linear(name: str, shape: Sequence[int], fan_in: int, dtype: torch.dtype) -> Leaf:
    return Leaf(name, tuple(shape), dtype, fan_in ** -0.5)


def small(name: str, shape: Sequence[int], dtype: torch.dtype = torch.float32,
          std: float = 0.02, mean: float = 0.0) -> Leaf:
    return Leaf(name, tuple(shape), dtype, std, mean)


def zeros(name: str, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> Leaf:
    """A leaf the checkpoint's layout holds and the architecture does not
    have (a bias the published model leaves out): all zeros."""
    return Leaf(name, tuple(shape), dtype, 0.0)


def norm(prefix: str, dim: int, weight: str = "weight", sep: str = ".",
         bias: bool = True) -> List[Leaf]:
    """A LayerNorm's weight 1 + N(0, 0.1^2) and bias N(0, 0.02^2) (zeros
    where the architecture has none), in f32."""
    b = f"{prefix}{sep}bias"
    return [Leaf(f"{prefix}{sep}{weight}", (dim,), torch.float32, 0.1, 1.0),
            Leaf(b, (dim,), torch.float32, 0.02) if bias else zeros(b, (dim,))]


def draw(leaves: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed`` on ``device``: one normal draw per dtype, cut
    into views and mapped in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for dtype in (torch.bfloat16, torch.float32):
        group = [leaf for leaf in leaves if leaf.dtype == dtype]
        if not group:
            continue
        sizes = [int(np.prod(leaf.shape)) for leaf in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
        for leaf, part in zip(group, flat.split(sizes)):
            t = part.view(leaf.shape)
            t.mul_(leaf.scale).add_(leaf.shift)
            out[leaf.name] = t
    return out


def _host_bytes(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return "BF16", t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return "F32", t.numpy()
    raise TypeError(f"no safetensors dtype for {t.dtype}")


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """A .safetensors file: 8-byte header length, JSON header, raw buffers."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        dt, arr = _host_bytes(t)
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        blobs.append(arr)
        offset += arr.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for arr in blobs:
            f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))


def write_npz(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """An uncompressed .npz of f32 arrays."""
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in tensors.items()})
