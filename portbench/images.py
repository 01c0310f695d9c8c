"""The traffic generator: seeded uint8 RGB images, drawn on the device from
``--seed`` in one call and copied to host memory, where the drivers hand them
to the port as a decoder would."""

from __future__ import annotations

import numpy as np
import torch


def pool(kind: str, count: int, size: int, seed: int, device) -> np.ndarray:
    """(count, size, size, 3) uint8 on the host. ``uniform_u8``: every byte
    uniform on 0..255."""
    if kind != "uniform_u8":
        raise ValueError(f"unknown image kind {kind!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t = torch.randint(0, 256, (count, size, size, 3), generator=gen, device=device,
                      dtype=torch.uint8)
    return t.cpu().numpy()
