"""Whether the program holds its model in the precision its configuration
states: a model that keeps weights in int8 or fp8 where the configuration
states bf16 departs from it, however near its outputs read."""

from __future__ import annotations

import itertools
from typing import Iterable

import torch


def low_precision_tensors(model: torch.nn.Module, allowed: Iterable[torch.dtype] = ()) -> int:
    """The parameters and buffers of ``model`` held in a number type of one
    byte or less (int8, uint8, the fp8 types) other than ``allowed``, the types
    the configuration states."""
    ok = set(allowed) | {torch.bool}
    return sum(1 for t in itertools.chain(model.parameters(), model.buffers())
               if t.dtype.itemsize <= 1 and t.dtype not in ok)
