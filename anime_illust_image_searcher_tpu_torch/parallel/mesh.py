"""Device mesh construction and batch / row placement helpers.

Port of the JAX package's parallel/mesh.py. JAX lays a batch over a
``(data, model)`` mesh with a ``NamedSharding`` and lets XLA place it; here the
mesh is the list of its data shards' devices and placement is a plain
function: ``shard_rows`` cuts the leading axis into one in-order block per data
shard and puts each block on its device, and a predictor's
``ReplicatedForward`` runs each block on its device's replica of the model.
The port has no model axis (tensor-parallel layouts are not ported):
``shape[MODEL_AXIS]`` is always 1.

A mesh is local to its process. When a ``torch.distributed`` group is up, the
mesh also carries this process's rank and the world size, and callers that
span processes (``put_global``, the sharded index, the sharded engine) count
``world_size x n_data`` shards in all, rank-major. ``RowLayout`` says where
the rows of a row-sharded array lie: JAX pads the leading axis to the shard
multiple and lets GSPMD place the blocks, the port keeps the same padded,
equal, in-order blocks as a list a process, one tensor a shard.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import DeviceLike, resolve_device, to_device
from ..utils.profiling import span

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The devices of this process's data shards, in order, with the axis
    sizes in ``shape`` (``mesh.shape[DATA_AXIS]`` as in JAX) and this
    process's ``rank`` of ``world_size`` (0 of 1 without a process group).
    ``group=False`` keeps the mesh to this process while a group is up."""

    def __init__(self, devices: Sequence[torch.device], group: bool = True) -> None:
        self.devices: List[torch.device] = list(devices)
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}
        self.distributed = group and dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world_size = dist.get_world_size() if self.distributed else 1

    @property
    def total_shards(self) -> int:
        """Data shards over every process of the group."""
        return self.world_size * self.shape[DATA_AXIS]

    @property
    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices without repeats, in order of first appearance."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}, "
                f"rank={self.rank}, world_size={self.world_size})")


def _indexed(dev: DeviceLike) -> torch.device:
    """``cuda`` as ``cuda:<current>``: a tensor's device always has an index,
    and replicas are looked up by it."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_cards() -> List[torch.device]:
    """This process's cards: every visible card, or, under a launcher that
    starts several processes on one host (``LOCAL_WORLD_SIZE`` > 1, as
    torchrun sets it), the card of this process's ``LOCAL_RANK`` alone, so
    that no two ranks share a card (NCCL refuses that). Raises without a
    card: a mesh never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA card is visible and no devices were given; "
            "pass devices=[torch.device('cpu')] to build a mesh on the CPU")
    if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        return [torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh over the first ``n_data`` of ``devices`` (all of them by
    default), by default this process's cards (``local_cards``).
    ``n_model`` is kept from the JAX signature and must be 1.

    ``devices`` may name one device more than once. NCCL puts one rank on a
    card, and the one-card machine has one card, so a mesh of ``[cuda:0,
    cuda:0]`` is how the split and the merge run with more than one shard
    there; the CPU tests build meshes of 2 or 8 ``cpu`` entries the same way
    (the counterpart of JAX's ``--xla_force_host_platform_device_count``)."""
    if n_model != 1:
        raise ValueError(f"the port's mesh has no model axis (tensor-parallel layouts "
                         f"are not ported): n_model must be 1, got {n_model}")
    devices = [_indexed(d) for d in (local_cards() if devices is None else devices)]
    if n_data is None:
        n_data = len(devices)
    if n_data < 1:
        raise ValueError(
            f"mesh needs n_data>=1 and n_model>=1, got n_data={n_data}, "
            f"n_model={n_model} over {len(devices)} devices")
    if n_data > len(devices):
        raise ValueError(
            f"mesh wants {n_data}x{n_model}={n_data} devices, "
            f"only {len(devices)} available")
    if n_data < len(devices):
        # idle hardware is a silent throughput loss the operator should see,
        # not discover in a profile
        print(f"make_mesh: using {n_data} of {len(devices)} devices "
              f"({len(devices) - n_data} idle)")
    return Mesh(devices[:n_data])


def device_mesh(device: DeviceLike = None) -> Mesh:
    """The one-shard mesh of ``device`` alone, local to this process even
    while a process group is up: what a predictor or an engine without a mesh
    runs on."""
    return Mesh([_indexed(device)], group=False)


def local_mesh(device: DeviceLike = None) -> Mesh:
    """The mesh of a CLI's ``--data-parallel``: ``make_mesh()`` over this
    process's cards on ``cuda``, one entry of the CPU when ``device`` is
    ``cpu``."""
    dev = resolve_device(device)
    return make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])


def data_parallel_batch(mesh: Mesh, batch_size: int) -> int:
    """``batch_size`` rounded up to a multiple of the mesh's data shards."""
    n = mesh.shape[DATA_AXIS]
    return -(-batch_size // n) * n


def run_mesh(mesh: Optional[Mesh], device: DeviceLike) -> Mesh:
    """``mesh``, or the one-shard mesh of ``device``, so that one code path
    serves both (its first device is the caller's device). ``device``, when
    given beside a mesh, must be of the mesh's type."""
    if mesh is None:
        return device_mesh(device)
    first = mesh.devices[0]
    if device is not None and resolve_device(device).type != first.type:
        raise ValueError(f"device {device} does not match the mesh's {first}")
    return mesh


def predictor_mesh(mesh: Optional[Mesh], device: DeviceLike, multi_host: str) -> Mesh:
    """A predictor's mesh (``run_mesh``). A mesh that spans processes raises
    ``ValueError(multi_host)``: the batch split places host arrays on this
    process's devices only."""
    if mesh is not None and mesh.world_size > 1:
        raise ValueError(multi_host)
    return run_mesh(mesh, device)


def gather_rows(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Row blocks concatenated in order on ``dev``; a single block is
    returned as it is, with no copy."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def device_scope(dev: torch.device):
    """Make ``dev`` the current card while work for it is queued: the hand
    kernels launch on the current device (a no-op on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# shard_rows' row blocks by route: through a PinnedStager, or as _put places them
uploads = {"pinned": 0, "pageable": 0}


def reset_uploads() -> None:
    for key in uploads:
        uploads[key] = 0


class PinnedStager:
    """The page-locked host buffers through which ``shard_rows`` uploads a
    numpy batch to a card: a ring of ``SLOTS`` buffers a card, each with the
    event of the last DMA that read it. A block is copied into the next slot
    (one ``copy_``, threaded for a large block) once that event is done, then
    goes up as one ``non_blocking`` DMA on the card's current stream, after
    which the event is recorded. So the host returns once its copy is made,
    and a slot is never written while a DMA still reads it, however far the
    caller lets the card run behind. A lock makes each upload whole, since a
    server's threads may share a predictor.

    A card's ring is allocated whole at its first block (a predictor's
    warm-up batch) and again only for a larger block: a smaller one uses the
    front of each slot. Each predictor's ``ReplicatedForward`` owns one
    stager."""

    SLOTS = 2

    def __init__(self) -> None:
        # card -> its slots: (flat uint8 buffer, event of the buffer's last DMA)
        self._slots: Dict[torch.device, List[Tuple[torch.Tensor, torch.cuda.Event]]] = {}
        self._turn: Dict[torch.device, int] = {}
        self._lock = threading.Lock()

    def upload(self, block: np.ndarray, dev: torch.device) -> torch.Tensor:
        """``block`` on the card ``dev``, queued on its current stream."""
        if any(st < 0 for st in block.strides):
            # torch.from_numpy refuses a negative stride (an ``x[..., ::-1]``
            # flip): such a block is made contiguous first
            block = np.ascontiguousarray(block)
        with warnings.catch_warnings():
            # torch warns that it cannot keep a read-only array (a memory
            # map) read-only; the copy below only reads it
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(block)
        nbytes = src.numel() * src.element_size()
        with self._lock:
            slots = self._slots.get(dev)
            if slots is None or slots[0][0].numel() < nbytes:
                # normal tensors, not inference ones: the forwards run in
                # inference mode and other callers do not. torch's host
                # allocator holds a dropped buffer until the DMAs that read
                # it are done.
                with torch.inference_mode(False):
                    slots = self._slots[dev] = [
                        (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                         torch.cuda.Event()) for _ in range(self.SLOTS)]
            i = self._turn.get(dev, 0)
            self._turn[dev] = (i + 1) % self.SLOTS
            buf, done = slots[i]
            done.synchronize()
            staged = buf[:nbytes].view(src.dtype).view(src.shape)
            staged.copy_(src)
            out = staged.to(dev, non_blocking=True)
            done.record(torch.cuda.current_stream(dev))
        return out


def _row_cut(arr, n_blocks: int, first: int, count: int) -> list:
    """Blocks ``first`` .. ``first + count - 1`` of ``arr`` cut into
    ``n_blocks`` equal row blocks, as views."""
    rows = arr.shape[0]
    if rows % n_blocks:
        raise ValueError(f"{rows} rows do not split into {n_blocks} equal shards; "
                         "pad the leading axis to a multiple first (pad_to_multiple)")
    m = rows // n_blocks
    return [arr[(first + i) * m:(first + i + 1) * m] for i in range(count)]


def _put(block, dev: torch.device) -> torch.Tensor:
    """``block`` on ``dev``: a tensor block is a view where it already lies
    on its device; a numpy block is copied (``to_device``: the array is often
    a read-only memory map)."""
    if isinstance(block, torch.Tensor):
        return block.to(dev)
    return to_device(block, dev)


def shard_rows(mesh: Mesh, arr, stager: PinnedStager) -> List[torch.Tensor]:
    """The in-order row blocks of ``arr`` (a numpy array or a tensor), one per
    data shard, each on its shard's device. The leading axis must divide by
    ``n_data``; otherwise this raises.

    A numpy block bound for a card goes up through the stager's page-locked
    ring as one asynchronous DMA: its copy into the ring is the copy of its
    own that ``to_device`` would make, so a read-only memory map stays safe,
    and it replaces ``to_device``'s two (a host copy, then a pageable copy
    that CUDA stages piece by piece while the host waits). A block on a CPU
    device, or a tensor block, is placed as ``_put`` places it. ``uploads``
    counts each block by its route."""
    out = []
    for block, dev in zip(_row_cut(arr, mesh.shape[DATA_AXIS], 0, len(mesh.devices)),
                          mesh.devices):
        pinned = dev.type == "cuda" and isinstance(block, np.ndarray)
        uploads["pinned" if pinned else "pageable"] += 1
        out.append(stager.upload(block, dev) if pinned else _put(block, dev))
    return out


class ReplicatedForward:
    """A predictor's batch step over its mesh: the one place that decides how
    a batch reaches the devices and runs there. ``replicas`` maps each
    distinct device of the mesh to (replica, *consts(device)): ``model``
    itself on the first device, elsewhere ``make(device)`` loaded with its
    state dict (int8 buffers as they are), in eval mode without grads. Its
    ``PinnedStager`` takes every numpy batch up to a card."""

    def __init__(self, mesh: Mesh, model: nn.Module,
                 make: Callable[[torch.device], nn.Module],
                 consts: Callable[[torch.device], tuple]) -> None:
        self.mesh = mesh
        self.device = mesh.devices[0]
        self._stager = PinnedStager()
        self.replicas: Dict[torch.device, tuple] = {self.device: (model, *consts(self.device))}
        for dev in mesh.distinct_devices[1:]:
            replica = make(dev)
            replica.load_state_dict(model.state_dict())
            self.replicas[dev] = (replica.eval().requires_grad_(False), *consts(dev))

    @property
    def consts(self) -> tuple:
        """The first device's constants, for paths that run ``model`` there."""
        return self.replicas[self.device][1:]

    def upload(self, images) -> torch.Tensor:
        """``images`` whole on the first device, by ``shard_rows``' route."""
        return shard_rows(device_mesh(self.device), images, self._stager)[0]

    def __call__(self, images, fn: Callable[..., tuple]) -> tuple:
        """``fn(replica, *constants, block)``, a tuple of tensors, on each row
        block of ``images``, queued with no sync between shards so that
        distinct cards overlap; each output gathered in order on the first
        device. One ``step.h2d`` span (the blocks' placement) and one
        ``step.launch`` span (the forwards and the gather) a batch."""
        with span("step.h2d"):
            blocks = shard_rows(self.mesh, images, self._stager)
        with span("step.launch"):
            outs = []
            for dev, x in zip(self.mesh.devices, blocks):
                replica, *consts = self.replicas[dev]
                with device_scope(dev):
                    outs.append(fn(replica, *consts, x))
            return tuple(gather_rows([o[i] for o in outs], self.device)
                         for i in range(len(outs[0])))


def put_global(arr, mesh: Mesh) -> List[torch.Tensor]:
    """This process's shards of a host array that every process holds whole
    (artifacts load from shared storage): of ``world_size x n_data`` in-order
    row blocks, blocks ``rank x n_data`` .. ``rank x n_data + n_data - 1``,
    each on its device, placed as ``_put`` places them (artifacts are
    uploaded once)."""
    n = mesh.shape[DATA_AXIS]
    return [_put(block, dev) for block, dev in
            zip(_row_cut(arr, mesh.world_size * n, mesh.rank * n, n), mesh.devices)]


def pad_to_multiple(arr, multiple: int, axis: int = 0, value=0):
    """Pad the leading axis with ``value`` so it divides the data-axis size
    (equal blocks, as XLA's static shapes need). ``arr`` comes back as it is
    when it divides already."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(arr), widths, constant_values=value), n


class RowLayout:
    """Where the ``num_rows`` rows of a row-sharded array lie on ``mesh``:
    padded to ``world_size x n_data`` equal blocks of ``block`` rows,
    rank-major, as JAX's ``pad_to_multiple`` + ``put_global`` lay them out.
    This process holds block ``i`` on ``devices[i]``: global rows
    ``starts[i]`` .. ``starts[i] + block - 1``, of which the first
    ``reals[i]`` are real and the rest padding (padding is at the global end,
    so it has the highest ids). ``single``: one block in all, the unsharded
    layout."""

    def __init__(self, mesh: Mesh, num_rows: int) -> None:
        n_data = mesh.shape[DATA_AXIS]
        self.mesh = mesh
        self.devices = mesh.devices
        self.num_rows = num_rows
        self.total = mesh.total_shards
        self.block = -(-num_rows // self.total)
        first = mesh.rank * n_data
        self.starts = [(first + i) * self.block for i in range(n_data)]
        self.reals = [min(max(num_rows - s, 0), self.block) for s in self.starts]
        self.single = self.total == 1

    def put(self, arr, fill=0) -> List[torch.Tensor]:
        """This process's blocks of ``arr`` (``num_rows`` rows of a numpy
        array, or of a tensor in the single layout), padding rows set to
        ``fill``. The single block of a tensor already on its device is the
        tensor's rows, not a copy."""
        padded, _ = pad_to_multiple(arr, self.total, value=fill)
        return put_global(padded, self.mesh)
