"""Query scores: the cosine matvec and the BM25 comparison sweep of the fused
normal-mode query, for up to 8 packed queries, as a hand-written CUDA kernel.

Port of the front of the JAX package's ops/fused_query.py::_fused_final
(:242-306). For each packed query b and every doc d:

    sims[b, d]      = matrix[d] . qvec[b]
    bm25[b, d]      = sum_w contrib_mat[d, w] * qw[b, q]   where term_mat[d, w] == qids[b, q]
    excl_hits[b, d] = number of slots of d that match an excluded query id
    req_hits[b, d]  = number of slots of d that match a required query id

The kernel is ``csrc/query_scores.cu`` (its header gives the design and the
bound). ``query_scores`` launches it for CUDA tensors and raises if it cannot;
it takes the plain version ``query_scores_reference`` only for tensors on the
CPU. There is no fallback from the card to the plain version or to the CPU.

``matvecs`` is the sims alone, ``out[b, d] = matrix[d] . vecs[b]`` for B <= 8
vectors: the port of the JAX package's rerank product
``jnp.dot(matrix, mean, precision=HIGHEST)`` (ops/fused_query.py:357) and of
the character query's ``1 - jnp.dot(m, q)`` (models/caformer.py:306, :329),
both in full f32. It is a second kernel of the same source,
``matvecs_kernel`` (C entry ``aiis_matvecs``): a pure stream of the matrix,
bound by its 4 D F bytes (plus 4 B F read and 4 B D written), which each warp
reads with 16-byte loads, 32 / kB rows of a group in flight, no shared-memory
staging, and stores as runs of consecutive scores. Its sums take the scoring
kernel's order (lanes over F by float4, fmaf x, y, z, w, the xor tree at
offsets 16 .. 1), so it gives the bits of ``query_scores`` with no term
slots, the route it replaced. On the CPU it is ``plain_matvecs``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build

KERNEL = "query_scores"
ID_BIAS = 0x4000_0000     # the id bias of the packed buffer (ops/fused_query.py)
MAX_BATCH = 8             # csrc/query_scores.cu holds up to 8 queries a launch
# The plain version walks D in chunks: at most this many rows, and at most
# _MATCH_ELEMS elements of the (rows, W, Q) match tensor.
CHUNK_ROWS = 65536
_MATCH_ELEMS = 1 << 26

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def split_packed(packed: torch.Tensor, f: int):
    """(qids, qw, qexcl, qreq, qvec, n_req) views of a (B, 4Q + F + 1) packed
    batch; the ids un-biased as int32 (exact: a bit-pattern view)."""
    q = (packed.shape[-1] - f - 1) // 4
    qids = packed[:, :q].contiguous().view(torch.int32) - ID_BIAS
    return (qids, packed[:, q:2 * q], packed[:, 2 * q:3 * q], packed[:, 3 * q:4 * q],
            packed[:, 4 * q:4 * q + f], packed[:, -1])


def plain_matvecs(matrix: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(D, F) x (B, F) -> (B, D) as one row reduction per (doc, query), in
    chunks of rows: a row's sum depends on its contents only, never on where
    the row sits (a BLAS product may take another path for edge rows)."""
    d = matrix.shape[0]
    out = torch.empty((vecs.shape[0], d), dtype=torch.float32, device=matrix.device)
    for s in range(0, d, CHUNK_ROWS):
        rows = matrix[s:s + CHUNK_ROWS]
        for b in range(vecs.shape[0]):
            out[b, s:s + CHUNK_ROWS] = (rows * vecs[b]).sum(dim=-1)
    return out


def query_scores_reference(matrix: torch.Tensor, term_mat: torch.Tensor,
                           contrib_mat: torch.Tensor, packed: torch.Tensor) -> Scores:
    """The plain PyTorch version: the same four (B, D) outputs, walking D in
    chunks so that the (rows, W, Q) match tensor stays bounded at any D."""
    d, f = matrix.shape
    w = term_mat.shape[1]
    qids, qw, qexcl, qreq, qvec, _ = split_packed(packed, f)
    b_n, q = qids.shape
    dev = matrix.device
    sims = plain_matvecs(matrix, qvec)
    bm25 = torch.empty((b_n, d), dtype=torch.float32, device=dev)
    excl_hits = torch.empty((b_n, d), dtype=torch.int32, device=dev)
    req_hits = torch.empty((b_n, d), dtype=torch.int32, device=dev)
    chunk = max(1, min(CHUNK_ROWS, _MATCH_ELEMS // max(1, w * q)))
    for s in range(0, d, chunk):
        tm, cm = term_mat[s:s + chunk], contrib_mat[s:s + chunk]
        for b in range(b_n):
            match = tm[:, :, None] == qids[b][None, None, :]          # (rows, W, Q)
            slot_w = (match * qw[b]).sum(dim=-1)   # exact: a slot matches one id at most
            bm25[b, s:s + chunk] = (slot_w * cm).sum(dim=-1)
            excl_hits[b, s:s + chunk] = (match & (qexcl[b] != 0)).sum(dim=(1, 2))
            req_hits[b, s:s + chunk] = (match & (qreq[b] != 0)).sum(dim=(1, 2))
    return sims, bm25, excl_hits, req_hits


def _check_matvecs_inputs(matrix: torch.Tensor, vecs: torch.Tensor) -> None:
    """The contract of ``matvecs`` on either device: f32, 2-D and contiguous,
    one F, 1..8 vectors."""
    for name, t in (("matrix", matrix), ("vecs", vecs)):
        if t.dtype != torch.float32:
            raise TypeError(f"matvecs: {name} must be torch.float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"matvecs: {name} must be a contiguous 2-D tensor")
    if vecs.shape[1] != matrix.shape[1] or matrix.shape[1] < 1:
        raise ValueError(f"matvecs: matrix {tuple(matrix.shape)} and vecs "
                         f"{tuple(vecs.shape)} must share F >= 1")
    if not 1 <= vecs.shape[0] <= MAX_BATCH:
        raise ValueError(f"matvecs: {vecs.shape[0]} vectors; the kernel takes 1..{MAX_BATCH}")


def matvecs(matrix: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(D, F) x (B, F) -> (B, D), B <= 8, each row's sum in the order of
    ``query_scores``' sims, whatever B is.

    CPU tensors go through ``plain_matvecs``. CUDA tensors (both on one card,
    D >= 1) go through the ``aiis_matvecs`` kernel, one launch a call, which
    adds one to ``matvecs.launches`` and to ``matvecs.launches_by_form``
    ("B=b") under a lock; it raises if the kernel cannot be built or launched.
    Bad arguments raise before anything is built or launched."""
    _check_matvecs_inputs(matrix, vecs)
    if matrix.device.type == "cpu" and vecs.device.type == "cpu":
        return plain_matvecs(matrix, vecs)
    for name, t in (("matrix", matrix), ("vecs", vecs)):
        if t.device.type != "cuda" or t.device != matrix.device:
            raise ValueError(f"matvecs: {name} is on {t.device}; both inputs must be on "
                             "one CUDA device (or both on the CPU)")
    d, f = matrix.shape
    b = vecs.shape[0]
    if d < 1:
        raise ValueError("matvecs: the kernel needs at least one matrix row")
    out = torch.empty((b, d), dtype=torch.float32, device=matrix.device)
    err = _entry(_bind_matvecs)(matrix.data_ptr(), vecs.data_ptr(), d, f, b, out.data_ptr(),
                                torch.cuda.current_stream(matrix.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matvecs kernel launch failed: CUDA error {err}")
    form = f"B={b}"
    with _lock:
        matvecs.launches += 1
        matvecs.launches_by_form[form] = matvecs.launches_by_form.get(form, 0) + 1
    return out


matvecs.launches = 0
matvecs.launches_by_form = {}


def _bind(lib: ctypes.CDLL):
    fn = lib.aiis_query_scores
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _bind_matvecs(lib: ctypes.CDLL):
    fn = lib.aiis_matvecs
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(matrix, term_mat, contrib_mat, packed) -> None:
    for name, t, dtype in (("matrix", matrix, torch.float32),
                           ("term_mat", term_mat, torch.int32),
                           ("contrib_mat", contrib_mat, torch.float32),
                           ("packed", packed, torch.float32)):
        if t.device.type != "cuda" or t.device != matrix.device:
            raise ValueError(f"query_scores: {name} is on {t.device}; all inputs must "
                             "be on one CUDA device (or all on the CPU)")
        if t.dtype != dtype:
            raise TypeError(f"query_scores: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"query_scores: {name} must be a contiguous 2-D tensor")
    d, f = matrix.shape
    if term_mat.shape != contrib_mat.shape or term_mat.shape[0] != d or d < 1 or f < 1:
        raise ValueError(f"query_scores: shapes matrix {tuple(matrix.shape)}, term_mat "
                         f"{tuple(term_mat.shape)}, contrib_mat {tuple(contrib_mat.shape)}")
    b, buflen = packed.shape
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"query_scores: {b} queries; the kernel takes 1..{MAX_BATCH}")
    if buflen < f + 1 or (buflen - f - 1) % 4:
        raise ValueError(f"query_scores: packed rows of {buflen} do not fit F={f}")


_lock = threading.Lock()
_entries: dict = {}


def _entry(binder):
    """A C entry point of the kernels' library, built, loaded and bound once."""
    fn = _entries.get(binder)
    if fn is None:
        with _lock:
            fn = _entries.get(binder)
            if fn is None:
                fn = _entries[binder] = binder(_build.load(KERNEL))
    return fn


def query_scores(matrix: torch.Tensor, term_mat: torch.Tensor,
                 contrib_mat: torch.Tensor, packed: torch.Tensor) -> Scores:
    """(sims, bm25, excl_hits, req_hits), each (B, D), for a (B, 4Q + F + 1)
    batch of pack_query() buffers (B <= 8).

    CPU tensors go through ``query_scores_reference``. CUDA tensors go through
    the kernel, and each launch adds one to ``query_scores.launches`` and to
    its form's entry of ``query_scores.launches_by_form`` ("matvecs B=b" with
    no term slots, else "scores B=b"), under a lock: the web server calls
    this from several threads."""
    if all(t.device.type == "cpu" for t in (matrix, term_mat, contrib_mat, packed)):
        return query_scores_reference(matrix, term_mat, contrib_mat, packed)
    _check_cuda_inputs(matrix, term_mat, contrib_mat, packed)
    d, f = matrix.shape
    b, buflen = packed.shape
    q = (buflen - f - 1) // 4
    dev = matrix.device
    sims = torch.empty((b, d), dtype=torch.float32, device=dev)
    bm25 = torch.empty((b, d), dtype=torch.float32, device=dev)
    excl_hits = torch.empty((b, d), dtype=torch.int32, device=dev)
    req_hits = torch.empty((b, d), dtype=torch.int32, device=dev)
    err = _entry(_bind)(
        matrix.data_ptr(), term_mat.data_ptr(), contrib_mat.data_ptr(), packed.data_ptr(),
        d, f, term_mat.shape[1], q, b,
        sims.data_ptr(), bm25.data_ptr(), excl_hits.data_ptr(), req_hits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"query_scores kernel launch failed: CUDA error {err}")
    form = f"{'matvecs' if q == 0 and term_mat.shape[1] == 0 else 'scores'} B={b}"
    with _lock:
        query_scores.launches += 1
        query_scores.launches_by_form[form] = query_scores.launches_by_form.get(form, 0) + 1
    return sims, bm25, excl_hits, req_hits


query_scores.launches = 0
query_scores.launches_by_form = {}


def reset_launches() -> None:
    """Zero both kernels' launch counts and their splits by form."""
    with _lock:
        for fn in (query_scores, matvecs):
            fn.launches = 0
            fn.launches_by_form.clear()
