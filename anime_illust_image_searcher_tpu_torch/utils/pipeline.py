"""The CLIs' depth-1 pipeline: batch N is queued on the card before batch N-1
is collected (copied back, its lines assembled) and written on the host, so
the host's side of N-1 runs while the card runs N.

The spans ``pipeline.loader_wait`` (the host waiting for a decoded batch)
and ``pipeline.write`` (a batch's output side) are recorded here, once for
every CLI (utils/profiling.span).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, TypeVar

from .profiling import span

B = TypeVar("B")


def run_depth1(
    batches: Iterable[B],
    queue: Callable[[B], Any],
    collect: Callable[[B, Any], Any],
    write: Callable[[B, Any], None],
) -> None:
    """For each batch: ``queue(batch)`` (device work, no sync), then
    ``collect`` and ``write`` of the batch before it; the last batch is
    collected and written after the loop."""
    it = iter(batches)
    pending = None
    while True:
        with span("pipeline.loader_wait"):
            batch = next(it, None)
        if batch is None:
            break
        queued = queue(batch)
        if pending is not None:
            _finish(pending, collect, write)
        pending = (batch, queued)
    if pending is not None:
        _finish(pending, collect, write)


def _finish(pending, collect, write) -> None:
    batch, queued = pending
    result = collect(batch, queued)
    with span("pipeline.write"):
        write(batch, result)
