"""Tracing of a run with torch.profiler (port of the JAX package's utils/profiling.py).

  - ``trace(dir)`` records host and CUDA activity of a region, writes a
    Chrome trace (viewable in Perfetto or chrome://tracing) into ``dir`` and
    prints what each span of the run cost the host;
  - ``span(name)`` marks one step of the port's work. While a profiler
    records (``trace`` or any other ``torch.profiler``), it is a host range
    named ``aiis:<name>`` on the trace's clock beside the card's kernels and
    copies, and its host seconds go into a process-wide recorder
    (``recorded()``, ``clear()``): the spans sit deep in the models, where no
    caller's object reaches. While none records, it costs one check and
    reads no clock.

Enable with the CLIs' ``--profile DIR`` flag or the ``AIIS_PROFILE_DIR``
environment variable.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "aiis:"

_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
# span name -> [count, total host s, max host s]
_recorder: Dict[str, list] = {}


class _Span:
    __slots__ = ("name", "_range", "_t")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        # a range of the function scope (a ``cpu_op`` in the trace):
        # ``record_function``'s user scope also puts an annotation on the
        # card's timeline over the kernels it launched, which a reader of
        # the device's busy time would count as work
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        self._t = time.perf_counter()

    def __exit__(self, *exc) -> None:
        sec = time.perf_counter() - self._t
        self._range.__exit__(*exc)
        with _lock:
            row = _recorder.setdefault(self.name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += sec
            row[2] = max(row[2], sec)


def span(name: str) -> contextlib.AbstractContextManager:
    """One step of the port's work, recorded only while a profiler records."""
    return _Span(name) if _profiler_enabled() else _OFF


def recorded() -> Dict[str, Dict[str, float]]:
    """Each span recorded since the last ``clear()``: its count, total host
    seconds and longest host seconds."""
    with _lock:
        return {name: {"count": c, "total_s": t, "max_s": m}
                for name, (c, t, m) in _recorder.items()}


def clear() -> None:
    with _lock:
        _recorder.clear()


def profile_dir() -> Optional[str]:
    return os.environ.get("AIIS_PROFILE_DIR") or None


def trace_path(directory: str) -> str:
    return os.path.join(directory, f"trace-{os.getpid()}-{time.time_ns()}.json")


@contextlib.contextmanager
def trace(directory: Optional[str] = None,
          counters: Optional[Dict[str, Dict[str, int]]] = None) -> Iterator[None]:
    """Record the region into a Chrome trace in ``directory`` (no-op when None
    and ``AIIS_PROFILE_DIR`` is unset), then print the spans it recorded and
    what the region added to each of ``counters`` (name -> a process-wide
    count by key, such as ``parallel/mesh.uploads``). CUDA activity is
    recorded when a card is present.

    A profiler that fails to start or to write never breaks the run, but an
    exception of the WRAPPED BODY propagates untouched."""
    directory = directory or profile_dir()
    if not directory:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    before = {name: dict(c) for name, c in (counters or {}).items()}
    prof = None
    try:
        os.makedirs(directory, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — profiler start failure only
        print(f"profiling unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                path = trace_path(directory)
                prof.export_chrome_trace(path)
                print(f"profiler trace written to {path}")
            except Exception as e:  # noqa: BLE001 — profiler finalize failure only
                print(f"profiler finalize failed: {e}")
            for name, r in sorted(recorded().items()):
                print(f"span {name}: {r['count']} calls, {r['total_s']:.3f} s total, "
                      f"{1e3 * r['total_s'] / r['count']:.2f} ms mean, "
                      f"{1e3 * r['max_s']:.2f} ms max")
            for name, c in (counters or {}).items():
                print(f"counter {name}: " + ", ".join(
                    f"{key} {n - before[name].get(key, 0)}" for key, n in c.items()))
