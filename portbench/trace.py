"""Spans the benchmark records around its calls into the port, and the
reading of a torch.profiler trace of the window.

Spans are kept in memory (name -> host seconds of each) in every run; in a
traced run each is also a ``torch.profiler.record_function`` range named
``portbench:<name>``, so the trace places it on the same clock as the
device's kernels and copies. ``summarize`` turns the trace into busy and
window seconds, device seconds by kernel group and by kernel, and the idle
gaps of the card, each named by the span the host was in at its midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "portbench:"
WINDOW = "window"
_DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}


class Spans:
    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        ctx = (torch.profiler.record_function(PREFIX + name) if self.traced
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ctx:
            yield
        self.seconds[name].append(time.perf_counter() - t)

    def clear(self) -> None:
        self.seconds.clear()


class KernelGroups:
    """Kernel name -> group, from every ``kernel_groups/*.json`` (files with
    higher names first, then each file's rules in order)."""

    def __init__(self, directory: str) -> None:
        self.rules: List[Tuple[str, List[str]]] = []
        for path in sorted(glob.glob(os.path.join(directory, "*.json")), reverse=True):
            with open(path, encoding="utf-8") as f:
                for rule in json.load(f)["rules"]:
                    self.rules.append((rule["group"], [p.lower() for p in rule["contains"]]))
        self._memo: Dict[str, str] = {}

    def __call__(self, name: str) -> str:
        g = self._memo.get(name)
        if g is None:
            low = name.lower()
            g = next((grp for grp, pats in self.rules if any(p in low for p in pats)), "other")
            self._memo[name] = g
        return g


def _activity(e) -> str:
    act = getattr(e, "activity_type", None)
    return act() if callable(act) else ""


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, groups: KernelGroups, top: int = 10) -> Optional[dict]:
    """Read the profiler's events: None where the trace holds no window span
    or no device operation."""
    device: List[Tuple[int, int, str, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name, act = e.name(), _activity(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if act and act not in _DEVICE_ACTIVITIES:
                continue
            if name.startswith(PREFIX):
                continue
            start = e.start_ns()
            kind = ("memcpy" if act == "gpu_memcpy" or "memcpy" in name.lower() else
                    "memset" if act == "gpu_memset" or "memset" in name.lower() else
                    groups(name))
            device.append((start, start + e.duration_ns(), kind, name))
        elif name.startswith(PREFIX):
            start = e.start_ns()
            spans.append((start, start + e.duration_ns(), name[len(PREFIX):]))
    window = [(s, e) for s, e, n in spans if n == WINDOW]
    if not window or not device:
        return None
    w0, w1 = window[0]
    inside = [(max(s, w0), min(e, w1), k, n) for s, e, k, n in device if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _, _ in inside])
    busy_ns = sum(e - s for s, e in busy)
    by_group: Dict[str, float] = defaultdict(float)
    by_name: Dict[Tuple[str, str], float] = defaultdict(float)
    for s, e, k, n in inside:
        by_group[k] += (e - s) / 1e9
        by_name[(k, n)] += (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    inner = sorted((s, e, n) for s, e, n in spans if n != WINDOW)
    starts = [s for s, _, _ in inner]

    def host_in(t: int) -> str:
        """The innermost span holding ``t`` (the one that started last)."""
        i = bisect.bisect_right(starts, t)
        for s, e, n in reversed(inner[max(0, i - 256):i]):
            if s <= t < e:
                return n
        return "outside spans"

    named = sorted(((e - s) / 1e9, host_in((s + e) // 2)) for s, e in gaps)[::-1]
    idle_by_span: Dict[str, float] = defaultdict(float)
    for sec, n in named:
        idle_by_span[n] += sec
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        group_s=dict(by_group),
        device_ops=[[f"{k} | {n[:100]}", sec] for (k, n), sec in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, sec] for sec, n in named[:top]],
        idle_by_span=dict(sorted(idle_by_span.items(), key=lambda kv: -kv[1])),
    )


def profiler() -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
