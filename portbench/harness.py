"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); ``cells/<cell>.json`` names the driver
(``drivers/<driver>.py``, the entry into the port) and the limits of the
check; each metric the cell reports is ``metrics/<metric>.json``, read by
``readers/<reader>.py``; kernel names fall into groups by
``kernel_groups/*.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from . import trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run (the JAX stack and
# the JAX package; the port's name only begins with the latter's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "anime_illust_image_searcher_tpu")


def load(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts), encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Spec:
    name: str
    workload: dict
    cell: dict
    config: dict
    traffic: dict

    @staticmethod
    def find(name: str, overrides: Optional[dict] = None) -> "Spec":
        wl = next((w for w in benchmark()["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        over = overrides or {}
        return Spec(name, wl,
                    _merge(load("cells", f"{name}.json"), over.get("cell", {})),
                    _merge(load("configs", f"{wl['config']}.json"), over.get("config", {})),
                    _merge(load("traffic", f"{wl['traffic']}.json"), over.get("traffic", {})))

    def metrics(self, kind: str) -> List[dict]:
        """The cell's end_to_end or per_layer metrics: those of
        BENCHMARK.json that list this cell or list none."""
        out = []
        for m in benchmark()[kind]:
            if "workloads" not in m or self.name in m["workloads"]:
                out.append({**load("metrics", f"{m['name']}.json"), **m})
        return out


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, a scratch directory
    under ``TMPDIR``, the spans and the peaks of the card."""
    spec: Spec
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    tmp: str
    spans: trace.Spans
    # the driver's control in the program's place
    control: bool = False
    # seconds of each set-up step and other facts a run prints on standard error
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def peaks(device_name: str) -> dict:
    table = load("peaks.json")
    for key, row in table.items():
        if key in device_name:
            return row
    return {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def _checks_ok(checks: List[dict]) -> bool:
    return all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks)


def run_cell(name: str, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", overrides: Optional[dict] = None,
             control: bool = False, report=print) -> Dict[str, Any]:
    """Set up, measure and check one run; returns the result object (without
    printing it). ``overrides`` (tests) merge into the cell, configuration
    and traffic files; ``control`` runs the driver's control in the
    program's place."""
    spec = Spec.find(name, overrides)
    dev = torch.device(device)
    driver = importlib.import_module(f"portbench.drivers.{spec.cell['driver']}")
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        # seeds feed torch and numpy generators, which take non-negative ints
        ctx = Context(spec, int(seed) % 2 ** 63, float(seconds), bool(traced), dev, tmp,
                      trace.Spans(bool(traced)), control)
        state = driver.setup(ctx)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = trace.profiler() if traced else None
        if prof is not None:
            prof.start()
        ctx.spans.clear()
        setup_s = time.perf_counter() - t_start
        with ctx.spans(trace.WINDOW):
            t0 = time.perf_counter()
            win = driver.window(ctx, state)
            _sync(dev)
            window_s = time.perf_counter() - t0
        summary = None
        if prof is not None:
            prof.stop()
            groups = trace.KernelGroups(os.path.join(BENCH_DIR, "kernel_groups"))
            summary = trace.summarize(prof, groups)
            del prof
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        spans = {k: list(v) for k, v in ctx.spans.seconds.items()}
        t_check = time.perf_counter()
        checks, attempted, failed = driver.check(ctx, state, win)
        ctx.notes["check_s"] = time.perf_counter() - t_check
        del state
        gc.collect()
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules of the JAX stack or package are loaded: {found}")
        kind = "per_layer" if traced else "end_to_end"
        rec = dict(spec=spec, images=win["images"], window_s=window_s, setup_s=setup_s,
                   counters=win.get("counters", {}), spans=spans, trace=summary,
                   peaks=peaks(torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""))
        metrics = {}
        for m in spec.metrics(kind):
            reader = importlib.import_module(f"portbench.readers.{m['reader']}")
            value = reader.read(m, rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info: Dict[str, Any] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                                       "kind": (torch.cuda.get_device_name(dev)
                                                if dev.type == "cuda" else "cpu"),
                                       "count": 1, "memory_peak_bytes": peak}
        result: Dict[str, Any] = {"correct": _checks_ok(checks), "attempted": attempted,
                                  "failed": failed, "metrics": metrics, "device": device_info}
        if traced:
            if summary is None:
                raise RuntimeError("the trace holds no device operation in the window")
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
            report("trace: device s by group " + json.dumps(summary["group_s"]), file=sys.stderr)
            report("trace: idle s by host span " + json.dumps(summary["idle_by_span"]),
                   file=sys.stderr)
        report("window: " + json.dumps(dict(images=win["images"], window_s=window_s,
                                            setup_s=setup_s, **ctx.notes,
                                            **win.get("notes", {}))),
               file=sys.stderr)
        result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _args(argv: List[str]):
    import argparse

    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = _args(argv)
    try:
        chips = next(w for w in benchmark()["workloads"] if w["name"] == args.workload)["chips"]
    except StopIteration:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
