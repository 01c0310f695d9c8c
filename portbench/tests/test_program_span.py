"""The reader of the port's own spans (``readers/program_span_ms``), on a
recorder filled under a CPU profiler."""

import time

import torch

from anime_illust_image_searcher_tpu_torch.utils import profiling
from portbench import harness
from portbench.readers import program_span_ms

METRIC = {"args": {"span": "step.launch"}}


def _fill(seconds):
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for s in seconds:
            with profiling.span("step.launch"):
                time.sleep(s)


def test_mean_ms_of_the_span():
    _fill([0.01, 0.03])
    got = program_span_ms.read(METRIC, {})
    assert 20.0 <= got < 40.0
    assert program_span_ms.read({"args": {"span": "step.h2d"}}, {}) is None
    profiling.clear()
    assert program_span_ms.read(METRIC, {}) is None


def test_a_port_without_a_recorder_reads_none(monkeypatch):
    _fill([0.0])
    monkeypatch.delattr(profiling, "recorded")
    assert program_span_ms.read(METRIC, {}) is None


def test_each_metric_names_a_span_of_the_port():
    spans = {"tagger.assemble", "step.h2d", "step.launch"}
    readers = [m for m in harness.benchmark()["per_layer"]
               if harness.load("metrics", f"{m['name']}.json")["reader"] == "program_span_ms"]
    assert len(readers) == 5
    for m in readers:
        assert harness.load("metrics", f"{m['name']}.json")["args"]["span"] in spans
        assert len(m["workloads"]) == 1
