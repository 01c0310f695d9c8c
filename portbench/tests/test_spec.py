"""Every file the harness finds by name loads, and every name and unit keeps
to the characters the benchmark's format allows."""

import importlib
import json
import os
import re

import pytest

from portbench import flops, harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_load(wl):
    spec = harness.Spec.find(wl["name"])
    assert NAME.match(wl["name"]) and NAME.match(wl["config"]) and NAME.match(wl["traffic"])
    assert wl["chips"] == 1
    assert len(wl["why"]) <= 200
    importlib.import_module(f"portbench.drivers.{spec.cell['driver']}")
    assert spec.config["name"] == wl["config"]
    for kind in ("end_to_end", "per_layer"):
        assert spec.metrics(kind), kind
    assert any(m["name"] == "setup_s" for m in spec.metrics("end_to_end"))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load(cfg):
    assert NAME.match(cfg["name"])
    with open(os.path.join(harness.ROOT, cfg["file"]), encoding="utf-8") as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    importlib.import_module(f"portbench.reference.{body['arch']}")
    flops.module(body["arch"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_files_load(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    body = harness.load("metrics", f"{m['name']}.json")
    for key in ("unit", "better", "source"):
        assert body[key] == m[key]
    if "layer" in m:
        assert body["layer"] == m["layer"] and body["moves"] == m["moves"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    reader = importlib.import_module(f"portbench.readers.{body['reader']}")
    assert callable(reader.read)


def test_kernel_groups_load():
    groups = trace.KernelGroups(os.path.join(harness.BENCH_DIR, "kernel_groups"))
    assert groups("void attn_fwd_wgmma<64>(Params)") == "attention"
    assert groups("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT") == "gemm"
    assert groups("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>") == "rope_cat"
    ln = "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>"
    assert groups(ln) == "layer_norm"
    assert groups("void at::native::RowwiseMomentsCUDAKernel<float, float, false>") == "layer_norm"
    assert groups("void at::native::vectorized_elementwise_kernel<4, ...>") == "elementwise"
