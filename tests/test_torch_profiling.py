"""utils/profiling.py (torch.profiler, the port's spans), the CLIs' --profile
flag and their depth-1 pipeline (utils/pipeline.py), on the CPU."""

import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from anime_illust_image_searcher_tpu.models import caformer as jc
from anime_illust_image_searcher_tpu.models.ccip_weights import save_ccip_checkpoint
from anime_illust_image_searcher_tpu_torch.cli import gen_cfeatures, genmodel, tagging
from anime_illust_image_searcher_tpu_torch.config import CCIPConfig, TaggerConfig
from anime_illust_image_searcher_tpu_torch.index import artifacts
from anime_illust_image_searcher_tpu_torch.utils import pipeline, profiling
from test_torch_checkpoint import timm_state_dict, write_checkpoint

# the spans of one batch of each CLI, and what the trace must show inside them
TAG_SPANS = ("pipeline.loader_wait", "step.h2d", "step.launch", "step.copy_back",
             "tagger.assemble", "pipeline.write")
CFEAT_SPANS = ("pipeline.loader_wait", "step.h2d", "step.launch", "step.copy_back",
               "pipeline.write")
# aten ops each span's body issues on the CPU
BODY_OPS = {"step.h2d": "aten::to", "step.launch": "aten::linear",
            "step.copy_back": "aten::to"}
# Chrome trace times are us with 3 decimals; a range's end is ts + dur
EPS_US = 0.002


def read_trace(directory):
    names = os.listdir(directory)
    assert len(names) == 1, names
    path = os.path.join(directory, names[0])
    assert os.path.getsize(path) > 0
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _ranges(events, name):
    return [e for e in events if e.get("name") == name and e.get("ph") == "X"]


def _inside(ev, rng):
    return (ev["tid"] == rng["tid"] and rng["ts"] - EPS_US <= ev["ts"]
            and ev["ts"] + ev["dur"] <= rng["ts"] + rng["dur"] + EPS_US)


def check_spans(events, spans, batches):
    """Every span is in the trace once a batch (the loader's wait once more,
    for the end of the batches), and each range encloses the aten ops of its
    body on the trace's clock: every aten op that starts inside a range ends
    inside it, each range holds its body's op, and every forward linear lies
    in a launch range."""
    aten = [e for e in events if str(e.get("name", "")).startswith("aten::")
            and e.get("ph") == "X"]
    for name in spans:
        rngs = _ranges(events, profiling.PREFIX + name)
        assert len(rngs) == batches + (name == "pipeline.loader_wait"), name
        for r in rngs:
            started = [e for e in aten if e["tid"] == r["tid"]
                       and r["ts"] <= e["ts"] < r["ts"] + r["dur"]]
            assert all(_inside(e, r) for e in started), name
            if name in BODY_OPS:
                assert any(e["name"] == BODY_OPS[name] for e in started), name
    launches = _ranges(events, profiling.PREFIX + "step.launch")
    linears = [e for e in aten if e["name"] == "aten::linear"]
    assert linears and all(any(_inside(e, r) for r in launches) for e in linears)


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path, capsys):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = read_trace(tmp_path / "t")["traceEvents"]
    (rng,) = _ranges(events, "aiis:region")
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert mms and all(_inside(e, rng) for e in mms)
    assert profiling.recorded()["region"]["count"] == 1
    assert "span region: 1 calls" in capsys.readouterr().out


class _Raises:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with no profiler recording")


def _no_range(*a, **k):
    raise AssertionError("a profiler range entered with no profiler recording")


def _forbid_ranges(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _no_range)


def test_span_is_inert_without_a_profiler(monkeypatch):
    profiling.clear()
    _forbid_ranges(monkeypatch)
    monkeypatch.setattr(profiling, "time", _Raises())
    for _ in range(3):
        with profiling.span("step.launch"):
            torch.ones(2).sum()
    assert profiling.recorded() == {}


def test_span_records_under_any_profiler():
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("a"):
                pass
    with profiling.span("a"):  # the profiler has stopped
        pass
    got = profiling.recorded()["a"]
    assert got["count"] == 2 and 0 <= got["max_s"] <= got["total_s"]
    profiling.clear()
    assert profiling.recorded() == {}


def test_trace_clears_the_recorder_when_it_starts(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    assert "before" in profiling.recorded()
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("during"):
            pass
    assert set(profiling.recorded()) == {"during"}


def test_body_exception_propagates_unchanged(tmp_path):
    err = KeyError("the body's own error")
    with pytest.raises(KeyError) as info:
        with profiling.trace(str(tmp_path / "t")):
            raise err
    assert info.value is err
    read_trace(tmp_path / "t")                  # the trace is still written


def test_no_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("AIIS_PROFILE_DIR", raising=False)
    with profiling.trace(None):
        torch.ones(3).sum()
    monkeypatch.setenv("AIIS_PROFILE_DIR", str(tmp_path / "env"))
    with profiling.trace(None):
        torch.ones(3).sum()
    read_trace(tmp_path / "env")


def test_run_depth1_order():
    """Batch N is queued before batch N-1 is collected and written."""
    calls = []
    pipeline.run_depth1(
        [1, 2, 3],
        lambda b: calls.append(("queue", b)) or b * 10,
        lambda b, q: calls.append(("collect", b, q)) or -b,
        lambda b, r: calls.append(("write", b, r)))
    assert calls == [("queue", 1), ("queue", 2), ("collect", 1, 10), ("write", 1, -1),
                     ("queue", 3), ("collect", 2, 20), ("write", 2, -2),
                     ("collect", 3, 30), ("write", 3, -3)]
    pipeline.run_depth1([], None, None, None)


def _tag_setup(tmp_cwd, monkeypatch, hidden=112):
    model_dir = write_checkpoint(tmp_cwd / "ckpt", timm_state_dict(23, hidden=hidden))
    os.makedirs("imgs")
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (30, 40, 3), np.uint8)).save(f"imgs/i{i}.png")
    monkeypatch.setattr(tagging, "TaggerConfig",
                        functools.partial(TaggerConfig, image_size=56, batch_size=2))
    return model_dir


def test_tagging_profile_flag(tmp_cwd, monkeypatch, capsys):
    model_dir = _tag_setup(tmp_cwd, monkeypatch)
    tagging.main(["--dir", "imgs", "--model-dir", model_dir, "--profile", "trace"],
                 device="cpu")
    events = read_trace("trace")["traceEvents"]
    assert any("linear" in str(e.get("name", "")) for e in events)
    check_spans(events, TAG_SPANS, batches=2)
    out = capsys.readouterr().out
    assert all(f"span {name}: " in out for name in TAG_SPANS)
    assert "span swiglu." not in out                # hidden 112 runs unpadded
    assert "counter uploads: pinned 0, pageable 2\n" in out   # 2 batches on the CPU
    with open("tags-wd-tagger.txt", encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 3


def test_tagging_profile_counts_padded_swiglu_forwards(tmp_cwd, monkeypatch, capsys):
    """A checkpoint with an unaligned SwiGLU hidden width (114) runs it padded
    to 120: 2 batches x 2 blocks padded forwards, each a range inside a
    launch range, counted in the summary."""
    model_dir = _tag_setup(tmp_cwd, monkeypatch, hidden=114)
    tagging.main(["--dir", "imgs", "--model-dir", model_dir, "--profile", "trace"],
                 device="cpu")
    assert "span swiglu.pad_114_to_120: 4 calls, " in capsys.readouterr().out
    events = read_trace("trace")["traceEvents"]
    padded = _ranges(events, profiling.PREFIX + "swiglu.pad_114_to_120")
    launches = _ranges(events, profiling.PREFIX + "step.launch")
    assert len(padded) == 4 and all(any(_inside(p, r) for r in launches) for p in padded)
    with open("tags-wd-tagger.txt", encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 3


def test_tagging_tag_file_is_the_same_with_spans_off(tmp_cwd, monkeypatch):
    """Without a profiler the spans enter no range and record nothing, and the
    tag file is byte-equal to the same run's under --profile."""
    model_dir = _tag_setup(tmp_cwd, monkeypatch)
    profiling.clear()
    with monkeypatch.context() as m:
        _forbid_ranges(m)
        tagging.main(["--dir", "imgs", "--model-dir", model_dir], device="cpu")
    assert profiling.recorded() == {}
    shutil.move("tags-wd-tagger.txt", "off.txt")
    tagging.main(["--dir", "imgs", "--model-dir", model_dir, "--profile", "trace"],
                 device="cpu")
    with open("off.txt", "rb") as a, open("tags-wd-tagger.txt", "rb") as b:
        off, on = a.read(), b.read()
    assert off == on and len(off.splitlines()) == 3


def test_genmodel_profile_flag(tmp_cwd):
    with open(artifacts.TAGS_FILE, "w", encoding="utf-8") as f:
        f.write("/a.png,1girl,solo,smile\n/b.png,1boy,solo,sword\n/c.png,1girl,sword,smile\n")
    genmodel.main(["--epochs", "2", "--profile", "trace"], device="cpu")
    read_trace("trace")
    assert os.path.exists(artifacts.DOC2VEC_INDEX + ".npy")


def test_gen_cfeatures_profile_flag(tmp_cwd, monkeypatch, capsys):
    tiny = jc.tiny_test_config()
    params = jax.tree_util.tree_map(np.asarray, jc.init_params(tiny, seed=0, use_pallas=False))
    save_ccip_checkpoint("model", tiny, params)
    os.makedirs("imgs")
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (50, 40, 3), np.uint8)).save(f"imgs/i{i}.png")
    monkeypatch.setattr(gen_cfeatures, "CCIPConfig",
                        functools.partial(CCIPConfig, image_size=64, feature_dim=32))
    gen_cfeatures.main(["--dir", "imgs", "--model-dir", "model", "--batch-size", "2",
                        "--profile", "trace"], device="cpu")
    check_spans(read_trace("trace")["traceEvents"], CFEAT_SPANS, batches=2)
    out = capsys.readouterr().out
    assert all(f"span {name}: " in out for name in CFEAT_SPANS)
    assert "span tagger.assemble" not in out
    assert "counter uploads: pinned 0, pageable 2\n" in out
    with open(artifacts.CFEATURES_CSV, encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 3
