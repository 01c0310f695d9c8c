"""The port's model hub (models/hub.py) and ``--model-repo`` against the JAX
package's, on the CPU.

There is no network here, so ``huggingface_hub``'s two download functions are
replaced by a stand-in that serves files from local directories standing for
the repos and records each call; both packages import the same patched
module. Held equal between the packages: the names and the cache root, the
destination paths and the hub calls, cache hits that never import
``huggingface_hub``, the offline and missing-file errors, the unreadable
``metrics.json`` error, the converted CCIP checkpoint (``config.json`` bytes,
``params.npz`` arrays key for key), each package's fetched directory as a hit
for the other, and both CLIs' files with ``--model-repo``. Then the port's
``cmd_run`` and its zipapp pass ``--model-repo`` through, and every JAX
console script has an ``aiis-torch-`` twin that resolves with JAX blocked.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import shutil
import subprocess
import sys
import textwrap
import tomllib

import huggingface_hub
import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu import config as jconfig
from anime_illust_image_searcher_tpu.cli import gen_cfeatures as jgen
from anime_illust_image_searcher_tpu.cli import tagging as jtagging
from anime_illust_image_searcher_tpu.models import ccip as jccip
from anime_illust_image_searcher_tpu.models import hub as jhub
from anime_illust_image_searcher_tpu.models import tagger as jtagger
from anime_illust_image_searcher_tpu.models.eva02 import tiny_test_config as jtiny
from anime_illust_image_searcher_tpu_torch.cli import gen_cfeatures as tgen
from anime_illust_image_searcher_tpu_torch.cli import tagging as ttagging
from anime_illust_image_searcher_tpu_torch.config import CCIPConfig, TaggerConfig
from anime_illust_image_searcher_tpu_torch.index import artifacts
from anime_illust_image_searcher_tpu_torch.index.similarity import SimilarityIndex
from anime_illust_image_searcher_tpu_torch.models import ccip as tccip
from anime_illust_image_searcher_tpu_torch.models import hub as thub
from anime_illust_image_searcher_tpu_torch.models import onnx_pb as topb
from anime_illust_image_searcher_tpu_torch.models import tagger as ttagger
from anime_illust_image_searcher_tpu_torch.models.eva02 import tiny_test_config
from test_ccip_convert import FEATURE_DIM, IMG, TCAFormer, _export_style_graph, _randomize
from test_torch_checkpoint import timm_state_dict, write_checkpoint
from test_torch_gen_cfeatures import make_images as make_cf_images
from test_torch_tagging_cli import JCFG, assert_no_near_ties, make_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUBS = {"jax": jhub, "port": thub}
BLOCKED = ("jax", "flax", "anime_illust_image_searcher_tpu")
TAGGER_REPO = "someone/tiny-tagger"
CCIP_REPO = "someone/tiny-ccip"
FWD_TOL = 1e-4            # tests/test_torch_ccip_convert.py: f32 forwards, two frameworks
ROW_TOL = 1e-5            # tests/test_torch_gen_cfeatures.py: unit rows
CFG = TaggerConfig(batch_size=4, image_size=tiny_test_config().img_size, decode_workers=2)
CCIP_CFG = CCIPConfig(image_size=IMG, feature_dim=FEATURE_DIM, batch_size=4, decode_workers=2)
JCCIP_CFG = jconfig.CCIPConfig(image_size=IMG, feature_dim=FEATURE_DIM, batch_size=4,
                               decode_workers=2)


class FakeHub:
    """``snapshot_download`` and ``hf_hub_download`` over local directories
    that stand for repos ({repo id: directory}); every call is recorded."""

    def __init__(self, repos: dict) -> None:
        self.repos = repos
        self.calls: list = []

    def snapshot_download(self, repo_id, local_dir=None, allow_patterns=None):
        self.calls.append(("snapshot_download", repo_id, local_dir, tuple(allow_patterns)))
        src = self.repos[repo_id]
        os.makedirs(local_dir, exist_ok=True)
        for name in sorted(os.listdir(src)):
            if any(fnmatch.fnmatch(name, p) for p in allow_patterns):
                shutil.copyfile(os.path.join(src, name), os.path.join(local_dir, name))
        return local_dir

    def hf_hub_download(self, repo_id, filename, local_dir=None):
        self.calls.append(("hf_hub_download", repo_id, filename))
        src = os.path.join(self.repos[repo_id], filename)
        if not os.path.exists(src):
            raise FileNotFoundError(f"{repo_id} has no {filename}")
        dst = os.path.join(local_dir, filename)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        return dst


def _raise(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


@pytest.fixture(scope="module")
def tagger_repo(tmp_path_factory):
    """The published tagger layout at test size: a timm-named
    model.safetensors and its selected_tags.csv."""
    return write_checkpoint(tmp_path_factory.mktemp("tagger_repo"), timm_state_dict(23))


def write_ccip_repo(directory, metrics: str | None, model: str = thub.DEFAULT_CCIP_MODEL,
                    seed: int = 3) -> str:
    """``{model}/model_feat.onnx`` (an export-style graph of the seeded
    metaformer replica) and, unless ``metrics`` is None, ``{model}/metrics.json``."""
    m = TCAFormer().eval()
    _randomize(m, seed=seed)
    os.makedirs(os.path.join(directory, model), exist_ok=True)
    topb.save_model(topb.ModelP(graph=_export_style_graph(m)),
                    os.path.join(directory, model, "model_feat.onnx"))
    if metrics is not None:
        with open(os.path.join(directory, model, "metrics.json"), "w", encoding="utf-8") as f:
            f.write(metrics)
    return str(directory)


@pytest.fixture(scope="module")
def ccip_repo(tmp_path_factory):
    return write_ccip_repo(tmp_path_factory.mktemp("ccip_repo"), '{"threshold": 0.2}')


@pytest.fixture
def fake_hub(monkeypatch, tmp_path, tagger_repo, ccip_repo):
    """The stand-in installed on the real module, and an empty model cache."""
    hub = FakeHub({TAGGER_REPO: tagger_repo, CCIP_REPO: ccip_repo})
    monkeypatch.setattr(huggingface_hub, "snapshot_download", hub.snapshot_download)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", hub.hf_hub_download)
    monkeypatch.setenv("AIIS_MODEL_CACHE", str(tmp_path / "cache"))
    return hub


def no_hub(monkeypatch):
    """Any import of huggingface_hub now raises."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)


def npz_arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_ccip_dirs(a, b):
    """config.json byte-equal, params.npz equal key for key (dtype, shape, values)."""
    with open(os.path.join(a, "config.json"), "rb") as f, \
            open(os.path.join(b, "config.json"), "rb") as g:
        assert f.read() == g.read()
    za, zb = npz_arrays(os.path.join(a, "params.npz")), npz_arrays(os.path.join(b, "params.npz"))
    assert sorted(za) == sorted(zb)
    for key in zb:
        assert za[key].dtype == zb[key].dtype and za[key].shape == zb[key].shape, key
        np.testing.assert_array_equal(za[key], zb[key])


# ------------------------------------------------------------------ names, paths


def test_names_and_cache_root_match_jax(monkeypatch, tmp_path):
    for name in ("DEFAULT_TAGGER_REPO", "DEFAULT_CCIP_REPO", "DEFAULT_CCIP_MODEL"):
        assert getattr(thub, name) == getattr(jhub, name), name
    monkeypatch.setenv("AIIS_MODEL_CACHE", str(tmp_path / "c"))
    assert thub._cache_root() == jhub._cache_root() == str(tmp_path / "c")
    monkeypatch.delenv("AIIS_MODEL_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert thub._cache_root() == jhub._cache_root() == str(
        tmp_path / "home" / ".cache" / "aiis-tpu" / "models")


@pytest.mark.parametrize("where", ["cache_dir", "model_cache"])
def test_tagger_cache_hit_imports_no_hub(monkeypatch, tmp_path, where):
    """A directory holding both files is returned before huggingface_hub is
    imported (blocked here), by both packages, at the same path."""
    monkeypatch.setenv("AIIS_MODEL_CACHE", str(tmp_path / "cache"))
    if where == "cache_dir":
        d, kw = tmp_path / "cached", {"cache_dir": str(tmp_path / "cached")}
    else:
        d, kw = tmp_path / "cache" / "x__y", {}
    d.mkdir(parents=True)
    (d / "model.safetensors").write_bytes(b"x")
    (d / "selected_tags.csv").write_text("tag_id,name,category\n")
    no_hub(monkeypatch)
    assert thub.fetch_tagger_repo("x/y", **kw) == jhub.fetch_tagger_repo("x/y", **kw) == str(d)


# ------------------------------------------------------------------ tagger fetch


def test_tagger_fetch_downloads_like_jax(fake_hub, tmp_path):
    """The same snapshot call (repo, destination in the shared cache, the two
    file patterns), the same destination and the repo's files in it."""
    got = {}
    for name, hub in HUBS.items():
        os.environ["AIIS_MODEL_CACHE"] = str(tmp_path / name)
        fake_hub.calls.clear()
        dest = hub.fetch_tagger_repo(TAGGER_REPO)
        assert dest == str(tmp_path / name / TAGGER_REPO.replace("/", "__"))
        got[name] = list(fake_hub.calls)
        assert len(got[name]) == 1
        _, repo, local_dir, patterns = got[name][0]
        assert (repo, local_dir, set(patterns)) == (
            TAGGER_REPO, dest, {"model.safetensors", "selected_tags.csv"})
        for f in patterns:
            with open(os.path.join(dest, f), "rb") as a, \
                    open(os.path.join(fake_hub.repos[TAGGER_REPO], f), "rb") as b:
                assert a.read() == b.read(), f
    assert got["port"][0][3] == got["jax"][0][3]


@pytest.mark.parametrize("failure", ["network", "no_package"])
def test_tagger_fetch_offline_message(monkeypatch, tmp_path, failure):
    """The hub failing (or missing) raises RuntimeError in both packages with
    the same first sentence; the port's names its own offline route."""
    if failure == "network":
        monkeypatch.setattr(huggingface_hub, "snapshot_download", _raise(OSError("no network")))
    else:
        no_hub(monkeypatch)
    msgs = {}
    for name, hub in HUBS.items():
        with pytest.raises(RuntimeError) as e:
            hub.fetch_tagger_repo("x/y", cache_dir=str(tmp_path / name))
        msgs[name] = str(e.value)
    head = "In offline/zero-egress environments, "
    assert msgs["port"].split(head)[0] == msgs["jax"].split(head)[0]
    assert msgs["port"].startswith("could not download x/y from the HuggingFace Hub (")
    assert "--model-dir" in msgs["port"] and "model.safetensors" in msgs["port"]
    assert "convert_checkpoint" in msgs["jax"] and "convert_checkpoint" not in msgs["port"]


def test_tagger_fetch_missing_file(fake_hub, tmp_path):
    """A snapshot without selected_tags.csv: the same error in both packages."""
    partial = tmp_path / "partial"
    partial.mkdir()
    shutil.copyfile(os.path.join(fake_hub.repos[TAGGER_REPO], "model.safetensors"),
                    partial / "model.safetensors")
    fake_hub.repos["x/partial"] = str(partial)
    msgs = {}
    for name, hub in HUBS.items():
        with pytest.raises(RuntimeError) as e:
            hub.fetch_tagger_repo("x/partial", cache_dir=str(tmp_path / name))
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["jax"] == "x/partial snapshot is missing ['selected_tags.csv']"


# ------------------------------------------------------------------ CCIP fetch


@pytest.mark.parametrize("metrics,threshold", [
    ('{"threshold": 0.2}', 0.2),
    ('{"val_threshold": 0.35}', 0.35),
    ('{"accuracy": 0.9}', -1.0),
    (None, None),
], ids=["threshold", "val_threshold", "neither", "no_metrics_json"])
def test_ccip_fetch_converts_like_jax(fake_hub, monkeypatch, tmp_path, capsys, metrics,
                                      threshold):
    """Both packages download model_feat.onnx (and metrics.json), convert
    and write the same checkpoint: config.json bytes, params.npz arrays, the
    threshold; the conversion report printed alike; a second call is a cache
    hit with the hub failing."""
    fake_hub.repos[CCIP_REPO] = write_ccip_repo(tmp_path / "repo", metrics)
    dests, calls, printed = {}, {}, {}
    for name, hub in HUBS.items():
        os.environ["AIIS_MODEL_CACHE"] = str(tmp_path / name)
        fake_hub.calls.clear()
        capsys.readouterr()
        dests[name] = hub.fetch_ccip_repo(CCIP_REPO)
        printed[name] = [l for l in capsys.readouterr().out.splitlines()
                         if l.startswith("ccip conversion: ")]
        calls[name] = list(fake_hub.calls)
        assert dests[name] == str(tmp_path / name / (CCIP_REPO.replace("/", "__") + "__"
                                                     + thub.DEFAULT_CCIP_MODEL))
    assert calls["port"] == calls["jax"] == [
        ("hf_hub_download", CCIP_REPO, f"{thub.DEFAULT_CCIP_MODEL}/model_feat.onnx"),
        ("hf_hub_download", CCIP_REPO, f"{thub.DEFAULT_CCIP_MODEL}/metrics.json")]
    assert printed["port"] == printed["jax"] and len(printed["port"]) == 1
    assert_same_ccip_dirs(dests["port"], dests["jax"])
    from anime_illust_image_searcher_tpu_torch.models.ccip_weights import load_ccip_checkpoint

    cfg, _, thr = load_ccip_checkpoint(dests["port"])
    assert thr == threshold and cfg.dims == (16, 32, 48, 64)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", _raise(OSError("net")))
    for name, hub in HUBS.items():
        os.environ["AIIS_MODEL_CACHE"] = str(tmp_path / name)
        assert hub.fetch_ccip_repo(CCIP_REPO) == dests[name]


@pytest.mark.parametrize("failure", ["network", "no_package"])
def test_ccip_fetch_offline_message(monkeypatch, tmp_path, failure):
    if failure == "network":
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", _raise(OSError("no network")))
    else:
        no_hub(monkeypatch)
    msgs = {}
    for name, hub in HUBS.items():
        with pytest.raises(RuntimeError) as e:
            hub.fetch_ccip_repo("x/y", cache_dir=str(tmp_path / name))
        msgs[name] = str(e.value)
        assert not os.path.exists(tmp_path / name / "config.json")
    head = "In offline/zero-egress environments, "
    assert msgs["port"].split(head)[0] == msgs["jax"].split(head)[0]
    assert "anime_illust_image_searcher_tpu_torch.cli.convert_ccip" in msgs["port"]
    assert "--model-dir" in msgs["port"] and "convert_ccip" in msgs["jax"]


def test_ccip_unreadable_metrics_json(fake_hub, tmp_path):
    """A metrics.json that is no JSON is a local failure: the same
    RuntimeError in both packages, not the offline one, and nothing cached."""
    fake_hub.repos["x/bad"] = write_ccip_repo(tmp_path / "repo", "{not json")
    msgs = {}
    for name, hub in HUBS.items():
        with pytest.raises(RuntimeError) as e:
            hub.fetch_ccip_repo("x/bad", cache_dir=str(tmp_path / name))
        msgs[name] = str(e.value)
        assert not os.path.exists(tmp_path / name / "params.npz")
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"].startswith("downloaded x/bad metrics.json is unreadable: ")


# ------------------------------------------------------------------ shared cache


@pytest.mark.parametrize("fetcher,reader", [("jax", "port"), ("port", "jax")])
def test_tagger_dir_is_a_hit_for_the_other_package(fake_hub, monkeypatch, fetcher, reader):
    dest = HUBS[fetcher].fetch_tagger_repo(TAGGER_REPO)
    no_hub(monkeypatch)
    assert HUBS[reader].fetch_tagger_repo(TAGGER_REPO) == dest


@pytest.mark.parametrize("fetcher,reader", [("jax", "port"), ("port", "jax")])
def test_ccip_dir_is_a_hit_for_the_other_package(fake_hub, monkeypatch, fetcher, reader):
    """And CCIPPredictor(model_dir=...) on the fetched directory gives the
    JAX predictor's features within FWD_TOL (f32 on both sides)."""
    dest = HUBS[fetcher].fetch_ccip_repo(CCIP_REPO)
    no_hub(monkeypatch)
    assert HUBS[reader].fetch_ccip_repo(CCIP_REPO) == dest
    from anime_illust_image_searcher_tpu.models.caformer import CAFormerConfig as JCAFormerConfig
    from anime_illust_image_searcher_tpu_torch.models.caformer import CAFormerConfig

    imgs = np.random.RandomState(4).randint(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    port = tccip.CCIPPredictor(CCIP_CFG, model_dir=dest, device="cpu",
                               model_cfg=CAFormerConfig(dtype=torch.float32))
    import jax.numpy as jnp

    jpred = jccip.CCIPPredictor(JCCIP_CFG, model_dir=dest, use_pallas=False,
                                model_cfg=JCAFormerConfig(dtype=jnp.float32))
    got, want = port.ccip_batch_extract_features(imgs), jpred.ccip_batch_extract_features(imgs)
    assert got.shape == (3, FEATURE_DIM) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    assert port.ccip_default_threshold() == jpred.ccip_default_threshold() == 0.2


# ------------------------------------------------------------------ the CLIs


@pytest.fixture
def tiny_tagging(monkeypatch):
    """Both tagging CLIs at the tiny geometry: the batch, the image size and
    the head count of the test checkpoint; the model directory is the CLI's."""
    jinit, tinit = jtagger.TaggerPredictor.__init__, ttagger.TaggerPredictor.__init__
    monkeypatch.setattr(jtagger.TaggerPredictor, "__init__", lambda self, config, **kw: jinit(
        self, config=config, model_dir=kw["model_dir"], model_cfg=jtiny(), use_pallas=False))
    monkeypatch.setattr(ttagger.TaggerPredictor, "__init__", lambda self, config, **kw: tinit(
        self, config=config, model_dir=kw["model_dir"], model_cfg=tiny_test_config(),
        device=kw["device"]))
    monkeypatch.setattr(jtagging, "DEFAULT_CONFIG", dataclasses.replace(
        jconfig.DEFAULT_CONFIG, tagger=JCFG))
    monkeypatch.setattr(ttagging, "TaggerConfig", lambda: CFG)


def run_tagging(package: str, argv: list, cache: str) -> bytes:
    os.environ["AIIS_MODEL_CACHE"] = cache
    if os.path.exists(artifacts.TAGS_FILE):
        os.remove(artifacts.TAGS_FILE)
    if package == "jax":
        jtagging.main(argv)
    else:
        ttagging.main(argv, device="cpu")
    with open(artifacts.TAGS_FILE, "rb") as f:
        return f.read()


def test_tagging_model_repo_writes_the_jax_tag_file(fake_hub, tiny_tagging, tmp_cwd, capsys):
    """tagging --model-repo in both packages, each into its own empty cache:
    one snapshot call each, the tag file byte-equal to the JAX CLI's and to
    --model-dir on the repo's files."""
    make_images(tmp_cwd / "imgs", 7)
    imgs = str(tmp_cwd / "imgs")
    assert_no_near_ties(fake_hub.repos[TAGGER_REPO], sorted(
        os.path.join(imgs, f) for f in os.listdir(imgs)))
    out = {}
    for package in ("jax", "port"):
        fake_hub.calls.clear()
        capsys.readouterr()
        out[package] = run_tagging(package, ["--dir", imgs, "--model-repo", TAGGER_REPO],
                                   str(tmp_cwd / f"cache_{package}"))
        dest = str(tmp_cwd / f"cache_{package}" / TAGGER_REPO.replace("/", "__"))
        assert f"model fetched to {dest}" in capsys.readouterr().out
        assert [c[:3] for c in fake_hub.calls] == [("snapshot_download", TAGGER_REPO, dest)]
    assert out["port"] == out["jax"] and len(out["port"].decode().splitlines()) == 7
    fake_hub.calls.clear()
    assert run_tagging("port", ["--dir", imgs, "--model-dir", fake_hub.repos[TAGGER_REPO]],
                       str(tmp_cwd / "unused")) == out["port"]
    assert run_tagging("port", ["--dir", imgs, "--model-repo", TAGGER_REPO],
                       str(tmp_cwd / "cache_jax")) == out["port"]      # the JAX cache: a hit
    assert fake_hub.calls == []


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tagging_precedence(fake_hub, tiny_tagging, tmp_cwd, monkeypatch, package):
    """--model-dir wins over --model-repo (the hub is never reached), and
    --model-repo wins over $AIIS_MODEL_DIR, in both packages."""
    make_images(tmp_cwd / "imgs", 3)
    imgs = str(tmp_cwd / "imgs")
    other = write_checkpoint(tmp_cwd / "other", timm_state_dict(29))
    cache = str(tmp_cwd / "cache")
    want = run_tagging(package, ["--dir", imgs, "--model-dir", fake_hub.repos[TAGGER_REPO]],
                       cache)
    assert run_tagging(package, ["--dir", imgs, "--model-dir", other], cache) != want
    monkeypatch.setattr(huggingface_hub, "snapshot_download", _raise(OSError("never")))
    assert run_tagging(package, ["--dir", imgs, "--model-dir", fake_hub.repos[TAGGER_REPO],
                                 "--model-repo", TAGGER_REPO], cache) == want
    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_hub.snapshot_download)
    monkeypatch.setenv("AIIS_MODEL_DIR", other)
    assert run_tagging(package, ["--dir", imgs, "--model-repo", TAGGER_REPO], cache) == want


@pytest.mark.parametrize("cli", ["tagging", "gen_cfeatures"])
def test_failed_fetch_raises_and_never_runs_seeded_weights(monkeypatch, tmp_cwd, cli):
    make_images(tmp_cwd / "imgs", 2)
    monkeypatch.setenv("AIIS_MODEL_CACHE", str(tmp_cwd / "cache"))
    no_hub(monkeypatch)
    mod = ttagging if cli == "tagging" else tgen
    with pytest.raises(RuntimeError, match="--model-dir"):
        mod.main(["--dir", str(tmp_cwd / "imgs"), "--model-repo", "x/y"], device="cpu")
    assert sorted(os.listdir(tmp_cwd)) == ["imgs"]


@pytest.fixture
def tiny_cfeatures(monkeypatch):
    """Both gen_cfeatures CLIs at the replica's image size and feature width,
    the converted model in f32 (the checkpoint's geometry, an explicit
    dtype), the extraction stamp held."""
    import types

    import jax.numpy as jnp

    from anime_illust_image_searcher_tpu.models.caformer import CAFormerConfig as JCAFormerConfig
    from anime_illust_image_searcher_tpu_torch.models.caformer import CAFormerConfig

    jinit, tinit = jccip.CCIPPredictor.__init__, tccip.CCIPPredictor.__init__
    monkeypatch.setattr(jccip.CCIPPredictor, "__init__", lambda self, config, **kw: jinit(
        self, config=config, model_dir=kw["model_dir"], use_pallas=False,
        model_cfg=JCAFormerConfig(dtype=jnp.float32)))
    monkeypatch.setattr(tccip.CCIPPredictor, "__init__", lambda self, config, **kw: tinit(
        self, config=config, model_dir=kw["model_dir"], device=kw["device"],
        model_cfg=CAFormerConfig(dtype=torch.float32)))
    monkeypatch.setattr(jgen, "DEFAULT_CONFIG", dataclasses.replace(
        jconfig.DEFAULT_CONFIG, ccip=JCCIP_CFG))
    monkeypatch.setattr(tgen, "CCIPConfig", lambda: CCIP_CFG)
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(jgen, "time", clock)
    monkeypatch.setattr(tgen, "time", clock)


def run_cfeatures(package: str, argv: list, cwd, cache: str) -> dict:
    """The files gen_cfeatures wrote into a fresh ``cwd``: {name: bytes}."""
    os.environ["AIIS_MODEL_CACHE"] = cache
    os.makedirs(cwd)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        if package == "jax":
            jgen.main(argv)
        else:
            tgen.main(argv, device="cpu")
    finally:
        os.chdir(old)
    return {f: (cwd / f).read_bytes() for f in os.listdir(cwd)}


def test_gen_cfeatures_model_repo_matches_jax(fake_hub, tiny_cfeatures, tmp_path, capsys):
    """gen_cfeatures --model-repo in both packages: the same converted
    checkpoint in each cache, the path list, index marker, stamps and meta
    byte-equal, rows and norms within tolerance; --model-dir on the port's
    fetched directory writes the port's files again."""
    make_cf_images(tmp_path / "imgs", 6)
    argv = ["--dir", str(tmp_path / "imgs"), "--model-repo", CCIP_REPO]
    files, dests = {}, {}
    for package in ("jax", "port"):
        capsys.readouterr()
        files[package] = run_cfeatures(package, argv, tmp_path / package,
                                       str(tmp_path / f"cache_{package}"))
        dests[package] = str(tmp_path / f"cache_{package}" / (
            CCIP_REPO.replace("/", "__") + "__" + thub.DEFAULT_CCIP_MODEL))
        assert f"ccip model converted to {dests[package]}" in capsys.readouterr().out
    assert_same_ccip_dirs(dests["port"], dests["jax"])
    assert files["port"].keys() == files["jax"].keys()
    name = artifacts.cfeatures_index_name(0)
    for f in (artifacts.CFEATURES_CSV, name, name + ".stamps.npy", name + ".meta.json"):
        assert files["port"][f] == files["jax"][f], f
    assert files["port"][artifacts.CFEATURES_CSV].count(b"\n") == 6
    port = SimilarityIndex.load(str(tmp_path / "port" / name))
    jax_idx = SimilarityIndex.load(str(tmp_path / "jax" / name))
    np.testing.assert_allclose(port.matrix, jax_idx.matrix, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(port.norms, jax_idx.norms, rtol=ROW_TOL)
    again = run_cfeatures("port", ["--dir", str(tmp_path / "imgs"), "--model-dir",
                                   dests["port"]], tmp_path / "model_dir", str(tmp_path / "x"))
    assert again == files["port"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_gen_cfeatures_model_dir_wins(fake_hub, tiny_cfeatures, tmp_path, monkeypatch, package):
    """With both flags the hub is never reached and --model-dir's files come out."""
    make_cf_images(tmp_path / "imgs", 3)
    model_dir = HUBS[package].fetch_ccip_repo(CCIP_REPO, cache_dir=str(tmp_path / "m"))
    argv = ["--dir", str(tmp_path / "imgs"), "--model-dir", model_dir]
    want = run_cfeatures(package, argv, tmp_path / "a", str(tmp_path / "cache"))
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", _raise(OSError("never")))
    got = run_cfeatures(package, argv + ["--model-repo", CCIP_REPO], tmp_path / "b",
                        str(tmp_path / "cache"))
    assert got == want and not os.path.exists(tmp_path / "cache")


# ------------------------------------------------------------------ pass-through


# A stand-in huggingface_hub in sys.modules (snapshot_download copies the
# repo's files from $STUB_REPO), JAX and the JAX package blocked, tagging's
# device="cpu" bound in; then cmd_run, or the zipapp's own __main__ when
# the first argument is the archive.
_STUB_RUN = """
import functools, os, runpy, shutil, sys, types
stub = types.ModuleType("huggingface_hub")
def snapshot_download(repo_id, local_dir=None, allow_patterns=None):
    print("stub snapshot_download", repo_id)
    os.makedirs(local_dir, exist_ok=True)
    for name in allow_patterns:
        shutil.copyfile(os.path.join(os.environ["STUB_REPO"], name),
                        os.path.join(local_dir, name))
stub.snapshot_download = snapshot_download
sys.modules["huggingface_hub"] = stub
for name in {blocked!r}:
    sys.modules[name] = None
from anime_illust_image_searcher_tpu_torch.cli import cmd_run, tagging
tagging.main = functools.partial(tagging.main, device="cpu")
if sys.argv[1].endswith(".pyz"):
    assert ".pyz" in cmd_run.__file__, cmd_run.__file__
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
else:
    sys.argv = ["cmd_run", *sys.argv[1:]]
    cmd_run.main()
""".format(blocked=BLOCKED)


@pytest.fixture(scope="module")
def pyz(tmp_path_factory) -> str:
    out = str(tmp_path_factory.mktemp("zipapp") / "aiis_torch.pyz")
    subprocess.run([sys.executable, os.path.join(REPO, "packaging", "build_zipapp_torch.py"),
                    "--out", out], check=True, capture_output=True, text=True, timeout=120)
    return out


@pytest.mark.parametrize("how", ["cmd_run", "zipapp"])
def test_model_repo_passes_through(how, tmp_path, tagger_repo, pyz):
    """``cmd_run tagging --model-repo R`` and ``aiis_torch.pyz tagging
    --model-repo R`` fetch R into $AIIS_MODEL_CACHE and tag from it."""
    (tmp_path / "empty").mkdir()
    cache = tmp_path / "cache"
    first = [pyz] if how == "zipapp" else []
    r = subprocess.run(
        [sys.executable, "-c", _STUB_RUN, *first, "tagging", "--dir", str(tmp_path / "empty"),
         "--model-repo", TAGGER_REPO],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PYTHONPATH": pyz if how == "zipapp" else REPO, "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1", "AIIS_MODEL_CACHE": str(cache),
             "STUB_REPO": tagger_repo})
    assert r.returncode == 0, r.stdout + r.stderr
    dest = cache / TAGGER_REPO.replace("/", "__")
    assert f"stub snapshot_download {TAGGER_REPO}" in r.stdout
    assert f"model fetched to {dest}" in r.stdout and "0 files found" in r.stdout
    assert sorted(os.listdir(dest)) == ["model.safetensors", "selected_tags.csv"]


# ------------------------------------------------------------------ console scripts


def test_console_scripts_have_torch_twins_that_resolve(tmp_path):
    """Each JAX console script has an ``aiis-torch-`` twin naming the same
    module and function in the port; each target imports and is callable in a
    process with jax, flax and the JAX package blocked."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    jax_scripts = {k: v for k, v in scripts.items() if not k.startswith("aiis-torch-")}
    assert len(jax_scripts) == 5
    targets = []
    for name, target in sorted(jax_scripts.items()):
        twin = "aiis-torch-" + name[len("aiis-"):]
        assert scripts.get(twin) == target.replace(
            "anime_illust_image_searcher_tpu.", "anime_illust_image_searcher_tpu_torch.", 1), twin
        targets.append(scripts[twin])
    assert len(scripts) == 2 * len(jax_scripts)
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        for target in {targets!r}:
            module, attr = target.split(":")
            assert callable(getattr(importlib.import_module(module), attr)), target
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
        assert not loaded, loaded
        print("SCRIPTS_OK", len({targets!r}))
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path,
                       env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SCRIPTS_OK 5" in r.stdout
