"""The port's SwinV2 tagger (models/swinv2.py) on the CPU, held to the plain
f32 reference the benchmark decides ``correct`` with
(portbench/reference/swinv2.py, written from timm's equations), on seeded
weights at a tiny size: img 64, patch 4, window 4, depths 2/2/2/2. Stages 1-2
(16² and 8² tokens) have shifted and unshifted blocks, stage 3 (4²) is one
window of its whole map, and stage 4 (2²) clamps the window to its map.

Also: the window shift's CPU route against ``torch.roll`` plus the partition
bit for bit, the attention tables built once at load, the timm-layout
checkpoint through ``load_tagger_checkpoint`` with ``config.json``, its
refusals, the predictor on a one-device and a two-shard CPU mesh, the CLI,
and the hub's fetch of ``config.json``. Nothing here imports JAX.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu_torch.cli import tagging as ttagging
from anime_illust_image_searcher_tpu_torch.config import TaggerConfig
from anime_illust_image_searcher_tpu_torch.models import hub, swinv2, tagger, weights
from anime_illust_image_searcher_tpu_torch.ops import flash_attention, window_attention
from anime_illust_image_searcher_tpu_torch.ops import window_shift
from anime_illust_image_searcher_tpu_torch.parallel.mesh import make_mesh
from anime_illust_image_searcher_tpu_torch.utils import profiling
from portbench import harness
from portbench import weights as bench_weights
from portbench.drivers.tag_swinv2 import write_checkpoint
from portbench.reference import swinv2 as ref

TINY = {"model": {"img_size": 64, "embed_dim": 16, "depths": [2, 2, 2, 2],
                  "num_heads": [1, 2, 2, 4], "window_size": 4, "cpb_hidden": 32,
                  "num_classes": 64},
        "labels": {"rating": 4, "general": 48, "character": 12}}
CFG = harness._merge(harness.load("configs", "wd-swinv2-tagger-v3.json"), TINY)
MEAN = torch.full((3,), 0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: the suite runs in six xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(dtype=torch.float32) -> swinv2.SwinV2Config:
    return swinv2.tiny_test_config(num_classes=64, dtype=dtype)


def draw(seed=7):
    """Seeded leaves in timm's names (bf16 where the port serves bf16), the
    labels, and the same leaves in f32."""
    params = bench_weights.draw(ref.leaves(CFG), seed, "cpu")
    names, cats = ref.labels(CFG, seed)
    ref.calibrate_head(params, CFG, cats)
    return params, names, cats, {k: v.float() for k, v in params.items()}


def images(n=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                                  np.uint8))


def logits_of(model, imgs):
    """The port's logits on the tagger's preprocessing (scale, 0.5/0.5, BGR)."""
    x = (imgs.float() / 255.0 - MEAN) / MEAN
    with torch.inference_mode():
        return model.eval()(x.flip(-1)).double()


def loaded(dtype, f32_params):
    model = swinv2.SwinV2(model_cfg(dtype), device="cpu")
    model.load_state_dict(f32_params)
    return model


def rms_gap(a, b):
    """The largest over images of the RMS over classes of a logit gap."""
    return float(((a.double() - b.double()) ** 2).mean(dim=1).sqrt().max())


# ------------------------------------------------------------------ forward


def test_port_f32_matches_reference():
    """f32 against f32: the port reorders sums (the window partition by
    index, the scale folded into q, a fused qkv bias) but rounds nowhere
    else, so the logits (|logit| up to about 30 with the calibrated head)
    agree to 1e-4 x max(1, |logit|), 100x f32's rounding of a sum of a few
    hundred terms."""
    _, _, _, p32 = draw()
    imgs = images()
    got = logits_of(loaded(torch.float32, p32), imgs)
    want = ref.logits(p32, CFG, imgs).double()
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


def test_port_bf16_matches_reference_and_fp8_does_not():
    """bf16 against f32. bf16 keeps 8 bits, so each Linear, norm output and
    residual add rounds by up to 2^-9 relative; through 8 blocks and a head
    of 128 inputs at scale 8/sqrt(128) the logit gap's RMS over classes reads
    0.2-0.4 on these seeds (measured), and 0.75 leaves room for the seeds'
    spread. The same rule has to refuse a lower precision: the reference
    with its block linears in fp8 e4m3 (the benchmark's control) lies at
    least 3x further from f32 than the port does."""
    _, _, _, p32 = draw()
    imgs = images()
    want = ref.logits(p32, CFG, imgs)
    port = rms_gap(logits_of(loaded(torch.bfloat16, p32), imgs), want)
    fp8 = rms_gap(ref.logits(p32, CFG, imgs, fp8=True), want)
    assert port < 0.75, port
    assert fp8 > 3 * port, (fp8, port)


def test_position_bias_and_mask_match_reference():
    """Each block's table: 16 sigmoid(cpb) gathered by the relative index,
    plus the -100 mask in shifted blocks, as one (1, nW H, S, S) tensor whose
    rows are padded to a multiple of 16 elements (16-byte aligned strides in
    bf16 and f32)."""
    _, _, _, p32 = draw()
    model = loaded(torch.float32, p32)
    m = CFG["model"]
    for s, depth in enumerate(m["depths"]):
        for j in range(depth):
            attn = model.layers[s].blocks[j].attn
            res, w, shift = ref._windows(m, s, j)
            assert (attn.res, attn.window, attn.shift) == (res, w, shift)
            b = f"layers.{s}.blocks.{j}"
            want = ref.position_bias(p32, b, attn.heads, w, "cpu")[None]
            if shift:
                want = want + ref.region_mask(res, w, shift, "cpu")[:, None]
            n = (res // w) ** 2
            want = want.expand(n, attn.heads, w * w, w * w).reshape(1, -1, w * w, w * w)
            assert torch.allclose(attn.attn_bias, want, atol=1e-5, rtol=0)
            assert attn.attn_bias.stride(2) % window_attention.BIAS_ROW_MULTIPLE == 0
            assert attn.attn_bias.stride(2) >= w * w
            scale = torch.exp(p32[f"{b}.attn.logit_scale"].clamp(max=math.log(100))).view(-1)
            assert torch.allclose(attn.scale, scale)
    shifted = [(s, j) for s, d in enumerate(m["depths"]) for j in range(d)
               if model.layers[s].blocks[j].attn.shift]
    assert shifted == [(0, 1), (1, 1)]


def test_tables_are_built_at_load_and_not_in_a_forward():
    """One ``swinv2.bias_tables`` span a block at load (sum of depths), none
    in a forward; a model never loaded refuses to run."""
    _, _, _, p32 = draw()
    model = swinv2.SwinV2(model_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="not built"):
        logits_of(model, images(1))
    acts = [torch.profiler.ProfilerActivity.CPU]
    profiling.clear()
    with torch.profiler.profile(activities=acts):
        model.load_state_dict(p32)
    assert profiling.recorded()["swinv2.bias_tables"]["count"] == sum(CFG["model"]["depths"])
    profiling.clear()
    with torch.profiler.profile(activities=acts):
        logits_of(model, images(1))
    assert "swinv2.bias_tables" not in profiling.recorded()


def test_seeded_init_runs():
    model = swinv2.SwinV2(model_cfg(), device="cpu")
    swinv2.init_params(model, seed=0)
    out = logits_of(model, images(2))
    assert out.shape == (2, 64) and torch.isfinite(out).all()


# ------------------------------------------------------------ window shift


def roll_partition(x, w, shift):
    b, r, _, c = x.shape
    y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    return y.view(b, r // w, w, r // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, (r // w) ** 2, w * w, c)


@pytest.mark.parametrize("res,w,shift", [(16, 4, 0), (16, 4, 2), (12, 4, 2), (8, 4, 3),
                                         (28, 14, 7), (4, 4, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_shift_matches_roll_and_partition(res, w, shift, dtype):
    """Both ways, bit for bit: the gather by ``_source_rows`` (the kernel's
    index map) against torch.roll + the permute copy, and the scatter back
    from a window-major and from a token-major (strided) input."""
    x = torch.randn(2, res, res, 8).to(dtype)
    part = window_shift.window_partition(x, w, shift)
    assert torch.equal(part, roll_partition(x, w, shift))
    assert torch.equal(window_shift.window_reverse(part, res, w, shift), x)
    token_major = part.transpose(1, 2).contiguous().transpose(1, 2)
    assert not token_major.is_contiguous() or (res // w) ** 2 == 1
    assert torch.equal(window_shift.window_reverse(token_major, res, w, shift), x)


def test_window_shift_refuses_bad_geometry():
    x = torch.zeros(1, 10, 10, 4)
    with pytest.raises(ValueError):
        window_shift.window_partition(x, 4, 0)
    with pytest.raises(ValueError):
        window_shift.window_partition(torch.zeros(1, 8, 8, 4), 4, 4)
    with pytest.raises(ValueError):
        window_shift.window_partition(torch.zeros(1, 8, 8, 4).transpose(1, 2), 4, 0)


# -------------------------------------------------------- window attention


def test_window_attention_cpu_route():
    """The fold of windows into heads, the scale folded into q and the bias
    broadcast over the batch give plain cosine attention window by window."""
    g = torch.Generator().manual_seed(3)
    b, n_win, s, heads, dh = 2, 4, 16, 2, 8
    qkv = torch.randn(b, n_win, s, 3 * heads * dh, generator=g)
    scale = torch.tensor([3.0, 20.0])
    bias = torch.randn(1, n_win * heads, s, s, generator=g)
    out = window_attention.window_attention(qkv, scale, bias, heads)
    q, k, v = qkv.view(b, n_win, s, 3, heads, dh).permute(3, 0, 1, 4, 2, 5)
    att = (torch.nn.functional.normalize(q, dim=-1)
           @ torch.nn.functional.normalize(k, dim=-1).transpose(-1, -2)) * scale.view(-1, 1, 1)
    att = att + bias.view(1, n_win, heads, s, s)
    want = (att.softmax(-1) @ v).transpose(2, 3).reshape(b, n_win, s, heads * dh)
    assert out.shape == want.shape
    assert torch.allclose(out, want, atol=1e-5, rtol=1e-5)


def test_reset_launches_clears_the_window_count():
    window_attention.window_attention.launches[32] = 5
    flash_attention.reset_launches()
    assert window_attention.window_attention.launches == {}


# -------------------------------------------------------------- checkpoint


def timm_dir(tmp_path, config=True, model_args=None, buffers=False, seed=7):
    """A seeded checkpoint as the repo publishes it: timm-named
    model.safetensors, selected_tags.csv and (unless ``config`` is False)
    config.json; ``buffers`` adds timm's non-persistent buffers."""
    params, names, cats, p32 = draw(seed)
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    if buffers:
        params = dict(params)
        params["layers.0.blocks.1.attn_mask"] = torch.zeros(16, 16, 16)
        params["layers.0.blocks.0.attn.relative_coords_table"] = torch.zeros(1, 7, 7, 2)
        params["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
        params["layers.0.blocks.0.attn.k_bias"] = torch.zeros(16)
    write_checkpoint(d, CFG, params, names, cats)
    path = os.path.join(d, "config.json")
    if not config:
        os.remove(path)
    elif model_args is not None:
        with open(path, encoding="utf-8") as f:
            body = json.load(f)
        body["model_args"] = model_args
        with open(path, "w", encoding="utf-8") as f:
            json.dump(body, f)
    return d, names, p32


def test_checkpoint_round_trip(tmp_path):
    """timm layout in, SwinV2 detected from the keys alone (heads from each
    stage's logit_scale, window and image size from config.json), timm's
    buffers ignored, and the loaded model equal to the reference."""
    d, names, p32 = timm_dir(tmp_path, buffers=True)
    state, cfg, labels = weights.load_tagger_checkpoint(d)
    assert cfg == swinv2.SwinV2Config(img_size=64, patch_size=4, embed_dim=16,
                                      depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                                      window_size=4, cpb_hidden=32, num_classes=64)
    assert labels.names == names
    assert set(state) == set(p32)
    model = swinv2.SwinV2(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    imgs = images()
    want = ref.logits(p32, CFG, imgs).double()
    assert torch.allclose(logits_of(model, imgs), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["no_config_json", "no_window_size", "no_img_size"])
def test_checkpoint_without_model_args_is_refused(tmp_path, case):
    kw = {"no_config_json": dict(config=False),
          "no_window_size": dict(model_args={"img_size": 64}),
          "no_img_size": dict(model_args={"window_size": 4})}[case]
    d, _, _ = timm_dir(tmp_path, **kw)
    with pytest.raises(ValueError, match="config.json"):
        weights.load_tagger_checkpoint(d)


def test_checkpoint_of_another_geometry_is_refused(tmp_path):
    """A model_args window that the checkpoint's tables do not fit (its
    geometry then builds other shapes, or none) is refused, not guessed."""
    d, _, _ = timm_dir(tmp_path, model_args={"img_size": 64, "window_size": 3})
    with pytest.raises(ValueError):
        weights.load_tagger_checkpoint(d)


@pytest.mark.parametrize("how", ["config", "env"])
def test_int8_request_is_refused(tmp_path, monkeypatch, how):
    d, _, _ = timm_dir(tmp_path)
    cfg = TaggerConfig(batch_size=4, image_size=64)
    if how == "config":
        cfg = TaggerConfig(batch_size=4, image_size=64, quant="int8")
    else:
        monkeypatch.setenv("AIIS_INT8", "1")
    pred = tagger.TaggerPredictor(cfg, model_dir=d, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        pred.load_model()


# --------------------------------------------------------------- predictor


def test_predictor_lines_on_one_device_and_two_shards(tmp_path):
    """The normal tagging path: the same lines from a one-device mesh and from
    two CPU shards (a replica built and loaded for the second), and
    probabilities that match the reference."""
    d, _, p32 = timm_dir(tmp_path)
    cfg = TaggerConfig(batch_size=4, image_size=64)
    base = swinv2.SwinV2Config(dtype=torch.float32)
    imgs = images(4, seed=5)
    got = {}
    for name, mesh in (("one", None), ("two", make_mesh(devices=["cpu", "cpu:0"]))):
        pred = tagger.TaggerPredictor(cfg, model_dir=d, model_cfg=base, device="cpu", mesh=mesh)
        pred.load_model()
        assert isinstance(pred.model, swinv2.SwinV2)
        got[name] = (pred.predict(imgs.numpy(), 0.3, True, 0.3, True),
                     pred.predict_probs(imgs.numpy()))
    assert got["one"][0] == got["two"][0]
    # f32 on the CPU: two rows a shard block the GEMMs differently from four
    np.testing.assert_allclose(got["one"][1], got["two"][1], rtol=1e-4, atol=1e-7)
    want = ref.probs(p32, CFG, imgs).numpy()
    np.testing.assert_allclose(got["one"][1], want, atol=1e-5, rtol=0)


def test_tagging_cli_detects_swinv2(tmp_path, monkeypatch, capsys):
    """``tagging --dir D --model-dir M`` with M a SwinV2 checkpoint: no other
    flag; ``--profile`` counts the tables built at load."""
    from PIL import Image

    d, _, _ = timm_dir(tmp_path / "model")
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, arr in enumerate(images(3, seed=9).numpy()):
        Image.fromarray(arr).save(imgs / f"{i}.png")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ttagging, "TaggerConfig",
                        lambda: TaggerConfig(image_size=64, batch_size=4, decode_workers=1))
    ttagging.main(["--dir", str(imgs), "--model-dir", d, "--profile", str(tmp_path / "prof")],
                  device="cpu")
    lines = (tmp_path / "tags-wd-tagger.txt").read_text(encoding="utf-8").splitlines()
    assert sorted(ln.split(",", 1)[0] for ln in lines) == sorted(
        str(imgs / f"{i}.png") for i in range(3))
    assert f"span swinv2.bias_tables: {sum(CFG['model']['depths'])} calls" in capsys.readouterr().out


# --------------------------------------------------------------------- hub


class _Hub:
    """``snapshot_download`` and ``hf_hub_download`` over a local directory."""

    def __init__(self, src):
        self.src, self.calls = src, []

    def snapshot_download(self, repo_id, local_dir=None, allow_patterns=None):
        self.calls.append(("snapshot", tuple(allow_patterns)))
        os.makedirs(local_dir, exist_ok=True)
        for name in allow_patterns:
            with open(os.path.join(self.src, name), "rb") as a, \
                    open(os.path.join(local_dir, name), "wb") as b:
                b.write(a.read())

    def hf_hub_download(self, repo_id, filename, local_dir=None):
        self.calls.append(("file", filename))
        with open(os.path.join(self.src, filename), "rb") as a, \
                open(os.path.join(local_dir, filename), "wb") as b:
            b.write(a.read())
        return os.path.join(local_dir, filename)


def test_hub_fetches_swinv2_config(tmp_path, monkeypatch):
    """A SwinV2 repo: the two-file snapshot EVA02 takes, then config.json;
    a cached directory that lacks config.json fetches it alone; one that has
    it is a hit with no call."""
    huggingface_hub = pytest.importorskip("huggingface_hub")
    src, _, _ = timm_dir(tmp_path / "repo")
    fake = _Hub(src)
    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake.snapshot_download)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake.hf_hub_download)
    dest = str(tmp_path / "cache")
    assert hub.fetch_tagger_repo("SmilingWolf/wd-swinv2-tagger-v3", cache_dir=dest) == dest
    assert fake.calls == [("snapshot", hub.TAGGER_FILES), ("file", "config.json")]
    assert weights.load_tagger_checkpoint(dest)[1].window_size == 4
    os.remove(os.path.join(dest, "config.json"))
    fake.calls.clear()
    hub.fetch_tagger_repo("SmilingWolf/wd-swinv2-tagger-v3", cache_dir=dest)
    assert fake.calls == [("file", "config.json")]
    fake.calls.clear()
    hub.fetch_tagger_repo("SmilingWolf/wd-swinv2-tagger-v3", cache_dir=dest)
    assert fake.calls == []
