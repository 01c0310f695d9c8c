"""Each plain reference agrees with the port's CPU path on tiny seeded
configurations, in f32, fed through the port's own checkpoint loaders from
the files the benchmark writes (the timm safetensors; the flax npz)."""

import dataclasses
import json

import numpy as np
import torch

from portbench import harness, weights
from portbench.reference import caformer as ref_caformer
from portbench.reference import eva02 as ref_eva02
from portbench.reference import tag_lines
from portbench.tests import tiny


def _config(name, over):
    return harness._merge(harness.load("configs", f"{name}.json"), over["config"])


def test_eva02_reference_matches_port_f32(tmp_path):
    from anime_illust_image_searcher_tpu_torch.models import eva02, tagger
    from anime_illust_image_searcher_tpu_torch.models.weights import load_tagger_checkpoint
    from portbench.drivers.tag_dir import _model_cfg

    cfg = _config("wd-eva02-large-tagger-v3", tiny.TAG)
    params = weights.draw(ref_eva02.leaves(cfg), 7, "cpu")
    names, cats = ref_eva02.labels(cfg, 7)
    ref_eva02.calibrate_head(params, cfg, cats)
    weights.write_safetensors(str(tmp_path / "model.safetensors"), params)
    with open(tmp_path / "selected_tags.csv", "w", encoding="utf-8") as f:
        f.write("tag_id,name,category,count\n")
        f.writelines(f"{i},{n},{int(c)},0\n" for i, (n, c) in enumerate(zip(names, cats)))
    state, mcfg, labels = load_tagger_checkpoint(
        str(tmp_path), base=_model_cfg(cfg["model"], torch.float32))
    model = eva02.Eva02(dataclasses.replace(mcfg, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 56, 56, 3), np.uint8))
    mean = torch.full((3,), 0.5)
    got = tagger._predict_probs(model.eval(), imgs, mean, mean).detach()
    want = ref_eva02.probs({k: v.float() for k, v in params.items()}, cfg, imgs)
    assert torch.allclose(got, want, atol=2e-5, rtol=0), (got - want).abs().max()
    assert labels.names == names


def test_tag_line_rules_match_port():
    from anime_illust_image_searcher_tpu_torch.config import TaggerConfig
    from anime_illust_image_searcher_tpu_torch.models.tagger import TaggerPredictor
    from anime_illust_image_searcher_tpu_torch.models.weights import LabelSet

    cfg = _config("wd-eva02-large-tagger-v3", tiny.TAG)
    names, cats = ref_eva02.labels(cfg, 3)
    pred = TaggerPredictor(TaggerConfig(), device="cpu")
    pred.labels = LabelSet(names, list(np.where(cats == 9)[0]), list(np.where(cats == 0)[0]),
                           list(np.where(cats == 4)[0]))
    pred._general_names = [names[i] for i in pred.labels.general_index]
    pred._character_names = [names[i] for i in pred.labels.character_index]
    pred._general_idx_np = np.asarray(pred.labels.general_index)
    pred._character_idx_np = np.asarray(pred.labels.character_index)
    rng = np.random.default_rng(1)
    probs = (1 / (1 + np.exp(-8 * (rng.standard_normal((16, 64)) - 1.0)))).astype(np.float32)
    probs[3, :5] = probs[3, 5]          # ties keep label order
    from anime_illust_image_searcher_tpu_torch.models.tagger import _category_thresholds

    g, c = _category_thresholds(torch.from_numpy(probs),
                                torch.as_tensor(pred._general_idx_np),
                                torch.as_tensor(pred._character_idx_np), 0.15)
    got = pred.finalize((torch.from_numpy(probs), g, c), 0.3, True, 0.3, True)
    assert got == [tag_lines.line(p, names, cats, cfg) for p in probs]


def test_caformer_reference_matches_port_f32(tmp_path):
    from anime_illust_image_searcher_tpu_torch.models import caformer
    from anime_illust_image_searcher_tpu_torch.models.ccip_weights import load_ccip_checkpoint

    cfg = _config("caformer-s36-384", tiny.CFEAT)
    params = weights.draw(ref_caformer.leaves(cfg), 5, "cpu")
    weights.write_npz(str(tmp_path / "params.npz"), params)
    with open(tmp_path / "config.json", "w", encoding="utf-8") as f:
        json.dump({**cfg["model"], "threshold": 0.5}, f)
    mcfg, state, _ = load_ccip_checkpoint(str(tmp_path))
    model = caformer.CAFormer(dataclasses.replace(mcfg, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), np.uint8))
    sv = cfg["serve"]
    got = caformer.extract_features(model.eval(), imgs, sv["mean"], sv["std"])
    want = ref_caformer.features({k: v.float() for k, v in params.items()}, cfg, imgs)
    rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max()
    assert rel < 1e-5, rel


def test_caformer_leaves_are_the_ports_tree():
    from anime_illust_image_searcher_tpu_torch.models import caformer
    from anime_illust_image_searcher_tpu_torch.models.ccip_weights import caformer_params_to_jax

    cfg = harness.load("configs", "caformer-s36-384.json")
    m = cfg["model"]
    model = caformer.CAFormer(caformer.CAFormerConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}), device="meta")
    tree = caformer_params_to_jax({k: torch.empty(v.shape) for k, v in model.state_dict().items()})
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        leaf.name: leaf.shape for leaf in ref_caformer.leaves(cfg)}


def test_fp8_rounds_as_stated():
    from portbench.reference.common import fake_fp8

    y = fake_fp8(torch.tensor([[448.0, 1.0, 1.0625]]), -1)
    assert torch.equal(y, torch.tensor([[448.0, 1.0, 1.0]]))
