"""The port's predictors with an f32 compute dtype against the JAX package's
f32 predictors, on the CPU.

``TaggerConfig(compute_dtype="float32")`` builds an f32 EVA02 in both packages,
and an explicit f32 ``model_cfg`` keeps the CCIP encoder in f32 over a model
dir. On the card the port then runs the f32 attention kernel
(tests/test_torch_kernels_cuda.py holds it against the plain version); here its
wrapper takes the plain version and the JAX predictors their XLA attention.
Tag lines must be identical; CCIP features agree within 1e-5 (f32 sums in
another order).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu.config import CCIPConfig as JCCIPConfig
from anime_illust_image_searcher_tpu.config import TaggerConfig as JTaggerConfig
from anime_illust_image_searcher_tpu.models import caformer as jc
from anime_illust_image_searcher_tpu.models import eva02 as jeva
from anime_illust_image_searcher_tpu.models import tagger as jtagger
from anime_illust_image_searcher_tpu.models.ccip import CCIPPredictor as JCCIPPredictor
from anime_illust_image_searcher_tpu.models.ccip_weights import save_ccip_checkpoint
from anime_illust_image_searcher_tpu_torch.config import CCIPConfig, TaggerConfig
from anime_illust_image_searcher_tpu_torch.models import caformer as tc
from anime_illust_image_searcher_tpu_torch.models import eva02 as teva
from anime_illust_image_searcher_tpu_torch.models import tagger as ttagger
from anime_illust_image_searcher_tpu_torch.models.ccip import CCIPPredictor
from anime_illust_image_searcher_tpu_torch.models.weights import from_jax_params
from anime_illust_image_searcher_tpu_torch.ops import flash_attention as tfa
from test_torch_caformer import jax_params
from test_torch_eva02 import perturb

# every field of the tiny EVA02 but those the predictors set (size, dtype, quant)
TINY_WIDTHS = {f.name: getattr(jeva.tiny_test_config(), f.name)
               for f in dataclasses.fields(jeva.Eva02Config)
               if f.name not in ("img_size", "dtype", "quant")}
SIZE = jeva.tiny_test_config().img_size


@pytest.fixture
def f32_taggers(monkeypatch):
    """The two packages' TaggerPredictor with compute_dtype="float32" at tiny
    width (each package's Eva02Config narrowed where its predictor builds
    one), on one set of peaked seeded weights."""
    monkeypatch.setattr(jtagger, "Eva02Config", functools.partial(jeva.Eva02Config,
                                                                  **TINY_WIDTHS))
    monkeypatch.setattr(ttagger, "Eva02Config", functools.partial(teva.Eva02Config,
                                                                  **TINY_WIDTHS))
    jpred = jtagger.TaggerPredictor(
        config=JTaggerConfig(compute_dtype="float32", image_size=SIZE), use_pallas=False)
    jpred.load_model()
    assert jpred.model_cfg.dtype == jnp.float32
    jpred.params = perturb(jpred.params, seed=11)
    pred = ttagger.TaggerPredictor(TaggerConfig(compute_dtype="float32", image_size=SIZE),
                                   device="cpu")
    pred.load_model()
    assert pred.model_cfg.dtype == torch.float32
    assert pred.model.blocks[0].attn.q_proj.weight.dtype == torch.float32
    pred.model.load_state_dict(from_jax_params(jpred.params, pred.model_cfg))
    assert pred.labels.names == jpred.labels.names
    return jpred, pred


@pytest.mark.parametrize("mcut", [False, True])
def test_f32_tagger_lines_match_jax(f32_taggers, mcut):
    jpred, pred = f32_taggers
    cfg = TaggerConfig()
    args = (cfg.general_thresh, mcut, cfg.character_thresh, mcut)
    imgs = np.random.RandomState(7).randint(0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8)
    probs, g_t, c_t = (np.asarray(a, np.float64) for a in jpred.predict_device(imgs))
    assert probs.std() > 0.05                   # not a degenerate fixture
    # precondition of identical lines: no probability within 1e-5 of the
    # threshold it meets or of another selected one
    for idx, t_mcut, t_fixed in ((jpred._general_idx_np, g_t, cfg.general_thresh),
                                 (jpred._character_idx_np, c_t, cfg.character_thresh)):
        for i, row in enumerate(probs[:, idx]):
            t = t_mcut[i] if mcut else t_fixed
            assert np.abs(row - t).min() > 1e-5
            sel = np.sort(row[row > t])
            assert sel.size == 0 or np.diff(sel).min(initial=1.0) > 1e-5
    before = dict(tfa.mha_attention.launches_f32)
    want = jpred.predict(imgs, *args)
    got = pred.predict(imgs, *args)
    assert tfa.mha_attention.launches_f32 == before       # the CPU launches nothing
    assert got == want
    assert sum(len(line.split(",")) for line in got) > len(got)   # tags were selected


@pytest.fixture(scope="module")
def ccip_model_dir(tmp_path_factory):
    cfg = jc.tiny_test_config()
    directory = str(tmp_path_factory.mktemp("ccip"))
    save_ccip_checkpoint(directory, cfg, jax_params(cfg, seed=3), threshold=0.25)
    return directory


def test_f32_ccip_features_match_jax(ccip_model_dir):
    """A model dir (its config.json stores no dtype: bf16 by default) with an
    explicit f32 model config: both predictors keep f32 and give one set of
    features."""
    jpred = JCCIPPredictor(JCCIPConfig(image_size=64, feature_dim=32),
                           model_cfg=dataclasses.replace(jc.tiny_test_config(),
                                                         dtype=jnp.float32),
                           model_dir=ccip_model_dir, use_pallas=False)
    pred = CCIPPredictor(CCIPConfig(image_size=64, feature_dim=32),
                         model_cfg=dataclasses.replace(tc.tiny_test_config(),
                                                       dtype=torch.float32),
                         model_dir=ccip_model_dir, device="cpu")
    imgs = np.random.RandomState(8).randint(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jpred.ccip_batch_extract_features(imgs), np.float32)
    got = pred.ccip_batch_extract_features(imgs)
    assert pred.model_cfg.dtype == torch.float32 and jpred.model_cfg.dtype == jnp.float32
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
