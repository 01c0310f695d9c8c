"""The rest of a run, on the CPU at tiny sizes (the harness's look for a card
skipped): a sound run comes out correct, and with the timed path broken
underneath, ``correct`` comes out false, once for each fault these cells can
have: an answer altered where it is produced, and half of the batch left out
with the mean of the rest in its place; and for faults that the sample has
to reach: one row of every batch altered, and every row of one later batch;
and weights held in int8 where the configuration states bf16.
(A state left unchanged and the exchange between chips belong to training
and to cells on several chips.)"""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2 ** 31 + 11


def _run(name, over, control=False):
    return harness.run_cell(name, SEED, 0.5, False, time.perf_counter(), device="cpu",
                            overrides=over, control=control, report=lambda *a, **k: None)


def _half_mean(t):
    t = t.clone()
    h = t.shape[0] // 2
    t[h:] = t[:h].mean(dim=0)
    return t


def _altered(t):
    t = t.clone()
    t[:, : t.shape[1] // 2] = t[:, : t.shape[1] // 2].flip(0)
    return t


def _one_row(t):
    t = t.clone()
    t[t.shape[0] // 2 + 1] = t[0]
    return t


FAULTS = {"answer_altered": _altered, "half_batch_mean": _half_mean, "one_row": _one_row}


class _OneCall:
    """A fault on the ``n``-th call only: one later batch of the window (the
    warm-up takes the first call)."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self, t):
        self.calls += 1
        return _altered(t) if self.calls == self.n else t


def test_tag_sound_run_is_correct():
    r = _run("tag.eva02l.b256", tiny.TAG)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


def test_cfeat_sound_run_is_correct():
    r = _run("cfeat.caformer_s36.b64", tiny.CFEAT)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["one_later_batch"])
def test_tag_fault_in_probabilities_is_caught(monkeypatch, fault):
    from anime_illust_image_searcher_tpu_torch.models import tagger

    real = tagger.TaggerPredictor._forward
    planted = FAULTS.get(fault) or _OneCall(4)

    def broken(self, images_u8, thresholds):
        probs, *rest = real(self, images_u8, thresholds)
        return (planted(probs), *rest)

    monkeypatch.setattr(tagger.TaggerPredictor, "_forward", broken)
    r = _run("tag.eva02l.b256", tiny.TAG)
    assert r["checks"]["logit_rms"]["value"] > r["checks"]["logit_rms"]["limit"], r["checks"]


def test_tag_fault_in_the_line_is_caught(monkeypatch):
    from anime_illust_image_searcher_tpu_torch.models import tagger

    real = tagger.TaggerPredictor._assemble_line

    def broken(self, *args):
        return real(self, *args) + ",extra_tag"

    monkeypatch.setattr(tagger.TaggerPredictor, "_assemble_line", broken)
    r = _run("tag.eva02l.b256", tiny.TAG)
    assert not r["correct"] and r["checks"]["line_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cfeat_fault_is_caught(monkeypatch, fault):
    from anime_illust_image_searcher_tpu_torch.models import ccip

    real = ccip.CCIPPredictor._forward
    monkeypatch.setattr(ccip.CCIPPredictor, "_forward",
                        lambda self, x: FAULTS[fault](real(self, x)))
    r = _run("cfeat.caformer_s36.b64", tiny.CFEAT)
    assert r["checks"]["feature_gap"]["value"] > r["checks"]["feature_gap"]["limit"], r["checks"]


def test_cfeat_dropped_rows_are_caught(monkeypatch):
    from anime_illust_image_searcher_tpu_torch.index import similarity

    real = similarity.SimilarityIndex.add_documents
    monkeypatch.setattr(similarity.SimilarityIndex, "add_documents",
                        lambda self, v, stamp=0.0: real(self, v[:-1], stamp))
    r = _run("cfeat.caformer_s36.b64", tiny.CFEAT)
    assert not r["correct"] and r["checks"]["missing_rows"]["value"] > 0


def test_tag_int8_weights_are_caught():
    r = _run("tag.eva02l.b256", tiny.TAG, control=True)
    assert not r["correct"] and r["checks"]["low_precision_tensors"]["value"] > 0


def test_cfeat_int8_weights_are_caught(monkeypatch):
    """The port's own int8 Linears (ops/quant.Int8Linear) planted in
    CAFormer's MLPs, as a change serving them in int8 would."""
    from anime_illust_image_searcher_tpu_torch.models import caformer, ccip
    from anime_illust_image_searcher_tpu_torch.ops.quant import Int8Linear

    real_load, real_linear = ccip.CCIPPredictor.load_model, caformer._linear

    def load(self):
        real_load(self)
        for m in self.model.modules():
            if isinstance(m, caformer.Mlp):
                for name in ("fc1", "fc2"):
                    lin = getattr(m, name)
                    if isinstance(lin, Int8Linear):
                        continue
                    q = Int8Linear(lin.in_features, lin.out_features, out_dtype=lin.weight.dtype)
                    q.set_weight(lin.weight.float())
                    q.bias.data.copy_(lin.bias.float())
                    setattr(m, name, q)

    monkeypatch.setattr(ccip.CCIPPredictor, "load_model", load)
    monkeypatch.setattr(caformer, "_linear", lambda layer, x: (
        layer(x) if isinstance(layer, Int8Linear) else real_linear(layer, x)))
    r = _run("cfeat.caformer_s36.b64", tiny.CFEAT)
    assert not r["correct"] and r["checks"]["low_precision_tensors"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "tag.eva02l.b256", "--seed", "1", "--seconds", "1"],
                      time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_are_found(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "anime_illust_image_searcher_tpu.ops",
                        types.ModuleType("anime_illust_image_searcher_tpu.ops"))
    assert harness.forbidden_modules() == ["anime_illust_image_searcher_tpu", "jax"]
