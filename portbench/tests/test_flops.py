"""The benchmark's own counts reproduce the port's records: 723.5 GFLOP an
EVA02-L image (ARCHITECTURE.md section 7a) and 37.77 an image at the port's
default CAFormerConfig() (chip_smoke.caformer_gflop); at CAFormer-S36/384 they
give the published 26 GMAC and 39.3 M parameters."""

import numpy as np


from portbench import flops, harness


def _model(name):
    return harness.load("configs", f"{name}.json")["model"]


def test_eva02_large():
    m = _model("wd-eva02-large-tagger-v3")
    assert round(flops.module("eva02").gflop_per_image(m), 1) == 723.5
    att = [c for c in flops.module("eva02").forward_calls(m, 256) if c.group == "attention"]
    assert len(att) == 24
    # one launch at B=256: the 1.114 ms FLOP bound of the port's records
    assert abs(att[0].flops / 989e12 * 1e3 - 1.114) < 1e-3


def test_caformer_24():
    m = dict(_model("caformer-s36-384"), depths=[3, 3, 15, 3], feature_dim=768,
             head_hidden=None)
    assert round(flops.module("caformer").gflop_per_image(m), 2) == 37.77
    att = [c for c in flops.module("caformer").forward_calls(m, 64) if c.group == "attention"]
    assert len(att) == 18
    peaks = harness.load("peaks.json")["NVIDIA H100"]
    # bytes bound of a forward's launches: 15 x 0.0282 + 3 x 0.0113 ms
    assert abs(flops.roofline_s(att, peaks) * 1e3 - 0.457) < 2e-3


def test_caformer_s36():
    from portbench.reference import caformer

    cfg = harness.load("configs", "caformer-s36-384.json")
    assert round(flops.module("caformer").gflop_per_image(cfg["model"]) / 2, 1) == 26.0
    att = [c for c in flops.module("caformer").forward_calls(cfg["model"], 64)
           if c.group == "attention"]
    assert len(att) == 21
    # the published model's parameters: the port's extra biases are the zero leaves
    published = sum(int(np.prod(leaf.shape)) for leaf in caformer.leaves(cfg) if leaf.scale)
    assert round(published / 1e6, 1) == 39.3
