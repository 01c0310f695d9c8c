"""The predictors' upload of a numpy batch to the card: through the
page-locked staging ring (``parallel/mesh.PinnedStager``) of the predictor's
``ReplicatedForward`` as one asynchronous DMA, bit-equal to the forward of
the batch placed by ``device.to_device``, a negative-stride batch too, safe
when batches are queued faster than the card takes them, and counted in
``mesh.uploads``.

Marked ``cuda``: they skip without an NVIDIA card (page-locked memory and
the card's copies). This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_pinned_upload_cuda.py --noconftest -q
"""

import dataclasses
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu_torch.config import CCIPConfig, TaggerConfig
from anime_illust_image_searcher_tpu_torch.device import to_device
from anime_illust_image_searcher_tpu_torch.models import eva02, swinv2
from anime_illust_image_searcher_tpu_torch.models.caformer import CAFormerConfig
from anime_illust_image_searcher_tpu_torch.models.ccip import CCIPPredictor
from anime_illust_image_searcher_tpu_torch.models.tagger import TaggerPredictor
from anime_illust_image_searcher_tpu_torch.parallel import mesh as mesh_lib

ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
ARGS = (0.35, True, 0.85, True)
B = 4
# small widths at Dh=32, as the cells run their attention
MODELS = {
    "eva02": lambda: dataclasses.replace(eva02.tiny_test_config(), dtype=torch.bfloat16),
    "swinv2": lambda: swinv2.SwinV2Config(
        img_size=224, patch_size=4, embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
        window_size=7, cpb_hidden=32, num_classes=32, dtype=torch.bfloat16),
    "caformer": lambda: CAFormerConfig(
        img_size=64, depths=(1, 1, 1, 1), dims=(16, 32, 64, 64), num_heads=(0, 0, 2, 2),
        feature_dim=32, dtype=torch.bfloat16),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: page-locked host memory and the card's copies")
    return torch.device("cuda")


def predictor(name: str, twice: bool = False):
    """A loaded predictor of ``name`` with seeded weights, on the card, or
    on a mesh that names the card twice (two row blocks a batch)."""
    cfg = MODELS[name]()
    mesh = mesh_lib.make_mesh(devices=["cuda", "cuda"]) if twice else None
    if name == "caformer":
        pred = CCIPPredictor(CCIPConfig(image_size=cfg.img_size, feature_dim=cfg.feature_dim,
                                        batch_size=B), model_cfg=cfg, device="cuda", mesh=mesh)
    else:
        pred = TaggerPredictor(TaggerConfig(batch_size=B, image_size=cfg.img_size),
                               model_cfg=cfg, device="cuda", mesh=mesh)
    pred.load_model()
    return pred


def batch(pred, seed: int) -> np.ndarray:
    s = pred.config.image_size
    return np.random.default_rng(seed).integers(0, 256, (B, s, s, 3), dtype=np.uint8)


def outputs(pred, x) -> tuple:
    """The predictor's device outputs for ``x``: probabilities and both
    thresholds, or the features."""
    if isinstance(pred, CCIPPredictor):
        return (pred.ccip_extract_device(x),)
    return pred.predict_device(x)


def pageable(pred, x) -> tuple:
    """The same forward on ``x`` placed on the card by ``to_device``'s
    pageable route."""
    return outputs(pred, to_device(x, pred.device))


@pytest.mark.cuda
@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_staged_upload_equals_pageable_and_is_counted(cuda, name, twice):
    """The staged route's outputs are torch.equal to the pageable route's
    (the tagger's probabilities and thresholds, CCIP's features), and
    ``uploads`` counts one pinned block a forward and a shard, no pageable
    one; a batch already on the card counts as pageable blocks."""
    pred = predictor(name, twice)
    blocks = 2 if twice else 1
    xs = [batch(pred, seed) for seed in (1, 2, 3)]
    mesh_lib.reset_uploads()
    staged = [outputs(pred, x) for x in xs]
    torch.cuda.synchronize()
    assert mesh_lib.uploads == {"pinned": 3 * blocks, "pageable": 0}
    for x, got in zip(xs, staged):
        want = pageable(pred, x)
        assert len(got) == len(want) == (1 if name == "caformer" else 3)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert mesh_lib.uploads == {"pinned": 3 * blocks, "pageable": 3 * blocks}


@pytest.mark.cuda
@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_flipped_batch_equals_its_contiguous_copy(cuda, name, twice):
    """A batch with a negative stride (``x[..., ::-1]``, an RGB<->BGR flip)
    goes up through the ring and gives outputs torch.equal to those of its
    ``np.ascontiguousarray`` copy, on one card and on a mesh that names it
    twice."""
    pred = predictor(name, twice)
    x = batch(pred, 4)[..., ::-1]
    assert x.strides[-1] < 0
    mesh_lib.reset_uploads()
    got = outputs(pred, x)
    assert mesh_lib.uploads == {"pinned": 2 if twice else 1, "pageable": 0}
    want = outputs(pred, np.ascontiguousarray(x))
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eva02", "swinv2"])
def test_queued_batches_keep_their_own_inputs(cuda, name):
    """Three batches queued behind a busy stream with no sync between them
    (more than the ring's two slots, so the third waits for the first DMA
    before it writes that slot), then each batch's finalize: every batch
    gives its own probabilities and lines."""
    pred = predictor(name)
    xs = [batch(pred, seed) for seed in (11, 12, 13)]
    want = [pageable(pred, x) for x in xs]
    want_lines = [pred.finalize(w, *ARGS) for w in want]
    pred.predict_device(xs[0])                # the ring is allocated before the stall
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s: the DMAs queue behind it
    queued = [pred.predict_device(x) for x in xs]
    for got, w, lines in zip(queued, want, want_lines):
        assert pred.finalize(got, *ARGS) == lines
        assert all(torch.equal(a, b) for a, b in zip(got, w))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_profiled_forward_copies_from_pinned_memory(cuda, name):
    """A profiled forward's input copy is ``Memcpy HtoD (Pinned -> Device)``,
    once, and no copy from pageable memory."""
    pred = predictor(name)
    x = batch(pred, 5)
    outputs(pred, x)                          # the ring is allocated outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        outputs(pred, x)
        torch.cuda.synchronize()
    copies = [e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and "HtoD" in e.name()]
    assert copies == ["Memcpy HtoD (Pinned -> Device)"], copies


@pytest.mark.cuda
def test_stager_reuses_a_slot_for_smaller_blocks_and_grows_for_larger(cuda):
    """Blocks of several shapes and dtypes go up bit-equal; a smaller block
    uses the front of a slot, a larger one reallocates the card's ring."""
    stager = mesh_lib.PinnedStager()
    rng = np.random.default_rng(7)
    first = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    got = stager.upload(first, cuda)
    ring = stager._slots[cuda]
    assert len(ring) == 2 and all(buf.is_pinned() and buf.numel() == first.nbytes
                                  for buf, _ in ring)
    for block in (rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
                  rng.standard_normal((3, 5), dtype=np.float32),
                  rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)):
        assert np.array_equal(stager.upload(block, cuda).cpu().numpy(), block)
        assert stager._slots[cuda] is ring
    assert np.array_equal(got.cpu().numpy(), first)
    bigger = rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    assert np.array_equal(stager.upload(bigger, cuda).cpu().numpy(), bigger)
    assert all(buf.numel() == bigger.nbytes for buf, _ in stager._slots[cuda])


@pytest.mark.cuda
def test_read_only_batch_goes_up_without_a_warning(cuda, tmp_path):
    """A read-only memory map goes up through the ring bit for bit, with no
    warning, and its file is left as it was."""
    want = np.random.default_rng(9).integers(0, 256, (4, 16, 3), dtype=np.uint8)
    want.tofile(tmp_path / "batch.u8")
    mm = np.memmap(tmp_path / "batch.u8", dtype=np.uint8, mode="r", shape=want.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        blocks = mesh_lib.shard_rows(mesh_lib.make_mesh(devices=["cuda", "cuda"]), mm,
                                     mesh_lib.PinnedStager())
    assert np.array_equal(torch.cat(blocks).cpu().numpy(), want)
    blocks[0].fill_(0)
    torch.cuda.synchronize()
    assert np.array_equal(np.fromfile(tmp_path / "batch.u8", np.uint8).reshape(want.shape), want)


@pytest.mark.cuda
def test_threads_sharing_a_stager_keep_their_own_blocks(cuda):
    """16 threads (more than the machine's cores) upload distinct blocks
    through one stager, 20 each, behind a stalled stream and with a short
    switch interval: every block comes back as it was sent."""
    stager = mesh_lib.PinnedStager()
    stager.upload(np.zeros((64, 257), np.uint8), cuda)       # the ring, before the stall
    torch.cuda.synchronize()
    bad, done = [], []

    def work(t: int) -> None:
        rng = np.random.default_rng(t)
        sent = [rng.integers(0, 256, (64, 257), dtype=np.uint8) for _ in range(20)]
        got = [stager.upload(b, cuda) for b in sent]
        bad.extend(t for b, g in zip(sent, got) if not np.array_equal(g.cpu().numpy(), b))
        done.append(t)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        torch.cuda._sleep(100_000_000)
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == list(range(16)) and bad == []
