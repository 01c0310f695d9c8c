"""Character features: ``CCIPPredictor.ccip_extract_device`` in
gen_cfeatures' depth-1 order (queue batch N, then copy batch N-1's features
back with ``.cpu()`` and append them to an in-memory
``index/similarity.SimilarityIndex``) over seeded decoded batches, until the
window closes.

The weights reach the port as a user's ``--model-dir`` does: a seeded
``params.npz`` (flax paths and layouts) and ``config.json``, read by
``models/ccip_weights.load_ccip_checkpoint``.

The check, once the window has closed: every batch has its rows in the
index; for a sample of the index's rows (``sample`` of them, spread evenly
over the window's batches and over the rows of a batch), the feature (unit
row x norm)
lies within ``feature_gap`` (the largest |port - plain| / |plain| of a row,
L2) of the plain f32 forward's on the same pixels and weights, drawn again
from the seed after the port is freed; and the port holds no weight below
the configuration's bf16 (``low_precision_tensors``). The control computes
the sample with the plain forward's block linears on operands rounded to fp8
e4m3 in the port's place.
"""

from __future__ import annotations

import gc
import json
import os
import time

import numpy as np
import torch

from anime_illust_image_searcher_tpu_torch.config import CCIPConfig
from anime_illust_image_searcher_tpu_torch.index.similarity import SimilarityIndex
from anime_illust_image_searcher_tpu_torch.models.ccip import CCIPPredictor
from anime_illust_image_searcher_tpu_torch.ops import flash_attention

from .. import census, images, weights
from ..reference import caformer as ref
from ..reference.common import strict_f32


def setup(ctx) -> dict:
    cfg, tr = ctx.spec.config, ctx.spec.traffic
    m, sv = cfg["model"], cfg["serve"]
    if sv["dtype"] != "bfloat16":
        raise ValueError("the CCIP checkpoint carries no dtype: the port serves it in bf16")
    t = time.perf_counter()
    model_dir = os.path.join(ctx.tmp, "ccip")
    os.makedirs(model_dir)
    params = weights.draw(ref.leaves(cfg), ctx.seed, ctx.device)
    weights.write_npz(os.path.join(model_dir, "params.npz"), params)
    del params
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**m, "threshold": sv["threshold"]}, f, indent=1)

    ctx.notes["setup_checkpoint_s"] = time.perf_counter() - t
    t = time.perf_counter()
    batch = sv["batch_size"]
    pool = images.pool(tr["images"], tr["pool_batches"] * batch, m["img_size"], ctx.seed + 1,
                       ctx.device).reshape(tr["pool_batches"], batch, m["img_size"],
                                           m["img_size"], 3)
    ccfg = CCIPConfig(image_size=m["img_size"], feature_dim=m["feature_dim"], batch_size=batch,
                      mean=tuple(sv["mean"]), std=tuple(sv["std"]))
    ctx.notes["setup_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pred = CCIPPredictor(ccfg, model_dir=model_dir, device=ctx.device)
    pred.load_model()
    ctx.notes["setup_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = SimilarityIndex(os.path.join(ctx.tmp, "warmup"), num_features=m["feature_dim"])
    for i in range(tr["warmup_batches"]):
        warm.add_documents(list(pred.ccip_extract_device(pool[i % len(pool)]).cpu().numpy()))
    ctx.notes["setup_warmup_s"] = time.perf_counter() - t
    return dict(pred=pred, pool=pool)


def window(ctx, st) -> dict:
    pred, pool, spans = st["pred"], st["pool"], ctx.spans
    index = SimilarityIndex(os.path.join(ctx.tmp, "cfeatures"),
                            num_features=ctx.spec.config["model"]["feature_dim"])
    stamp = time.time()
    before = dict(flash_attention.mha_attention.launches)

    def flush(dev) -> None:
        with spans("copy_back"):
            feats = dev.cpu().numpy()
        with spans("index_append"):
            index.add_documents(list(feats), stamp=stamp)

    t0, n, pending = time.perf_counter(), 0, None
    while True:
        with spans("batch"):
            imgs = pool[n % len(pool)]
        with spans("enqueue"):
            dev = pred.ccip_extract_device(imgs)
        if pending is not None:
            flush(pending)
        pending, n = dev, n + 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    flush(pending)
    st["index"], st["batches"] = index, n
    launches = {dh: c - before.get(dh, 0)
                for dh, c in flash_attention.mha_attention.launches.items()}
    return dict(images=len(index), counters=dict(forwards=n, attention_launches=launches),
                notes=dict(batches=n))


def check(ctx, st, win):
    cfg, tr = ctx.spec.config, ctx.spec.traffic
    batch = cfg["serve"]["batch_size"]
    index, pool = st["index"], st["pool"]
    expected = st["batches"] * batch
    missing = max(expected - len(index), 0)
    # the sample spread evenly over the window's batches, its rows walking a
    # seeded permutation of a batch's rows, so every row of a batch is sampled
    j = np.arange(tr["sample"])
    rows = (j * st["batches"] // len(j)) * batch + np.random.default_rng([ctx.seed, 3]) \
        .permutation(batch)[j % batch]
    pick = np.unique(rows[rows < len(index)])
    port = index.matrix[pick] * index.norms[pick][:, None]
    imgs = np.stack([pool[(i // batch) % len(pool)][i % batch] for i in pick])
    low = census.low_precision_tensors(st["pred"].model)
    st["pred"] = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    params = {k: v.float() for k, v in weights.draw(ref.leaves(cfg), ctx.seed, ctx.device).items()}
    x = torch.from_numpy(imgs).to(ctx.device)
    with strict_f32():
        want = ref.features_chunked(params, cfg, x).cpu().numpy()
        if ctx.control:
            port = ref.features_chunked(params, cfg, x, fp8=True).cpu().numpy()
    gap = float((np.linalg.norm(port - want, axis=1) / np.linalg.norm(want, axis=1)).max())
    checks = [dict(name="feature_gap", value=gap, limit=ctx.spec.cell["limits"]["feature_gap"]),
              dict(name="low_precision_tensors", value=low, limit=0),
              dict(name="missing_rows", value=missing, limit=0)]
    return checks, expected, missing
