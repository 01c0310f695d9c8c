"""Tagging a directory with the WD SwinV2 tagger: ``tag_dir``'s window (the
CLI's ``Predictor.process_directory`` pass after pass over placeholder files
whose pixels a ``decode_fn`` hands back) on a SwinV2 checkpoint.

The weights reach the port as a user's ``--model-dir`` does: a seeded
``model.safetensors`` (timm layout), ``config.json`` (timm's hub config, whose
``model_args`` give the window and image size) and ``selected_tags.csv``,
read by ``models/weights.load_tagger_checkpoint``, which detects SwinV2 from
the keys.

The check is ``tag_dir``'s, with the same names: ``missing_lines``,
``line_mismatch`` (each sampled line against the plain line rules on the
port's own probabilities), ``logit_rms`` against ``reference/swinv2``'s f32
forward on the same pixels and weights, drawn again from the seed after the
port is freed, and ``low_precision_tensors``. The control computes the
sample with the plain forward's block linears on operands rounded to fp8
e4m3 in the port's place (the port has no int8 SwinV2 to run).

``attention_launches`` counts ``ops/window_attention``'s calls on the card.

The predictor is ``tag_dir``'s ``BenchPredictor``, whose ``output_wait``
drains the card's stream before ``finalize``, as in the EVA02 cell.
"""

from __future__ import annotations

import csv
import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from anime_illust_image_searcher_tpu_torch.config import TaggerConfig
from anime_illust_image_searcher_tpu_torch.models.swinv2 import SwinV2Config
from anime_illust_image_searcher_tpu_torch.ops.window_attention import window_attention

from .. import census, images, weights
from ..reference import swinv2 as ref
from ..reference import tag_lines
from ..reference.common import strict_f32
from .tag_dir import BenchPredictor, _placeholders, resolved_logit
from .tag_dir import window as _dir_window

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# images a chunk of the reference's forward (its scores are materialised)
REF_CHUNK = 16


def _model_cfg(m: dict, dtype: torch.dtype) -> SwinV2Config:
    """The detection's base: it gives the dtype (the geometry comes from the
    checkpoint and its config.json)."""
    return SwinV2Config(dtype=dtype, layer_norm_eps=m["layer_norm_eps"])


def _params(ctx, device):
    cfg = ctx.spec.config
    params = weights.draw(ref.leaves(cfg), ctx.seed, device)
    names, cats = ref.labels(cfg, ctx.seed)
    ref.calibrate_head(params, cfg, cats)
    return params, names, cats


def write_checkpoint(model_dir: str, cfg: dict, params, names, cats) -> None:
    """model.safetensors, config.json (timm's hub config) and selected_tags.csv."""
    m = cfg["model"]
    weights.write_safetensors(os.path.join(model_dir, "model.safetensors"), params)
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"architecture": "swinv2_base_window8_256", "num_classes": m["num_classes"],
                   "num_features": m["embed_dim"] * 2 ** (len(m["depths"]) - 1),
                   "global_pool": m["global_pool"],
                   "model_args": {"img_size": m["img_size"], "window_size": m["window_size"]}},
                  f, indent=2)
    with open(os.path.join(model_dir, "selected_tags.csv"), "w", newline="",
              encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["tag_id", "name", "category", "count"])
        for i, (name, cat) in enumerate(zip(names, cats)):
            w.writerow([i, name, int(cat), 0])


def setup(ctx) -> dict:
    cfg, tr = ctx.spec.config, ctx.spec.traffic
    m, sv = cfg["model"], cfg["serve"]
    batch, per_pass, k = sv["batch_size"], tr["images_per_pass"], tr["sample_per_batch"]
    if per_pass % batch:
        raise ValueError(f"images_per_pass {per_pass} is not a multiple of the batch {batch}")
    if batch % k:
        raise ValueError(f"sample_per_batch {k} does not divide the batch {batch}")
    t = time.perf_counter()
    model_dir = os.path.join(ctx.tmp, "model")
    os.makedirs(model_dir)
    params, names, cats = _params(ctx, ctx.device)
    write_checkpoint(model_dir, cfg, params, names, cats)
    del params
    ctx.notes["setup_checkpoint_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = images.pool(tr["images"], tr["pool_images"], m["img_size"], ctx.seed + 1, ctx.device)
    index = _placeholders(os.path.join(ctx.tmp, "images"), "img", per_pass)
    index.update(_placeholders(os.path.join(ctx.tmp, "warmup"), "warm", tr["warmup_images"]))

    def decode(path: str) -> np.ndarray:
        return pool[index[path] % len(pool)]

    ctx.notes["setup_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tcfg = TaggerConfig(
        batch_size=batch, image_size=m["img_size"], decode_workers=tr["decode_workers"],
        general_mcut_enabled=sv["general_mcut"], character_mcut_enabled=sv["character_mcut"],
        character_thresh_floor=sv["character_floor"], compute_dtype=sv["dtype"],
        output_file=os.path.join(ctx.tmp, "warmup-tags.txt"))
    pred = BenchPredictor(
        config=tcfg, model_dir=model_dir, model_cfg=_model_cfg(m, DTYPES[sv["dtype"]]),
        device=ctx.device, spans=ctx.spans, per_batch=k,
        slots=torch.from_numpy(np.random.default_rng([ctx.seed, 2]).permutation(batch))
        .to(ctx.device))
    pred.load_model()
    if not isinstance(pred.model_cfg, SwinV2Config):
        raise RuntimeError(f"the checkpoint loaded as {type(pred.model_cfg).__name__}")
    ctx.notes["setup_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pred.process_directory(os.path.join(ctx.tmp, "warmup"), decode_fn=decode)
    ctx.notes["setup_warmup_s"] = time.perf_counter() - t
    pred.config = dataclasses.replace(tcfg, output_file=os.path.join(ctx.tmp, "tags.txt"))
    pred.reset()
    return dict(pred=pred, pool=pool, index=index, names=names, cats=cats,
                dir=os.path.join(ctx.tmp, "images"), decode=decode, out=pred.config.output_file)


def window(ctx, st) -> dict:
    before = dict(window_attention.launches)
    win = _dir_window(ctx, st)
    win["counters"]["attention_launches"] = {
        dh: n - before.get(dh, 0) for dh, n in window_attention.launches.items()}
    return win


def check(ctx, st, win):
    cfg, tr = ctx.spec.config, ctx.spec.traffic
    batch = cfg["serve"]["batch_size"]
    lines, index = st["lines"], st["index"]
    expected = st["passes"] * tr["images_per_pass"]
    parsed = [ln.split(",", 1) for ln in lines]
    missing = max(expected - len(lines), 0) + sum(
        1 for p in parsed if len(p) != 2 or p[0] not in index)
    tags = [len([t for t in p[1].split(",") if t]) for p in parsed if len(p) == 2]
    tags_a_line = float(np.mean(tags)) if tags else 0.0
    print(f"tag lines: {len(lines)}, mean tags a line {tags_a_line:.2f}", flush=True)
    win.setdefault("notes", {})["tags_a_line"] = tags_a_line

    pred = st["pred"]
    pick, port = [], []
    for f in sorted(pred.kept):
        kept = pred.kept[f].float().cpu().numpy()
        for j, r in enumerate(pred.sampled(f).tolist()):
            if f * batch + r < len(lines):
                pick.append(f * batch + r)
                port.append(kept[j])
    port = np.stack(port) if port else np.zeros((0, cfg["model"]["num_classes"]), np.float32)
    mismatch, img = 0, []
    for j, i in enumerate(pick):
        path, text = parsed[i] if len(parsed[i]) == 2 else (parsed[i][0], None)
        mismatch += int(text != tag_lines.line(port[j], st["names"], st["cats"], cfg))
        img.append(index.get(path, -1))
    win["notes"]["sampled_lines"] = len(pick)
    low = census.low_precision_tensors(pred.model)
    # free the program's state before the reference runs
    st["pred"] = pred = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    gap = float("inf")
    if pick and min(img) >= 0:
        params, _, _ = _params(ctx, ctx.device)
        params = {k: v.float() for k, v in params.items()}
        pool = st["pool"]
        x = torch.from_numpy(pool[np.asarray(img) % len(pool)]).to(ctx.device)
        with strict_f32():
            want = ref.probs(params, cfg, x, REF_CHUNK).cpu().numpy()
            if ctx.control:
                port = ref.probs(params, cfg, x, REF_CHUNK, fp8=True).cpu().numpy()
        d = resolved_logit(port) - resolved_logit(want)
        gap = float(np.sqrt((d * d).mean(axis=1)).max())
        del params, want, x
    limits = ctx.spec.cell["limits"]
    checks = [dict(name="logit_rms", value=gap, limit=limits["logit_rms"]),
              dict(name="line_mismatch", value=mismatch, limit=0),
              dict(name="low_precision_tensors", value=low, limit=0),
              dict(name="missing_lines", value=missing, limit=0)]
    return checks, expected, missing
