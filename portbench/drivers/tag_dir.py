"""Tagging a directory: ``cli.tagging.Predictor.process_directory`` over a
directory of placeholder files whose decoded pixels a ``decode_fn`` hands
back from a seeded pool in host memory, pass after pass until the window
closes.

The weights reach the port as a user's ``--model-dir`` does: a seeded
``model.safetensors`` (timm layout) and ``selected_tags.csv`` written under
the run's scratch directory, read by ``models/weights.load_tagger_checkpoint``.

The check, once the window has closed: every image of every pass has its
line; for a sample of the window's lines drawn from every batch (its
probabilities kept by a gather on the card), the line equals the one the
plain MCut and line rules give for the port's own probabilities, and those
probabilities' logits lie near the plain f32 forward's on the same pixels
and weights, drawn again from the seed after the port is freed:
``logit_rms``, the largest over the sampled images of the root mean square
over all classes of the gap (``resolved_logit``: an f32 probability near 1
has lost its logit, so both sides are clamped to 1 - 1e-4 first); and the
port holds no weight in a type below the configuration's
(``low_precision_tensors``; ``serve.quant: int8`` states int8). Batch f
keeps the ``sample_per_batch`` rows at positions f*k .. f*k + k - 1 of a
seeded permutation of the batch's rows, so every batch is sampled and the
batches of a pass together cover every row of a batch.

A pass's edges, the time from its start to the first batch handed to the
card and from the last batch's lines to its return, are summed as
``pass_edge_s``.
"""

from __future__ import annotations

import csv
import dataclasses
import gc
import os
import time

import numpy as np
import torch

from anime_illust_image_searcher_tpu_torch.cli.tagging import Predictor
from anime_illust_image_searcher_tpu_torch.config import TaggerConfig
from anime_illust_image_searcher_tpu_torch.models.eva02 import Eva02Config
from anime_illust_image_searcher_tpu_torch.ops import flash_attention

from .. import census, images, weights
from ..reference import eva02 as ref
from ..reference import tag_lines
from ..reference.common import strict_f32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BenchPredictor(Predictor):
    """The CLI's predictor with the benchmark's spans around its two calls
    (``enqueue``: ``predict_device``; ``output_wait``, then ``finalize``),
    the count of forwards, the sampled rows of each batch's probabilities
    (``slots``: a seeded permutation of a batch's rows, on the card), and the
    times of a pass's first enqueue and last lines.

    ``finalize`` copies its batch's outputs back on the card's stream, where
    they queue behind the forward of the batch enqueued after them; the
    ``output_wait`` span waits for that stream, so that ``finalize``'s span
    holds the copy and the host's line assembly alone."""

    def __init__(self, *args, spans, slots: torch.Tensor, per_batch: int, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.spans, self.slots, self.per_batch = spans, slots, per_batch
        self.reset()

    def reset(self) -> None:
        self.forwards = 0
        self.kept = {}
        self.first_enqueue = self.last_lines = None

    def sampled(self, forward: int) -> torch.Tensor:
        """The rows of batch ``forward`` that the check keeps."""
        start = forward * self.per_batch % len(self.slots)
        return self.slots[start:start + self.per_batch]

    def predict_device(self, images_u8):
        if self.first_enqueue is None:
            self.first_enqueue = time.perf_counter()
        with self.spans("enqueue"):
            out = super().predict_device(images_u8)
        self.kept[self.forwards] = out[0].index_select(0, self.sampled(self.forwards))
        self.forwards += 1
        return out

    def finalize(self, device_outputs, *args):
        if device_outputs[0].is_cuda:
            with self.spans("output_wait"):
                torch.cuda.current_stream(device_outputs[0].device).synchronize()
        with self.spans("finalize"):
            lines = super().finalize(device_outputs, *args)
        self.last_lines = time.perf_counter()
        return lines


# an f32 probability above 1 - 1e-4 no longer resolves its logit to 1e-3
P_MAX = 1.0 - 1e-4


def resolved_logit(p: np.ndarray) -> np.ndarray:
    """log(p / (1 - p)) in f64 of each probability clamped to [1e-37, P_MAX]:
    where both sides are above P_MAX they agree, and a probability that has
    left the resolved range on one side only shows as a gap."""
    q = np.clip(np.asarray(p, np.float64), 1e-37, P_MAX)
    return np.log(q) - np.log1p(-q)


def _model_cfg(m: dict, dtype: torch.dtype) -> Eva02Config:
    return Eva02Config(
        img_size=m["img_size"], patch_size=m["patch_size"], embed_dim=m["embed_dim"],
        depth=m["depth"], num_heads=m["num_heads"], mlp_hidden_dim=m["mlp_hidden_dim"],
        num_classes=m["num_classes"], rope_temperature=m["rope_temperature"],
        ref_feat_shape=tuple(m["ref_feat_shape"]), layer_norm_eps=m["layer_norm_eps"],
        global_pool=m["global_pool"], dtype=dtype)


def _params(ctx, device):
    cfg = ctx.spec.config
    params = weights.draw(ref.leaves(cfg), ctx.seed, device)
    names, cats = ref.labels(cfg, ctx.seed)
    ref.calibrate_head(params, cfg, cats)
    return params, names, cats


def _placeholders(directory: str, prefix: str, count: int) -> dict:
    os.makedirs(directory)
    index = {}
    for i in range(count):
        path = os.path.join(directory, f"{prefix}_{i:06d}.png")
        open(path, "wb").close()
        index[path] = i
    return index


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
    weights.write_safetensors(os.path.join(model_dir, "model.safetensors"), params)
    del params
    with open(os.path.join(model_dir, "selected_tags.csv"), "w", newline="",
              encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["tag_id", "name", "category", "count"])
        for i, (name, cat) in enumerate(zip(names, cats)):
            w.writerow([i, name, int(cat), 0])
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
        quant="int8" if ctx.control else sv.get("quant", "none"),
        output_file=os.path.join(ctx.tmp, "warmup-tags.txt"))
    pred = BenchPredictor(
        config=tcfg, model_dir=model_dir, model_cfg=_model_cfg(m, DTYPES[sv["dtype"]]),
        device=ctx.device, spans=ctx.spans, per_batch=k,
        slots=torch.from_numpy(np.random.default_rng([ctx.seed, 2]).permutation(batch))
        .to(ctx.device))
    pred.load_model()
    ctx.notes["setup_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pred.process_directory(os.path.join(ctx.tmp, "warmup"), decode_fn=decode)
    ctx.notes["setup_warmup_s"] = time.perf_counter() - t
    pred.config = dataclasses.replace(tcfg, output_file=os.path.join(ctx.tmp, "tags.txt"))
    pred.reset()
    return dict(pred=pred, pool=pool, index=index, names=names, cats=cats,
                dir=os.path.join(ctx.tmp, "images"), decode=decode, out=pred.config.output_file)


def window(ctx, st) -> dict:
    pred = st["pred"]
    before = dict(flash_attention.mha_attention.launches)
    t0, passes, edge_s = time.perf_counter(), 0, 0.0
    while True:
        pred.first_enqueue = None
        t = time.perf_counter()
        with ctx.spans("pass"):
            pred.process_directory(st["dir"], decode_fn=st["decode"])
        t_end = time.perf_counter()
        edge_s += (pred.first_enqueue - t) + (t_end - pred.last_lines)
        passes += 1
        if t_end - t0 >= ctx.seconds:
            break
    with open(st["out"], encoding="utf-8") as f:
        lines = f.read().splitlines()
    st["lines"], st["passes"] = lines, passes
    launches = {dh: n - before.get(dh, 0)
                for dh, n in flash_attention.mha_attention.launches.items()}
    return dict(images=len(lines),
                counters=dict(forwards=pred.forwards, attention_launches=launches,
                              pass_edge_s=edge_s),
                notes=dict(passes=passes, forwards=pred.forwards, pass_edge_s=edge_s,
                           pass_edge_share=edge_s / (time.perf_counter() - t0)))


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
    low = census.low_precision_tensors(
        pred.model, [torch.int8] if cfg["serve"].get("quant") == "int8" else [])
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
        with strict_f32():
            want = ref.probs(params, cfg, torch.from_numpy(pool[np.asarray(img) % len(pool)])
                             .to(ctx.device)).cpu().numpy()
        d = resolved_logit(port) - resolved_logit(want)
        gap = float(np.sqrt((d * d).mean(axis=1)).max())
        del params, want
    limits = ctx.spec.cell["limits"]
    checks = [dict(name="logit_rms", value=gap, limit=limits["logit_rms"]),
              dict(name="line_mismatch", value=mismatch, limit=0),
              dict(name="low_precision_tensors", value=low, limit=0),
              dict(name="missing_lines", value=missing, limit=0)]
    return checks, expected, missing
