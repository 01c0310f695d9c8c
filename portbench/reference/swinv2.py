"""WD SwinV2 tagger v3: its leaves in the published (timm) layout and a plain
f32 forward to probabilities, written from timm's ``SwinTransformerV2``
(``swinv2_base_window8_256`` built with ``img_size=448, window_size=14``, as
the repo's ``config.json`` gives them; Swin Transformer V2, arXiv:2111.09883):

  patch embed (conv 4/4) -> NHWC -> LN -> stages -> LN -> mean over tokens ->
  head.fc -> sigmoid.
  stage s >= 2 starts with PatchMerging v2: the 2x2 neighbours concatenated in
  timm's order (x0 even rows and cols, x1 odd rows even cols, x2 even rows odd
  cols, x3 odd rows and cols) -> reduction (no bias) -> LN.
  block (res-post-norm): x += LN1(attn(x)); x += LN2(fc2(gelu(fc1 x)))
  attn: roll by -w/2 in odd blocks (where the map is larger than the window)
  -> windows of w x w tokens -> qkv (bias [q_bias, 0, v_bias]) -> heads ->
  normalize(q) normalize(k)^T * exp(min(logit_scale, ln 100))
  + 16 sigmoid(cpb_mlp(log-spaced relative coordinates))[relative index]
  (+ the -100 region mask of a shifted block) -> softmax -> @ v -> proj ->
  windows back in place -> roll back.
  A stage whose map is no larger than the window uses window = map, no shift.

The tagger's input is uint8 RGB; the published pipeline scales to [0, 1],
normalizes with mean = std = 0.5 and feeds BGR. Every score tensor is
materialised here, one chunk of images at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..weights import Leaf, linear, norm, small
from . import eva02
from .common import dense, fake_fp8, layer_norm

BF16, F32 = torch.bfloat16, torch.float32

# the same seeded names and categories as the EVA02 tagger
labels = eva02.labels


def calibrate_head(params: Dict[str, torch.Tensor], cfg: dict, categories: np.ndarray) -> None:
    """head.fc.bias = -head_scale * threshold_z of each class's category (the
    EVA02 cell's calibration)."""
    a = cfg["assumed"]
    z = {eva02.CATEGORY_CODE[c]: v for c, v in a["threshold_z"].items()}
    bias = np.asarray([-a["head_scale"] * z[int(c)] for c in categories], np.float32)
    params["head.fc.bias"].copy_(torch.from_numpy(bias))


def _dims(m: dict) -> List[int]:
    return [m["embed_dim"] * 2 ** s for s in range(len(m["depths"]))]


def _windows(m: dict, s: int, j: int) -> Tuple[int, int, int]:
    """(map side, window, shift) of block j of stage s."""
    res = m["img_size"] // m["patch_size"] // 2 ** s
    if res <= m["window_size"]:
        return res, res, 0
    return res, m["window_size"], m["window_size"] // 2 if j % 2 else 0


def leaves(cfg: dict) -> List[Leaf]:
    """Every leaf of ``model.safetensors`` in timm's names and layouts. Block
    linears, the merges' reductions, the q/v biases and the patch conv are
    drawn in bf16, the type the port serves them in; the rest (the LayerNorms,
    the logit scales, the cpb MLPs, the head) in f32."""
    m, a = cfg["model"], cfg["assumed"]
    c0, p, hid = m["embed_dim"], m["patch_size"], m["cpb_hidden"]
    dims = _dims(m)
    out = [linear("patch_embed.proj.weight", (c0, 3, p, p), 3 * p * p, BF16),
           small("patch_embed.proj.bias", (c0,), BF16)]
    out += norm("patch_embed.norm", c0)
    for s, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        c = dims[s]
        if s:
            out.append(linear(f"layers.{s}.downsample.reduction.weight", (c, 2 * c), 2 * c,
                              BF16))
            out += norm(f"layers.{s}.downsample.norm", c)
        mlp = int(c * m["mlp_ratio"])
        for j in range(depth):
            b = f"layers.{s}.blocks.{j}"
            out += [linear(f"{b}.attn.qkv.weight", (3 * c, c), c, BF16),
                    small(f"{b}.attn.q_bias", (c,), BF16),
                    small(f"{b}.attn.v_bias", (c,), BF16),
                    Leaf(f"{b}.attn.logit_scale", (heads, 1, 1), F32,
                         a["logit_scale_std"], math.log(10.0)),
                    linear(f"{b}.attn.cpb_mlp.0.weight", (hid, 2), 2, F32),
                    small(f"{b}.attn.cpb_mlp.0.bias", (hid,), F32),
                    linear(f"{b}.attn.cpb_mlp.2.weight", (heads, hid), hid, F32),
                    linear(f"{b}.attn.proj.weight", (c, c), c, BF16),
                    small(f"{b}.attn.proj.bias", (c,), BF16)]
            out += norm(f"{b}.norm1", c)
            out += [linear(f"{b}.mlp.fc1.weight", (mlp, c), c, BF16),
                    small(f"{b}.mlp.fc1.bias", (mlp,), BF16),
                    linear(f"{b}.mlp.fc2.weight", (c, mlp), mlp, BF16),
                    small(f"{b}.mlp.fc2.bias", (c,), BF16)]
            out += norm(f"{b}.norm2", c)
    out += norm("norm", dims[-1])
    out += [Leaf("head.fc.weight", (m["num_classes"], dims[-1]), F32,
                 a["head_scale"] / dims[-1] ** 0.5),
            Leaf("head.fc.bias", (m["num_classes"],), F32, 0.0, 0.0)]
    return out


def position_bias(params, b: str, heads: int, window: int, device) -> torch.Tensor:
    """(H, S, S): 16 sigmoid of cpb_mlp over timm's log-spaced relative
    coordinate table, gathered by the pairwise relative-position index."""
    r = torch.arange(-(window - 1), window, dtype=F32, device=device)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)          # (2w-1, 2w-1, 2)
    t = t / max(window - 1, 1) * 8
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)
    h = F.relu(dense(t, params[f"{b}.attn.cpb_mlp.0.weight"],
                     params[f"{b}.attn.cpb_mlp.0.bias"]))
    table = dense(h, params[f"{b}.attn.cpb_mlp.2.weight"], None).reshape(-1, heads)
    ij = torch.stack(torch.meshgrid(torch.arange(window, device=device),
                                    torch.arange(window, device=device),
                                    indexing="ij")).flatten(1)             # (2, S)
    d = ij[:, :, None] - ij[:, None, :] + window - 1
    index = d[0] * (2 * window - 1) + d[1]                                  # (S, S)
    return 16 * torch.sigmoid(table[index].permute(2, 0, 1))


def _partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, hh, ww, c = x.shape
    return x.view(b, hh // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _merge_windows(x: torch.Tensor, w: int, res: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // (res // w) ** 2
    return x.view(b, res // w, res // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, res, res, c)


def region_mask(res: int, w: int, shift: int, device) -> torch.Tensor:
    """(nW, S, S): 0 within a region of the rolled map, -100 across regions."""
    img = torch.zeros((1, res, res, 1), device=device)
    n = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = n
            n += 1
    mw = _partition(img, w).squeeze(-1)                                     # (nW, S)
    d = mw[:, None, :] - mw[:, :, None]
    return (d != 0).float() * -100.0


def logits(params: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """(B, S, S, 3) uint8 RGB -> (B, classes) f32 logits; ``params`` in f32.
    ``fp8`` (the control): every block linear (qkv, proj, fc1, fc2) takes
    operands rounded to fp8 e4m3, activations by row and weights by output
    channel; the merges, attention products, norms and the head stay f32."""
    m, sv = cfg["model"], cfg["serve"]
    eps = m["layer_norm_eps"]
    dev = images_u8.device
    P = params

    def lin(x, name, bias=None):
        """A block linear; ``bias`` in place of the layer's own (qkv's)."""
        w = P[f"{name}.weight"]
        if fp8:    # w is (out, in): one scale an output channel
            x, w = fake_fp8(x, -1), fake_fp8(w, -1)
        return dense(x, w, P[f"{name}.bias"] if bias is None else bias)

    def ln(x, name):
        return layer_norm(x, P[f"{name}.weight"], P[f"{name}.bias"], eps)

    mean = torch.tensor(sv["mean"], device=dev)
    std = torch.tensor(sv["std"], device=dev)
    x = (images_u8.float() / 255.0 - mean) / std
    if sv["bgr"]:
        x = x[..., [2, 1, 0]]
    x = F.conv2d(x.permute(0, 3, 1, 2), P["patch_embed.proj.weight"],
                 P["patch_embed.proj.bias"], stride=m["patch_size"]).permute(0, 2, 3, 1)
    x = ln(x, "patch_embed.norm")
    for s, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        if s:
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1)
            x = ln(dense(x, P[f"layers.{s}.downsample.reduction.weight"], None),
                   f"layers.{s}.downsample.norm")
        for j in range(depth):
            b = f"layers.{s}.blocks.{j}"
            res, w, shift = _windows(m, s, j)
            bsz, _, _, c = x.shape
            dh, nw, n = c // heads, (res // w) ** 2, w * w
            y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
            y = _partition(y, w)                                             # (B nW, S, C)
            qkv_b = torch.cat([P[f"{b}.attn.q_bias"], torch.zeros_like(P[f"{b}.attn.q_bias"]),
                               P[f"{b}.attn.v_bias"]])
            q, k, v = lin(y, f"{b}.attn.qkv", qkv_b).view(-1, n, 3, heads, dh) \
                .permute(2, 0, 3, 1, 4)
            scale = P[f"{b}.attn.logit_scale"].clamp(max=math.log(100.0)).exp()   # (H, 1, 1)
            att = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-1, -2) * scale
            att = att + position_bias(P, b, heads, w, dev)
            if shift:
                att = (att.view(bsz, nw, heads, n, n)
                       + region_mask(res, w, shift, dev)[None, :, None]).view(-1, heads, n, n)
            y = (torch.softmax(att, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
            y = _merge_windows(lin(y, f"{b}.attn.proj"), w, res)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
            x = x + ln(y, f"{b}.norm1")
            x = x + ln(lin(F.gelu(lin(x, f"{b}.mlp.fc1")), f"{b}.mlp.fc2"), f"{b}.norm2")
    pooled = ln(x, "norm").mean(dim=(1, 2))
    return dense(pooled, P["head.fc.weight"], P["head.fc.bias"])


def probs(params, cfg, images_u8: torch.Tensor, chunk: int = 8,
          fp8: bool = False) -> torch.Tensor:
    """sigmoid(logits) in chunks of ``chunk`` images."""
    return torch.cat([torch.sigmoid(logits(params, cfg, images_u8[i:i + chunk], fp8))
                      for i in range(0, images_u8.shape[0], chunk)])


def parameter_count(cfg: dict) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in leaves(cfg))
