"""WD-EVA02-Large tagger: its leaves in the published (timm) layout and a plain
f32 forward to probabilities, written from timm's ``Eva``
(``eva02_large_patch14_448``) as the WD tagger uses it:

  patch embed (conv 14/14) -> [cls | patches] + pos embed -> blocks -> mean of
  the patch tokens -> fc_norm -> head -> sigmoid.
  block: x += attn(LN1 x); x += mlp(LN2 x)
  attn: q (bias), k (no bias), v (bias) -> heads; 2D axial RoPE on the patch
  rows of q and k (timm RotaryEmbeddingCat, interleaved pairs; the cls row is
  not rotated) -> softmax(q k^T / sqrt(Dh)) v -> proj
  mlp (SwiGLU with sub-LN): fc2(LN(silu(fc1_g x) * fc1_x x))

The tagger's input is uint8 RGB; the published pipeline scales to [0, 1],
normalizes with mean = std = 0.5 and feeds BGR.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..weights import Leaf, linear, norm, small
from .common import dense, layer_norm

BF16, F32 = torch.bfloat16, torch.float32


def leaves(cfg: dict) -> List[Leaf]:
    """Every leaf of ``model.safetensors`` in timm's names and layouts. Block
    linears and the patch conv are drawn in bf16, the type the port serves
    them in; the rest in f32."""
    m, a = cfg["model"], cfg["assumed"]
    d, hid, p = m["embed_dim"], m["mlp_hidden_dim"], m["patch_size"]
    n_tok = (m["img_size"] // p) ** 2 + 1
    out = [linear("patch_embed.proj.weight", (d, 3, p, p), 3 * p * p, BF16),
           small("patch_embed.proj.bias", (d,), BF16),
           small("cls_token", (1, 1, d)),
           small("pos_embed", (1, n_tok, d))]
    for i in range(m["depth"]):
        b = f"blocks.{i}"
        out += norm(f"{b}.norm1", d)
        out += [linear(f"{b}.attn.q_proj.weight", (d, d), d, BF16),
                small(f"{b}.attn.q_proj.bias", (d,), BF16),
                linear(f"{b}.attn.k_proj.weight", (d, d), d, BF16),
                linear(f"{b}.attn.v_proj.weight", (d, d), d, BF16),
                small(f"{b}.attn.v_proj.bias", (d,), BF16),
                linear(f"{b}.attn.proj.weight", (d, d), d, BF16),
                small(f"{b}.attn.proj.bias", (d,), BF16)]
        out += norm(f"{b}.norm2", d)
        out += [linear(f"{b}.mlp.fc1_g.weight", (hid, d), d, BF16),
                small(f"{b}.mlp.fc1_g.bias", (hid,), BF16),
                linear(f"{b}.mlp.fc1_x.weight", (hid, d), d, BF16),
                small(f"{b}.mlp.fc1_x.bias", (hid,), BF16)]
        out += norm(f"{b}.mlp.norm", hid)
        out += [linear(f"{b}.mlp.fc2.weight", (d, hid), hid, BF16),
                small(f"{b}.mlp.fc2.bias", (d,), BF16)]
    out += [Leaf("fc_norm.weight", (d,), F32, 0.0, 1.0),
            Leaf("fc_norm.bias", (d,), F32, 0.0, 0.0),
            Leaf("head.weight", (m["num_classes"], d), F32, a["head_scale"] / d ** 0.5),
            Leaf("head.bias", (m["num_classes"],), F32, 0.0, 0.0)]
    return out


CATEGORY_CODE = {"rating": 9, "general": 0, "character": 4}


def labels(cfg: dict, seed: int) -> Tuple[List[str], np.ndarray]:
    """Seeded tag names and categories (selected_tags.csv codes) in a seeded
    order; every fourth general or character name carries a space, which a
    line writes as an underscore."""
    names, cats = [], []
    for cat, count in cfg["labels"].items():
        for i in range(count):
            names.append(f"{cat} {i}" if cat != "rating" and i % 4 == 0 else f"{cat}_{i}")
            cats.append(CATEGORY_CODE[cat])
    order = np.random.default_rng(seed).permutation(len(names))
    return [names[i] for i in order], np.asarray(cats)[order]


def calibrate_head(params: Dict[str, torch.Tensor], cfg: dict, categories: np.ndarray) -> None:
    """head.bias = -head_scale * threshold_z of each class's category."""
    a = cfg["assumed"]
    z = {CATEGORY_CODE[c]: v for c, v in a["threshold_z"].items()}
    bias = np.asarray([-a["head_scale"] * z[int(c)] for c in categories], np.float32)
    params["head.bias"].copy_(torch.from_numpy(bias))


def rope_tables(cfg: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm build_rotary_pos_embed with in_pixels=False: bands
    1 / T^(i / (Dh/4)), coordinates arange(g) / g * ref per axis, [y | x]
    angles, each repeated for the two elements of its pair. (N, Dh) each."""
    m = cfg["model"]
    dh = m["embed_dim"] // m["num_heads"]
    g = m["img_size"] // m["patch_size"]
    nb = dh // 4
    bands = 1.0 / (m["rope_temperature"] ** (torch.arange(nb, dtype=torch.float32) / nb))
    t = [torch.arange(g, dtype=torch.float32) / g * r for r in m["ref_feat_shape"]]
    grid = torch.stack(torch.meshgrid(t[0], t[1], indexing="ij"), dim=-1)   # (g, g, 2)
    pos = (grid[..., None] * bands).reshape(g * g, 2 * nb)
    return (pos.sin().repeat_interleave(2, -1).to(device),
            pos.cos().repeat_interleave(2, -1).to(device))


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def logits(params: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 RGB -> (B, classes) f32 logits; ``params`` in f32."""
    m, s = cfg["model"], cfg["serve"]
    eps, d, h = m["layer_norm_eps"], m["embed_dim"], m["num_heads"]
    dh = d // h
    dev = images_u8.device
    mean = torch.tensor(s["mean"], device=dev)
    std = torch.tensor(s["std"], device=dev)
    x = (images_u8.float() / 255.0 - mean) / std
    if s["bgr"]:
        x = x[..., [2, 1, 0]]
    x = F.conv2d(x.permute(0, 3, 1, 2), params["patch_embed.proj.weight"],
                 params["patch_embed.proj.bias"], stride=m["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    b, n = x.shape[0], x.shape[1] + 1
    x = torch.cat([params["cls_token"].expand(b, 1, d), x], dim=1) + params["pos_embed"]
    sin, cos = rope_tables(cfg, dev)

    def heads(t):
        return t.view(b, n, h, dh).transpose(1, 2)

    def rope(t):
        r = t[:, :, 1:]
        return torch.cat([t[:, :, :1], r * cos + _rotate_pairs(r) * sin], dim=2)

    for i in range(m["depth"]):
        p = lambda k: params[f"blocks.{i}.{k}"]  # noqa: E731
        y = layer_norm(x, p("norm1.weight"), p("norm1.bias"), eps)
        q = rope(heads(dense(y, p("attn.q_proj.weight"), p("attn.q_proj.bias"))))
        k = rope(heads(dense(y, p("attn.k_proj.weight"), None)))
        v = heads(dense(y, p("attn.v_proj.weight"), p("attn.v_proj.bias")))
        att = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1) @ v
        x = x + dense(att.transpose(1, 2).reshape(b, n, d), p("attn.proj.weight"),
                      p("attn.proj.bias"))
        y = layer_norm(x, p("norm2.weight"), p("norm2.bias"), eps)
        y = (F.silu(dense(y, p("mlp.fc1_g.weight"), p("mlp.fc1_g.bias")))
             * dense(y, p("mlp.fc1_x.weight"), p("mlp.fc1_x.bias")))
        y = layer_norm(y, p("mlp.norm.weight"), p("mlp.norm.bias"), eps)
        x = x + dense(y, p("mlp.fc2.weight"), p("mlp.fc2.bias"))
    pooled = layer_norm(x[:, 1:].mean(dim=1), params["fc_norm.weight"],
                        params["fc_norm.bias"], eps)
    return dense(pooled, params["head.weight"], params["head.bias"])


def probs(params, cfg, images_u8: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """sigmoid(logits) in chunks of ``chunk`` images."""
    return torch.cat([torch.sigmoid(logits(params, cfg, images_u8[i:i + chunk]))
                      for i in range(0, images_u8.shape[0], chunk)])
