"""CAFormer through CCIP's feature path: its leaves in the checkpoint layout
that ``--model-dir`` reads (``params.npz``: flax paths, Dense kernels (in, out),
Conv kernels HWIO) and a plain f32 forward, written from the MetaFormer paper
(arXiv:2210.13452) and its official CAFormer:

  stem conv 7x7/4 pad 2 + LN; stages 2-4 start with LN + conv 3x3/2 pad 1;
  block: x = x * rs1 + mixer(LN1 x); x = x * rs2 + mlp(LN2 x) (rs: res_scale,
  stages 3-4 only);
  sepconv mixer (stages 1-2): pw1 -> StarReLU -> depthwise 7x7 pad 3 -> pw2;
  attention mixer (stages 3-4): qkv -> heads of 32 -> softmax(q k^T / sqrt(32)) v
  -> proj;
  mlp: fc1 -> StarReLU -> fc2; StarReLU(x) = s * relu(x)^2 + b;
  head: mean over H, W -> LN -> fc1 -> relu^2 -> LN -> fc2 (the feature row).

CCIP's input is uint8 RGB scaled to [0, 1] and normalized with CLIP's mean and
std. LayerNorms are over channels. The published blocks have no bias in their
LayerNorms, linears and depthwise conv, nor do the stem and downsample
LayerNorms; the port's layout carries those biases, so ``leaves`` draws them
as zeros and ``features`` leaves them out. The stem and downsample convs, the
final LayerNorm and the head keep theirs.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..weights import Leaf, linear, norm, small, zeros
from .common import fake_fp8, layer_norm

BF16, F32 = torch.bfloat16, torch.float32


def _hidden(m: dict, key: str, ratio: str, stage: int, blk: int) -> int:
    if m.get(key) is not None:
        return m[key][stage][blk]
    return m[ratio] * m["dims"][stage]


def leaves(cfg: dict) -> List[Leaf]:
    m = cfg["model"]
    dims = m["dims"]
    out = [linear("stem/kernel", (7, 7, 3, dims[0]), 147, BF16),
           small("stem/bias", (dims[0],), BF16)]
    if m["stem_post_norm"]:
        out += norm("stem_norm", dims[0], "scale", "/", bias=False)
    for s in range(1, 4):
        if m["downsample_pre_norm"]:
            out += norm(f"downsample_{s}_norm", dims[s - 1], "scale", "/", bias=False)
        out += [linear(f"downsample_{s}/kernel", (3, 3, dims[s - 1], dims[s]), 9 * dims[s - 1],
                       BF16),
                small(f"downsample_{s}/bias", (dims[s],), BF16)]
    for s in range(4):
        c = dims[s]
        for b in range(m["depths"][s]):
            p = f"stage{s}_block{b}"
            if m["res_scale_stages"][s]:
                out += [Leaf(f"{p}/res_scale1", (c,), F32, 0.1, 1.0),
                        Leaf(f"{p}/res_scale2", (c,), F32, 0.1, 1.0)]
            out += norm(f"{p}/norm1", c, "scale", "/", bias=False)
            if m["num_heads"][s]:
                out += [linear(f"{p}/mixer/qkv/kernel", (c, 3 * c), c, BF16),
                        zeros(f"{p}/mixer/qkv/bias", (3 * c,), BF16),
                        linear(f"{p}/mixer/proj/kernel", (c, c), c, BF16),
                        zeros(f"{p}/mixer/proj/bias", (c,), BF16)]
            else:
                hid = _hidden(m, "sepconv_hidden", "sepconv_ratio", s, b)
                out += [linear(f"{p}/mixer/pw1/kernel", (c, hid), c, BF16),
                        zeros(f"{p}/mixer/pw1/bias", (hid,), BF16),
                        Leaf(f"{p}/mixer/act/scale", (), F32, 0.05, 0.8944),
                        Leaf(f"{p}/mixer/act/bias", (), F32, 0.05, -0.4472),
                        linear(f"{p}/mixer/dw/kernel", (7, 7, 1, hid), 49, BF16),
                        zeros(f"{p}/mixer/dw/bias", (hid,), BF16),
                        linear(f"{p}/mixer/pw2/kernel", (hid, c), hid, BF16),
                        zeros(f"{p}/mixer/pw2/bias", (c,), BF16)]
            out += norm(f"{p}/norm2", c, "scale", "/", bias=False)
            hid = _hidden(m, "mlp_hidden", "mlp_ratio", s, b)
            out += [linear(f"{p}/mlp/fc1/kernel", (c, hid), c, BF16),
                    zeros(f"{p}/mlp/fc1/bias", (hid,), BF16),
                    Leaf(f"{p}/mlp/act/scale", (), F32, 0.05, 0.8944),
                    Leaf(f"{p}/mlp/act/bias", (), F32, 0.05, -0.4472),
                    linear(f"{p}/mlp/fc2/kernel", (hid, c), hid, BF16),
                    zeros(f"{p}/mlp/fc2/bias", (c,), BF16)]
    d = dims[-1]
    hh = m["head_hidden"] or m["mlp_ratio"] * d
    out += norm("norm", d, "scale", "/")
    out += [linear("head_fc1/kernel", (d, hh), d, F32), small("head_fc1/bias", (hh,))]
    out += norm("head_norm", hh, "scale", "/")
    out += [linear("head_fc2/kernel", (hh, m["feature_dim"]), hh, F32),
            small("head_fc2/bias", (m["feature_dim"],))]
    return out


def features(params: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
             fp8: bool = False) -> torch.Tensor:
    """(B, S, S, 3) uint8 RGB -> (B, feature_dim) f32; ``params`` in f32.
    ``fp8`` (the control): every linear of the blocks takes operands rounded
    to fp8 e4m3, activations by row and weights by output channel;
    convolutions, attention products and the head stay f32."""
    m, sv = cfg["model"], cfg["serve"]
    eps = m["layer_norm_eps"]
    dev = images_u8.device
    P = params

    def ln(x, name, bias=True):
        return layer_norm(x, P[f"{name}/scale"], P[f"{name}/bias"] if bias else None, eps)

    def lin(x, name):
        """A block's linear: no bias."""
        w = P[f"{name}/kernel"]
        if fp8:
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w

    def head(x, name):
        return x @ P[f"{name}/kernel"] + P[f"{name}/bias"]

    def conv(x, name, stride, pad, groups=1, bias=True):
        w = P[f"{name}/kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, P[f"{name}/bias"] if bias else None, stride, pad,
                     groups=groups)
        return y.permute(0, 2, 3, 1)

    def star(x, name):
        return P[f"{name}/scale"] * F.relu(x) ** 2 + P[f"{name}/bias"]

    mean = torch.tensor(sv["mean"], device=dev)
    std = torch.tensor(sv["std"], device=dev)
    x = (images_u8.float() / 255.0 - mean) / std
    for s in range(4):
        if s == 0:
            x = conv(x, "stem", 4, 2)
            if m["stem_post_norm"]:
                x = ln(x, "stem_norm", bias=False)
        else:
            if m["downsample_pre_norm"]:
                x = ln(x, f"downsample_{s}_norm", bias=False)
            x = conv(x, f"downsample_{s}", 2, 1)
        heads = m["num_heads"][s]
        for b in range(m["depths"][s]):
            p = f"stage{s}_block{b}"
            y = ln(x, f"{p}/norm1", bias=False)
            if heads:
                bb, hh, ww, c = y.shape
                n = hh * ww
                qkv = lin(y.reshape(bb, n, c), f"{p}/mixer/qkv")
                qh, kh, vh = qkv.view(bb, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
                att = torch.softmax(qh @ kh.transpose(-1, -2) * (c // heads) ** -0.5, dim=-1) @ vh
                y = lin(att.transpose(1, 2).reshape(bb, n, c), f"{p}/mixer/proj")
                y = y.reshape(bb, hh, ww, c)
            else:
                h = star(lin(y, f"{p}/mixer/pw1"), f"{p}/mixer/act")
                h = conv(h, f"{p}/mixer/dw", 1, 3, groups=h.shape[-1], bias=False)
                y = lin(h, f"{p}/mixer/pw2")
            x = (x * P[f"{p}/res_scale1"] if m["res_scale_stages"][s] else x) + y
            y = ln(x, f"{p}/norm2", bias=False)
            y = star(lin(y, f"{p}/mlp/fc1"), f"{p}/mlp/act")
            y = lin(y, f"{p}/mlp/fc2")
            x = (x * P[f"{p}/res_scale2"] if m["res_scale_stages"][s] else x) + y
    pooled = ln(x.mean(dim=(1, 2)), "norm")
    h = F.relu(head(pooled, "head_fc1")) ** 2
    return head(ln(h, "head_norm"), "head_fc2")


def features_chunked(params, cfg, images_u8: torch.Tensor, chunk: int = 32,
                     fp8: bool = False) -> torch.Tensor:
    return torch.cat([features(params, cfg, images_u8[i:i + chunk], fp8)
                      for i in range(0, images_u8.shape[0], chunk)])
