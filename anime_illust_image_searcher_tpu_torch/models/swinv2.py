"""SwinV2 vision transformer in PyTorch — the WD SwinV2 tagger v3 backbone.

``SmilingWolf/wd-swinv2-tagger-v3`` is timm's ``swinv2_base_window8_256``
built with ``img_size=448, window_size=14`` (its ``config.json``'s
``model_args``): patch embed 4×4 → 128-d, four stages of depths 2/2/18/2 at
widths 128/256/512/1024 and 4/8/16/32 heads (Dh=32), windows of 14×14 tokens,
a 10,861-class multi-label head. Written from timm's ``swin_transformer_v2.py``
(Swin Transformer V2, arXiv:2111.09883); the modules keep timm's names, so a
timm state dict loads as it is (``models/weights.py``).

  patch embed: conv 4/4 → NHWC → LayerNorm
  stage s ≥ 2: PatchMerging v2: cat of the 2×2 neighbours (x0 even rows and
      cols, x1 odd rows even cols, x2 even rows odd cols, x3 odd rows and
      cols) → reduction Linear(4C, 2C, no bias) → LayerNorm(2C)
  block (res-post-norm): x += LN1(attn(x)); x += LN2(fc2(GELU(fc1 x)))
  attn, per window of S = w² tokens: qkv = x W_qkvᵀ + [q_bias, 0, v_bias];
      softmax(normalize(q) normalize(k)ᵀ · exp(min(logit_scale, ln 100))
      + 16·sigmoid(cpb) + mask) v → proj. cpb = cpb_mlp (Linear(2, 512) →
      ReLU → Linear(512, H, no bias)) of the log-spaced relative coordinates
      (offsets in [−(w−1), w−1]², / (w − 1), × 8, sign(t)·log2(|t| + 1)/3),
      gathered by the pairwise relative-position index.
  shift: odd blocks roll by −w/2 before the partition (and back after) and
      add the −100 mask between tokens of different regions; a stage whose
      resolution is at most the window uses window = resolution and no shift
  head: LayerNorm → mean over tokens → fc

How the parts run:

- The bias (cpb, sigmoid, gather, plus the shift mask) depends on no input:
  each block builds it once at load (``build_tables``, the span
  ``swinv2.bias_tables``), in the compute dtype, as one (1, nW·H, S, S)
  tensor that broadcasts over the batch, its rows padded so that SDPA takes
  it without a copy. A forward reads it; a model whose parameters were not
  loaded (``load_state_dict``) or drawn (``init_params``) raises.
- The shift and the partition, and their inverse, are one kernel each
  (``ops/window_shift``); the attention is ``ops/window_attention`` (SDPA's
  memory-efficient or cuDNN backend, never math, with the logit scale folded
  into the normalized q).
- Rounding: the input is cast to the compute dtype before the patch conv;
  the residual stream, the Linears and the conv run in the compute dtype; the
  LayerNorms of the stages (patch embed, merges, post-norms) read and write
  the compute dtype and compute in f32 inside PyTorch's kernel, which takes
  weights of the input's dtype only on the card, so their weights are stored
  in the compute dtype too (unlike EVA02's, whose f32 norms cost a cast of
  their input and output: two more passes over the activations a norm); the
  final norm, the pooling and the head run in f32. Parameters of the Linears,
  the q/v biases, the conv and the stages' norms are stored in the compute
  dtype; the logit scales, the cpb MLP, the final norm and the head in f32.
  In f32 compute the path is the same, in f32.

Departures from timm: a resolution that the window does not divide is
refused (timm pads it); ``quant="int8"`` (``AIIS_INT8=1``) is refused, since
int8 block Linears exist for EVA02 only; the qkv bias, the scales and the
attention bias are held at load, not rebuilt each forward; in a 16-bit
compute dtype a checkpoint's f32 weights of the stages' LayerNorms are
rounded to that dtype at load (above).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import round_up
from ..ops.window_attention import BIAS_ROW_MULTIPLE, LOGIT_SCALE_MAX, window_attention
from ..ops.window_shift import window_partition, window_reverse
from ..utils.profiling import span

MASK_VALUE = -100.0   # timm's value between tokens of different shift regions


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 448
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 14
    mlp_ratio: float = 4.0
    cpb_hidden: int = 512
    num_classes: int = 10861
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # compute dtype of the Linears and the conv
    # kept so that a quant request reaches the model as it does EVA02's; only
    # "none" is carried
    quant: str = "none"

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * 2 ** s

    def stage_resolution(self, s: int) -> int:
        return self.img_size // self.patch_size // 2 ** s

    def stage_window(self, s: int, block: int) -> Tuple[int, int]:
        """(window, shift) of block ``block`` of stage ``s``: timm's
        ``_calc_window_shift`` (a map no larger than the window is one
        window with no shift; odd blocks shift by half a window)."""
        res = self.stage_resolution(s)
        if res <= self.window_size:
            return res, 0
        return self.window_size, (self.window_size // 2 if block % 2 else 0)


def tiny_test_config(num_classes: int = 32, dtype: torch.dtype = torch.float32) -> SwinV2Config:
    """Small config for CPU tests: stages at 16², 8², 4² and 2² tokens with
    windows of 4 (shifted odd blocks in stages 1-2; stage 4 clamps the window
    to its resolution)."""
    return SwinV2Config(img_size=64, patch_size=4, embed_dim=16, depths=(2, 2, 2, 2),
                        num_heads=(1, 2, 2, 4), window_size=4, cpb_hidden=32,
                        num_classes=num_classes, dtype=dtype)


def relative_tables(window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm's ``relative_coords_table`` ((2w−1)², 2) f32, log-spaced, and
    ``relative_position_index`` (w², w²) int64."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)
    table = table / max(window - 1, 1) * 8
    table = torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8)
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)       # (2, S)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)        # (2, S, S)
    return table, rel[0] * (2 * window - 1) + rel[1]


def shift_mask(res: int, window: int, shift: int) -> torch.Tensor:
    """(nW, S, S) f32: 0 between tokens of one region of the rolled map,
    −100 between tokens of different ones (timm's ``attn_mask``)."""
    region = torch.zeros(res, res)
    cuts = ((0, res - window), (res - window, res - shift), (res - shift, res))
    n = 0
    for r0, r1 in cuts:
        for c0, c1 in cuts:
            region[r0:r1, c0:c1] = n
            n += 1
    per = res // window
    win = region.view(per, window, per, window).permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A stage's LayerNorm: input, weights and output in the compute dtype,
    statistics in f32."""
    return F.layer_norm(x, layer.normalized_shape, layer.weight, layer.bias, layer.eps)


def _stage_norm(dim: int, cfg: SwinV2Config, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=cfg.layer_norm_eps, device=device, dtype=cfg.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size,
                              device=device, dtype=cfg.dtype)
        self.norm = _stage_norm(cfg.embed_dim, cfg, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.proj(images.permute(0, 3, 1, 2))        # NHWC memory in and out
        return _norm(self.norm, x.permute(0, 2, 3, 1))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device, dtype=cfg.dtype)
        self.norm = _stage_norm(2 * dim, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        # (hsub, wsub) order (0,0), (1,0), (0,1), (1,1): timm's x0, x1, x2, x3
        x = x.view(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(
            b, h // 2, w // 2, 4 * c)
        return _norm(self.norm, F.linear(x, self.reduction.weight))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, res: int, window: int, shift: int,
                 cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        self.heads, self.res, self.window, self.shift = heads, res, window, shift
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device, dtype=cfg.dtype)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=cfg.dtype))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=cfg.dtype))
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), math.log(10.0), device=device))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, cfg.cpb_hidden, device=device), nn.ReLU(),
                                     nn.Linear(cfg.cpb_hidden, heads, bias=False, device=device))
        self.proj = nn.Linear(dim, dim, device=device, dtype=cfg.dtype)
        # built from the parameters at load (build_tables)
        self.register_buffer("qkv_bias", None, persistent=False)
        self.register_buffer("scale", None, persistent=False)
        self.register_buffer("attn_bias", None, persistent=False)

    @torch.no_grad()
    def build_tables(self) -> None:
        """The qkv bias, the heads' clamped logit scales and the attention
        bias (1, nW·H, S, S): 16·sigmoid(cpb) plus the shift mask, in the
        compute dtype, in a buffer whose rows are padded to a multiple of
        ``BIAS_ROW_MULTIPLE`` elements."""
        with span("swinv2.bias_tables"):
            dev, dtype = self.qkv.weight.device, self.qkv.weight.dtype
            w, h = self.window, self.heads
            s, n_win = w * w, (self.res // w) ** 2
            table, index = relative_tables(w)
            cpb = self.cpb_mlp(table.to(dev))                              # ((2w-1)², H)
            bias = (16 * torch.sigmoid(cpb))[index.to(dev).view(-1)].view(s, s, h).permute(2, 0, 1)
            full = bias.expand(n_win, h, s, s)
            if self.shift:
                full = full + shift_mask(self.res, w, self.shift).to(dev)[:, None]
            store = torch.zeros((1, n_win * h, s, round_up(s, BIAS_ROW_MULTIPLE)),
                                dtype=dtype, device=dev)
            store[..., :s] = full.reshape(1, n_win * h, s, s)
            self.attn_bias = store[..., :s]
            self.scale = self.logit_scale.clamp(max=LOGIT_SCALE_MAX).exp().view(h)
            self.qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, R, R, C) -> (B, R, R, C), contiguous."""
        if self.attn_bias is None:
            raise RuntimeError("SwinV2 attention tables are not built: load a state dict "
                               "or call init_params first")
        xw = window_partition(x, self.window, self.shift)                 # (B, nW, S, C)
        qkv = F.linear(xw, self.qkv.weight, self.qkv_bias)
        del xw
        o = window_attention(qkv, self.scale, self.attn_bias, self.heads)
        del qkv
        token_major = o.transpose(1, 2)
        if token_major.is_contiguous():
            y = F.linear(token_major, self.proj.weight, self.proj.bias).transpose(1, 2)
        else:
            y = F.linear(o, self.proj.weight, self.proj.bias)
        del o, token_major
        return window_reverse(y, self.res, self.window, self.shift)


class Mlp(nn.Module):
    def __init__(self, dim: int, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=cfg.dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinV2Block(nn.Module):
    def __init__(self, s: int, j: int, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        dim = cfg.stage_dim(s)
        window, shift = cfg.stage_window(s, j)
        self.attn = WindowAttention(dim, cfg.num_heads[s], cfg.stage_resolution(s), window,
                                    shift, cfg, device=device)
        self.norm1 = _stage_norm(dim, cfg, device)
        self.mlp = Mlp(dim, cfg, device=device)
        self.norm2 = _stage_norm(dim, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + _norm(self.norm1, self.attn(x))
        return x + _norm(self.norm2, self.mlp(x))


class SwinV2Stage(nn.Module):
    def __init__(self, s: int, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        self.downsample = PatchMerging(cfg.stage_dim(s - 1), cfg, device=device) if s else None
        self.blocks = nn.ModuleList([SwinV2Block(s, j, cfg, device=device)
                                     for j in range(cfg.depths[s])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class SwinV2(nn.Module):
    """Full tagger network: images (B, H, W, 3) f32 -> logits (B, num_classes) f32.

    Images come channels-last, as the tagger hands them to EVA02."""

    def __init__(self, cfg: SwinV2Config, device=None) -> None:
        super().__init__()
        if cfg.quant != "none":
            raise NotImplementedError(
                f"quant={cfg.quant!r}: SwinV2 taggers run in bf16 or f32 only; the int8 "
                "block Linears (quant='int8', AIIS_INT8=1) exist for EVA02 taggers")
        for s in range(len(cfg.depths)):
            res = cfg.stage_resolution(s)
            window = cfg.stage_window(s, 0)[0]
            if res % window or res * 2 ** s * cfg.patch_size != cfg.img_size:
                raise ValueError(f"SwinV2: stage {s + 1}'s {res}² tokens are not cut whole by "
                                 f"its window {window} (img {cfg.img_size}, patch "
                                 f"{cfg.patch_size})")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.layers = nn.ModuleList([SwinV2Stage(s, cfg, device=device)
                                     for s in range(len(cfg.depths))])
        last = cfg.stage_dim(len(cfg.depths) - 1)
        self.norm = nn.LayerNorm(last, eps=cfg.layer_norm_eps, device=device)
        self.head = nn.Module()
        self.head.fc = nn.Linear(last, cfg.num_classes, device=device)
        self.register_load_state_dict_post_hook(lambda module, keys: module.build_tables())

    def build_tables(self) -> None:
        """Every block's attention tables from the current parameters (after
        a load or a seeded draw)."""
        for m in self.modules():
            if isinstance(m, WindowAttention):
                m.build_tables()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.to(self.cfg.dtype))
        for stage in self.layers:
            x = stage(x)
        pooled = F.layer_norm(x.float(), self.norm.normalized_shape, self.norm.weight,
                              self.norm.bias, self.norm.eps).mean(dim=(1, 2))
        return F.linear(pooled, self.head.fc.weight, self.head.fc.bias)


@torch.no_grad()
def init_params(model: SwinV2, seed: int = 0) -> None:
    """Seeded weights for a run without a checkpoint: Linear and conv weights
    N(0, 1/fan_in) truncated at 2σ, biases 0, LayerNorms ones and zeros,
    logit scales ln 10 (timm's init), drawn in f32 and rounded to each
    parameter's dtype; then the attention tables."""
    gen = torch.Generator(device=model.head.fc.weight.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            buf = torch.empty(m.weight.shape, device=m.weight.device)
            std = fan_in ** -0.5
            nn.init.trunc_normal_(buf, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.weight.copy_(buf)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            m.q_bias.zero_()
            m.v_bias.zero_()
            m.logit_scale.fill_(math.log(10.0))
    model.build_tables()

