"""EVA02 vision transformer in PyTorch — the WD-EVA02-Large tagger backbone.

Port of the JAX package's models/eva02.py (the timm ``Eva`` architecture behind
``SmilingWolf/wd-eva02-large-tagger-v3``): patch embed 14×14 → 1024-d, 24 blocks
× 16 heads, learned absolute position embedding + 2D axial cat-RoPE on q/k (cls
token exempt), SwiGLU MLP with sub-LN, final norm + linear multi-label head.

Rounding points mirror the JAX bf16 path: the input is cast to the compute
dtype before the patch conv, the residual stream stays in the compute dtype,
every Linear/conv runs in the compute dtype, and LayerNorms, pooling and the head
run in f32. Parameters of the Linears and the conv are stored in the compute
dtype (the JAX model keeps f32 params and casts them at use, which rounds the
same way); norms, layer scales, cls token, pos embed and head stay f32.

Attention goes through ``ops.flash_attention.mha_attention``: the hand-written
CUDA kernel on the card, its plain version on the CPU.

``quant="int8"`` (``AIIS_INT8=1``) builds the block Linears (q/k/v, proj, w1,
w2, w3) as ``ops.quant.Int8Linear``, as the JAX package builds ``Int8Dense``;
the patch conv and the head stay as they are. Layers that read one input (q,
k and v; w1 and w2) quantize it once, which gives the same bits as quantizing
it for each.

q/k projections are stored in the half-split head-dim order that
``rope_half_permutation`` defines (new dim i = timm dim 2i, new dim Dh/2+i =
timm dim 2i+1); ``models/weights.py`` applies it when loading timm weights.
Only the ``sliced`` rope layout is implemented: ``idrow`` was a TPU relayout
knob with bit-identical outputs.

A bf16 SwiGLU whose hidden width is not a multiple of 8 (EVA02-L's 2730: a row
of 5,460 bytes) runs its three GEMMs at ``padded_hidden``, whose rows are
16-byte aligned: cuBLAS's Hopper kernels load their operands by TMA, which
takes no other leading dimension, and an unaligned GEMM falls back to an sm80
``mma.sync`` kernel. ``w1``/``w2`` hold zero rows and ``w3`` zero columns in the
pad (``PaddedLinear``), so the math is unchanged, and the state dict carries
the published shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import mha_attention
from ..ops.quant import ALIGN, Int8Linear, int8_quantize_rows, round_up
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Eva02Config:
    img_size: int = 448
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    # EVA02's SwiGLU ratio: hidden = int(dim * 4 * 2/3)
    mlp_hidden_dim: int = 2730
    num_classes: int = 10861
    use_rope: bool = True
    rope_temperature: float = 10000.0
    ref_feat_shape: Tuple[int, int] = (16, 16)  # pretraining grid (224/14)
    use_abs_pos_emb: bool = True
    # sub-LN inside the attention (before out-proj). EVA02-L uses it only in the MLP;
    # the weight loader flips this if the checkpoint carries attn.norm weights.
    scale_attn_inner: bool = False
    use_layer_scale: bool = False
    # 'avg': mean over patch tokens -> fc_norm -> head; 'token': cls token ->
    # norm -> head. The weight loader detects which by the fc_norm/norm keys.
    global_pool: str = "avg"
    # LayerNorms always compute in f32 here; kept so configs match the JAX
    # package field for field (there, too, it leaves outputs bit-identical).
    norm_in_f32: bool = True
    # Only "sliced" (rope on rows 1..N, cls row concatenated back) is carried.
    rope_variant: str = "sliced"
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16  # compute dtype of the Linears and the conv
    # "none" or "int8" (ops/quant.py: the block Linears on int8 with f32 rescale)
    quant: str = "none"

    @property
    def grid_size(self) -> Tuple[int, int]:
        g = self.img_size // self.patch_size
        return (g, g)

    @property
    def num_patches(self) -> int:
        g = self.grid_size
        return g[0] * g[1]

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def tiny_test_config(num_classes: int = 32) -> Eva02Config:
    """Small config for CPU tests (mirrors the JAX package's)."""
    return Eva02Config(
        img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=2,
        mlp_hidden_dim=112, num_classes=num_classes, ref_feat_shape=(4, 4),
        dtype=torch.float32,
    )


# ---------------------------------------------------------------------------
# RoPE (timm RotaryEmbeddingCat semantics: lang-mode freq bands, axial 2D), in
# the half-split (rotate_half) head-dim layout.
# ---------------------------------------------------------------------------


def rope_half_permutation(head_dim: int) -> np.ndarray:
    """Index map interleaved -> half-split: new[..., j] = old[..., perm[j]]."""
    return np.concatenate(
        [np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def build_rope_cat(
    grid: Tuple[int, int],
    head_dim: int,
    temperature: float,
    ref_shape: Optional[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (sin, cos), each (grid_h*grid_w, head_dim), f32, half-split layout."""
    num_bands = head_dim // 4
    exp = torch.arange(num_bands, dtype=torch.float32) / num_bands
    bands = 1.0 / (temperature ** exp)                       # (num_bands,)

    coords = []
    for axis, size in enumerate(grid):
        t = torch.arange(size, dtype=torch.float32)
        if ref_shape is not None:
            t = t / size * ref_shape[axis]
        coords.append(t)
    yy, xx = torch.meshgrid(coords[0], coords[1], indexing="ij")
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)   # (N, 2)

    angles = pos[:, :, None] * bands[None, None, :]              # (N, 2, num_bands)
    angles = angles.reshape(pos.shape[0], 2 * num_bands)         # [y bands | x bands]
    # each band appears once per half (the two elements of its rotation pair)
    angles = torch.cat([angles, angles], dim=-1)                 # (N, head_dim)
    return torch.sin(angles), torch.cos(angles)


def apply_rope_cat(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., N, head_dim) in half-split dim order. rotate_half: (a, b) -> (-b, a)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos + rot * sin


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The layer in its parameters' dtype (the compute dtype for block layers)."""
    return F.linear(x.to(layer.weight.dtype), layer.weight, layer.bias)


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed and returned in f32."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps)


def _block_linear(cfg: Eva02Config, n_in: int, n_out: int, bias: bool = True, device=None,
                  padded: Optional[Tuple[int, int]] = None):
    """A block-level Linear: the compute dtype, or the int8 path. ``padded``
    (in, out) holds it at that padded shape (``PaddedLinear``) where it
    differs from (n_in, n_out); the int8 path pads its own operands."""
    if cfg.quant == "int8":
        return Int8Linear(n_in, n_out, bias=bias, out_dtype=cfg.dtype, device=device)
    if padded is not None and padded != (n_in, n_out):
        return PaddedLinear(n_in, n_out, *padded, bias=bias, device=device, dtype=cfg.dtype)
    return nn.Linear(n_in, n_out, bias=bias, device=device, dtype=cfg.dtype)


def padded_hidden(cfg: Eva02Config) -> int:
    """The width a SwiGLU of ``cfg`` runs its GEMMs at. In a 16-bit compute
    dtype, the hidden width rounded up to a multiple of 8, which makes the rows
    16-byte aligned for cuBLAS's sm90 GEMMs: on an H100 that gave EVA02-L's
    three SwiGLU GEMMs at B=256 less device time than whole tiles of 64 or 128
    did (6.85 ms at 2736 against 7.09 at 2752, 7.26 at 2816 and 19.31
    unpadded; tools/swiglu_pad_ab.py). f32 keeps its width: with TF32 off its
    GEMMs run the same SIMT kernel at either width, and the padded route's
    copies made EVA02-L's f32 forward at B=64 2.2% slower (1,074 against
    1,051 ms). The int8 path pads its own operands."""
    if cfg.quant == "int8" or cfg.dtype.itemsize != 2:
        return cfg.mlp_hidden_dim
    return round_up(cfg.mlp_hidden_dim, ALIGN)


class PaddedLinear(nn.Linear):
    """A Linear of published shape (out_features, in_features) whose weight
    and bias are held zero-padded to (out_padded, in_padded): it reads an
    input of width ``in_padded`` whose pad columns are 0 and writes an output
    of width ``out_padded`` whose pad columns are exactly 0.

    ``in_features``/``out_features`` are the published widths. The state dict
    carries the published shapes (views of the published rows and columns),
    and a published-shape tensor loads into them, so checkpoints, converters and
    replicas see the layer as an ``nn.Linear`` of that shape."""

    def __init__(self, in_features: int, out_features: int, in_padded: int, out_padded: int,
                 bias: bool = True, device=None, dtype=None) -> None:
        super().__init__(in_padded, out_padded, bias=bias, device=device, dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def published(self, t: torch.Tensor) -> torch.Tensor:
        """The published rows and columns of the weight or the bias ``t`` (a view)."""
        if t.dim() == 2:
            return t[: self.out_features, : self.in_features]
        return t[: self.out_features]

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for key in (prefix + "weight", prefix + "bias"):
            if key in destination:
                destination[key] = self.published(destination[key])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a published-shape tensor is copied into the published rows and
        # columns, and the parameter stands in for it (its copy onto itself is
        # a no-op); the pads stay 0
        for name in ("weight", "bias"):
            param, key = getattr(self, name), prefix + name
            if param is not None and key in state_dict \
                    and state_dict[key].shape == self.published(param).shape:
                with torch.no_grad():
                    self.published(param).copy_(state_dict[key])
                state_dict[key] = param
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return (f"{super().extra_repr()}, padded to ({self.weight.shape[0]}, "
                f"{self.weight.shape[1]})")


def _linears(layers, x: torch.Tensor):
    """Each layer on ``x``; int8 layers share one quantization of it."""
    if isinstance(layers[0], Int8Linear):
        xq = int8_quantize_rows(x)
        return [layer.forward_quantized(*xq) for layer in layers]
    return [_linear(layer, x) for layer in layers]


class EvaAttention(nn.Module):
    def __init__(self, cfg: Eva02Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.q_proj = _block_linear(cfg, c, c, bias=True, device=device)
        self.k_proj = _block_linear(cfg, c, c, bias=False, device=device)
        self.v_proj = _block_linear(cfg, c, c, bias=True, device=device)
        self.norm = (nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
                     if cfg.scale_attn_inner else None)
        self.proj = _block_linear(cfg, c, c, bias=True, device=device)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        cfg = self.cfg
        b, n, c = x.shape
        h, dh = cfg.num_heads, cfg.head_dim

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, n, h, dh).transpose(1, 2)       # (B, H, N, Dh) view

        q, k, v = (split_heads(t) for t in _linears((self.q_proj, self.k_proj, self.v_proj), x))

        if rope is not None:
            sin, cos = rope
            sin = sin.to(q.dtype)
            cos = cos.to(q.dtype)
            # cls token (index 0) is exempt from rotation
            q = torch.cat([q[:, :, :1], apply_rope_cat(q[:, :, 1:], sin, cos)], dim=2)
            k = torch.cat([k[:, :, :1], apply_rope_cat(k[:, :, 1:], sin, cos)], dim=2)

        out = mha_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, n, c)
        if self.norm is not None:
            out = _layer_norm(self.norm, out)
        return _linears((self.proj,), out)[0]


class SwiGLU(nn.Module):
    """EVA02 MLP: silu(w1(x)) * w2(x) -> sub-LN -> w3 (timm SwiGLU: fc1_g/fc1_x/norm/fc2).

    At an unaligned hidden width (``padded_hidden``) the three Linears are
    ``PaddedLinear``s at ``hidden_padded``: ``g`` and ``u`` come out with zero
    pad columns, the sub-LN reads the real ones, and its output is written,
    in w3's dtype, into a buffer whose pad columns are zeroed. Such a forward
    is the span ``swiglu.pad_<hidden>_to_<hidden_padded>``, so a profiled run
    counts them (``utils/profiling``)."""

    def __init__(self, cfg: Eva02Config, device=None) -> None:
        super().__init__()
        d, hid = cfg.embed_dim, cfg.mlp_hidden_dim
        self.hidden, self.hidden_padded = hid, padded_hidden(cfg)
        hp = self.hidden_padded
        self.w1 = _block_linear(cfg, d, hid, device=device, padded=(d, hp))
        self.w2 = _block_linear(cfg, d, hid, device=device, padded=(d, hp))
        self.norm = nn.LayerNorm(hid, eps=cfg.layer_norm_eps, device=device)
        self.w3 = _block_linear(cfg, hid, d, device=device, padded=(hp, d))
        self._span = f"swiglu.pad_{hid}_to_{hp}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = _linears((self.w1, self.w2), x)
        hid = self.hidden
        if self.hidden_padded == hid:
            return _linears((self.w3,), _layer_norm(self.norm, F.silu(g) * u))[0]
        with span(self._span):
            n = _layer_norm(self.norm, (F.silu(g) * u)[..., :hid])
            del g, u
            # the cast into w3's dtype is the copy into the buffer, made once
            # the sub-LN's f32 input is freed; pad columns left unwritten could
            # hold NaN, which 0 * NaN would carry into w3's sums
            y = torch.empty(n.shape[:-1] + (self.hidden_padded,), dtype=self.w3.weight.dtype,
                            device=n.device)
            y[..., hid:].zero_()
            y[..., :hid] = n
            del n
            return F.linear(y, self.w3.weight, self.w3.bias)


class EvaBlock(nn.Module):
    def __init__(self, cfg: Eva02Config, device=None) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.attn = EvaAttention(cfg, device=device)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.mlp = SwiGLU(cfg, device=device)
        if cfg.use_layer_scale:
            # f32 like the flax params: bf16 * f32 promotes the residual to f32
            # in both frameworks
            self.gamma_1 = nn.Parameter(torch.ones(d, device=device))
            self.gamma_2 = nn.Parameter(torch.ones(d, device=device))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        attn_out = self.attn(_layer_norm(self.norm1, x), rope)
        if self.gamma_1 is not None:
            attn_out = attn_out * self.gamma_1
        x = x + attn_out
        mlp_out = self.mlp(_layer_norm(self.norm2, x))
        if self.gamma_2 is not None:
            mlp_out = mlp_out * self.gamma_2
        return x + mlp_out


class Eva02(nn.Module):
    """Full tagger network: images (B, H, W, 3) f32 -> logits (B, num_classes) f32.

    Images come channels-last, as in the JAX package, so both take the same arrays.
    """

    def __init__(self, cfg: Eva02Config, device=None) -> None:
        super().__init__()
        if cfg.rope_variant != "sliced":
            raise NotImplementedError(
                f"rope_variant={cfg.rope_variant!r} is not carried by the port; "
                "'sliced' gives bit-identical outputs")
        if cfg.quant not in ("none", "int8"):
            raise NotImplementedError(f"quant={cfg.quant!r}: only 'none' and 'int8' exist")
        if cfg.global_pool not in ("avg", "token"):
            raise ValueError(f"unknown global_pool {cfg.global_pool!r}")
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                                     device=device, dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = (nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d, device=device))
                          if cfg.use_abs_pos_emb else None)
        self.blocks = nn.ModuleList([EvaBlock(cfg, device=device) for _ in range(cfg.depth)])
        if cfg.global_pool == "avg":
            self.fc_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        else:
            self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.head = nn.Linear(d, cfg.num_classes, device=device)
        if cfg.use_rope:
            sin, cos = build_rope_cat(cfg.grid_size, cfg.head_dim,
                                      cfg.rope_temperature, cfg.ref_feat_shape)
            self.register_buffer("rope_sin", sin.to(device), persistent=False)
            self.register_buffer("rope_cos", cos.to(device), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = images.shape[0]
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)          # NCHW view
        x = self.patch_embed(x).flatten(2).transpose(1, 2)    # (B, N, D)
        cls = self.cls_token.expand(b, 1, cfg.embed_dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)
        rope = (self.rope_sin, self.rope_cos) if cfg.use_rope else None
        for blk in self.blocks:
            x = blk(x, rope)
        if cfg.global_pool == "avg":
            # mean over PATCH tokens (cls excluded), then fc_norm, then head
            pooled = _layer_norm(self.fc_norm, x[:, 1:].float().mean(dim=1))
        else:
            pooled = _layer_norm(self.norm, x[:, 0])
        return F.linear(pooled, self.head.weight, self.head.bias)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (±2σ) scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_params(model: Eva02, seed: int = 0) -> None:
    """Seeded init mirroring flax's distributions (the bits differ from jax.random):
    lecun-normal Linear/conv kernels, zero biases, LayerNorm ones/zeros, layer
    scales ones, truncated-normal(0.02) cls token and pos embed. Values are drawn
    in f32 and rounded to each parameter's dtype; an int8 model quantizes the
    f32 draws of its block Linears (the same draws as the model without int8)."""
    dev = model.cls_token.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(p: torch.Tensor, draw) -> None:
        buf = torch.empty(p.shape, dtype=torch.float32, device=dev)
        draw(buf)
        p.copy_(buf)

    for m in model.modules():
        if isinstance(m, Int8Linear):
            w = torch.empty(m.out_features, m.in_features, dtype=torch.float32, device=dev)
            _lecun_normal_(w, m.in_features, gen)
            m.set_weight(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            # a PaddedLinear draws its published shape into its real rows and
            # columns: the same draws as the unpadded layer
            w = m.published(m.weight) if isinstance(m, PaddedLinear) else m.weight
            fan_in = w[0].numel()
            fill(w, lambda t: _lecun_normal_(t, fan_in, gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, EvaBlock) and m.gamma_1 is not None:
            m.gamma_1.fill_(1.0)
            m.gamma_2.fill_(1.0)
    fill(model.cls_token, lambda t: nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=gen))
    if model.pos_embed is not None:
        fill(model.pos_embed,
             lambda t: nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=gen))


def forward_logits(model: Eva02, images: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(images)


def forward_probs(model: Eva02, images: torch.Tensor) -> torch.Tensor:
    """sigmoid(logits) — the reference applies the activation outside the model
    (tagging.py:176)."""
    return torch.sigmoid(forward_logits(model, images))
