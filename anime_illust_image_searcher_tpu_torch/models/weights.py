"""Weight loading (timm checkpoint or JAX param tree -> the port's Eva02 or
SwinV2) and labels.

Port of the JAX package's models/weights.py. A local checkpoint directory holds

    model_dir/
      model.safetensors     (timm state dict)
      selected_tags.csv     (tag_id,name,category — category 9=rating, 0=general, 4=character)

``model.safetensors`` is read by a small reader of this module's own, so the
port does not depend on the ``safetensors`` package. Only split q/k/v projections are
supported; a fused-qkv checkpoint is refused rather than guessed at. The q/k
projections get the rope half-split column permutation (models/eva02.py).

A checkpoint whose keys hold SwinV2's attention (``layers.{s}.blocks.{j}.attn.
cpb_mlp.*``, ``logit_scale``, ``q_bias``/``v_bias``, ``qkv``) is the WD SwinV2
tagger's timm layout (``models/swinv2.py``). Its window and image sizes are not
in the weights: they come from the directory's ``config.json`` (``model_args``,
as timm's hub config writes them), and a SwinV2 checkpoint without them is
refused. The heads of each stage are read from its ``logit_scale`` rows;
timm's non-persistent buffers (``relative_coords_table``,
``relative_position_index``, ``attn_mask``, ``k_bias``), where a file holds
them, are dropped.

``from_jax_params`` turns the JAX package's param tree (as numpy arrays) into
this package's state dict, so both packages can run one set of weights.

Every state dict here holds f32 tensors. A bf16 model rounds them as it loads
them; an int8 model (``Eva02Config.quant="int8"``) quantizes its block Linears'
weights from the f32 values (``ops/quant.Int8Linear``), as the JAX package does.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import TaggerModelConfig
from .eva02 import Eva02Config, rope_half_permutation
from .swinv2 import SwinV2, SwinV2Config


@dataclasses.dataclass
class LabelSet:
    names: List[str]
    rating_index: List[int]
    general_index: List[int]
    character_index: List[int]

    @staticmethod
    def from_csv(csv_path: str) -> "LabelSet":
        """Parse selected_tags.csv (columns name, category) like tagging.py:122-140."""
        names: List[str] = []
        categories: List[int] = []
        with open(csv_path, "r", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            for row in reader:
                names.append(row["name"])
                categories.append(int(row["category"]))
        cats = np.asarray(categories)
        return LabelSet(
            names=names,
            rating_index=list(np.where(cats == 9)[0]),
            general_index=list(np.where(cats == 0)[0]),
            character_index=list(np.where(cats == 4)[0]),
        )

    @staticmethod
    def synthetic(num_classes: int, seed: int = 0) -> "LabelSet":
        """Deterministic fake label set: 4 ratings, 80% general, rest character
        (the same RandomState draws as the JAX package, so the same labels)."""
        rng = np.random.RandomState(seed)
        n_rating = min(4, num_classes)
        n_general = int((num_classes - n_rating) * 0.8)
        n_character = num_classes - n_rating - n_general
        names = (
            [f"rating_{i}" for i in range(n_rating)]
            + [f"general_tag_{i}" for i in range(n_general)]
            + [f"character_{i}" for i in range(n_character)]
        )
        order = rng.permutation(num_classes)
        names = [names[i] for i in order]
        cats = np.concatenate([
            np.full(n_rating, 9), np.full(n_general, 0), np.full(n_character, 4)
        ])[order]
        return LabelSet(
            names=names,
            rating_index=list(np.where(cats == 9)[0]),
            general_index=list(np.where(cats == 0)[0]),
            character_index=list(np.where(cats == 4)[0]),
        )


# ------------------------------------------------------------- safetensors

_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def read_safetensors_header(path: str) -> dict:
    """The JSON header of a .safetensors file: {name: {dtype, shape,
    data_offsets}} (and ``__metadata__`` where it has one)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(header_len))


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file: 8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}}, then the raw buffers.
    F32 and F16 come back as stored; BF16 is widened to f32 (numpy has no bf16)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=_SAFETENSORS_DTYPES[dtype],
                            count=(end - start) // np.dtype(_SAFETENSORS_DTYPES[dtype]).itemsize,
                            offset=start)
        if dtype == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def load_timm_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    return read_safetensors(os.path.join(model_dir, "model.safetensors"))


# ------------------------------------------------------------- config detection

# Published timm EVA02 geometries (S/B/L all use head_dim 64). Head count is
# NOT stored in a timm state dict, and every q/k/v kernel is (D, D) regardless
# of head count — a wrong value passes all shape checks while the rope
# permutation and head splits silently scramble channels across heads. So the
# loader only accepts embed_dims whose head count it knows (or a caller-
# supplied base config carrying an explicit num_heads).
_EVA02_NUM_HEADS = {384: 6, 768: 12, 1024: 16}


def detect_config_from_state_dict(sd: Mapping[str, np.ndarray],
                                  base: Optional[Eva02Config] = None) -> Eva02Config:
    """Infer depth/dims/options from checkpoint shapes."""
    base = base or Eva02Config()
    embed_dim = sd["cls_token"].shape[-1]
    if embed_dim == base.embed_dim:
        num_heads = base.num_heads  # caller's (or default) geometry
    elif embed_dim in _EVA02_NUM_HEADS:
        num_heads = _EVA02_NUM_HEADS[embed_dim]  # published geometry
    elif embed_dim % base.num_heads == 0:
        # non-published geometry: keep the base head count, but say so
        num_heads = base.num_heads
        print(f"weights: embed_dim={embed_dim} is not a published EVA02 size; "
              f"assuming num_heads={num_heads} from the base config — pass an "
              "explicit Eva02Config(num_heads=...) if that is wrong")
    else:
        raise ValueError(
            f"cannot infer num_heads for embed_dim={embed_dim}: pass a "
            "base Eva02Config with explicit num_heads (a wrong head count "
            "passes every shape check but scrambles attention heads)")
    depth = 1 + max(
        int(k.split(".")[1]) for k in sd if k.startswith("blocks.")
    )
    num_classes = sd["head.weight"].shape[0]
    patch_size = sd["patch_embed.proj.weight"].shape[-1]
    use_abs_pos_emb = "pos_embed" in sd
    if use_abs_pos_emb:
        num_patches = sd["pos_embed"].shape[1] - 1
        grid = int(round(num_patches ** 0.5))
        img_size = grid * patch_size
    else:
        # rope-only checkpoint: the input size is not recoverable from the weights
        img_size = base.img_size
    mlp_key = "blocks.0.mlp.w1.weight" if "blocks.0.mlp.w1.weight" in sd else "blocks.0.mlp.fc1_g.weight"
    mlp_hidden = sd[mlp_key].shape[0]
    return dataclasses.replace(
        base,
        img_size=img_size,
        patch_size=patch_size,
        embed_dim=embed_dim,
        num_heads=num_heads,
        depth=depth,
        mlp_hidden_dim=mlp_hidden,
        num_classes=num_classes,
        use_abs_pos_emb=use_abs_pos_emb,
        scale_attn_inner="blocks.0.attn.norm.weight" in sd,
        use_layer_scale="blocks.0.gamma_1" in sd,
        global_pool="avg" if "fc_norm.weight" in sd else "token",
    )


# ------------------------------------------------------------- state dicts


def _qk_permutation(cfg: Eva02Config) -> np.ndarray:
    """Per-head column permutation to the half-split rope layout, over all heads."""
    perm = rope_half_permutation(cfg.head_dim)
    return np.concatenate([h * cfg.head_dim + perm for h in range(cfg.num_heads)])


def state_dict_from_timm(sd: Mapping[str, np.ndarray], cfg: Eva02Config) -> Dict[str, torch.Tensor]:
    """timm Eva state dict -> state dict of the port's ``Eva02`` (f32 tensors)."""
    if "blocks.0.attn.qkv.weight" in sd:
        raise ValueError(
            "fused-qkv Eva checkpoint: only split q_proj/k_proj/v_proj layouts "
            "are supported (all published EVA02 tagger checkpoints); convert "
            "the checkpoint to split projections first")
    # q·k is invariant under one permutation of the head dim applied to both,
    # so permuting the q/k output rows makes the half-split rope equal timm's
    # interleaved one. v/proj are untouched.
    perm = _qk_permutation(cfg) if cfg.use_rope else None

    def qk(arr: np.ndarray) -> np.ndarray:
        return arr if perm is None else arr[perm]

    out: Dict[str, np.ndarray] = {
        "patch_embed.weight": sd["patch_embed.proj.weight"],
        "patch_embed.bias": sd["patch_embed.proj.bias"],
        "cls_token": sd["cls_token"],
    }
    if cfg.use_abs_pos_emb:
        out["pos_embed"] = sd["pos_embed"]
    mlp_names = (("w1", "w2", "w3") if "blocks.0.mlp.w1.weight" in sd
                 else ("fc1_g", "fc1_x", "fc2"))
    for i in range(cfg.depth):
        p = f"blocks.{i}"   # the port keeps timm's block names
        for ln in ("norm1", "norm2"):
            out[f"{p}.{ln}.weight"] = sd[f"{p}.{ln}.weight"]
            out[f"{p}.{ln}.bias"] = sd[f"{p}.{ln}.bias"]
        out[f"{p}.attn.q_proj.weight"] = qk(sd[f"{p}.attn.q_proj.weight"])
        out[f"{p}.attn.q_proj.bias"] = qk(sd[f"{p}.attn.q_proj.bias"])
        out[f"{p}.attn.k_proj.weight"] = qk(sd[f"{p}.attn.k_proj.weight"])
        for name in ("v_proj", "proj"):
            out[f"{p}.attn.{name}.weight"] = sd[f"{p}.attn.{name}.weight"]
            out[f"{p}.attn.{name}.bias"] = sd[f"{p}.attn.{name}.bias"]
        if cfg.scale_attn_inner:
            out[f"{p}.attn.norm.weight"] = sd[f"{p}.attn.norm.weight"]
            out[f"{p}.attn.norm.bias"] = sd[f"{p}.attn.norm.bias"]
        for ours, theirs in zip(("w1", "w2", "w3"), mlp_names):
            out[f"{p}.mlp.{ours}.weight"] = sd[f"{p}.mlp.{theirs}.weight"]
            out[f"{p}.mlp.{ours}.bias"] = sd[f"{p}.mlp.{theirs}.bias"]
        out[f"{p}.mlp.norm.weight"] = sd[f"{p}.mlp.norm.weight"]
        out[f"{p}.mlp.norm.bias"] = sd[f"{p}.mlp.norm.bias"]
        if cfg.use_layer_scale:
            out[f"{p}.gamma_1"] = sd[f"{p}.gamma_1"]
            out[f"{p}.gamma_2"] = sd[f"{p}.gamma_2"]
    final = "fc_norm" if cfg.global_pool == "avg" else "norm"
    out[f"{final}.weight"] = sd[f"{final}.weight"]
    out[f"{final}.bias"] = sd[f"{final}.bias"]
    out["head.weight"] = sd["head.weight"]
    out["head.bias"] = sd["head.bias"]
    return _to_tensors(out, cfg)


def from_jax_params(params_np: Mapping, cfg: Eva02Config) -> Dict[str, torch.Tensor]:
    """The JAX package's Eva02 param tree (numpy arrays, with or without the
    outer ``params`` key) -> state dict of the port's ``Eva02``.

    flax Dense ``kernel (in, out)`` becomes Linear ``weight (out, in)``; the conv
    kernel goes (P, P, 3, D) -> (D, 3, P, P); LayerNorm ``scale`` becomes
    ``weight``. The q/k projections are already in the half-split layout there.
    """
    p = params_np.get("params", params_np)

    def dense(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
        out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
        if "bias" in tree:
            out[f"{prefix}.bias"] = np.asarray(tree["bias"])

    def ln(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
        out[f"{prefix}.weight"] = np.asarray(tree["scale"])
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])

    out: Dict[str, np.ndarray] = {
        "patch_embed.weight": np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "patch_embed.bias": np.asarray(p["patch_embed"]["bias"]),
        "cls_token": np.asarray(p["cls_token"]),
    }
    if "pos_embed" in p:
        out["pos_embed"] = np.asarray(p["pos_embed"])
    for i in range(cfg.depth):
        blk, dst = p[f"blocks_{i}"], f"blocks.{i}"
        ln(blk["norm1"], f"{dst}.norm1", out)
        ln(blk["norm2"], f"{dst}.norm2", out)
        for name in ("q_proj", "k_proj", "v_proj", "proj"):
            dense(blk["attn"][name], f"{dst}.attn.{name}", out)
        if "norm" in blk["attn"]:
            ln(blk["attn"]["norm"], f"{dst}.attn.norm", out)
        for name in ("w1", "w2", "w3"):
            dense(blk["mlp"][name], f"{dst}.mlp.{name}", out)
        ln(blk["mlp"]["norm"], f"{dst}.mlp.norm", out)
        if "gamma_1" in blk:
            out[f"{dst}.gamma_1"] = np.asarray(blk["gamma_1"])
            out[f"{dst}.gamma_2"] = np.asarray(blk["gamma_2"])
    if "fc_norm" in p:
        ln(p["fc_norm"], "fc_norm", out)
    if "norm" in p:
        ln(p["norm"], "norm", out)
    dense(p["head"], "head", out)
    return _to_tensors(out, cfg)


def _to_tensors(sd: Mapping[str, np.ndarray], cfg: Eva02Config) -> Dict[str, torch.Tensor]:
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}  # copies
    _validate_shapes(out, cfg)
    return out


def _validate_shapes(sd: Mapping[str, torch.Tensor], cfg: Eva02Config) -> None:
    d = cfg.embed_dim
    checks = [
        ("patch_embed.weight", (d, 3, cfg.patch_size, cfg.patch_size)),
        ("cls_token", (1, 1, d)),
        ("blocks.0.attn.q_proj.weight", (d, d)),
        ("blocks.0.mlp.w1.weight", (cfg.mlp_hidden_dim, d)),
        ("head.weight", (cfg.num_classes, d)),
    ]
    if "pos_embed" in sd:
        checks.append(("pos_embed", (1, cfg.num_patches + 1, d)))
    for key, want in checks:
        got = tuple(sd[key].shape)
        if got != tuple(want):
            raise ValueError(f"shape mismatch for {key}: got {got}, want {want}")


# timm SwinV2 buffers that a file may hold and the port rebuilds (or, for
# k_bias, folds into its qkv bias)
SWINV2_BUFFERS = ("relative_coords_table", "relative_position_index", "attn_mask", "k_bias")
MODEL_ARGS = ("img_size", "window_size")


def is_swinv2_state_dict(sd: Mapping[str, np.ndarray]) -> bool:
    return any(k.endswith(".attn.cpb_mlp.0.weight") for k in sd)


def read_model_args(model_dir: str) -> dict:
    """``model_args`` of the directory's ``config.json``, or {} without one."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return dict(json.load(f).get("model_args") or {})


def detect_swinv2_config(sd: Mapping[str, np.ndarray], model_args: Mapping,
                         base: Optional[TaggerModelConfig] = None) -> SwinV2Config:
    """A timm SwinV2 state dict's geometry: widths and depths from its shapes,
    heads from each stage's ``logit_scale``, window and image size from
    ``model_args``; the dtype (and a SwinV2 base's eps) from ``base``."""
    missing = [k for k in MODEL_ARGS if k not in model_args]
    if missing:
        raise ValueError(
            f"SwinV2 checkpoint without {' and '.join(missing)}: the window and image "
            "sizes are not in the weights; put the repo's config.json (its model_args) "
            "beside model.safetensors")
    stages = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    if stages != list(range(len(stages))):
        raise ValueError(f"SwinV2 checkpoint with stages {stages}")
    embed_dim, _, patch, _ = sd["patch_embed.proj.weight"].shape
    depths = tuple(1 + max(int(k.split(".")[3]) for k in sd
                           if k.startswith(f"layers.{s}.blocks.")) for s in stages)
    return SwinV2Config(
        img_size=int(model_args["img_size"]), patch_size=int(patch), embed_dim=int(embed_dim),
        depths=depths,
        num_heads=tuple(int(sd[f"layers.{s}.blocks.0.attn.logit_scale"].shape[0])
                        for s in stages),
        window_size=int(model_args["window_size"]),
        mlp_ratio=sd["layers.0.blocks.0.mlp.fc1.weight"].shape[0] / embed_dim,
        cpb_hidden=int(sd["layers.0.blocks.0.attn.cpb_mlp.0.weight"].shape[0]),
        num_classes=int(sd["head.fc.weight"].shape[0]),
        layer_norm_eps=base.layer_norm_eps if isinstance(base, SwinV2Config) else 1e-5,
        dtype=base.dtype if base is not None else torch.bfloat16)


def swinv2_state_dict(sd: Mapping[str, np.ndarray], cfg: SwinV2Config) -> Dict[str, torch.Tensor]:
    """timm SwinV2 state dict -> the port's (the same names, f32 tensors),
    every key and shape held to the model that ``cfg`` builds."""
    sd = {k: v for k, v in sd.items() if k.split(".")[-1] not in SWINV2_BUFFERS}
    want = {k: tuple(v.shape) for k, v in SwinV2(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        extra, lost = sorted(set(got) - set(want)), sorted(set(want) - set(got))
        wrong = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(f"SwinV2 checkpoint does not match {cfg}: unexpected keys "
                         f"{extra[:5]}, missing keys {lost[:5]}, shape mismatches "
                         f"{[(k, got[k], want[k]) for k in wrong[:5]]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_tagger_checkpoint(
    model_dir: str, base: Optional[TaggerModelConfig] = None,
) -> Tuple[Dict[str, torch.Tensor], TaggerModelConfig, LabelSet]:
    """Load state dict + config + labels from a local checkpoint directory.
    The keys choose the backbone: SwinV2 (with ``config.json``'s
    ``model_args``) or EVA02.

    ``base``: optional config whose dtype (EVA02: also num_heads/img_size)
    seeds detection — needed for geometries outside the published EVA02
    sizes."""
    sd = load_timm_state_dict(model_dir)
    if is_swinv2_state_dict(sd):
        cfg = detect_swinv2_config(sd, read_model_args(model_dir), base)
        state = swinv2_state_dict(sd, cfg)
    else:
        if base is not None and not isinstance(base, Eva02Config):
            base = Eva02Config(dtype=base.dtype)
        cfg = detect_config_from_state_dict(sd, base=base)
        state = state_dict_from_timm(sd, cfg)
    labels = LabelSet.from_csv(os.path.join(model_dir, "selected_tags.csv"))
    if len(labels.names) != cfg.num_classes:
        raise ValueError(
            f"label count {len(labels.names)} != head size {cfg.num_classes}"
        )
    return state, cfg, labels
