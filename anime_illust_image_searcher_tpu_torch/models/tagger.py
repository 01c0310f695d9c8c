"""The WD tagger predictor: batched ViT forward + MCut thresholding + CSV assembly.

The backbone is EVA02 (``models/eva02.py``, the default and the JAX package's
one) or SwinV2 (``models/swinv2.py``), chosen by the model config's type: an
explicit ``model_cfg``, or the one ``models/weights.load_tagger_checkpoint``
detects from a checkpoint's keys. Everything around the forward is shared.

Port of the JAX package's models/tagger.py:
  - preprocessing (scale, normalize, RGB→BGR swap) runs on the device before the
    forward, so the host only ships uint8 pixels;
  - MCut runs vectorized on the device for the whole batch × both tag categories;
  - per-image tag selection/ordering semantics match tagging.py:184-227 exactly
    (general: MCut threshold; character: max(0.15, MCut); sort desc; spaces→underscores;
    general tags then character tags, comma-joined).

Runs on ``cuda`` unless ``device="cpu"`` is passed; without a card it raises.
Each batch is cut into one in-order row block per data shard of the
predictor's mesh (parallel/mesh.py), each block runs on a replica of the model
on its shard's device, and the outputs are gathered in order on the mesh's
first device. Without a ``mesh`` the mesh is ``device`` alone: one block, the
whole batch. The replicas, the upload of a batch and the split, launch and
gather are ``parallel/mesh.ReplicatedForward``'s, built at load.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import TaggerConfig, TaggerModelConfig
from ..device import DeviceLike
from ..ops.mcut import mcut_threshold_batch
from ..parallel.mesh import Mesh, ReplicatedForward, predictor_mesh
from ..utils.profiling import span
from . import eva02, swinv2
from .eva02 import Eva02Config
from .swinv2 import SwinV2Config
from .weights import LabelSet, load_tagger_checkpoint


def build_backbone(cfg: TaggerModelConfig, device=None) -> torch.nn.Module:
    """The backbone of ``cfg``'s type, with its parameters not yet set."""
    if isinstance(cfg, SwinV2Config):
        return swinv2.SwinV2(cfg, device=device)
    return eva02.Eva02(cfg, device=device)


def init_backbone(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded weights for either backbone."""
    (swinv2.init_params if isinstance(model, swinv2.SwinV2) else eva02.init_params)(model, seed)


def _predict_probs(model: torch.nn.Module, images_u8: torch.Tensor, mean: torch.Tensor,
                   std: torch.Tensor) -> torch.Tensor:
    """Preprocess + forward + sigmoid. images_u8: (B, S, S, 3) uint8 RGB, already
    resized. Returns (B, num_classes) f32."""
    x = images_u8.float() / 255.0
    x = (x - mean) / std
    x = x.flip(-1)  # RGB -> BGR channel swap (tagging.py:243)
    return torch.sigmoid(model(x))


def _category_thresholds(
    probs: torch.Tensor,             # (B, C)
    general_gather: torch.Tensor,    # (G,) int64
    character_gather: torch.Tensor,  # (K,) int64
    character_floor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    def mcut_or_none(cat: torch.Tensor) -> torch.Tensor:
        # MCut needs >= 2 probabilities (it thresholds at the largest GAP).
        # A category of 0/1 tags gets the placeholder 1.0, which selects
        # nothing if its mcut flag is ever turned on.
        if cat.shape[1] < 2:
            return torch.ones((cat.shape[0],), dtype=torch.float32, device=cat.device)
        return mcut_threshold_batch(cat)

    g_thresh = mcut_or_none(probs[:, general_gather])
    c_thresh = torch.clamp(mcut_or_none(probs[:, character_gather]), min=character_floor)
    return g_thresh, c_thresh


class TaggerPredictor:
    """Predictor facade: loads weights/labels once, then tags uint8 batches."""

    def __init__(
        self,
        config: TaggerConfig = TaggerConfig(),
        model_dir: Optional[str] = None,
        model_cfg: Optional[TaggerModelConfig] = None,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """``device``: ``None``/``"cuda"`` (default) or ``"cpu"``; CUDA without a
        card raises. ``model_dir`` defaults to ``$AIIS_MODEL_DIR``; without one
        the model gets seeded random weights and synthetic labels.
        ``model_cfg``: an ``Eva02Config`` or a ``SwinV2Config``; with a
        ``model_dir`` the checkpoint's keys choose the backbone and this
        config seeds the detection (its dtype, and EVA02's head count).
        ``AIIS_INT8=1`` sets ``config.quant`` to ``"int8"``, and a quant request
        reaches the model whatever ``model_cfg`` says (a SwinV2 model refuses
        it).

        ``mesh``: batches shard over its data axis and the model is replicated
        on each of its distinct devices (the first of them is the predictor's
        device); the batch size must divide by the data-axis size."""
        # Multi-host tagging is deliberately per-host (embarrassingly
        # parallel over directories).
        self.mesh = predictor_mesh(
            mesh, device,
            "TaggerPredictor's data-parallel mesh must be single-host; "
            "for multi-host tagging run the CLI per host on disjoint "
            "directories and concatenate the tag files")
        self.device = self.mesh.devices[0]
        if os.environ.get("AIIS_INT8", "0") == "1" and config.quant == "none":
            config = dataclasses.replace(config, quant="int8")
        self.config = config
        self.model_dir = model_dir or os.environ.get("AIIS_MODEL_DIR") or None
        self._model_cfg = model_cfg
        self.model: Optional[torch.nn.Module] = None
        self.labels: Optional[LabelSet] = None
        self.replicated: Optional[ReplicatedForward] = None

    def load_model(self) -> None:
        if self.model is not None:
            return
        state = None
        if self.model_dir:
            state, model_cfg, self.labels = load_tagger_checkpoint(
                self.model_dir, base=self._model_cfg)
        else:
            model_cfg = self._model_cfg or Eva02Config(
                img_size=self.config.image_size,
                dtype=torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32,
            )
        if self.config.quant != "none" and model_cfg.quant == "none":
            # a quant request (config.quant / AIIS_INT8=1) is never dropped by
            # an explicit or detected model config; int8 layers quantize the
            # f32 weights as they load them
            model_cfg = dataclasses.replace(model_cfg, quant=self.config.quant)
        self.model_cfg = model_cfg
        model = build_backbone(model_cfg, device=self.device)
        if state is not None:
            model.load_state_dict(state)
        else:
            print(
                "WARNING: no --model-dir given; using seeded RANDOM weights and "
                "synthetic labels. Output format is real, tag semantics are not."
            )
            init_backbone(model, seed=0)
            self.labels = LabelSet.synthetic(model_cfg.num_classes)
        self.model = model.eval().requires_grad_(False)
        self._general_names = [self.labels.names[i] for i in self.labels.general_index]
        self._character_names = [self.labels.names[i] for i in self.labels.character_index]
        # host-side gather indices, built once (finalize runs per batch)
        self._general_idx_np = np.asarray(self.labels.general_index, np.int64)
        self._character_idx_np = np.asarray(self.labels.character_index, np.int64)
        self.replicated = ReplicatedForward(
            self.mesh, self.model, lambda dev: build_backbone(self.model_cfg, device=dev),
            lambda dev: (
                torch.as_tensor(self._general_idx_np, device=dev),
                torch.as_tensor(self._character_idx_np, device=dev),
                # mean/std 0.5 is the WD-v3 timm data config
                torch.tensor([0.5, 0.5, 0.5], dtype=torch.float32, device=dev),
                torch.tensor([0.5, 0.5, 0.5], dtype=torch.float32, device=dev),
            ))

    # ------------------------------------------------------------------ predict

    def predict_probs(self, images_u8: np.ndarray) -> np.ndarray:
        self.load_model()
        return self._forward(images_u8, thresholds=False)[0].cpu().numpy()

    def _forward(self, images_u8, thresholds: bool) -> tuple:
        """The forward over a uint8 array or tensor on the replicas: the
        probabilities, and with ``thresholds`` both categories' MCut
        thresholds, gathered in order on the first device."""
        floor = self.config.character_thresh_floor

        def step(model, general, character, mean, std, x) -> tuple:
            probs = _predict_probs(model, x, mean, std)
            if not thresholds:
                return (probs,)
            return (probs, *_category_thresholds(probs, general, character, floor))

        with torch.inference_mode():
            return self.replicated(images_u8, step)

    def predict_device(self, images_u8: np.ndarray):
        """Queue the device part (forward + thresholds) WITHOUT a sync — lets the
        CLI assemble batch N-1's lines on the host while the card runs batch N."""
        self.load_model()
        return self._forward(images_u8, thresholds=True)

    def predict(
        self,
        images_u8: np.ndarray,
        general_thresh: float,
        general_mcut_enabled: bool,
        character_thresh: float,
        character_mcut_enabled: bool,
    ) -> List[str]:
        """Batch -> per-image comma-joined tag strings (tagging.py:156-229 semantics)."""
        return self.finalize(
            self.predict_device(images_u8),
            general_thresh, general_mcut_enabled,
            character_thresh, character_mcut_enabled,
        )

    def finalize(
        self,
        device_outputs,
        general_thresh: float,
        general_mcut_enabled: bool,
        character_thresh: float,
        character_mcut_enabled: bool,
    ) -> List[str]:
        probs_dev, g_thresh_dev, c_thresh_dev = device_outputs
        with span("step.copy_back"):
            probs = probs_dev.cpu().numpy()
            g_mcut = g_thresh_dev.cpu().numpy()
            c_mcut = c_thresh_dev.cpu().numpy()

        with span("tagger.assemble"):
            general = probs[:, self._general_idx_np]
            character = probs[:, self._character_idx_np]

            ret_strings: List[str] = []
            for idx in range(probs.shape[0]):
                g_t = g_mcut[idx] if general_mcut_enabled else general_thresh
                c_t = c_mcut[idx] if character_mcut_enabled else character_thresh

                ret_strings.append(
                    self._assemble_line(general[idx], g_t, character[idx], c_t)
                )
        return ret_strings

    @staticmethod
    def _select_sorted(names: List[str], probs: np.ndarray, thresh: float) -> List[str]:
        """Reference tag selection, byte-exact (tagging.py:194,203-226): tags above
        the threshold are dict-deduplicated BY NAME (last occurrence's prob wins, the
        first occurrence's position orders equal-prob ties via Python's stable sort),
        sorted by prob descending, spaces -> underscores.

        The f64 upcast is load-bearing: the reference compares ``astype(float)``
        probs against the f64 threshold (tagging.py:186,194), so an f32 prob of
        0.3 (0.30000001... in f64) PASSES a ``> 0.3`` test that it would fail in
        f32 arithmetic."""
        probs = probs.astype(np.float64)
        sel = np.where(probs > thresh)[0]
        res: dict = {}
        for i in sel:
            res[names[i]] = probs[i]
        ordered = sorted(res.items(), key=lambda x: x[1], reverse=True)
        return [name.replace(" ", "_") for name, _ in ordered]

    def _assemble_line(self, general: np.ndarray, g_t: float,
                       character: np.ndarray, c_t: float) -> str:
        ret = ",".join(self._select_sorted(self._general_names, general, g_t))
        c_parts = self._select_sorted(self._character_names, character, c_t)
        if c_parts:
            # The reference always prefixes the character block with a comma
            # (tagging.py:224) — with an empty general set the full file line
            # becomes ``path,,chartag`` (leading empty token). Kept byte-exact
            # (QUIRKS.md #17).
            ret += "," + ",".join(c_parts)
        return ret
