"""CCIP predictor facade: feature extraction, thresholds, pairwise metrics.

Port of the JAX package's models/ccip.py (:27-412). It mirrors the
reference's ``Predictor`` surface (gen_cfeatures.py:68-335):
``ccip_batch_extract_features``, ``ccip_extract_feature``, ``ccip_difference``,
``ccip_batch_differences``, ``ccip_default_threshold``, ``get_image_feature``,
plus the reranker's device stages (live, row-gather, capped candidates).

Runs on ``cuda`` unless ``device="cpu"`` is passed; without a card it raises.
The encoder runs in its config's compute dtype: bf16 by default, f32 when
``model_cfg`` says so (on the card each dtype has its attention kernel).
Seeded weights come from a ``torch.Generator`` and so differ from the JAX
package's seeded weights: runs that compare the two packages share a
``params.npz`` model dir (models/ccip_weights.py).

The metric is the JAX package's choice, made the same way: a model dir that
ships ``model_metrics.onnx`` (cli/convert_ccip.py copies it there when the
published metric is not 1 - cosine) is analyzed once; a learned pairwise graph
that converts replaces the metric (models/ccip_weights.metric_fn_from_graph,
torch ops on the predictor's device); a 1 - cosine graph keeps the fused ops;
a graph that is not pairwise, does not convert, or whose analysis raises keeps
1 - cosine with a WARNING, as the JAX package does.

Feature batches shard over the data axis of the predictor's mesh onto
replicas of the encoder through ``parallel/mesh.ReplicatedForward``, as the
tagger's do; without a ``mesh`` the mesh is ``device`` alone. The rerank
paths put their small top-k batch whole on the mesh's first device through
the same object's upload.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import CCIPConfig
from ..device import DeviceLike, to_device
from ..parallel.mesh import Mesh, ReplicatedForward, predictor_mesh
from .caformer import (
    CAFormer, CAFormerConfig, _rerank_diffs_from_rows, _valid_mean,
    ccip_batch_differences_op, ccip_differences_vs_index_op,
    ccip_mean_feature_from_rows_op, ccip_rerank_diffs_from_rows_batch_op,
    ccip_rerank_diffs_op, ccip_rerank_matches_from_rows_batch_op, extract_features,
    init_params,
)

FeatureOrImage = Union[np.ndarray, str]

LEARNED_METRIC_FILE = "model_metrics.onnx"


class CCIPPredictor:
    def __init__(
        self,
        config: CCIPConfig = CCIPConfig(),
        model_cfg: Optional[CAFormerConfig] = None,
        seed: int = 0,
        model_dir: Optional[str] = None,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """``device``: ``None``/``"cuda"`` (default) or ``"cpu"``. ``model_dir``
        (default ``$AIIS_CCIP_MODEL_DIR``): a ``params.npz`` + ``config.json``
        checkpoint; without one the encoder gets seeded random weights.
        ``mesh``: feature batches shard over its data axis, the encoder is
        replicated on each of its distinct devices (the first is the
        predictor's device); the batch size must divide by the data-axis size."""
        # Same rationale as the tagger: cfeature extraction is
        # per-host-parallel (every process would re-decode the same directory).
        self.mesh = predictor_mesh(
            mesh, device,
            "CCIPPredictor's data-parallel mesh must be single-host; "
            "for multi-host extraction run gen_cfeatures per host on "
            "disjoint directories")
        self.device = self.mesh.devices[0]
        self.model_dir = model_dir or os.environ.get("AIIS_CCIP_MODEL_DIR") or None
        self.config = config
        self.model_cfg = model_cfg or (
            None if self.model_dir else CAFormerConfig(
                img_size=config.image_size, feature_dim=config.feature_dim))
        self.seed = seed
        self.model: Optional[CAFormer] = None
        self.replicated: Optional[ReplicatedForward] = None
        # Working threshold, mutable like the reference Predictor's attribute
        # (get_image_feature's lazy default/1.5 write, gen_cfeatures.py:299).
        self.threshold: float = -1.0
        # The checkpoint's own threshold: the DEFAULT, kept apart from the
        # mutable working threshold so the lazy /1.5 write never compounds.
        self._checkpoint_threshold: Optional[float] = None
        # the learned metric, set lazily when the model dir ships a
        # model_metrics.onnx that is NOT 1 - cosine
        self._metric_fn = None
        self._metric_vs_index = None
        self._metric_checked = False

    def _ensure_metric(self) -> None:
        """Metric-only load: pure-feature metric calls must not force a full
        (possibly random-weight) encoder init just to pick the metric."""
        if self._metric_checked:
            return
        self._metric_checked = True
        if self.model_dir:
            self._load_learned_metric()

    def _load_learned_metric(self) -> None:
        """Convert the model dir's ``model_metrics.onnx`` into the metric
        functions when it is a learned pairwise graph; 1 - cosine graphs keep
        the fused ops (reference: gen_cfeatures.py:124-130,248-274)."""
        path = os.path.join(self.model_dir, LEARNED_METRIC_FILE)
        if not os.path.exists(path):
            return
        from .ccip_weights import analyze_metric_graph, metric_vs_index_fn
        from .onnx_pb import load_model as load_onnx

        graph = load_onnx(path).graph
        # probe with the CHECKPOINT's feature dim (config.json carries it even
        # before load_model builds model_cfg)
        feature_dim = self.config.feature_dim
        if self.model_cfg is not None:
            feature_dim = self.model_cfg.feature_dim
        else:
            import json

            cfg_path = os.path.join(self.model_dir, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path, encoding="utf-8") as f:
                    feature_dim = json.load(f).get("feature_dim", feature_dim)
        try:
            verdict = analyze_metric_graph(graph, feature_dim, device=self.device)
        except Exception as e:  # noqa: BLE001 — a weird metric graph must not
            # brick feature extraction; the fused 1-cos ops keep working
            print(
                "WARNING: model_metrics.onnx analysis failed; falling back to "
                f"the fused 1-cosine metric. {type(e).__name__}: {e}"
            )
            return
        if verdict["is_one_minus_cosine"]:
            return  # the fused 1-cos ops are exact; keep the one-dispatch paths
        converted = verdict.pop("_converted_fn", None)
        if not verdict.get("pairwise", False):
            # the batched ops (and metric_vs_index_fn's [0,1]-cell read) assume
            # a pairwise (N, N) metric matrix; any other layout would be misread
            converted = None
        if not verdict.get("convertible", False) or converted is None:
            print(
                "WARNING: model_metrics.onnx is neither 1-cosine nor "
                "convertible; falling back to the fused 1-cosine metric. "
                f"Verdict: {verdict.get('convert_error', verdict)}"
            )
            return
        self._metric_fn = converted
        self._metric_vs_index = metric_vs_index_fn(graph, self.device)
        print(f"CCIP: using converted learned metric (verdict: {verdict})")

    def load_model(self) -> None:
        if self.model is not None:
            return
        if self.model_dir:
            from .ccip_weights import load_ccip_checkpoint

            explicit_cfg = self.model_cfg
            cfg, state, thr = load_ccip_checkpoint(self.model_dir)
            if explicit_cfg is not None and explicit_cfg.dtype != cfg.dtype:
                # the checkpoint's geometry is authoritative, an explicit
                # compute dtype is kept
                cfg = dataclasses.replace(cfg, dtype=explicit_cfg.dtype)
            self.model_cfg = cfg
            if thr is not None:
                self._checkpoint_threshold = thr
                if self.threshold <= 0:
                    self.threshold = thr
            self._ensure_metric()
        else:
            state = None
            print(
                "WARNING: no CCIP model dir (set AIIS_CCIP_MODEL_DIR or pass "
                "--model-dir); using seeded RANDOM weights. Feature format is "
                "real, character semantics are not."
            )
        model = CAFormer(self.model_cfg, device=self.device)
        if state is None:
            init_params(model, seed=self.seed)
        else:
            model.load_state_dict(state)
        self.model = model.eval().requires_grad_(False)
        self.replicated = ReplicatedForward(
            self.mesh, self.model, lambda dev: CAFormer(self.model_cfg, device=dev),
            lambda dev: tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                              for v in (self.config.mean, self.config.std)))

    def uses_learned_metric(self) -> bool:
        """True when the checkpoint ships a converted non-cosine metric graph:
        callers with 1 - cos-only fused programs take the per-query metric
        path instead."""
        self.load_model()
        self._ensure_metric()
        return self._metric_vs_index is not None

    def ccip_default_threshold(self) -> float:
        """Published metrics.json threshold of ccip-caformer-24-randaug-pruned
        (gen_cfeatures.py:183-202); a checkpoint carries its own. Reads the
        checkpoint constant, never the mutable working ``self.threshold``."""
        self.load_model()
        if self._checkpoint_threshold is not None and self._checkpoint_threshold > 0:
            return self._checkpoint_threshold
        return self.config.default_threshold

    # ---- features ------------------------------------------------------------

    def ccip_extract_device(self, images_u8: np.ndarray) -> torch.Tensor:
        """Queue the feature forward WITHOUT a sync: gen_cfeatures' depth-1
        pipeline indexes batch N-1 on the host while the card runs batch N.
        Returns the (B, feature_dim) f32 tensor on the device."""
        self.load_model()
        return self._forward(images_u8)

    def _forward(self, images_u8) -> torch.Tensor:
        """The features of a uint8 array or tensor, from the replicas,
        gathered in order on the first device."""
        return self.replicated(
            images_u8, lambda model, mean, std, x: (extract_features(model, x, mean, std),))[0]

    def ccip_batch_extract_features(self, images_u8: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 RGB -> (B, feature_dim) f32."""
        return self.ccip_extract_device(images_u8).cpu().numpy()

    def ccip_extract_feature(self, image_u8: np.ndarray) -> np.ndarray:
        return self.ccip_batch_extract_features(image_u8[None])[0]

    def gen_image_ndarray(self, file_path: str) -> Optional[np.ndarray]:
        """Decode one file to the CCIP input: white-flattened RGB, bilinear
        resize to the square input (gen_cfeatures.py:285-295); None on failure.
        Normalization runs on the device."""
        from PIL import Image

        from ..data.ingest import load_rgb_square

        return load_rgb_square(file_path, self.config.image_size,
                               resample=Image.BILINEAR, pad_to_square=False)

    def get_image_feature(self, file_path: str) -> np.ndarray:
        if self.threshold == -1.0:
            # the webui's lazy path (gen_cfeatures.py:299)
            self.threshold = self.ccip_default_threshold() / 1.5
        img = self.gen_image_ndarray(file_path)
        if img is None:
            raise ValueError(f"failed to load {file_path}")
        return self.ccip_extract_feature(img)

    # ---- metrics ---------------------------------------------------------------

    def _p_feature(self, x: FeatureOrImage) -> np.ndarray:
        if isinstance(x, np.ndarray) and x.ndim == 1:
            return x
        if isinstance(x, str):
            return self.get_image_feature(x)
        return self.ccip_extract_feature(np.asarray(x))

    def ccip_difference(self, x: FeatureOrImage, y: FeatureOrImage) -> float:
        return float(self.ccip_batch_differences([x, y])[0, 1])

    def ccip_batch_differences(self, images: List[FeatureOrImage]) -> np.ndarray:
        feats = np.stack([self._p_feature(i) for i in images]).astype(np.float32)
        feats_dev = torch.from_numpy(feats).to(self.device)
        self._ensure_metric()
        if self._metric_fn is not None:
            with torch.no_grad():
                return self._metric_fn(feats_dev).cpu().numpy()
        return ccip_batch_differences_op(feats_dev).cpu().numpy()

    def ccip_differences_vs_index(self, index_matrix: np.ndarray,
                                  query_feat: np.ndarray) -> np.ndarray:
        """All-rows difference (index rows unit) in one pass."""
        m = to_device(index_matrix, self.device, np.float32)
        q = to_device(query_feat, self.device, np.float32)
        self._ensure_metric()
        if self._metric_vs_index is not None:
            return self._metric_vs_index(m, q).cpu().numpy()
        return ccip_differences_vs_index_op(m, q).cpu().numpy()

    def rerank_diffs(self, images_u8: np.ndarray, n_valid: int, index) -> np.ndarray:
        """Live character rerank stage: (k, S, S, 3) zero-padded top-k images
        -> diffs of their valid-mean feature vs every indexed row (the index
        rides its device copy). With a learned metric: the features, their
        valid mean, then the vs-index metric."""
        self.load_model()
        valid = torch.arange(images_u8.shape[0], device=self.device) < n_valid
        images = self.replicated.upload(images_u8)
        if self._metric_vs_index is not None:
            feats = extract_features(self.model, images, *self.replicated.consts)
            return self._metric_vs_index(index.device_matrix(),
                                         _valid_mean(feats, valid)).cpu().numpy()
        return ccip_rerank_diffs_op(self.model, images, valid, *self.replicated.consts,
                                    index.device_matrix()).cpu().numpy()

    def _rows(self, row_ids: np.ndarray, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row ids on the device and the valid mask of their last dim: (k,) ids
        and an int count, or (B, k) ids and (B,) counts."""
        ids = torch.from_numpy(np.asarray(row_ids, np.int64)).to(self.device)
        n = torch.as_tensor(np.asarray(n_valid), device=self.device)
        return ids, torch.arange(ids.shape[-1], device=self.device) < n[..., None]

    def rerank_diffs_from_rows(self, row_ids: np.ndarray, n_valid: int, index) -> np.ndarray:
        """Row-gather character rerank: the top-k features are matrix[row] *
        norm[row] of the device-resident cfeature index. Callers have checked
        eligibility (CCIPReranker._gather_rows)."""
        self.load_model()
        ids, valid = self._rows(row_ids, n_valid)
        if self._metric_vs_index is not None:
            mean = ccip_mean_feature_from_rows_op(index.device_matrix(), index.device_norms(),
                                                  ids, valid)
            return self._metric_vs_index(index.device_matrix(), mean).cpu().numpy()
        return _rerank_diffs_from_rows(index.device_matrix(), index.device_norms(),
                                       ids, valid).cpu().numpy()

    def rerank_matches_from_rows(
            self, row_ids: np.ndarray, n_valid: int, index, thresh_up: float, cap: int,
    ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Candidate-only row-gather rerank: (count, cand_idx int64, cand_diffs),
        the ``cap`` smallest diffs in (diff asc, index asc) order and how many
        rows beat ``thresh_up`` (an f32 rounded UP from the f64 threshold).
        None when a learned metric is active (callers take the full diffs)."""
        res = self.rerank_matches_from_rows_batch(
            np.asarray(row_ids)[None], np.asarray([n_valid]), index, thresh_up, cap)
        if res is None:
            return None
        counts, idx, diffs = res
        return int(counts[0]), idx[0], diffs[0]

    def rerank_matches_from_rows_batch(
            self, row_ids: np.ndarray, n_valid: np.ndarray, index, thresh_up: float, cap: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Batched candidate-only rerank of up to 8 queries in one pass:
        (counts (B,), idx (B, cap), diffs (B, cap)); None when a learned
        metric is active."""
        self.load_model()
        self._ensure_metric()
        if self._metric_vs_index is not None:
            return None
        ids, valid = self._rows(row_ids, n_valid)
        count, idx, diffs = ccip_rerank_matches_from_rows_batch_op(
            index.device_matrix(), index.device_norms(), ids, valid, thresh_up, cap)
        out = torch.cat([count.double()[:, None], idx.double(), diffs.double()], dim=1).cpu().numpy()
        return (out[:, 0].astype(np.int64), out[:, 1:1 + cap].astype(np.int64),
                out[:, 1 + cap:].astype(np.float32))

    def rerank_diffs_from_rows_batch(self, row_ids: np.ndarray, n_valid: np.ndarray,
                                     index) -> Optional[np.ndarray]:
        """Up to 8 queries' row-gather reranks in one pass: (B, k) row ids +
        (B,) valid counts -> (B, D) diffs. None when a learned metric is
        active: its program is per query, and callers take one pass a query."""
        self.load_model()
        self._ensure_metric()
        if self._metric_vs_index is not None:
            return None
        ids, valid = self._rows(row_ids, n_valid)
        return ccip_rerank_diffs_from_rows_batch_op(
            index.device_matrix(), index.device_norms(), ids, valid).cpu().numpy()
