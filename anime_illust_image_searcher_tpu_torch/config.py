"""Typed configuration of the tagging, character-feature and query-serving stages.

Copies of the JAX package's ``TaggerConfig``, ``Doc2VecConfig``, ``BM25Config``,
``SearchConfig``, ``CCIPConfig`` and ``Config`` (anime_illust_image_searcher_tpu/config.py),
kept here so the port imports nothing of that package. The field names and
values are the on-disk and CLI contract shared by both packages: the
``doc2vec_model`` pickle carries a ``Doc2VecConfig``, which the port's loaders
map onto the class below (utils/pickles.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple, Union

if TYPE_CHECKING:
    from .models.eva02 import Eva02Config
    from .models.swinv2 import SwinV2Config


# the backbone configs the tagger predictor takes (models/tagger.py); a
# checkpoint's keys choose between them (models/weights.py)
TaggerModelConfig = Union["Eva02Config", "SwinV2Config"]


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    """WD ViT tagger stage (reference: tagging.py:45-59, 333)."""

    # any WD v3 tagger repo of an EVA02 or SwinV2 backbone, e.g.
    # SmilingWolf/wd-swinv2-tagger-v3
    model_repo: str = "SmilingWolf/wd-eva02-large-tagger-v3"
    extensions: Tuple[str, ...] = (".png", ".jpg", ".jpeg", ".PNG", ".JPG", ".JPEG")
    # The reference uses BATCH_SIZE=10 sized for an M1 GPU (tagging.py:49); the TPU path
    # defaults much larger to keep the MXU fed (measured on v5e: 117.5 img/s at B=128
    # vs 79.5 at B=64 with XLA attention; round-4 interleaved sweep: 141.5/143.3/146.1
    # img/s at B=128/192/256, so 256 is the default). Padded to a fixed bucket so XLA
    # compiles one program; tail batches pad, so tiny directories pay one 256-wide
    # forward (~1.8 s) — use --batch-size for small one-off runs.
    batch_size: int = 256
    progress_interval: int = 1000
    decode_workers: int = 8
    image_size: int = 448
    # Thresholds exactly as hardcoded at the reference call site (tagging.py:333).
    general_thresh: float = 0.3
    general_mcut_enabled: bool = True
    character_thresh: float = 0.3
    character_mcut_enabled: bool = True
    character_thresh_floor: float = 0.15  # tagging.py:201
    output_file: str = "tags-wd-tagger.txt"
    # bf16 compute on the MXU; logits/probabilities come back in f32.
    compute_dtype: str = "bfloat16"
    # "none" or "int8": the block Linears on the int8 tensor cores (ops/quant.py).
    # Also settable via AIIS_INT8=1. Tag sets differ from the bf16 path's near
    # the thresholds: check them on real weights before enabling in production.
    quant: str = "none"


@dataclasses.dataclass(frozen=True)
class Doc2VecConfig:
    """PV-DBOW training (reference: genmodel.py:15-16,159)."""

    vector_size: int = 300
    epochs: int = 100
    # gensim defaults carried by Doc2Vec(dm=0): negative sampling, lr schedule.
    negative: int = 5
    ns_exponent: float = 0.75
    alpha: float = 0.025
    min_alpha: float = 0.0001
    sample: float = 1e-3
    min_count: int = 1
    # window=50 is accepted for CLI parity but PV-DBOW without dbow_words never reads it.
    window: int = 50
    seed: int = 1
    infer_epochs: int = 100
    # Device batching: documents are padded to this many tags per doc (tag docs are
    # dozens of tokens; 128 is one VPU lane-width and fits every real corpus we saw).
    max_doc_len: int = 128
    # Training-only option: gather syn1 rows as bf16 (f32 master weights take
    # the update). MEASURED A/B on v5e (5000 docs x 300 dim, interleaved,
    # 2026-08-16): 4.97 s vs 4.97 s per 10 epochs — NO gain; the epoch scan is
    # not gather-bound at these sizes, so the default stays f32 (which also
    # keeps training numerics bit-stable). Inference always gathers f32 — the
    # deterministic tag-vector table depends on it.
    train_gather_bf16: bool = False


@dataclasses.dataclass(frozen=True)
class BM25Config:
    """Okapi BM25 (reference: webui.py:126-127)."""

    k1: float = 1.5
    b: float = 0.75


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Query-time fusion + rerank weights (reference: webui.py:51-60, 38)."""

    bm25_weight: float = 0.5
    doc2vec_weight: float = 0.5
    original_score_weight: float = 0.7
    reranked_score_weight: float = 0.3
    diff_filter_thresh: float = 1e-6
    require_tag_magic_number: int = 1000
    topn: int = 800  # webui.py:586
    rerank_top_k: int = 10
    # NG_WORDS verbatim, including the reference's 'pixcel_art' spelling (webui.py:38).
    ng_words: Tuple[str, ...] = ("language", "english_text", "pixcel_art")
    # Bug-compat PRF: emulate the reference's tuple-array rerank AS BUILT
    # (webui.py:198-211 — (index,value) pairs Frobenius-normalized with the
    # index column, round() collapsing every feature id to 0) instead of the
    # intended math QUIRKS #5 implements. Engine __init__ also honors
    # AIIS_REFERENCE_PRF=1. Rankings then bit-match the as-built reference
    # (modulo deterministic inference); the fused one-dispatch path is bypassed.
    reference_prf: bool = False


@dataclasses.dataclass(frozen=True)
class CCIPConfig:
    """Character-feature stage (reference: gen_cfeatures.py:41-53,100-110)."""

    model_name: str = "ccip-caformer-24-randaug-pruned"
    image_size: int = 384
    feature_dim: int = 768
    # reference BATCH_SIZE=20 (gen_cfeatures.py:50); the JAX package's default
    batch_size: int = 64
    progress_interval: int = 100
    decode_workers: int = 8
    # CLIP normalization constants (gen_cfeatures.py:100).
    mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    # Default decision threshold of ccip-caformer-24-randaug-pruned's
    # metrics.json (gen_cfeatures.py:183-202 fetches it; the published value).
    default_threshold: float = 0.17847511429108218
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class Config:
    """The stages this port serves (the JAX package's tree also holds a
    ``MeshConfig`` of axis names that no module reads; parallel/mesh.py keeps
    them as constants)."""

    tagger: TaggerConfig = dataclasses.field(default_factory=TaggerConfig)
    doc2vec: Doc2VecConfig = dataclasses.field(default_factory=Doc2VecConfig)
    bm25: BM25Config = dataclasses.field(default_factory=BM25Config)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    ccip: CCIPConfig = dataclasses.field(default_factory=CCIPConfig)


DEFAULT_CONFIG = Config()
