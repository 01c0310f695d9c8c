"""Model fetch from the HuggingFace Hub at run time (networked deployments).

Port of the JAX package's models/hub.py. The reference fetches its weights as
it starts (tagging.py:146-148 pulls ``SmilingWolf/wd-eva02-large-tagger-v3``
through timm; gen_cfeatures.py:112-118 pulls ``deepghs/ccip_onnx``). Here
``--model-repo`` on the tagging and gen_cfeatures CLIs resolves a repo id to a
local model directory, downloading (and, for CCIP, converting) on first use.

The cache is the JAX package's: ``$AIIS_MODEL_CACHE`` (default
``~/.cache/aiis-tpu/models``), one directory a repo under the same name and
with the same files, so a directory fetched by either package is a cache hit
for the other. ``huggingface_hub`` is imported only on a miss. Where it is
missing or the network is not reachable, the fetch raises a ``RuntimeError``
that names the offline route: the published files in a directory passed as
``--model-dir``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

DEFAULT_TAGGER_REPO = "SmilingWolf/wd-eva02-large-tagger-v3"
DEFAULT_CCIP_REPO = "deepghs/ccip_onnx"
DEFAULT_CCIP_MODEL = "ccip-caformer-24-randaug-pruned"

TAGGER_FILES = ("model.safetensors", "selected_tags.csv")
CCIP_FILES = ("params.npz", "config.json")

TAGGER_OFFLINE = ("put model.safetensors and selected_tags.csv from the repo in a "
                  "directory and pass --model-dir DIR instead")
CCIP_OFFLINE = ("run python -m anime_illust_image_searcher_tpu_torch.cli.convert_ccip "
                "on a networked machine and pass --model-dir instead")


def _cache_root() -> str:
    return os.environ.get(
        "AIIS_MODEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "aiis-tpu", "models"),
    )


def _offline_error(repo_id: str, route: str, exc: Exception) -> RuntimeError:
    return RuntimeError(
        f"could not download {repo_id} from the HuggingFace Hub "
        f"({type(exc).__name__}: {exc}). In offline/zero-egress environments, "
        f"{route}."
    )


def _has_all(directory: str, names) -> bool:
    return all(os.path.exists(os.path.join(directory, f)) for f in names)


def fetch_tagger_repo(repo_id: str = DEFAULT_TAGGER_REPO,
                      cache_dir: Optional[str] = None) -> str:
    """Download the tagger's checkpoint files; returns a ``--model-dir``
    directory (model.safetensors + selected_tags.csv)."""
    dest = cache_dir or os.path.join(_cache_root(), repo_id.replace("/", "__"))
    if _has_all(dest, TAGGER_FILES):
        return dest
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(repo_id, local_dir=dest, allow_patterns=list(TAGGER_FILES))
    except Exception as e:  # noqa: BLE001 — any hub or network failure
        raise _offline_error(repo_id, TAGGER_OFFLINE, e) from e
    missing = [f for f in TAGGER_FILES if not os.path.exists(os.path.join(dest, f))]
    if missing:
        raise RuntimeError(f"{repo_id} snapshot is missing {missing}")
    return dest


def _read_threshold(repo_id: str, path: str) -> float:
    """metrics.json's ``threshold``, else ``val_threshold``, else -1. A file
    that cannot be read is a local failure, not a download one."""
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
        return float(m.get("threshold", m.get("val_threshold", -1)))
    except (OSError, ValueError, TypeError, AttributeError) as e:
        raise RuntimeError(f"downloaded {repo_id} metrics.json is unreadable: {e}") from e


def fetch_ccip_repo(repo_id: str = DEFAULT_CCIP_REPO,
                    model: str = DEFAULT_CCIP_MODEL,
                    cache_dir: Optional[str] = None) -> str:
    """Download the CCIP ONNX files and convert them into a checkpoint
    directory (params.npz + config.json) for ``--model-dir`` /
    ``AIIS_CCIP_MODEL_DIR``. Only the downloads are wrapped in the offline
    error: a conversion failure raises as itself."""
    dest = cache_dir or os.path.join(
        _cache_root(), f"{repo_id.replace('/', '__')}__{model}")
    if _has_all(dest, CCIP_FILES):
        return dest
    with tempfile.TemporaryDirectory() as tmp:
        try:
            from huggingface_hub import hf_hub_download

            feat = hf_hub_download(repo_id, f"{model}/model_feat.onnx", local_dir=tmp)
        except Exception as e:  # noqa: BLE001 — any hub or network failure
            raise _offline_error(repo_id, CCIP_OFFLINE, e) from e
        try:
            metrics_json = hf_hub_download(repo_id, f"{model}/metrics.json", local_dir=tmp)
        except Exception:  # noqa: BLE001 — the threshold is optional
            metrics_json = None
        threshold = _read_threshold(repo_id, metrics_json) if metrics_json else None
        from .ccip_weights import convert_feat_file, save_ccip_checkpoint

        cfg, state, report = convert_feat_file(feat)
        print(f"ccip conversion: {report.summary()}")
        save_ccip_checkpoint(dest, cfg, state, threshold)
    return dest
