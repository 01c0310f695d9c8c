"""Tagging from precomputed arrays — the "offload tagging" variant, on the card.

Port of the JAX package's cli/tagging_pre.py. The reference's workflow for weak
local machines is: preprocess images locally into tensor files, upload, and
batch-tag them on a rented accelerator (colab_env/tagging.py, README "Tips: when
you can not prepare GPU machine"). This is that second stage, reading ``.npy``
arrays produced by ``cli.utility.make_tensor_files`` (or the reference's own
torch tensor files):

    python -m anime_illust_image_searcher_tpu_torch.cli.tagging_pre --dir TENSOR_DIR
        [--model-dir M] [--batch-size N] [--decode-workers N]

``main([...], device="cpu")`` runs it on the CPU. Parity notes: output opens in
'w' mode — the colab variant truncates instead of appending
(colab_env/tagging.py:278, QUIRKS.md #2 contrast); output lines carry the .npy
path with the suffix stripped, matching the reference's convention that tensor
files mirror the original image paths. The batch size defaults to the tagging
CLI's (256) instead of the colab variant's 200; ``--batch-size`` restores any
value.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, TaggerConfig
from ..data.ingest import PrefetchLoader
from ..device import DeviceLike
from ..models.tagger import TaggerPredictor
from ..utils.pipeline import run_depth1
from ..utils.progress import ProgressMeter

DEFAULT_BATCH = DEFAULT_CONFIG.tagger.batch_size

# The reference's make_tensor_files keeps the IMAGE path name for its torch
# tensor files (utility/make_tensor_files.py:165-171: dirbase swapped for dest,
# extension untouched), so a reference tensor dir contains .jpg/.png-named
# torch pickles. Ours are imagepath + ".npy". Both are accepted.
TENSOR_EXTENSIONS = (".npy", ".png", ".jpg", ".jpeg", ".PNG", ".JPG", ".JPEG")


def list_npy_recursive(dir_path: str) -> List[str]:
    out: List[str] = []
    for root, _, files in os.walk(dir_path):
        for f in files:
            if f.endswith(TENSOR_EXTENSIONS):
                out.append(os.path.join(root, f))
    return out


def _pt_to_uint8_rgb(tensor, size: int) -> Optional[np.ndarray]:
    """Invert the reference's saved transform — (3, S, S) f32, mean/std 0.5
    normalized, BGR channel order (make_tensor_files.py:186-188) — back to the
    uint8 RGB HWC this pipeline ships to the device (which re-applies the same
    normalization + BGR swap; the u8 round trip is exact)."""
    arr = np.asarray(tensor, dtype=np.float32)
    if arr.shape != (3, size, size):
        print(f"bad tensor shape {arr.shape}, want (3, {size}, {size})")
        return None
    bgr = np.clip((arr * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(bgr[::-1].transpose(1, 2, 0))  # BGR CHW -> RGB HWC


def load_npy(size: int):
    def f(path: str) -> Optional[np.ndarray]:
        try:
            if path.endswith(".npy"):
                arr = np.load(path)
                if arr.shape != (size, size, 3) or arr.dtype != np.uint8:
                    print(f"bad array {path}: {arr.shape} {arr.dtype}")
                    return None
                return arr
            # a reference-made tensor file
            return _pt_to_uint8_rgb(
                torch.load(path, map_location="cpu", weights_only=True), size)
        except Exception as e:  # noqa: BLE001 — skip-and-continue is the contract
            print(f"{type(e)}: {e}")
            return None
    return f


def main(arg_str: List[str], device: DeviceLike = None) -> None:
    """CLI entry. ``device`` as for ``TaggerPredictor`` (default ``cuda``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", nargs=1, required=True, help="precomputed tensor directory")
    parser.add_argument("--model-dir", default=None, help="local converted checkpoint dir")
    parser.add_argument("--batch-size", type=int, default=DEFAULT_BATCH)
    parser.add_argument("--decode-workers", type=int, default=None,
                        help="host load threads (default 8, clamped to the core count)")
    args = parser.parse_args(arg_str)
    if args.batch_size < 1:
        parser.error(f"--batch-size must be >= 1, got {args.batch_size}")
    if args.decode_workers is not None and args.decode_workers < 1:
        parser.error(f"--decode-workers must be >= 1, got {args.decode_workers}")

    cfg: TaggerConfig = dataclasses.replace(
        DEFAULT_CONFIG.tagger, batch_size=args.batch_size,
        decode_workers=args.decode_workers or DEFAULT_CONFIG.tagger.decode_workers,
    )
    predictor = TaggerPredictor(config=cfg, model_dir=args.model_dir, device=device)
    predictor.load_model()

    file_list = list_npy_recursive(args.dir[0])
    print(f"{len(file_list)} files found")

    meter = ProgressMeter(cfg.progress_interval)
    loader = PrefetchLoader(
        file_list, size=cfg.image_size, batch_size=cfg.batch_size,
        workers=cfg.decode_workers, decode_fn=load_npy(cfg.image_size),
    )
    with open(cfg.output_file, "w", encoding="utf-8") as out:  # 'w': colab semantics
        def write(batch, lines) -> None:
            for path, line in zip(batch.paths, lines[: batch.valid]):
                # .npy files map back to the image path; reference .pt tensor
                # files already CARRY the image path (colab_env/tagging.py:291)
                if path.endswith(".npy"):
                    path = path[: -len(".npy")]
                out.write(path + "," + line + "\n")
            meter.add(batch.valid)

        run_depth1(
            loader,
            lambda batch: predictor.predict_device(batch.images),
            lambda batch, devs: predictor.finalize(
                devs,
                cfg.general_thresh, cfg.general_mcut_enabled,
                cfg.character_thresh, cfg.character_mcut_enabled,
            ),
            write,
        )
    meter.report()
    loader.report_failures()


if __name__ == "__main__":
    main(sys.argv[1:])
