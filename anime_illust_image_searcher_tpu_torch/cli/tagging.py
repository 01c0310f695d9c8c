"""Tagging CLI — batched WD-EVA02 ViT tagging of an image directory, on the card.

Port of the JAX package's cli/tagging.py:

    python -m anime_illust_image_searcher_tpu_torch.cli.tagging --dir D [--after YYYY-MM-DD]
        [--model-dir M | --model-repo REPO_ID] [--batch-size N] [--decode-workers N]
        [--scaled-decode] [--profile DIR] [--data-parallel]

``--model-repo`` fetches the checkpoint from the HuggingFace Hub into the model
cache that the JAX package shares (models/hub.py, ``$AIIS_MODEL_CACHE``) on
first use; ``--model-dir`` wins over it, and it wins over ``$AIIS_MODEL_DIR``.
A failed fetch raises: it never falls back to seeded weights.

Host decode runs through the native C++ pool (data/native_ingest.py) when it
builds, else through Pillow, with the same bytes; ``AIIS_DECODE_PROC=<n>`` moves
it into n worker processes. ``--scaled-decode`` (``AIIS_SCALED_DECODE=1``)
decodes JPEGs near the target size in the DCT domain: faster, with slightly
different pixels. ``AIIS_INT8=1`` runs the block Linears on int8
(ops/quant.py). ``--profile DIR`` writes a torch.profiler Chrome trace.
``--data-parallel`` shards each batch over this process's cards (the batch
rounded up to a multiple of their count), a replica of the model on each. It
starts no process group: tagging over several hosts is one run a host, on
disjoint directories.

Behavior parity (see QUIRKS.md):
  - output appended to tags-wd-tagger.txt, one ``path,tag,...`` line per image (#2)
  - --after filters by st_ctime date and backs up the tag file first (#3)
  - per-image decode failures are skipped and counted, never fatal
  - FIXED vs reference: the tail batch is padded and processed instead of dropped (#1),
    and output order is deterministic listing order (#13)
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys
from typing import Callable, Optional

import numpy as np

from ..config import TaggerConfig
from ..data.ingest import PrefetchLoader, filter_files_by_date, list_files_recursive
from ..device import DeviceLike
from ..index import artifacts
from ..models.hub import fetch_tagger_repo
from ..models.tagger import TaggerPredictor
from ..parallel.mesh import DATA_AXIS, data_parallel_batch, local_mesh
from ..utils.profiling import trace
from ..utils.progress import ProgressMeter


class Predictor(TaggerPredictor):
    """Directory-processing wrapper keeping the reference's entry-point API
    (``Predictor().process_directory(dir, added_date)`` — tagging.py:276)."""

    def process_directory(
        self, dir_path: str, added_date: Optional[datetime.date] = None,
        decode_fn: Optional[Callable[[str], Optional[np.ndarray]]] = None,
    ) -> None:
        """``decode_fn``: optional path -> (S, S, 3) uint8 decoder in place of
        the Pillow one (None marks a failed decode)."""
        cfg: TaggerConfig = self.config
        file_list = list_files_recursive(dir_path, cfg.extensions)
        print(f"{len(file_list)} files found")

        if added_date is not None:
            file_list = filter_files_by_date(file_list, added_date)
            print(f"{len(file_list)} files found after {added_date}")
            if os.path.exists(cfg.output_file):
                artifacts.backup_file(cfg.output_file)
            else:
                print(f"{cfg.output_file} not found")
                sys.exit(1)

        self.load_model()
        meter = ProgressMeter(cfg.progress_interval)
        loader = PrefetchLoader(
            file_list,
            size=cfg.image_size,
            batch_size=cfg.batch_size,
            workers=cfg.decode_workers,
            pad_to_square=True,
            decode_fn=decode_fn,
        )
        with open(cfg.output_file, "a", encoding="utf-8") as out:
            def flush(pending) -> None:
                pbatch, devs = pending
                results = self.finalize(
                    devs,
                    cfg.general_thresh, cfg.general_mcut_enabled,
                    cfg.character_thresh, cfg.character_mcut_enabled,
                )
                for path, line in zip(pbatch.paths, results[: pbatch.valid]):
                    out.write(path + "," + line + "\n")
                meter.add(pbatch.valid)

            # depth-1 pipeline: queue batch N on the card, then assemble batch
            # N-1's lines on the host while the card runs.
            pending = None
            for batch in loader:
                devs = self.predict_device(batch.images)
                if pending is not None:
                    flush(pending)
                pending = (batch, devs)
            if pending is not None:
                flush(pending)
        meter.report(final=True)
        loader.report_failures()


def main(arg_str: list, device: DeviceLike = None) -> None:
    """CLI entry. ``device`` as for ``TaggerPredictor`` (default ``cuda``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", nargs=1, required=True, help="tagging target directory path")
    parser.add_argument(
        "--after", nargs=1,
        help="tagging new images after this date (mtime attribute). Format: YYYY-MM-DD",
    )
    parser.add_argument(
        "--model-dir", default=None,
        help="local checkpoint dir with model.safetensors + selected_tags.csv "
             "(from SmilingWolf/wd-eva02-large-tagger-v3); "
             "defaults to $AIIS_MODEL_DIR, else random weights",
    )
    parser.add_argument(
        "--model-repo", default=None, metavar="REPO_ID",
        help="HF Hub repo to download at runtime (e.g. "
             "SmilingWolf/wd-eva02-large-tagger-v3); networked deployments only",
    )
    parser.add_argument("--batch-size", type=int, default=None, help="device batch size")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help="host decode threads (default 8, clamped to the core count)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to DIR")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard batches across all visible cards")
    parser.add_argument("--scaled-decode", action="store_true",
                        help="libjpeg DCT-domain scaled decode: faster host decode, "
                             "pixels differ slightly from the full-decode path; "
                             "same as AIIS_SCALED_DECODE=1")
    args = parser.parse_args(arg_str)
    if args.scaled_decode:
        os.environ["AIIS_SCALED_DECODE"] = "1"

    cfg = TaggerConfig()
    if args.batch_size is not None:
        if args.batch_size < 1:
            parser.error(f"--batch-size must be >= 1, got {args.batch_size}")
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.decode_workers is not None:
        if args.decode_workers < 1:
            parser.error(f"--decode-workers must be >= 1, got {args.decode_workers}")
        cfg = dataclasses.replace(cfg, decode_workers=args.decode_workers)

    mesh = None
    if args.data_parallel:
        mesh = local_mesh(device)
        cfg = dataclasses.replace(cfg, batch_size=data_parallel_batch(mesh, cfg.batch_size))
        print(f"data-parallel over {mesh.shape[DATA_AXIS]} devices, batch {cfg.batch_size}")

    after_date = None
    if args.after is not None:
        try:
            after_date = datetime.datetime.strptime(args.after[0], "%Y-%m-%d").date()
        except ValueError as e:
            print("%s: %s" % (type(e), str(e)))
            print("Invalid date format. format is YYYY-MM-DD")
            sys.exit(1)

    model_dir = args.model_dir
    if model_dir is None and args.model_repo:
        model_dir = fetch_tagger_repo(args.model_repo)
        print(f"model fetched to {model_dir}")

    predictor = Predictor(config=cfg, model_dir=model_dir, device=device, mesh=mesh)
    with trace(args.profile):
        predictor.process_directory(args.dir[0], after_date)


def _console() -> None:
    """pip console-script entry (pyproject [project.scripts])."""
    main(sys.argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
