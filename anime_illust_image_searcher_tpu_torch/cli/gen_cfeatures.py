"""Character-feature index build CLI, on the card.

Port of the JAX package's cli/gen_cfeatures.py (public surface of the
reference's gen_cfeatures.py:461-483):

    python -m anime_illust_image_searcher_tpu_torch.cli.gen_cfeatures --dir D
        [--after YYYY-MM-DD] [--batch-size N] [--model-dir M | --model-repo REPO_ID]
        [--decode-workers N] [--profile DIR] [--data-parallel]

Behavior (gen_cfeatures.py:337-459), as in the JAX package:
  - recursive listing + optional ctime --after filter
  - --after: a timestamped backup dir of every charactor-featues-idx* file,
    then the old index rows are copied verbatim into revision N+1 and the new
    rows append there
  - batched CCIP feature extraction; paths appended to charactor-featues-idx.csv
    (the reference's misspelling kept); unit rows, norms and per-row
    extraction stamps into the revisioned similarity index
  - FIXED vs reference: the tail batch is processed, listing order is
    deterministic (QUIRKS.md #1/#13)

The files are the JAX package's, byte for byte, so either package reads the
other's index. ``--model-dir`` takes a directory written by either package's
converter (``python -m anime_illust_image_searcher_tpu_torch.cli.convert_ccip``
from the published ONNX files), a learned ``model_metrics.onnx`` included.
``--model-repo`` downloads the published ONNX files from the HuggingFace Hub and
converts them into the model cache that the JAX package shares (models/hub.py,
``$AIIS_MODEL_CACHE``) on first use; ``--model-dir`` wins over it, and a
failed fetch raises. ``--profile DIR`` writes a torch.profiler Chrome trace of
the run into DIR; ``--data-parallel`` shards each feature batch over this
process's cards (the batch rounded up to a multiple of their count; one run a
host, with no process group).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import sys
import time
from typing import Optional

import numpy as np

from ..config import CCIPConfig
from ..data.ingest import PrefetchLoader, filter_files_by_date, list_files_recursive
from ..device import DeviceLike
from ..index import artifacts
from ..index.similarity import SimilarityIndex
from ..models.ccip import CCIPPredictor
from ..models.hub import fetch_ccip_repo
from ..parallel.mesh import DATA_AXIS, data_parallel_batch, local_mesh
from ..utils.profiling import trace
from ..utils.progress import ProgressMeter


class Predictor(CCIPPredictor):
    """Directory-processing wrapper (reference Predictor, gen_cfeatures.py:68,337)."""

    def __init__(self, config: CCIPConfig = CCIPConfig(), **kw) -> None:
        super().__init__(config=config, **kw)
        self.cindex: Optional[SimilarityIndex] = None

    def get_current_cfeature_number(self) -> int:
        return artifacts.get_current_cfeature_number()

    def process_directory(
        self, dir_path: str, added_date: Optional[datetime.date] = None
    ) -> None:
        cfg = self.config
        # Extraction stamp of every row THIS run adds: the reranker's row-gather
        # path compares file mtimes against it. Copied rows keep their own.
        build_started = time.time()
        file_list = list_files_recursive(dir_path)
        print(f"{len(file_list)} files found")

        index_name = artifacts.cfeatures_index_name(0)
        if added_date is not None:
            file_list = filter_files_by_date(file_list, added_date)
            print(f"{len(file_list)} files found after {added_date}")

            backup_dir = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            for name in artifacts.backup_cfeature_indexes(backup_dir):
                print(f"Backed up {name} to {backup_dir}")

            max_number = self.get_current_cfeature_number()
            print("copying index files to new index files")
            old_index = SimilarityIndex.load(artifacts.cfeatures_index_name(max_number), mmap=None)
            index_name = artifacts.cfeatures_index_name(max_number + 1)
            self.cindex = SimilarityIndex(index_name, num_features=cfg.feature_dim)
            if len(old_index):
                # verbatim copy: rows, pre-normalization norms and stamps
                self.cindex.extend_from(old_index)
            print("copying index files to new index files done")
        elif SimilarityIndex.exists(index_name):
            # append mode on rev 0, like gensim Similarity reopened by name
            self.cindex = SimilarityIndex.load(index_name, mmap=None)

        self.load_model()
        self.threshold = self.ccip_default_threshold()
        if self.cindex is None:
            self.cindex = SimilarityIndex(index_name, num_features=cfg.feature_dim)

        from PIL import Image

        meter = ProgressMeter(cfg.progress_interval)
        loader = PrefetchLoader(
            file_list, size=cfg.image_size, batch_size=cfg.batch_size,
            workers=cfg.decode_workers, pad_to_square=False, resample=Image.BILINEAR,
        )
        with open(artifacts.CFEATURES_CSV, "a", encoding="utf-8") as out:
            def flush(pending) -> None:
                pbatch, dev = pending
                feats = dev.cpu().numpy()[: pbatch.valid]
                for path in pbatch.paths:
                    out.write(path + "\n")
                self.cindex.add_documents(list(feats), stamp=build_started)
                meter.add(pbatch.valid)

            # depth-1 pipeline: queue batch N on the card, then copy back and
            # index batch N-1 while the card runs
            pending = None
            for batch in loader:
                dev = self.ccip_extract_device(batch.images)
                if pending is not None:
                    flush(pending)
                pending = (batch, dev)
            if pending is not None:
                flush(pending)
        stamped = np.asarray(self.cindex.stamps)
        stamped = stamped[stamped > 0]
        self.cindex.meta["build_started"] = float(
            min(stamped.min(), build_started)) if len(stamped) else build_started
        self.cindex.save(index_name)
        meter.report(final=True)
        loader.report_failures()


def main(arg_str: list, device: DeviceLike = None) -> None:
    """CLI entry. ``device`` as for ``CCIPPredictor`` (default ``cuda``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", nargs=1, required=True, help="tagging target directory path")
    parser.add_argument(
        "--after", nargs=1,
        help="tagging new images after this date (mtime attribute). Format: YYYY-MM-DD",
    )
    parser.add_argument("--batch-size", type=int, default=None, help="device batch size")
    parser.add_argument("--model-dir", default=None,
                        help="CCIP checkpoint dir (params.npz + config.json, and "
                             "model_metrics.onnx for a learned metric: cli.convert_ccip "
                             "writes it); defaults to $AIIS_CCIP_MODEL_DIR, else random weights")
    parser.add_argument("--model-repo", default=None, metavar="REPO_ID",
                        help="HF Hub repo to download + convert at runtime "
                             "(e.g. deepghs/ccip_onnx); networked deployments only")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard feature batches across all visible cards")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to DIR")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help="host decode threads (default 8, clamped to the core count)")
    args = parser.parse_args(arg_str)

    cfg = CCIPConfig()
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
        print(f"cfeatures data-parallel over {mesh.shape[DATA_AXIS]} devices, "
              f"batch {cfg.batch_size}")

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
        model_dir = fetch_ccip_repo(args.model_repo)
        print(f"ccip model converted to {model_dir}")

    predictor = Predictor(config=cfg, model_dir=model_dir, device=device, mesh=mesh)
    with trace(args.profile):
        predictor.process_directory(args.dir[0], after_date)


def _console() -> None:
    """pip console-script entry (pyproject [project.scripts])."""
    main(sys.argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
