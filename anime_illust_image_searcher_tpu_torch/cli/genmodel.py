"""Index build CLI — Doc2Vec PV-DBOW training, the similarity index and the
BM25 artifacts, on the card (port of the JAX package's cli/genmodel.py):

    python -m anime_illust_image_searcher_tpu_torch.cli.genmodel [--update] [--epochs N]
        [--data-parallel] [--profile DIR]

``main([...], device="cpu")`` runs it on the CPU. ``--data-parallel`` shards
Doc2Vec training and the inference pass over this process's cards (one CPU
entry on the CPU); every artifact but the model pickle, whose fingerprint
marks the mode, is the plain build's, byte for byte. ``--profile DIR`` writes
a torch.profiler Chrome trace of the build into DIR. The artifact chain is the
reference's (genmodel.py:21-43,84-97,155-177), and the JAX package's files:

  tags-wd-tagger.txt -> tags-wd-tagger_doc2vec_idx.csv (docs with >= 3 tags, in order)
                     -> doc2vec_dictionary, doc2vec_model, doc2vec_index
                     -> bm25_corpus / bm25_idf / bm25_avgdl / bm25_D / bm25_doc_lengths

The idx csv, the dictionary and the five BM25 pickles are byte-identical to
the JAX genmodel's on the same tags file; the pickles name the JAX package's
classes, so an index built by either package serves from the other.

--update semantics (genmodel.py:123-148,177; QUIRKS.md): the idx csv is backed
up, only docs beyond the old line count get vectors appended to the similarity
index, the dictionary is NOT extended, and BM25 is rebuilt from the full corpus.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_CONFIG, Doc2VecConfig
from ..device import DeviceLike, resolve_device
from ..index import artifacts
from ..index.bm25_index import BM25DeviceIndex, build_bm25_stats, save_bm25_artifacts
from ..index.dictionary import TagDictionary
from ..index.similarity import SimilarityIndex
from ..models.doc2vec import Doc2VecModel
from ..parallel.mesh import Mesh, local_mesh
from ..utils.profiling import trace


def read_documents_and_gen_idx_text(file_path: str) -> Tuple[List[List[str]], List[str]]:
    """Read the tag file, keep docs with >= 3 tags, and write the docid-ordered idx csv
    (reference: genmodel.py:21-43). Returns (token docs, original lines kept)."""
    processed_docs: List[List[str]] = []
    kept_lines: List[str] = []
    idx_text_fpath = file_path.split(".")[0] + "_doc2vec_idx.csv"
    with open(idx_text_fpath, "w", encoding="utf-8") as idx_f:
        with open(file_path, "r", encoding="utf-8") as f:
            for line in f:
                row = line.strip().split(",")
                tokens = row[1:]  # drop the file-path element
                if tokens and len(tokens) >= 3:
                    processed_docs.append(tokens)
                    kept_lines.append(line)
                    idx_f.write(line)
    return processed_docs, kept_lines


def main(arg_str: List[str], device: DeviceLike = None) -> None:
    """CLI entry. Training and inference run on ``device`` (default ``cuda``,
    which raises without a card)."""
    logging.basicConfig(
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s", level=logging.INFO
    )
    parser = argparse.ArgumentParser()
    parser.add_argument("--update", action="store_true", help="add new images to index")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override Doc2Vec training epochs (default 100)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard Doc2Vec training batches across all visible cards")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to DIR")
    parser.add_argument("--no-reuse-model", action="store_true",
                        help="always retrain, even when a finished doc2vec_model "
                             "trained from exactly this corpus/config already "
                             "exists (reuse is bit-identical to retraining — "
                             "training is seeded and deterministic — and is how "
                             "a build that crashed after training skips the "
                             "training bill on rerun)")
    parser.add_argument("--checkpoint-every", type=int, default=10, metavar="N",
                        help="snapshot training state every N epochs for crash "
                             "resume (0 disables; default 10). Each snapshot "
                             "copies the full doc-vector table to the host "
                             "(~1.2 GB at 1M docs)")
    args = parser.parse_args(arg_str)
    device = resolve_device(device)  # before any file is written

    mesh = None
    if args.data_parallel:
        mesh = local_mesh(device)
        print(f"doc2vec training + inference data-parallel over "
              f"{mesh.total_shards} devices")

    if args.update:
        if os.path.exists(artifacts.DOC2VEC_IDX_CSV):
            artifacts.backup_file(artifacts.DOC2VEC_IDX_CSV, artifacts.DOC2VEC_IDX_CSV_BAK)
        else:
            print(f"{artifacts.DOC2VEC_IDX_CSV} not found")
            sys.exit(1)

    if not os.path.exists(artifacts.TAGS_FILE):
        print(f"{artifacts.TAGS_FILE} not found — run tagging first")
        sys.exit(1)

    processed_docs, _ = read_documents_and_gen_idx_text(artifacts.TAGS_FILE)
    if not processed_docs:
        print(f"no documents with >= 3 tags in {artifacts.TAGS_FILE}; nothing to index")
        sys.exit(1)

    cfg: Doc2VecConfig = DEFAULT_CONFIG.doc2vec
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs, infer_epochs=args.epochs)
    with trace(args.profile):
        _build(args, cfg, processed_docs, device, mesh)


def _infer_vectors_resumable(model: Doc2VecModel, docs: Sequence[Sequence[str]]) -> np.ndarray:
    """Whole-corpus inference with crash resume for large builds.

    Per-doc inference is deterministic and batch-invariant, so slicing the
    corpus and persisting each finished slice gives the same vectors as one
    ``infer_vectors`` call, and a build that dies mid-pass resumes from the
    last completed slice. Progress lives in ``doc2vec_model.infer_progress/``
    keyed by (model identity, cfg, docs); any mismatch recomputes from
    scratch; the caller removes the directory once the index is written.
    AIIS_INFER_RESUME_SLICE sets the slice size (docs; 0 disables)."""
    n = len(docs)
    slice_docs = int(os.environ.get("AIIS_INFER_RESUME_SLICE", "131072"))
    if slice_docs <= 0 or n <= slice_docs:
        return model.infer_vectors(docs)

    h = hashlib.blake2b(digest_size=16)
    ident = model.train_fp or hashlib.blake2b(
        np.ascontiguousarray(model.syn1neg).tobytes(), digest_size=16
    ).hexdigest()
    h.update(ident.encode())
    h.update(repr(model.cfg).encode())
    h.update(np.int64(n).tobytes())
    h.update(np.int64(slice_docs).tobytes())
    for doc in docs:
        for t in doc:
            h.update(t.encode())
            h.update(b"\0")
        h.update(b"\1")
    fp = h.hexdigest()

    d = _infer_progress_dir()
    manifest_path = os.path.join(d, "manifest.json")
    done: set = set()
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, "r", encoding="ascii") as f:
                manifest = json.load(f)
            if manifest.get("fp") == fp:
                done = set(manifest.get("done", []))
            else:
                print("doc2vec: inference progress is from a different "
                      "model/corpus — recomputing")
                # drop the stale slices now, so crashed builds over changing
                # corpora do not pile up orphaned slice files
                shutil.rmtree(d, ignore_errors=True)
        except (OSError, ValueError):
            pass
    os.makedirs(d, exist_ok=True)

    out = np.empty((n, model.cfg.vector_size), np.float32)
    starts = list(range(0, n, slice_docs))
    resumed = 0
    for i, s in enumerate(starts):
        e = min(s + slice_docs, n)
        slice_path = os.path.join(d, f"slice_{i}.npy")
        if i in done and os.path.exists(slice_path):
            try:
                arr = np.load(slice_path)
                if arr.shape == (e - s, model.cfg.vector_size):
                    out[s:e] = arr
                    resumed += 1
                    continue
            except (OSError, ValueError):
                pass  # unreadable slice: recompute it
        out[s:e] = model.infer_vectors(docs[s:e])
        tmp = f"{slice_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:  # file object: np.save can't append .npy
            np.save(f, out[s:e])
        os.replace(tmp, slice_path)
        done.add(i)
        tmp_m = f"{manifest_path}.tmp{os.getpid()}"
        with open(tmp_m, "w", encoding="ascii") as f:
            json.dump({"fp": fp, "done": sorted(done)}, f)
        os.replace(tmp_m, manifest_path)
    if resumed:
        print(f"doc2vec: resumed inference — {resumed}/{len(starts)} slices "
              "loaded from progress")
    return out


def _infer_progress_dir() -> str:
    return artifacts.DOC2VEC_MODEL + ".infer_progress"


def _ensure_serve_cache(model: Doc2VecModel) -> None:
    """Refresh the mmap'd serving sidecar only if it doesn't match the (reused,
    untouched) model pickle — e.g. the prior run crashed before writing it."""
    from ..utils.sidecar_cache import read_manifest

    path = artifacts.DOC2VEC_MODEL
    try:
        manifest = read_manifest(Doc2VecModel.serve_cache_dir(path))
        if (manifest is not None
                and manifest.get("fp") == Doc2VecModel._serve_cache_fp(path)):
            return
        model.write_serve_cache(path)
    except OSError:
        pass


def _build(args, cfg: Doc2VecConfig, processed_docs, device: DeviceLike,
           mesh: Optional[Mesh]) -> None:
    if args.update:
        if args.epochs is not None:
            # appended vectors must be inferred with the stored model's epochs,
            # or the index rows disagree with query-time re-inference
            print("WARNING: --epochs is ignored with --update (the loaded model's "
                  "training/inference settings apply); rebuild without --update to "
                  "change epochs")
        dictionary = TagDictionary.load(artifacts.DOC2VEC_DICTIONARY)
        model = Doc2VecModel.load(artifacts.DOC2VEC_MODEL, device=device)
        model.mesh = mesh  # --data-parallel shards the append-inference pass too
        index = SimilarityIndex.load(artifacts.DOC2VEC_INDEX, mmap=None)
        before = artifacts.count_non_empty_lines(artifacts.DOC2VEC_IDX_CSV_BAK)
        print(f"update index: {len(processed_docs) - before} files")
        new_docs = processed_docs[before:]
    else:
        dictionary = TagDictionary(processed_docs)
        dictionary.save(artifacts.DOC2VEC_DICTIONARY)
        # checkpoint_path is passed even with snapshots disabled: it also
        # names the finished artifact that a rerun on identical inputs reuses
        model = Doc2VecModel.train(
            processed_docs, cfg, log_every=10,
            checkpoint_path=artifacts.DOC2VEC_MODEL,
            checkpoint_every=args.checkpoint_every,
            reuse_finished=not args.no_reuse_model,
            device=device, mesh=mesh,
        )
        if model.reused_finished:
            # the on-disk pickle IS this model: rewriting it would only
            # invalidate the serve cache it already has
            _ensure_serve_cache(model)
        else:
            model.save(artifacts.DOC2VEC_MODEL)
            try:  # best-effort: serving rebuilds it
                model.write_serve_cache(artifacts.DOC2VEC_MODEL)
            except OSError:
                pass
        index = None
        new_docs = processed_docs

    # per-doc infer_vector, batched on the device (the reference loops one doc
    # at a time — genmodel.py:168-173)
    if new_docs:
        vectors = _infer_vectors_resumable(model, new_docs)
        if index is None:
            index = SimilarityIndex(artifacts.DOC2VEC_INDEX, num_features=cfg.vector_size)
        index.add_documents(list(vectors))
    # new_docs is empty only under --update, which loaded an index
    index.save(artifacts.DOC2VEC_INDEX)
    # the inference results are now durable downstream; drop the slice files
    shutil.rmtree(_infer_progress_dir(), ignore_errors=True)

    # BM25 is always regenerated from the full corpus (genmodel.py:134,177)
    stats = build_bm25_stats(processed_docs, dictionary)
    save_bm25_artifacts(stats)
    # the mmap'd serving cache, derived while the stats are in memory, so the
    # first engine start skips the corpus unpickle (best-effort)
    try:
        BM25DeviceIndex.from_stats(
            stats, vocab_size=len(dictionary), cfg=DEFAULT_CONFIG.bm25
        ).write_cache(".", cfg=DEFAULT_CONFIG.bm25)
    except OSError:
        pass


def _console() -> None:
    """pip console-script entry (pyproject [project.scripts])."""
    main(sys.argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
