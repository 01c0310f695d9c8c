#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port (anime_illust_image_searcher_tpu_torch) only; it imports nothing
of JAX or of the JAX package. Every phase is fatal on failure:

  1. build   — print the card's name and power limit, build every CUDA kernel
               from the sources in this checkout (nvcc, sm_90a);
  2. kernels — hold each kernel against its plain PyTorch version on the card at
               the shapes the main path gives it, the edges of its tiling and
               the head-split views the model hands it, and time the kernel,
               the plain version and the library call that computes the same
               function (``library_ms``) at the main path's B=32 shape;
 2c. f32     — the f32 attention kernel (csrc/flash_attention_f32.cu) against
               its plain f32 version (within 1e-5) and f64 (its error at most
               twice the plain version's plus 1e-6) at Dh=64, S = 1, 63, 64,
               65, 127, 128, 129, 257, 1025 and on head-split views, and at
               Dh=32 on qkv views with garbage past S (S = 1, 63, 64, 65, 129,
               144, 576, and B=64 at S=144); then held and timed in turns with
               SDPA f32 (its error against plain printed beside its time), the
               plain version and two bounds, the products as 3 TF32 passes on
               the tensor cores (the kernel's design, the bound it is held to)
               and as FFMA, at the EVA02-L layer (B=32) and the CAFormer-24
               stage 3 and 4 layers (B=64);
  3. parity  — a full-width, depth-2 EVA02 with one set of seeded weights: the
               card (bf16, kernel) against the CPU (f32, plain), probabilities
               within 2e-2;
 3b. parity f32 — the same model in f32 on both sides, the card through the
               f32 kernel: logits within 5e-5 x max(1, |logit|);
  4. main    — TaggerPredictor on the card at full width (WD-EVA02-Large: 448²,
               24 blocks, 1024-d, 16 heads, 10861 classes), seeded weights,
               synthetic labels, B=256: a warm-up, 3 timed batches through the
               CLI's depth-1 pipeline, 2 forwards timed on the card; prints
               img/s and MFU;
  5. cli     — cli.tagging.Predictor.process_directory on 7 images at B=4 (the
               tail batch is padded): 7 tag lines.
 4b. f32 tagging — phases 4 and 5 again with TaggerConfig(compute_dtype=
               "float32") at B=64, one forward under torch.profiler (device
               ms by kernel group): img/s, the f32 kernel's launches (24 a
               forward) and none of the bf16 kernel's.
  6. profile — one B=256 predict under torch.profiler: device time by kernel.
 16. tagging end to end (runs after 6) — the port's decode library: g++ and
               its headers probed, runtime/ingest.cpp built (fatal if the
               toolchain is there and the build fails); a seeded corpus of
               768 illustration-like images (800-2400 px a side, 75% JPEG
               q90 baseline/progressive, 25% PNG RGB/RGBA/palette) written by
               a spawned process pool; decode img/s with no model for Pillow
               threads, the native pool, the native pool scaled, and the
               subprocess pool at 2 and 4 workers, with gates: native equal
               to Pillow on every image, scaled within a mean of 2/255 of
               full, subprocess batches equal to in-process; int8 gates: the
               ``torch._int_mm`` product equal to the exact plain product at
               EVA02-L's Linear shapes (padded 2730 included), a depth-2
               full-width int8 EVA02 on the card against the CPU within 2e-2;
               then ``cli.tagging.Predictor.process_directory`` at full width,
               B=256, over the corpus with Pillow, native, and native +
               AIIS_INT8=1 (img/s from the listing to the last tag line, the
               two full-decode tag files byte-equal), the bf16 and int8
               forwards on CUDA events, the int8 forward's device time by
               group (``_int_mm``, quantize/rescale, the rest), and a
               ``cli.tagging --profile`` run (`tagging e2e {json}`, `int8 {json}`).
  7. query kernels — the query-scores kernel (cosine matvec + BM25 comparison
               sweep + exclude/require hit counts) against its plain version
               at edge shapes (D, W, Q, B, F), with unused slots, sentinel
               ids, required/excluded terms and duplicate rows, and at the
               edges of its row ring (ragged last tiles, a base the bulk copy
               cannot take, 8 queries with one id list or disjoint lists, the
               largest shared memory), each query of a batch equal alone; then
               times at D=1M, F=300, W=32 for B=1/8 and Q=8/64/256 beside the
               plain version and the bound, the kernel's launch plan and
               ptxas registers. Then the matvecs kernel (the rerank product
               and every 1 - cos: csrc/query_scores.cu's second kernel)
               torch.equal to the old route (the query-scores kernel with no
               term slots) at every B in 1..8 for D = 1, 31, 33, 97, 100,003
               and F = 1, 7, 300, 768 (duplicate rows bit-equal) and at bases
               that are not 16-byte aligned, within QUERY_TOL of the plain
               version, each query alone equal to its batch; timed at D=1M,
               B=1, F=300 and F=768 in turns with the old route and
               ``torch.mv``, and at F=300, B=8 with the old route and
               ``torch.mm`` (beside the plain version); its launch plan and
               ptxas registers;
  8. query main — a 1M-doc artifact chain (300-d rows, Zipf-like 10k-tag
               vocabulary, 10-30 tags a doc, 500 long docs spilling into the
               COO overflow) written in the loaders' formats with its BM25
               serve cache, loaded by the port's WebUIServer into its
               SearchEngine on the card; gates: kernel path vs plain path on
               4 queries, exact vs prefix program on 1, and the two programs'
               costs at B=1 and B=8; then 256 single queries
               (find_similar_documents + search), 32 batches of 8
               (find_similar_documents_batch), a 40-term and a 200-term query:
               engine ms p50/p99, each dispatch's CUDA-event ms, a profiled
               window (busy share, the K5 kernels' share of device time);
  9. serve   — the web server over the same engine, from a client process:
               a burst of 16 concurrent /api/search requests, then 16 threads
               sending 32 requests each; requests/s, latency p50/p99, every
               answer equal to engine.search.
 2b. dh32    — the attention kernel at head dim 32 against its plain version
               at S = 1, 63, 64, 65, 127, 128, 129, 144, 576 on the head-split
               views of a (B, N, 3C) qkv buffer with garbage past S, then at
               the CAFormer's B=64 shapes (H=10, S=576 and H=16, S=144): held
               against the plain version, then timed beside SDPA, the plain
               version and the bound;
 10. ccip parity — the CAFormer at full width (384², dims 64/128/320/512,
               heads 10/16) and depth (1, 1, 2, 1), one set of seeded weights:
               the card (bf16, kernel) against the CPU (f32, plain), unit
               features within 5e-3 and each cosine at least 0.9995;
 10b. ccip f32 — the same CPU features against the card's f32 model through
               the f32 kernel, unit features within 5e-5; then CAFormer-24 in
               f32 (an explicit f32 model config) at B=64 through
               CCIPPredictor.ccip_extract_device: a warm-up, 3 batches, the
               forward on CUDA events, one forward under torch.profiler
               (device ms by kernel group), 18 f32 launches a forward;
 11. ccip main — CAFormer-24 at full width, B=64, seeded weights, through
               CCIPPredictor.ccip_extract_device: a warm-up, 3 batches through
               gen_cfeatures' depth-1 pipeline (img/s end to end), the
               forward alone on CUDA events, and one forward under
               torch.profiler (device time by kernel group);
 12. gen_cfeatures — cli.gen_cfeatures on 200 generated images at B=64 (a
               tail batch of 8), then an --after revision; the rows held
               against direct extraction, the revision's copied rows verbatim;
 13. character — character mode over phase 8's 1M-doc chain, given a
               cfeature index of 1M seeded 768-d rows (3.07 GB f32 on the
               card, clusters around each query's top-10 so that matches
               exist) and the top-10 files on disk: 64 single character
               queries through the engine (p50/p99), the first one's 1 - cos
               over every row and its candidates held against the plain
               version at F=768, one-dispatch answers
               equal to two-dispatch answers, 4 queries with a stale top-10
               file (the live CAFormer forward at k=10), and 16 character
               requests through the web server, each equal to engine.search.
 15. ccip onnx — CCIP from the published files' layout (runs after 13,
               before 14): phase 11's seeded CAFormer-24 written as an
               export-style model_feat.onnx (folded ``onnx::MatMul_N``
               weights, weight-less attention MatMuls, a Gemm head), an
               absdiff-MLP model_metrics.onnx (F=768, H=1024) and a
               metrics.json, converted by cli.convert_ccip; the converted
               weights and CCIPPredictor(model_dir) features equal the seeded
               model's bit for bit, gen_cfeatures --model-dir on phase 12's
               PNGs gives phase 12's rows, the learned metric on phase 13's 1M
               cfeature rows is held against the numpy executor on 4,096
               rows and timed (its peak memory too), 64 character queries
               run through the engine with it; then, with 1 - cos, 32 bursts
               of 8 through the batched character program (each answer the
               single-query answer), 16 client threads of character requests
               through the web server (`ccip convert`, `learned metric`,
               `character batch` JSON lines, the last with both K5 kernels'
               launches by form and B, and the matvecs kernel at B = 2, 4, 8
               on the cfeature rows held to the old route's bits and timed in
               turns with it and ``torch.mm``).
 17. data parallel — --data-parallel's path (runs after 13, before 15, while
               phase 12's PNGs exist): (a) TaggerPredictor at full width, B=256,
               with no mesh, with ``make_mesh()`` (the card) and with a mesh
               that names the card twice: a warm-up forward (24 launches a
               shard), 3 batches through the CLI's depth-1 pipeline (img/s),
               2 forwards on CUDA events; the one-card mesh's probabilities
               and lines bit-equal to no mesh, each half of the two-entry
               mesh bit-equal to that half run alone, the two-entry mesh
               within 2e-2 of the full batch; (b) cli.tagging over phase 5's 7
               images at B=4 with and without --data-parallel, the tag files
               byte-equal; (c) the same three ways for CAFormer-24 at B=64 (18
               launches a shard forward, unit features within 5e-3 of the
               full batch), then cli.gen_cfeatures over phase 12's PNGs with
               and without the flag, every file byte-equal (the extraction
               stamp held); (d) a 1M-row, 300-d seeded unit index (1.2 GB)
               sharded over 1, 2 and 4 entries of the card: 16 queries'
               top-100 ids and scores and the scores of every row bit-equal
               to one unsharded ``matvecs`` + ``exact_top_k``, the kernel
               within 1e-5 of ``plain_matvecs``, top_k p50 ms a shard count;
               (e) an NCCL process group of one (``initialize`` from
               MASTER_ADDR/MASTER_PORT, WORLD_SIZE=1, RANK=0), its
               ``process_info``, the index over it equal to (d), the group
               destroyed (`data parallel {json}`).
 18. sharded engine (runs after 17, before 15) — SearchEngine(mesh=) over
               phase 8's chain and phase 13's 1M × 768 cfeature index, served
               by WebUIServer(mesh=) over 1, 2 and 4 entries of the card (each
               engine takes phase 13's loaded reranker), then an NCCL group of
               one at 2 shards: 256 single queries, 32 batches of 8, the raw
               exact-program rows of 16 queries, 64 character queries and 8
               bursts of 8 through the one-dispatch program, each answer
               bit-equal to phase 8's unsharded engine (the group: 64, 8, 16,
               16, 2); 64 requests served through each mesh's server, each
               equal to engine.search; engine p50/p99 single and a batch of 8,
               character p50, requests/s, a profiled window of 8 queries
               (busy share, host waits), beside the unsharded engine's
               (`sharded engine {json}`).

14. index build — the port's Doc2Vec and genmodel. Gates on a 20,000-doc
               tags file from the phase-8 generators (a 10,000-tag Zipf-like
               vocabulary, 10-30 tags a doc): a training step's and an
               inference epoch's draws (uniforms, keep masks, negatives)
               equal on card and CPU; genmodel --epochs 2 twice on the card,
               every artifact byte-equal; 2,000 docs trained (2 epochs) and
               256 inferred (100 epochs) on card and CPU within 1e-5; 8
               queries through an engine on the built chain, batched equal
               to engine.search. Then the published defaults (dim 300,
               negative 5, max_doc_len 128, batch 512) on phase 8's 1M-doc
               collection: a step profile (ms on CUDA events, device ms by
               group, busy share, kernels a step), Doc2VecModel.train for as
               many epochs as ~30 s allow (the depth cut) and inference over
               16,384 docs at infer_epochs=100 (`index build {json}`). Last,
               over phase 8's chain, 16 queries each through AIIS_REFERENCE_PRF=1
               (an engine of its own), 300-term queries (the multi-call PRF)
               and the default path (still the fused program, no inference):
               engine ms p50/p99, every answer equal to engine.search
               (`reinfer {json}`).
 19. data-parallel Doc2Vec (runs after 14) — Doc2VecModel.train at the
               published defaults on phase 14's 1M-doc collection, one epoch
               (the depth cut), then infer_vectors over 4,096 of its docs at
               infer_epochs=100, with no mesh, over [cuda:0, cuda:0] and over
               an NCCL group of one at 2 shards: docvecs, syn1neg and the
               inferred vectors of each mesh bit-equal to no mesh (or, the
               bits kept in the line, within rtol 1e-4 / atol 1e-5, JAX's own
               dp tolerance); ms a step on CUDA events, the set-up, inference
               docs/s, the busy share of a profiled 20-step training
               window, and the bytes gathered a step. Then genmodel --data-parallel on phase 14's 20,000-doc
               gate corpus: every file but the model pickle and its
               fingerprint (marked ``:dp<n>``) byte-equal to phase 14's
               plain build; and train_gather_bf16 on 1,024 docs: the card
               within 1e-5 of the CPU and of the card twice, and apart from
               the f32 gathers (`dp doc2vec bf16 {json}`, then `dp doc2vec
               {json}` with the phase's wall time).
 20. packaging (runs last) — packaging/build_zipapp_torch.py builds the
               port's zipapp from this checkout; a process with PYTHONPATH set
               to the archive alone, a fresh XDG_CACHE_HOME and a temporary cwd
               (its package's __file__ inside the archive) builds the three
               kernels from sources extracted out of the archive (timed), then
               runs cli.cmd_run's tagging --dir on phase 5's 7 images (full
               width, seeded, --batch-size 4), genmodel on a copy of phase
               14's 20,000-doc gate tags file, gen_cfeatures --dir on 16 of
               phase 12's PNGs (the extraction stamp held) and a WebUIServer
               answering 8 queries from a client thread; a process with the
               checkout on PYTHONPATH runs the same but genmodel. Gates: the
               tag file and the cfeature files byte-equal to the tree's,
               genmodel's artifacts byte-equal to phase 14's build, every
               served answer equal to engine.search, each kernel library built
               in the fresh cache under the tree's file name, 48 Dh=64, 18 Dh=32
               and as many query-scores as matvecs launches from the archive. Then
               CAFormer(fast_variance=True) at full width, depth (1, 1, 2, 1),
               B=8, bf16 and f32 on the card against the CPU within phases 10's
               and 10b's tolerances, and tools/quant_report_torch.py --batch 32
               at full width (`packaging {json}`, then `packaging
               fast_variance {json} quant {json}`).
 21. the model hub (runs last) — ``--model-repo`` through a stand-in
               ``huggingface_hub`` (this script's ``StubHub``, in
               ``sys.modules`` for the phase only: the card's machine has
               neither the package nor a network) over local directories that
               stand for the repos, with ``$AIIS_MODEL_CACHE`` a fresh
               directory. The tagger: a seeded full-width WD-EVA02-Large
               ``model.safetensors`` (F32, timm names, the published layout;
               its shapes detect as ``Eva02Config()``) and a 10,861-row
               ``selected_tags.csv``; cli.tagging on phase 5's 7 images at B=4
               with ``--model-dir`` on them, then ``--model-repo`` (one
               snapshot into the cache), then ``--model-repo`` again (a cache
               hit: no hub call), the three tag files byte-equal. CCIP: phase
               15's model_feat.onnx and metrics.json as
               ``deepghs/ccip_onnx``; cli.gen_cfeatures ``--model-repo`` on
               phase 12's 200 PNGs downloads and converts into the cache:
               config.json byte-equal to phase 15's converted one, its
               threshold, the rows within 1e-6 of phase 15's ``--model-dir``
               rows, and a second fetch calls no hub. Offline: with
               ``sys.modules["huggingface_hub"] = None`` and an empty cache,
               both CLIs' ``--model-repo`` raise a RuntimeError naming
               --model-dir and write nothing. The checkpoint write, the
               fetches (and the conversion) and each CLI run are timed (`hub
               {json}`).

The kernel launch counts are set to 0 just before the path that runs them and
read just after it: the bf16 attention kernel at Dh=64 around phases 4-5 and
around phase 16's end-to-end runs (24 launches per forward), at Dh=32 around
phases 11-13 (18 launches per CAFormer forward) and around phase 15; the f32
attention kernel (its own counts) at Dh=64 around phase 4b and at Dh=32
around phase 10b's CAFormer-24 run, each window also checking that the other
dtype's kernel did not launch; the two K5 kernels, query-scores and matvecs,
each with its own count, around phases 8-9's served traffic (one launch of
each per dispatch of the fused program, counted in each phase), around phase
13 (one of each per character pass of 1 to 8 queries, one more matvecs launch
per second dispatch) and around phase 15. Phase 17 sets the attention counts
to 0 at its start and the K5 counts after its unsharded references: 24 Dh=64
launches a shard forward of the tagger, 18 Dh=32 launches a shard forward of
the CAFormer, one matvecs launch (B=1) a shard a sharded ``top_k`` or
``scores`` call and no query-scores launch. Phase 18 sets the K5 counts to 0
before each mesh's work and reads them after: one launch of each a shard for
each normal dispatch and for each one-dispatch character pass, one more
matvecs launch for each full-diffs dispatch, and one of each a shard for each
served dispatch. Phase 20's archive process sets every count to 0 before each
CLI run and reads it after; phase 21 sets the attention counts to 0 before
each CLI run and reads them after (24 Dh=64 launches a tagger forward, 18
Dh=32 launches a CAFormer forward).
The last two lines are a ``kernels`` JSON object and the device line
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import fnmatch
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
GFLOP_PER_IMAGE = 723.5        # EVA02-L matmul FLOPs per 448² image (ARCHITECTURE.md §7a)
KERNEL_TOL = 2e-2              # max |kernel - plain bf16| on N(0,1) inputs
PARITY_TOL = 2e-2              # max |probs bf16 card - probs f32 CPU|
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # H100 SXM dense TF32 on the tensor cores
F32_PASSES = 3                 # TF32 products a product of the f32 attention kernel
N_SMS, EXP2_PER_CLK_SM = 132, 16   # H100 SXM SMs; MUFU ex2 throughput a clock per SM
QUERY_TOL = 1e-5               # |kernel - plain| <= QUERY_TOL * max(1, |plain|): f32 sums
                               # taken in another order
MAGIC = 1000                   # SearchConfig.require_tag_magic_number
# the query phases' sizes and device (a rehearsal on the CPU shrinks them)
DEV = "cuda"
CHECK_DOCS = (1, 31, 33, 1000, 100_003)   # phase 7's edge shapes
QUERY_DOCS = 1_000_000                    # phases 7-9, 13: the collection a user reaches
CCIP_TOL = 5e-3           # max |unit feature card bf16 - CPU f32|: an element of a unit
                          # 768-d vector is about 0.036; phase 10 reads 1.3e-3
CCIP_MIN_COS = 0.9995     # min cosine of a card feature with its CPU twin
CHARACTER = "character oriented"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def max_sm_ghz() -> float:
    """The card's maximum SM clock (the MUFU rate scales with it)."""
    return float(smi_line("clocks.max.sm").split()[0]) / 1e3


def attention_bound(b, h, s, dh, elt, sm_ghz, passes=0):
    """(bound ms, bound_by, detail) of one attention launch: q, k, v read and o
    written once at the memory rate; against the operations' peaks, the
    products (4*B*H*S^2*Dh FLOPs: on the tensor cores in bf16, elt 2; in f32,
    elt 4, as ``passes`` TF32 products on the tensor cores, the f32 kernel's
    split precision, or with ``passes=0`` on the FMA pipes, the FFMA figure)
    and the softmax's one exp2 a score on the MUFU (B*H*S^2 at 16 a clock on
    each SM)."""
    flops, exps, nbytes = 4 * b * h * s * s * dh, b * h * s * s, 4 * b * h * s * dh * elt
    if elt == 2:
        t_products, on = flops / PEAK_BF16_FLOPS * 1e3, "tensor cores bf16"
    elif passes:
        t_products, on = passes * flops / PEAK_TF32_FLOPS * 1e3, f"tensor cores {passes} x TF32"
    else:
        t_products, on = flops / PEAK_F32_FLOPS * 1e3, "FFMA f32"
    t_mufu = exps / (N_SMS * EXP2_PER_CLK_SM * sm_ghz * 1e9) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_products, t_mufu, t_bytes)
    return bound, ("bytes" if t_bytes >= max(t_products, t_mufu) else "operations"), dict(
        gflop=flops / 1e9, mega_exp2=exps / 1e6, mb=nbytes / 1e6,
        products_ms=t_products, products_on=on, mufu_ms=t_mufu, bytes_ms=t_bytes)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_attention(torch, fa, q, k, v, label: str) -> float:
    """The kernel against its plain bf16 version and an f32 reference."""
    got = fa.mha_attention(q, k, v).float()
    torch.cuda.synchronize()
    plain = fa.attention_reference(q, k, v).float()
    exact = fa.attention_reference(q.float(), k.float(), v.float())
    err = (got - plain).abs().max().item()
    kern_err = (got - exact).abs().max().item()
    plain_err = (plain - exact).abs().max().item()
    print(f"kernel flash_attention {label}: |kernel-plain|={err:.3e} "
          f"|kernel-f32|={kern_err:.3e} |plain-f32|={plain_err:.3e}", flush=True)
    check(torch.isfinite(got).all().item(), f"non-finite kernel output at {label}")
    check(err <= KERNEL_TOL, f"kernel vs plain {err} > {KERNEL_TOL} at {label}")
    check(kern_err <= 2 * plain_err + 1e-3,
          f"kernel error vs f32 {kern_err} > 2*{plain_err}+1e-3 at {label}")
    return err


def phase_kernels(torch, fa, gen, sm_ghz) -> dict:
    """Kernel vs plain at the EVA02 shape, the tiling's edges (64-key tiles,
    128 query rows a block) and head-split views, then timings at B=32."""
    max_err = 0.0
    shapes = [(4, 16, 1025, 64), (2, 16, 100, 64), (2, 16, 257, 64)]
    shapes += [(2, 16, s, 64) for s in (1, 64, 65, 127, 128, 129)]
    for b, h, s, dh in shapes:
        q, k, v = (torch.randn(b, h, s, dh, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        max_err = max(max_err, check_attention(torch, fa, q, k, v, f"B={b} H={h} S={s} Dh={dh}"))
    b, s = 2, 1025          # the model's layout: heads split off a (B, S, 1024) projection
    q, k, v = (torch.randn(b, s, 16 * 64, generator=gen, device="cuda").to(torch.bfloat16)
               .view(b, s, 16, 64).transpose(1, 2) for _ in range(3))
    max_err = max(max_err, check_attention(torch, fa, q, k, v, f"head-split views B={b} S={s}"))

    b, h, s, dh = 32, 16, 1025, 64          # one EVA02-L layer at B=32
    q, k, v = (torch.randn(b, h, s, dh, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # in turns (kernel, sdpa, sdpa, kernel), each the mean of 20 launches
    kernel_runs, sdpa_runs = [cuda_ms(lambda: fa.mha_attention(q, k, v), iters=20)], []
    sdpa_runs += [cuda_ms(lambda: sdpa(q, k, v), iters=20) for _ in range(2)]
    kernel_runs.append(cuda_ms(lambda: fa.mha_attention(q, k, v), iters=20))
    ms, library_ms = sum(kernel_runs) / 2, sum(sdpa_runs) / 2
    plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v), iters=5)
    bound_ms, bound_by, detail = attention_bound(b, h, s, dh, q.element_size(), sm_ghz)
    print(f"kernel flash_attention B={b} H={h} S={s} Dh={dh}: kernel {ms:.4f} ms "
          f"(runs {kernel_runs[0]:.4f}, {kernel_runs[1]:.4f}), "
          f"{detail['gflop'] / ms:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; "
          f"sdpa {library_ms:.4f} ms (runs {sdpa_runs[0]:.4f}, {sdpa_runs[1]:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) " + json.dumps(detail),
          flush=True)
    return dict(name="flash_attention", route="cuda",
                source="anime_illust_image_searcher_tpu_torch/csrc/flash_attention.cu",
                replaces="anime_illust_image_searcher_tpu/ops/flash_attention.py:109",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def qkv_views(torch, gen, b, h, s, pad=0, dtype=None):
    """The CAFormer mixer's q, k, v: head-split views of a (B, S, 3C) bf16 (or
    ``dtype``) projection (C = 32 H), with ``pad`` rows of garbage past S."""
    c = 32 * h
    buf = torch.randn(b, s + pad, 3 * c, generator=gen, device="cuda").to(
        dtype or torch.bfloat16)
    return buf[:, :s].view(b, s, 3, h, 32).permute(2, 0, 3, 1, 4).unbind(0)


def phase_kernels_dh32(torch, fa, gen, sm_ghz) -> dict:
    """Head dim 32 (the 64-byte swizzle) against its plain version at the
    tiling's edges and the CAFormer's token counts, on qkv views with garbage
    past S; then, at the CAFormer-24 shapes at B=64 (multi-wave grids), held
    against the plain version and timed in turns with SDPA.
    The ``kernels`` entry is the stage-3 shape (15 of a forward's 18 calls)."""
    max_err = 0.0
    for s in (1, 63, 64, 65, 127, 128, 129, 144, 576):
        for h in ((10, 16) if s in (144, 576) else (10,)):
            q, k, v = qkv_views(torch, gen, 2, h, s, pad=7)
            max_err = max(max_err, check_attention(
                torch, fa, q, k, v, f"qkv views B=2 H={h} S={s} Dh=32"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    for label, (b, h, s) in (("stage3", (64, 10, 576)), ("stage4", (64, 16, 144))):
        q, k, v = qkv_views(torch, gen, b, h, s, pad=7)
        max_err = max(max_err, check_attention(
            torch, fa, q, k, v, f"qkv views B={b} H={h} S={s} Dh=32"))
        runs = [cuda_ms(lambda: fa.mha_attention(q, k, v), iters=50)]
        lib_runs = [cuda_ms(lambda: sdpa(q, k, v), iters=50) for _ in range(2)]
        runs.append(cuda_ms(lambda: fa.mha_attention(q, k, v), iters=50))
        plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v), iters=3)
        bound_ms, bound_by, detail = attention_bound(b, h, s, 32, 2, sm_ghz)
        ms = sum(runs) / 2
        shapes[label] = dict(B=b, H=h, S=s, ms=ms, runs=runs, sdpa_ms=sum(lib_runs) / 2,
                             sdpa_runs=lib_runs, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, share_of_bound=bound_ms / ms, **detail)
    print("kernel flash_attention Dh=32 " + json.dumps(dict(max_abs_err=max_err, sm_ghz=sm_ghz,
                                                             **shapes)), flush=True)
    s3 = shapes["stage3"]
    return dict(name="flash_attention_dh32", route="cuda",
                source="anime_illust_image_searcher_tpu_torch/csrc/flash_attention.cu",
                replaces="anime_illust_image_searcher_tpu/ops/flash_attention.py:109",
                max_abs_err=max_err, ms=s3["ms"], plain_ms=s3["plain_ms"],
                bound_ms=s3["bound_ms"], bound_by=s3["bound_by"], library_ms=s3["sdpa_ms"])


F32_KERNEL_TOL = 1e-5     # max |f32 kernel - plain f32| on N(0,1) inputs


def f64_attention(torch, q, k, v):
    """Attention in f64: the yardstick of the f32 kernel and its plain version."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v)


def check_attention_f32(torch, fa, q, k, v, label: str) -> float:
    """The f32 kernel against its plain f32 version (within 1e-5) and f64 (its
    error at most twice the plain version's plus 1e-6)."""
    got = fa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    plain = fa.attention_reference(q, k, v)
    exact = f64_attention(torch, q, k, v)
    err = (got - plain).abs().max().item()
    kern_err = (got.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    print(f"kernel flash_attention_f32 {label}: |kernel-plain|={err:.3e} "
          f"|kernel-f64|={kern_err:.3e} |plain-f64|={plain_err:.3e}", flush=True)
    check(got.dtype == torch.float32 and torch.isfinite(got).all().item(),
          f"f32 kernel output not finite f32 at {label}")
    check(err <= F32_KERNEL_TOL, f"f32 kernel vs plain {err} > {F32_KERNEL_TOL} at {label}")
    check(kern_err <= 2 * plain_err + 1e-6,
          f"f32 kernel error vs f64 {kern_err} > 2*{plain_err}+1e-6 at {label}")
    return err


def phase_kernels_f32(torch, fa, gen, sm_ghz) -> list:
    """Phase 2c: the f32 kernel against its plain f32 version and f64 at the
    card tests' shapes (Dh=64 at the tiling's edges and on head-split views,
    Dh=32 on qkv views with garbage past S), then held and timed at the three
    main-path shapes in turns with SDPA f32 (whose error against the plain
    version is printed beside its time), the plain version and two bounds:
    the products as ``F32_PASSES`` TF32 passes on the tensor cores (the bound
    the kernel is held to) and as FFMA.
    Returns the ``kernels`` entries: Dh=64 (EVA02) and Dh=32 (stage 3)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 matmuls")
    max_err = {64: 0.0, 32: 0.0}
    for s in (1, 63, 64, 65, 127, 128, 129, 257, 1025):
        q, k, v = (torch.randn(2, 16, s, 64, generator=gen, device="cuda") for _ in range(3))
        max_err[64] = max(max_err[64], check_attention_f32(torch, fa, q, k, v,
                                                           f"B=2 H=16 S={s} Dh=64"))
    x = torch.randn(3, 2, 1025, 16 * 64, generator=gen, device="cuda")
    q, k, v = (t.view(2, 1025, 16, 64).transpose(1, 2) for t in x)
    max_err[64] = max(max_err[64], check_attention_f32(torch, fa, q, k, v,
                                                       "head-split views B=2 S=1025"))
    for b, h, s in ([(2, 2, s) for s in (1, 63, 64, 65, 129)]
                    + [(2, 16, 144), (2, 10, 576), (64, 16, 144)]):
        q, k, v = qkv_views(torch, gen, b, h, s, pad=7, dtype=torch.float32)
        max_err[32] = max(max_err[32], check_attention_f32(
            torch, fa, q, k, v, f"qkv views B={b} H={h} S={s} Dh=32"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    for label, (b, h, s, dh) in (("eva02", (32, 16, 1025, 64)), ("stage3", (64, 10, 576, 32)),
                                 ("stage4", (64, 16, 144, 32))):
        if dh == 64:
            q, k, v = (torch.randn(b, h, s, dh, generator=gen, device="cuda") for _ in range(3))
        else:
            q, k, v = qkv_views(torch, gen, b, h, s, pad=7, dtype=torch.float32)
        max_err[dh] = max(max_err[dh], check_attention_f32(
            torch, fa, q, k, v, f"B={b} H={h} S={s} Dh={dh}"))
        plain = fa.attention_reference(q, k, v)
        sdpa_err = (sdpa(q, k, v) - plain).abs().max().item()
        del plain
        iters = 10 if dh == 64 else 30
        runs = [cuda_ms(lambda: fa.mha_attention(q, k, v), iters=iters)]
        lib_runs = [cuda_ms(lambda: sdpa(q, k, v), iters=iters) for _ in range(2)]
        runs.append(cuda_ms(lambda: fa.mha_attention(q, k, v), iters=iters))
        plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v), iters=3)
        bound_ms, bound_by, detail = attention_bound(b, h, s, dh, 4, sm_ghz, F32_PASSES)
        ffma_bound_ms, ffma_bound_by, ffma = attention_bound(b, h, s, dh, 4, sm_ghz)
        ms = sum(runs) / 2
        shapes[label] = dict(B=b, H=h, S=s, Dh=dh, ms=ms, runs=runs,
                             sdpa_ms=sum(lib_runs) / 2, sdpa_runs=lib_runs,
                             sdpa_max_abs_err_vs_plain=sdpa_err, plain_ms=plain_ms,
                             passes=F32_PASSES, bound_ms=bound_ms, bound_by=bound_by,
                             share_of_bound=bound_ms / ms, ffma_bound_ms=ffma_bound_ms,
                             ffma_bound_by=ffma_bound_by,
                             share_of_ffma_bound=ffma_bound_ms / ms,
                             tflops=detail["gflop"] / ms, ffma_products_ms=ffma["products_ms"],
                             **detail)
        del q, k, v
    torch.cuda.empty_cache()
    print("kernel flash_attention_f32 " + json.dumps(dict(
        max_abs_err=max_err, sm_ghz=sm_ghz, backends_allow_tf32=False, **shapes)), flush=True)
    entries = []
    for name, label, dh in (("flash_attention_f32", "eva02", 64),
                            ("flash_attention_f32_dh32", "stage3", 32)):
        r = shapes[label]
        entries.append(dict(name=name, route="cuda",
                            source="anime_illust_image_searcher_tpu_torch/csrc/flash_attention_f32.cu",
                            replaces="anime_illust_image_searcher_tpu/ops/flash_attention.py:109",
                            max_abs_err=max_err[dh], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["sdpa_ms"], passes=r["passes"],
                            share_of_bound=r["share_of_bound"], ffma_bound_ms=r["ffma_bound_ms"],
                            share_of_ffma_bound=r["share_of_ffma_bound"]))
    return entries


def phase_parity(torch, eva02, tagger) -> None:
    """Full width, depth 2: card (bf16, kernel) vs CPU (f32, plain)."""
    cfg = eva02.Eva02Config(depth=2)
    cpu_model = eva02.Eva02(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    eva02.init_params(cpu_model, seed=0)
    gpu_model = eva02.Eva02(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    imgs = np.random.RandomState(1).randint(0, 256, (2, 448, 448, 3), dtype=np.uint8)
    probs = []
    for model, dev in ((gpu_model.eval(), "cuda"), (cpu_model.eval(), "cpu")):
        half = torch.tensor([0.5, 0.5, 0.5], device=dev)
        with torch.inference_mode():
            p = tagger._predict_probs(model, torch.from_numpy(imgs).to(dev), half, half)
        probs.append(p.float().cpu())
    err = (probs[0] - probs[1]).abs().max().item()
    print(f"parity depth-2 full width, card bf16 vs cpu f32: max|dprob|={err:.3e} "
          f"(tol {PARITY_TOL}), prob spread {probs[1].std().item():.3f}", flush=True)
    check(torch.isfinite(probs[0]).all().item(), "non-finite probs on the card")
    check(err <= PARITY_TOL, f"card vs cpu probs differ by {err} > {PARITY_TOL}")


F32_LOGIT_TOL = 5e-5      # |logit card f32 - CPU f32| <= tol * max(1, |logit|): the off-CPU
                          # f32 bound of tests/test_eva02_oracle.py


def phase_parity_f32(torch, eva02) -> None:
    """Phase 3b: full width, depth 2, f32 on both sides: the card (f32
    kernel) against the CPU (plain), logits within 5e-5 x max(1, |logit|)."""
    cfg = eva02.Eva02Config(depth=2, dtype=torch.float32)
    cpu_model = eva02.Eva02(cfg, device="cpu")
    eva02.init_params(cpu_model, seed=0)
    gpu_model = eva02.Eva02(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy((np.random.RandomState(1).rand(2, 448, 448, 3) * 2 - 1).astype(np.float32))
    logits = [eva02.forward_logits(m.eval(), x.to(dev)).cpu()
              for m, dev in ((gpu_model, "cuda"), (cpu_model, "cpu"))]
    rel = ((logits[0] - logits[1]).abs() / logits[1].abs().clamp_min(1)).max().item()
    print(f"parity f32 depth-2 full width, card f32 kernel vs cpu f32: max|dlogit|/max(1,|logit|)="
          f"{rel:.3e} (tol {F32_LOGIT_TOL}), max|dlogit|="
          f"{(logits[0] - logits[1]).abs().max().item():.3e}, logit spread "
          f"{logits[1].std().item():.3f}", flush=True)
    check(logits[0].dtype == torch.float32 and torch.isfinite(logits[0]).all().item(),
          "non-finite f32 logits on the card")
    check(rel <= F32_LOGIT_TOL, f"card vs cpu f32 logits differ by {rel} > {F32_LOGIT_TOL}")
    del gpu_model
    torch.cuda.empty_cache()


def phase_main(torch, tagger_mod, config_mod, eva02, fa, compute_dtype="bfloat16",
               batch_size=None, profile=False) -> tuple:
    """Full-width tagging (B=256 by default): a warm-up, 3 batches through the
    depth-1 pipeline of cli.tagging (queue batch N, then assemble batch N-1's
    lines), 2 forwards timed on the card alone and, with ``profile``, one
    forward under torch.profiler (device ms by kernel group). With
    ``compute_dtype="float32"`` (phase 4b) the f32 model runs, through the
    f32 attention kernel. Returns (results, forwards run)."""
    f32 = compute_dtype == "float32"
    cfg = config_mod.TaggerConfig(compute_dtype=compute_dtype)
    if batch_size:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    pred = tagger_mod.TaggerPredictor(cfg, device="cuda")
    pred.load_model()
    want_cfg = eva02.Eva02Config(dtype=torch.float32 if f32 else torch.bfloat16)
    check(pred.model_cfg == want_cfg, f"not the full config: {pred.model_cfg}")
    counts = fa.mha_attention.launches_f32 if f32 else fa.mha_attention.launches
    peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
    b = cfg.batch_size
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 256, (b, 448, 448, 3), dtype=np.uint8) for _ in range(3)]
    args = (cfg.general_thresh, cfg.general_mcut_enabled,
            cfg.character_thresh, cfg.character_mcut_enabled)
    before = counts[64]
    warm = pred.predict(batches[0], *args)
    check(counts[64] - before == pred.model_cfg.depth,
          "attention did not launch once per block in one forward")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, pending, host_s = [], None, 0.0
    for imgs in batches:
        devs = pred.predict_device(imgs)
        if pending is not None:
            h0 = time.perf_counter()
            outs.append(pred.finalize(pending, *args))
            host_s += time.perf_counter() - h0
        pending = devs
    check(torch.isfinite(pending[0]).all().item() and pending[0].dtype == torch.float32,
          "non-finite or non-f32 probabilities")
    h0 = time.perf_counter()
    outs.append(pred.finalize(pending, *args))
    host_s += time.perf_counter() - h0
    wall = time.perf_counter() - t0
    check(outs[0] == warm, "two identical batches gave different tag lines")
    check(all(len(o) == b for o in outs), "wrong number of tag lines")

    x = torch.from_numpy(batches[1]).to("cuda")

    def forward():
        pred._forward(x, thresholds=False)

    fwd_ms = cuda_ms(forward, iters=2, warmup=0)
    prof = profile_groups(torch, forward, _kernel_group) if profile else None
    img_s = 3 * b / wall
    res = dict(compute_dtype=compute_dtype, batch=b, batches_timed=3, seconds=wall,
               img_s=img_s, mfu=img_s * GFLOP_PER_IMAGE * 1e9 / peak,
               mfu_of=f"{peak / 1e12:.0f} TFLOP/s {'f32' if f32 else 'bf16'}",
               finalize_s_per_batch=host_s / 3,
               tags_per_line=float(np.mean([len(l.split(",")) for o in outs for l in o])),
               forward_ms=fwd_ms,
               forward_img_s=b / fwd_ms * 1e3,
               forward_mfu=b / fwd_ms * 1e3 * GFLOP_PER_IMAGE * 1e9 / peak,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if prof is not None:
        res["profile"] = prof
    print(("tagging f32 " if f32 else "tagging ") + json.dumps(res), flush=True)
    del pred, x
    torch.cuda.empty_cache()
    return res, 6 + int(profile)


def write_cli_images(directory: str) -> None:
    """Phase 5's 7 seeded PNGs (300-420 x 200-380 px: padded to square and
    resized) in ``directory``; phase 20 writes the same bytes again."""
    from PIL import Image

    rng = np.random.RandomState(3)
    os.makedirs(directory)
    for i in range(7):
        shape = (300 + 20 * i, 200 + 30 * i, 3)
        Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(
            os.path.join(directory, f"img_{i}.png"))


def phase_cli(torch, tagging, config_mod, compute_dtype="bfloat16") -> int:
    rng = np.random.RandomState(3)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            try:
                from PIL import Image
            except ImportError:
                Image = None
            if Image is not None:
                print("cli: PNG images through Pillow", flush=True)
                write_cli_images("imgs")
                cfg = config_mod.TaggerConfig(batch_size=4, compute_dtype=compute_dtype)
                decode_fn = None
            else:
                print("cli: no Pillow; .npy arrays through PrefetchLoader's decode_fn", flush=True)
                os.makedirs("imgs")
                for i in range(7):
                    np.save(f"imgs/img_{i}.npy", rng.randint(0, 256, (448, 448, 3), dtype=np.uint8))
                cfg = config_mod.TaggerConfig(batch_size=4, extensions=(".npy",),
                                              compute_dtype=compute_dtype)
                decode_fn = np.load
            pred = tagging.Predictor(config=cfg, device="cuda")
            pred.process_directory("imgs", decode_fn=decode_fn)
            with open(cfg.output_file, encoding="utf-8") as f:
                lines = [line for line in f.read().splitlines() if line]
            check(len(lines) == 7, f"cli wrote {len(lines)} lines, expected 7")
            check(all(line.startswith("imgs/img_") for line in lines), "cli line paths")
            print(f"cli ({compute_dtype}): 7 lines, first: {lines[0][:120]}", flush=True)
            del pred
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    return 2   # forwards: one full batch of 4, one padded tail batch


def _kernel_group(name: str) -> str:
    if "attn_fwd" in name:
        return "attention kernel"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "cublas", "nvjet", "Kernel2")):
        return "gemm"
    if "CatArrayBatchedCopy" in name:
        return "cat (rope, cls token)"
    if "conv" in name.lower():
        return "conv"
    if "layer_norm" in name.lower() or "LayerNorm" in name:
        return "layer_norm"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort (mcut)"
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy"
    return "other elementwise/copy"


def phase_profile(torch, tagger_mod, config_mod) -> None:
    """One B=256 predict (H2D, forward, sigmoid) under torch.profiler: device
    time by kernel, from CUDA kernel events only."""
    pred = tagger_mod.TaggerPredictor(config_mod.TaggerConfig(), device="cuda")
    pred.load_model()
    imgs = np.random.RandomState(4).randint(0, 256, (256, 448, 448, 3), dtype=np.uint8)
    pred.predict_probs(imgs)
    out = profile_groups(torch, lambda: pred.predict_probs(imgs), _kernel_group)
    print("profile " + json.dumps(out), flush=True)
    del pred
    torch.cuda.empty_cache()


# ------------------------------------------------------- tagging end to end (16)

E2E_IMAGES = 768          # phase 16's corpus: 3 batches of 256 (cut from 1,024 for time)
E2E_PARTS = 4             # written into this many subdirectories (the first is profiled)
SCALED_TOL = 2.0          # mean |scaled - full decode| of an image (tests/test_native_ingest.py:198)
INT8_TOPS = 1979e12       # H100 SXM dense int8 (NVIDIA data sheet)
# (long side / short side) of portrait, square and landscape illustrations
ASPECTS = (1.0, 4 / 3, 3 / 2, 16 / 9)


def corpus_image(args) -> str:
    """Write image ``i`` of phase 16's corpus and return its path: 800-2400 px
    a side at an illustration's aspect, smooth content (gradients, soft flat
    shapes, mild noise) so that files compress like art; i % 4 == 3 is a PNG
    (RGB, RGBA, palette in turn, compress_level 1), the rest JPEG q90, a third
    of them progressive. Runs in a worker process."""
    from PIL import Image, ImageDraw

    directory, i, seed = args
    rng = np.random.default_rng([seed, i])
    ratio = ASPECTS[int(rng.integers(len(ASPECTS)))]
    short = int(rng.integers(800, int(2400 / ratio) + 1))
    long_ = int(round(short * ratio))
    w, h = (long_, short) if rng.integers(2) else (short, long_)
    lw, lh = max(8, w // 8), max(8, h // 8)
    yy, xx = np.mgrid[0:lh, 0:lw].astype(np.float32)
    chans = []
    for _ in range(3):
        fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / max(lw, lh)
        ph = rng.uniform(0, 2 * np.pi)
        chans.append(128 + 60 * np.sin(xx * fx + ph) + 50 * np.cos(yy * fy - ph)
                     + rng.uniform(-40, 40) * (xx / lw - yy / lh))
    small = Image.fromarray(np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(small)
    for _ in range(int(rng.integers(3, 9))):
        x0, y0 = int(rng.integers(0, lw)), int(rng.integers(0, lh))
        x1, y1 = x0 + int(rng.integers(2, lw // 2 + 3)), y0 + int(rng.integers(2, lh // 2 + 3))
        fill = tuple(int(c) for c in rng.integers(0, 256, 3))
        (draw.ellipse if rng.integers(2) else draw.rectangle)((x0, y0, x1, y1), fill=fill)
    arr = np.asarray(small.resize((w, h), Image.BICUBIC), dtype=np.int16)
    arr = np.clip(arr + rng.integers(-3, 4, arr.shape, dtype=np.int16), 0, 255).astype(np.uint8)
    img = Image.fromarray(arr)
    part = os.path.join(directory, f"part{(i // 4) % E2E_PARTS}")
    if i % 4 == 3:
        path = os.path.join(part, f"img_{i:05d}.png")
        mode = (i // 4) % 3
        if mode == 1:
            alpha = np.clip(np.asarray(small.convert("L").resize((w, h), Image.BICUBIC),
                                       np.int16) * 2 - 64, 0, 255).astype(np.uint8)
            img = Image.fromarray(np.concatenate([arr, alpha[..., None]], -1), "RGBA")
        elif mode == 2:
            img = img.quantize(256)
        img.save(path, compress_level=1)
    else:
        path = os.path.join(part, f"img_{i:05d}.jpg")
        img.save(path, quality=90, progressive=(i // 4) % 3 == 0)
    return path


def write_corpus(directory: str, n: int, seed: int = 16) -> dict:
    """The corpus, written by a process pool (spawned: this process holds a
    CUDA context). Returns its description."""
    import concurrent.futures
    import multiprocessing

    for p in range(E2E_PARTS):
        os.makedirs(os.path.join(directory, f"part{p}"), exist_ok=True)
    t0 = time.perf_counter()
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        paths = list(ex.map(corpus_image, [(directory, i, seed) for i in range(n)],
                            chunksize=4))
    sizes = [os.path.getsize(p) for p in paths]
    return dict(images=n, seconds=time.perf_counter() - t0, writers=workers,
                jpeg=sum(p.endswith(".jpg") for p in paths),
                png=sum(p.endswith(".png") for p in paths), mb=sum(sizes) / 1e6,
                mb_per_image=float(np.mean(sizes)) / 1e6)


def native_probe(native) -> dict:
    """The decode library's toolchain, its build, and the host's cores. A
    toolchain that is present but fails to build or load is fatal; a missing
    one leaves the loaders on Pillow (the JAX package's behaviour)."""
    probe = native.toolchain_probe()
    probe["cpu_count"] = os.cpu_count()
    probe["affinity"] = len(os.sched_getaffinity(0))
    print("native decode probe " + json.dumps(probe), flush=True)
    can_build = bool(probe["gxx"] and probe["jpeglib.h"] and probe["png.h"])
    t0 = time.perf_counter()
    built = native.available()
    probe["build_s"] = time.perf_counter() - t0
    probe["library"] = native.lib_path() if built else None
    if can_build:
        check(built, "the toolchain and headers are present but the native decode "
                     "library did not build or load")
    else:
        print("native decode: no toolchain or headers on this machine; the phase "
              "runs on Pillow", flush=True)
    return probe


def drain(ingest, files, size, batch, **kw) -> dict:
    """Every image of ``files`` through PrefetchLoader (the tagger's decode,
    no model): rows in file order, paths, batch layout, failures, host img/s."""
    rows = np.empty((len(files), size, size, 3), np.uint8)
    paths, layout = [], []
    t0 = time.perf_counter()
    loader = ingest.PrefetchLoader(files, size=size, batch_size=batch, workers=8, **kw)
    for b in loader:
        rows[len(paths):len(paths) + b.valid] = b.images[:b.valid]
        paths += b.paths
        layout.append(b.valid)
    secs = time.perf_counter() - t0
    return dict(rows=rows[:len(paths)], paths=paths, layout=layout,
                failed=loader.failed_count, seconds=secs, img_s=len(files) / secs)


def with_env(env: dict, fn):
    """``fn()`` with the environment variables in ``env`` set, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_decode(ingest, native, files, size, batch) -> tuple:
    """Decode rates over the corpus and the decode gates: the native pool
    bit-equal to the Pillow loader on every image, the scaled decode within
    SCALED_TOL of the full decode, the subprocess pool's batches bit-equal to
    the in-process native producer's at 2 and 4 workers."""
    pil = drain(ingest, files, size, batch, use_native=False)
    check(pil["failed"] == 0 and pil["paths"] == files, "Pillow failed to decode the corpus")
    res = dict(pillow_threads=dict(img_s=pil["img_s"], seconds=pil["seconds"],
                                   threads=min(8, os.cpu_count() or 8)))
    if not native.available():
        # the loaders' native path would decode with Pillow again: skip it
        res["native"] = res["native_scaled"] = dict(skipped="no native decode library")
        nat = pil
    else:
        nat = drain(ingest, files, size, batch)
        check(nat["paths"] == files, "the native loader lost or reordered files")
        bad = [files[i] for i in range(len(files))
               if not np.array_equal(nat["rows"][i], pil["rows"][i])]
        check(not bad, f"native decode differs from Pillow on {len(bad)} images, first {bad[:3]}")
        res["native"] = dict(img_s=nat["img_s"], seconds=nat["seconds"], layout=nat["layout"])
        del pil
        phase_scaled(ingest, files, size, batch, nat, res)
    for procs in (2, 4):
        got = with_env({"AIIS_DECODE_PROC": str(procs)}, lambda: drain(ingest, files, size, batch))
        same_layout = got["layout"] == nat["layout"] or not native.available()
        check(got["paths"] == files and same_layout and np.array_equal(got["rows"], nat["rows"]),
              f"AIIS_DECODE_PROC={procs} batches differ from the in-process batches")
        res[f"subprocess_{procs}"] = dict(img_s=got["img_s"], seconds=got["seconds"])
    print("decode rates " + json.dumps(res), flush=True)
    return res, nat["rows"]


def phase_scaled(ingest, files, size, batch, nat, res) -> None:
    """The scaled decode's rate, and its gate against the full decode."""
    scaled = with_env({"AIIS_SCALED_DECODE": "1"}, lambda: drain(ingest, files, size, batch))
    check(scaled["paths"] == files, "the scaled loader lost or reordered files")
    means = np.array([np.abs(scaled["rows"][i].astype(np.int16) - nat["rows"][i]).mean()
                      for i in range(len(files))])
    res["native_scaled"] = dict(img_s=scaled["img_s"], seconds=scaled["seconds"],
                                mean_abs_diff=float(means.mean()),
                                max_image_mean_abs_diff=float(means.max()),
                                images_changed=int((means > 0).sum()))
    check(means.max() < SCALED_TOL, f"scaled decode off the full decode by a mean "
                                    f"{means.max():.3f} on one image (bound {SCALED_TOL})")


def phase_int8_gates(torch, quant, eva02, tagger) -> dict:
    """The int8 product on the card (torch._int_mm, zero-padded) bit-equal to
    its plain version (an exact f64 product) at EVA02-L's Linear shapes, an
    Int8Linear's output on the card bit-equal to the CPU's, and a full-width
    depth-2 int8 EVA02 on the card (bf16) against the CPU (f32, plain)."""
    gen = torch.Generator(device=DEV).manual_seed(16)
    res = {}
    for m in (2050, 17):
        for k, n in ((1024, 1024), (1024, 2730), (2730, 1024)):
            a = torch.randint(-127, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
            b = torch.randint(-127, 128, (n, k), generator=gen, device=DEV, dtype=torch.int8)
            got, want = quant.int8_mm(a, b), quant.plain_int8_mm(a, b)
            check(got.dtype == torch.int32 and torch.equal(got, want),
                  f"int8_mm differs from its plain version at M={m} K={k} N={n}")
            layer = quant.Int8Linear(k, n, out_dtype=torch.bfloat16, device=DEV)
            layer.set_weight(torch.randn(n, k, generator=gen, device=DEV) * k ** -0.5)
            with torch.no_grad():
                layer.bias.normal_(generator=gen)
            cpu_layer = quant.Int8Linear(k, n, out_dtype=torch.bfloat16)
            cpu_layer.load_state_dict({key: v.cpu() for key, v in layer.state_dict().items()})
            x = torch.randn(m, k, generator=gen, device=DEV).to(torch.bfloat16)
            with torch.inference_mode():
                y, y_cpu = layer(x).cpu(), cpu_layer(x.cpu())
            res[f"M={m} K={k} N={n}"] = dict(
                linear_equal=bool(torch.equal(y, y_cpu)),
                linear_max_abs_diff=(y.float() - y_cpu.float()).abs().max().item())
            check(torch.equal(y, y_cpu), f"Int8Linear on {DEV} differs from the CPU's at "
                                         f"M={m} K={k} N={n}: {res[f'M={m} K={k} N={n}']}")
    # full width, depth 2, one set of seeded f32 weights: the card (bf16,
    # kernels, torch._int_mm) against the CPU's plain version at the same
    # compute dtype (the gate), and beside it the CPU at f32: int8 magnifies
    # the bf16-vs-f32 differences (an activation a bf16 step away from a
    # rounding boundary moves a whole int8 step)
    cfg = eva02.Eva02Config(depth=2, quant="int8")
    f32_model = eva02.Eva02(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    eva02.init_params(f32_model, seed=0)
    bf16_model = eva02.Eva02(cfg, device="cpu")
    dev_model = eva02.Eva02(cfg, device=DEV)
    for model in (bf16_model, dev_model):
        model.load_state_dict(f32_model.state_dict())
    imgs = np.random.RandomState(1).randint(0, 256, (2, 448, 448, 3), dtype=np.uint8)
    probs = []
    for model, dev in ((dev_model, DEV), (bf16_model, "cpu"), (f32_model, "cpu")):
        half = torch.tensor([0.5, 0.5, 0.5], device=dev)
        with torch.inference_mode():
            probs.append(tagger._predict_probs(model.eval(), torch.from_numpy(imgs).to(dev),
                                               half, half).float().cpu())
    err = (probs[0] - probs[1]).abs().max().item()
    res["parity_depth2"] = dict(
        max_abs_dprob_vs_cpu_bf16=err, tol=PARITY_TOL,
        max_abs_dprob_vs_cpu_f32=(probs[0] - probs[2]).abs().max().item(),
        cpu_bf16_vs_cpu_f32=(probs[1] - probs[2]).abs().max().item(),
        prob_spread=probs[2].std().item())
    print("int8 gates " + json.dumps(res), flush=True)
    check(torch.isfinite(probs[0]).all().item(), "non-finite int8 probs on the card")
    for key in ("max_abs_dprob_vs_cpu_bf16", "max_abs_dprob_vs_cpu_f32"):
        got = res["parity_depth2"][key]
        check(got <= PARITY_TOL, f"int8 card vs cpu probs: {key} {got} > {PARITY_TOL}")
    return res


def run_directory(torch, pred, corpus, workdir, output_file, decode_fn=None) -> tuple:
    """cli.tagging's process_directory over the corpus in ``workdir``: the tag
    file's bytes and the seconds from the listing to the last tag line."""
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.process_directory(corpus, decode_fn=decode_fn)
        secs = time.perf_counter() - t0
        with open(output_file, "rb") as f:
            data = f.read()
    finally:
        os.chdir(cwd)
    return data, secs


K11_FUNCTIONS = ("int8_quantize_rows", "int8_mm", "int8_rescale")
K11_GROUPS = ("_int_mm", "int8_mm operand pads", "quantize", "rescale")


def int8_profile(torch, fn, quant, eva02) -> dict:
    """``fn`` (an int8 forward) once under torch.profiler with the port's
    K11_FUNCTIONS in FnLabels ranges: wall ms, device ms, the busy share, and
    every kernel's device ms by the function that launched it: ``_int_mm``
    (the int32 products of ``int8_mm``), the rest of ``int8_mm`` (its operand
    pads), ``quantize`` (``int8_quantize_rows``), ``rescale``
    (``int8_rescale``), and the kernels outside them as ``_kernel_group``
    sorts them, under ``rest:``."""
    from torch.profiler import ProfilerActivity, profile

    # eva02 quantizes the shared q/k/v and w1/w2 input through its own name
    targets = [(quant, f) for f in K11_FUNCTIONS] + [(eva02, "int8_quantize_rows")]
    torch.cuda.synchronize()
    with FnLabels(torch, "k11", targets), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # every kernel once, from the device-side events (the ranges' own spans
    # on the device timeline are left out), by name
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("k11:")
                and not getattr(e, "is_user_annotation", False)):
            g = _kernel_group(e.name)
            by_name[g] = by_name.get(g, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    total = sum(by_name.values())
    # the labelled ones through the aten op that launched each: a kernel also
    # hangs off a runtime event ("Command Buffer Full") where its launch
    # waited for room in the queue, so only aten ops count
    groups = dict.fromkeys(K11_GROUPS, 0.0)
    labelled: dict = {}
    for e in prof.events():
        if not e.kernels or not e.name.startswith("aten::"):
            continue
        label = labelled_function(e, "k11")
        if label is None:
            continue
        if label == "int8_mm":
            in_int_mm = any(name == "aten::_int_mm" for name in op_chain(e, "k11:"))
            g = "_int_mm" if in_int_mm else "int8_mm operand pads"
        else:
            g = "quantize" if label == "int8_quantize_rows" else "rescale"
        for k in e.kernels:
            groups[g] += k.duration / 1e3
            labelled[_kernel_group(k.name)] = (labelled.get(_kernel_group(k.name), 0.0)
                                               + k.duration / 1e3)
    for g, ms in by_name.items():
        groups["rest: " + g] = ms - labelled.get(g, 0.0)
    if DEV == "cuda":
        check(all(groups[g] > 0 for g in ("_int_mm", "quantize", "rescale")),
              f"int8 forward: the profiled groups {groups} lack one")
        check(all(groups[g] > -1e-3 * total for g in groups if g.startswith("rest:"))
              and total <= 1.02 * wall,
              f"int8 forward: a kernel counted twice (groups {groups}, device "
              f"{total} ms, wall {wall} ms)")
    return dict(wall_ms=wall, device_ms=total if total else "not measured",
                busy_share=total / wall if total else "not measured", groups=groups)


def int_mm_shapes(torch, quant, b: int) -> dict:
    """The int8 products alone at EVA02-L's three Linear shapes and batch
    ``b`` (M = 1025 b rows): ``int8_mm`` against a weight padded once (the
    w3 input's K padded per call, as in the model) beside bf16 ``torch.mm``
    at the same shapes, on CUDA events, with each one's rate and bound."""
    m = 1025 * b
    gen = torch.Generator(device=DEV).manual_seed(17)
    shapes = {}

    def timed(fn):
        runs = [cuda_ms(fn, iters=3, warmup=1), cuda_ms(fn, iters=3, warmup=0)]
        return sum(runs) / 2

    for (k, n), count in (((1024, 1024), 4), ((1024, 2730), 2), ((2730, 1024), 1)):
        layer = quant.Int8Linear(k, n, device=DEV)
        layer.set_weight(torch.randn(n, k, generator=gen, device=DEV))
        a8 = torch.randint(-127, 128, (m, k), generator=gen, device=DEV, dtype=torch.int8)
        ms8 = timed(lambda: quant.int8_mm(a8, layer.weight_q))
        del a8
        a16 = torch.randn(m, k, generator=gen, device=DEV).to(torch.bfloat16)
        w16 = torch.randn(k, n, generator=gen, device=DEV).to(torch.bfloat16)
        ms16 = timed(lambda: torch.mm(a16, w16))
        del a16, w16, layer
        ops = 2 * m * k * n
        shapes[f"K={k} N={n}"] = dict(int8_ms=ms8, bf16_ms=ms16, int8_tops=ops / ms8 / 1e9,
                                      bf16_tflops=ops / ms16 / 1e9,
                                      int8_bound_ms=ops / INT8_TOPS * 1e3,
                                      per_forward=24 * count)
    torch.cuda.empty_cache()
    return shapes


def phase_tagging_e2e(torch, tagging, tagger_mod, config_mod, eva02, quant, ingest, native,
                      corpus, rows) -> tuple:
    """cli.tagging.Predictor.process_directory at full width and B=256 over the
    corpus with the Pillow decoder, the native decoder, and the native decoder
    under AIIS_INT8=1, after a warm-up; the forwards alone on CUDA events; a
    --profile run; the int8 forward's device time by group. Returns (result,
    int8 result, forwards run)."""
    cfg = config_mod.TaggerConfig()
    size, b = cfg.image_size, cfg.batch_size
    args = (cfg.general_thresh, cfg.general_mcut_enabled,
            cfg.character_thresh, cfg.character_mcut_enabled)
    pred = tagging.Predictor(config=cfg, device=DEV)
    pred.load_model()
    pred8 = with_env({"AIIS_INT8": "1"}, lambda: tagging.Predictor(config=cfg, device=DEV))
    pred8.load_model()
    if DEV == "cuda":
        check(pred.model_cfg == eva02.Eva02Config(), f"not the full config: {pred.model_cfg}")
    check(pred8.model_cfg == dataclasses.replace(pred.model_cfg, quant="int8"),
          f"AIIS_INT8 did not reach the model: {pred8.model_cfg}")
    depth, forwards = pred.model_cfg.depth, 0
    for p in (pred, pred8):                          # warm-up
        p.predict(rows[:b], *args)
        forwards += 1
    n = len(rows)
    batches = -(-n // b)
    runs, files = {}, {}
    plan = [("pillow", pred, lambda path: ingest.load_rgb_square(path, size))]
    if native.available():          # else the default decode is Pillow again: skipped
        plan.append(("native", pred, None))
    plan.append(("default_int8", pred8, None))
    with tempfile.TemporaryDirectory() as work:
        for name, p, decode_fn in plan:
            data, secs = run_directory(torch, p, corpus, os.path.join(work, name),
                                       cfg.output_file, decode_fn)
            forwards += batches
            files[name] = data
            runs[name] = dict(seconds=secs, img_s=n / secs)
    lines = {k: v.decode().splitlines() for k, v in files.items()}
    check(all(len(v) == n for v in lines.values()),
          f"tag files of {[len(v) for v in lines.values()]} lines, expected {n}")
    check(files["pillow"] == files.get("native", files["pillow"]),
          "the Pillow and native full-decode tag files differ")
    differ = sum(a != c for a, c in zip(lines["pillow"], lines["default_int8"]))
    jaccard = float(np.mean([
        len(set(a.split(",")[1:]) & set(c.split(",")[1:]))
        / max(1, len(set(a.split(",")[1:]) | set(c.split(",")[1:])))
        for a, c in zip(lines["pillow"], lines["default_int8"])]))
    tags_per_line = float(np.mean([len(a.split(",")) - 1 for a in lines["pillow"]]))
    devs = pred.predict_device(rows[:b])
    forwards += 1
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    pred.finalize(devs, *args)
    finalize_s = time.perf_counter() - h0
    del devs

    x = torch.from_numpy(rows[:b]).to(DEV)

    def forward(p):
        def run():
            p._forward(x, thresholds=False)
        return run

    turns = [cuda_ms(forward(pred), iters=1, warmup=0), cuda_ms(forward(pred8), iters=1, warmup=0),
             cuda_ms(forward(pred8), iters=1, warmup=0), cuda_ms(forward(pred), iters=1, warmup=0)]
    forwards += 4
    bf16_ms, int8_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    for name, run in runs.items():
        fwd = int8_ms if name.endswith("int8") else bf16_ms
        run["busy_share_est"] = batches * fwd / 1e3 / run["seconds"]
    shapes = int_mm_shapes(torch, quant, b) if DEV == "cuda" else {}

    prof8 = int8_profile(torch, forward(pred8), quant, eva02)
    prof16 = profile_groups(torch, forward(pred), _kernel_group)
    forwards += 2
    del x, pred, pred8
    torch.cuda.empty_cache()

    # --profile: cli.tagging.main over the first part of the corpus, int8
    with tempfile.TemporaryDirectory() as work:
        trace_dir = os.path.join(work, "trace")
        cwd = os.getcwd()
        os.chdir(work)
        try:
            part0 = os.path.join(corpus, "part0")
            with_env({"AIIS_INT8": "1"}, lambda: tagging.main(
                ["--dir", part0, "--profile", trace_dir], device=DEV))
            part_n = len(ingest.list_files_recursive(part0))
            forwards += -(-part_n // b)
            with open(cfg.output_file, encoding="utf-8") as f:
                check(len(f.read().splitlines()) == part_n, "--profile run lost tag lines")
        finally:
            os.chdir(cwd)
        traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        check(len(traces) == 1, f"--profile wrote {traces}, expected one trace file")
        trace_mb = os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6
        check(trace_mb > 0, "--profile wrote an empty trace")

    gflop8 = 2 * 1025 * 24 * (4 * 1024 * 1024 + 3 * 1024 * 2730) / 1e9   # int8 ops an image
    bound_ms = b * gflop8 * 1e9 / INT8_TOPS * 1e3
    g8 = prof8["groups"]
    int8_res = dict(
        batch=b, forward_ms=int8_ms, bf16_forward_ms=bf16_ms, turns_ms=turns,
        speedup_vs_bf16=bf16_ms / int8_ms,
        device_ms_by_group=dict(
            _int_mm=g8["_int_mm"],
            quantize_rescale=sum(g8[g] for g in ("int8_mm operand pads", "quantize", "rescale")),
            rest=sum(v for g, v in g8.items() if g.startswith("rest:"))),
        int_mm_bound_ms=bound_ms, int_mm_bound_by="operations", int8_gop_per_image=gflop8,
        bf16_gemm_ms_profiled=prof16["groups"].get("gemm"), int_mm_shapes=shapes,
        profile_int8=prof8, profile_bf16=prof16,
        tag_lines_differing=differ, tag_lines_differing_share=differ / n,
        tag_set_jaccard_mean=jaccard, profile_trace_mb=trace_mb)
    res = dict(images=n, batch=b, depth=depth, runs=runs,
               tag_files_equal_pillow_native=True if "native" in files else "no native library",
               forward_ms=dict(bf16=bf16_ms, int8=int8_ms), finalize_s_per_batch=finalize_s,
               tags_per_line=tags_per_line,
               tag_lines_differing_int8_vs_bf16=differ, profile_trace_mb=trace_mb)
    return res, int8_res, forwards


def phase_tagging(torch, tagging, tagger_mod, config_mod, eva02, quant, ingest, native,
                  fa) -> tuple:
    """Phase 16: the probe and build of the decode library, the corpus, the
    decode rates and gates, the int8 gates, then tagging end to end with the
    Dh=64 launch count set to 0 just before it. Returns (result, int8 result)."""
    probe = native_probe(native)
    cfg = config_mod.TaggerConfig()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        info = write_corpus(corpus, E2E_IMAGES)
        print("tagging corpus " + json.dumps(info), flush=True)
        files = ingest.list_files_recursive(corpus)       # the CLI's listing order
        rates, rows = phase_decode(ingest, native, files, cfg.image_size, cfg.batch_size)
        gates = phase_int8_gates(torch, quant, eva02, tagger_mod)
        fa.reset_launches()
        res, int8_res, forwards = phase_tagging_e2e(
            torch, tagging, tagger_mod, config_mod, eva02, quant, ingest, native, corpus, rows)
        res["attention_launches"] = dict(fa.mha_attention.launches)
        depth = res["depth"]
        check(fa.mha_attention.launches == {64: depth * forwards, 32: 0}
              and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
              f"flash_attention launched {fa.mha_attention.launches} times in phase 16, "
              f"expected {depth} x {forwards} forwards at Dh=64")
    res.update(probe=probe, corpus=info, decode=rates, native_library=native.available(),
               int8_gates=dict(product_bit_equal=True, linear_bit_equal=True, **gates))
    print("tagging e2e " + json.dumps(res), flush=True)
    print("int8 " + json.dumps(int8_res), flush=True)
    return res, int8_res


# ---------------------------------------------------------------- CCIP encoder


def caformer_gflop(cfg) -> float:
    """Matmul and conv GFLOP of one CAFormer image (2 per multiply-add)."""
    side = cfg.img_size // 4
    f = 2 * side * side * cfg.dims[0] * 49 * 3
    for stage in range(4):
        c = cfg.dims[stage]
        if stage:
            side //= 2
            f += 2 * side * side * c * 9 * cfg.dims[stage - 1]
        n = side * side
        for blk in range(cfg.depths[stage]):
            f += 4 * n * c * cfg.mlp_hidden_of(stage, blk)
            if cfg.num_heads[stage]:
                f += 2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c
            else:
                hid = cfg.sepconv_hidden_of(stage, blk)
                f += 4 * n * c * hid + 2 * n * hid * 49
    d = cfg.dims[-1]
    hidden = cfg.head_hidden or cfg.mlp_ratio * d
    return (f + 2 * d * hidden + 2 * hidden * cfg.feature_dim) / 1e9


def unit_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


CCIP_F32_TOL = 5e-5       # max |unit feature card f32 - CPU f32|


def phase_ccip_parity(torch, caformer, config_mod, fast_variance: bool = False,
                      batch: int = 2) -> dict:
    """Full width, depth (1, 1, 2, 1) at 384², one CPU forward (f32, plain)
    against two on the card: bf16 through the bf16 kernel (phase 10) and f32
    through the f32 kernel (phase 10b, unit features within 5e-5). Phase 20
    runs it with ``fast_variance`` (one-pass LayerNorms) at B=8. Returns the
    errors by card dtype."""
    cfg = caformer.CAFormerConfig(depths=(1, 1, 2, 1), fast_variance=fast_variance)
    cpu_model = caformer.CAFormer(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    caformer.init_params(cpu_model, seed=0)
    ccfg = config_mod.CCIPConfig()
    imgs = np.random.RandomState(5).randint(0, 256, (batch, 384, 384, 3), dtype=np.uint8)
    label = (f"ccip parity{' fast_variance' if fast_variance else ''} B={batch} depth "
             "(1, 1, 2, 1) full width")
    errs = {}

    def features(model, dev):
        return caformer.extract_features(model.eval(), torch.from_numpy(imgs).to(dev),
                                         ccfg.mean, ccfg.std).float().cpu().numpy()

    want = unit_rows(features(cpu_model, "cpu"))
    for dtype in (torch.bfloat16, torch.float32):
        gpu_model = caformer.CAFormer(dataclasses.replace(cfg, dtype=dtype), device=DEV)
        gpu_model.load_state_dict(cpu_model.state_dict())
        got = features(gpu_model, DEV)
        del gpu_model
        check(np.isfinite(got).all(), f"non-finite CCIP features on the card ({dtype})")
        err = float(np.abs(unit_rows(got) - want).max())
        cos = (unit_rows(got) * want).sum(-1)
        if dtype == torch.bfloat16:
            print(f"{label}, card bf16 vs cpu f32: "
                  f"max|dunit|={err:.3e} (tol {CCIP_TOL}), cos {cos.min():.6f} (min "
                  f"{CCIP_MIN_COS})", flush=True)
            check(err <= CCIP_TOL, f"{label}: card vs cpu CCIP features differ by {err} > "
                  f"{CCIP_TOL}")
            check(cos.min() >= CCIP_MIN_COS,
                  f"{label}: card vs cpu CCIP cosine {cos.min()} < {CCIP_MIN_COS}")
            errs["bf16"] = dict(max_abs_unit=err, min_cos=float(cos.min()), tol=CCIP_TOL)
        else:
            print(f"{label}, card f32 kernel vs cpu f32: max|dunit|={err:.3e} (tol "
                  f"{CCIP_F32_TOL}), cos {cos.min():.9f}", flush=True)
            check(err <= CCIP_F32_TOL,
                  f"{label}: card vs cpu f32 CCIP features differ by {err} > {CCIP_F32_TOL}")
            errs["f32"] = dict(max_abs_unit=err, min_cos=float(cos.min()), tol=CCIP_F32_TOL)
    torch.cuda.empty_cache()
    return errs


def _ccip_group(name: str) -> str:
    low = name.lower()
    if "attn_fwd" in name:
        return "attention kernel"
    if "query_scores" in name:
        return "query_scores kernel"
    if "matvecs_kernel" in name:
        return "matvecs kernel"
    if any(t in low for t in ("gemm", "cutlass", "cublas", "nvjet")) or "Kernel2" in name:
        return "gemm"
    if "depthwise" in low:
        return "depthwise conv"
    if "conv" in low or "fprop" in low or "implicit" in low:
        return "conv"
    if "layer_norm" in low or "layernorm" in low:
        return "layer_norm"
    if "memcpy" in low:
        return "memcpy"
    return "other elementwise/copy"


class FnLabels:
    """Wraps functions of modules in profiler ranges named ``<prefix>:<name>``
    while in effect: the real functions run, and a profile can tell which of
    them launched each kernel. ``targets`` holds (module, function name)."""

    def __init__(self, torch, prefix: str, targets):
        self.torch, self.prefix, self.targets, self.saved = torch, prefix, targets, []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._labelled(name, fn))
        return self

    def _labelled(self, name, fn):
        record_function = self.torch.profiler.record_function
        label = f"{self.prefix}:{name}"

        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved = []


def labelled_function(event, prefix: str):
    """The name in the innermost FnLabels range of ``prefix`` above a profiler
    event, or None."""
    tag = prefix + ":"
    p = event.cpu_parent
    while p is not None:
        if p.name.startswith(tag):
            return p.name[len(tag):]
        p = p.cpu_parent
    return None


def op_chain(event, stop: str) -> list:
    """The names of a profiler event and its parents, up to the first whose
    name starts with ``stop``."""
    names, p = [], event
    while p is not None and not p.name.startswith(stop):
        names.append(p.name)
        p = p.cpu_parent
    return names


def profile_groups(torch, fn, group) -> dict:
    """``fn`` once under torch.profiler: wall ms, device ms summed over CUDA
    events, the busy share, device ms by group and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    groups: dict = {}
    for us, key, _ in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + us / 1e3
    return dict(wall_ms=wall, device_ms=total if total else "not measured",
                busy_share=total / wall if total else "not measured", groups=groups,
                top=[dict(name=k[:90], ms=us / 1e3, count=n) for us, k, n in rows[:12]])


def phase_ccip_main(torch, ccip_mod, config_mod, caformer, fa) -> tuple:
    """CAFormer-24 at full width, B=64, seeded weights: a warm-up, 3 batches
    through gen_cfeatures' depth-1 pipeline (queue batch N, copy batch N-1's
    features back), the forward alone on CUDA events and one forward under
    torch.profiler. Returns (results, forwards run)."""
    cfg = config_mod.CCIPConfig()
    pred = ccip_mod.CCIPPredictor(cfg, device="cuda")
    pred.load_model()
    check(pred.model_cfg == caformer.CAFormerConfig(), f"not the full config: {pred.model_cfg}")
    b = cfg.batch_size
    rng = np.random.RandomState(6)
    batches = [rng.randint(0, 256, (b, 384, 384, 3), dtype=np.uint8) for _ in range(3)]
    before = dict(fa.mha_attention.launches)
    warm = pred.ccip_batch_extract_features(batches[0])
    check(fa.mha_attention.launches == {64: before[64], 32: before[32] + 18},
          "attention did not launch at Dh=32 once per attention block in one forward")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, pending = [], None
    for imgs in batches:
        dev = pred.ccip_extract_device(imgs)
        if pending is not None:
            outs.append(pending.cpu().numpy())
        pending = dev
    outs.append(pending.cpu().numpy())
    wall = time.perf_counter() - t0
    check(all(o.shape == (b, cfg.feature_dim) and np.isfinite(o).all() for o in outs),
          "CCIP features: wrong shape or non-finite")
    rerun = float(np.abs(outs[0] - warm).max())
    check(rerun <= 1e-6, f"the same batch gave features {rerun} apart")
    x = torch.from_numpy(batches[1]).to("cuda")
    fwd_ms = cuda_ms(lambda: caformer.extract_features(pred.model, x, pred._mean, pred._std),
                     iters=3, warmup=1)
    prof = profile_groups(torch, lambda: caformer.extract_features(
        pred.model, x, pred._mean, pred._std), _ccip_group)
    gflop = caformer_gflop(pred.model_cfg)
    img_s = 3 * b / wall
    res = dict(batch=b, batches_timed=3, seconds=wall, img_s=img_s, gflop_per_image=gflop,
               mfu=img_s * gflop * 1e9 / PEAK_BF16_FLOPS, forward_ms=fwd_ms,
               forward_img_s=b / fwd_ms * 1e3,
               forward_mfu=b / fwd_ms * 1e3 * gflop * 1e9 / PEAK_BF16_FLOPS,
               same_batch_max_diff=rerun, profile=prof,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("ccip " + json.dumps(res), flush=True)
    del pred, x
    torch.cuda.empty_cache()
    return res, 1 + 3 + 4 + 1


def phase_ccip_f32(torch, ccip_mod, config_mod, caformer, fa) -> tuple:
    """Phase 10b's main path: CAFormer-24 at full width in f32 (an explicit
    f32 model config), B=64, seeded weights, through
    CCIPPredictor.ccip_extract_device: a warm-up (18 f32 launches), 3 batches
    through gen_cfeatures' depth-1 pipeline, the forward alone on CUDA events
    and one forward under torch.profiler (device ms by kernel group).
    Returns (results, forwards run)."""
    cfg = config_mod.CCIPConfig()
    pred = ccip_mod.CCIPPredictor(
        cfg, model_cfg=caformer.CAFormerConfig(dtype=torch.float32), device="cuda")
    pred.load_model()
    check(pred.model_cfg == caformer.CAFormerConfig(dtype=torch.float32),
          f"not the full f32 config: {pred.model_cfg}")
    b = cfg.batch_size
    rng = np.random.RandomState(6)
    batches = [rng.randint(0, 256, (b, 384, 384, 3), dtype=np.uint8) for _ in range(3)]
    before = dict(fa.mha_attention.launches_f32)
    warm = pred.ccip_extract_device(batches[0]).cpu().numpy()
    check(fa.mha_attention.launches_f32 == {64: before[64], 32: before[32] + 18},
          "the f32 kernel did not launch at Dh=32 once per attention block in one forward")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, pending = [], None
    for imgs in batches:
        dev = pred.ccip_extract_device(imgs)
        if pending is not None:
            outs.append(pending.cpu().numpy())
        pending = dev
    outs.append(pending.cpu().numpy())
    wall = time.perf_counter() - t0
    check(all(o.shape == (b, cfg.feature_dim) and o.dtype == np.float32 and np.isfinite(o).all()
              for o in outs), "f32 CCIP features: wrong shape or dtype, or non-finite")
    rerun = float(np.abs(outs[0] - warm).max())
    check(rerun <= 1e-6, f"the same batch gave f32 features {rerun} apart")
    x = torch.from_numpy(batches[1]).to("cuda")
    fwd_ms = cuda_ms(lambda: caformer.extract_features(pred.model, x, pred._mean, pred._std),
                     iters=3, warmup=1)
    prof = profile_groups(torch, lambda: caformer.extract_features(
        pred.model, x, pred._mean, pred._std), _ccip_group)
    gflop = caformer_gflop(pred.model_cfg)
    img_s = 3 * b / wall
    res = dict(compute_dtype="float32", batch=b, batches_timed=3, seconds=wall, img_s=img_s,
               gflop_per_image=gflop, forward_ms=fwd_ms, forward_img_s=b / fwd_ms * 1e3,
               forward_share_of_f32_peak=b / fwd_ms * 1e3 * gflop * 1e9 / PEAK_F32_FLOPS,
               same_batch_max_diff=rerun, profile=prof)
    print("ccip f32 " + json.dumps(res), flush=True)
    del pred, x
    torch.cuda.empty_cache()
    return res, 1 + 3 + 4 + 1


def phase_gen_cfeatures(torch, gen_cfeatures, config_mod, artifacts, similarity,
                        directory) -> tuple:
    """cli.gen_cfeatures on 200 generated PNGs at B=64 (3 full batches and a
    tail of 8), then an --after revision (every file re-extracted, the old
    rows copied verbatim); the rows held against direct extraction in the
    loader's batches. The PNGs stay in ``directory`` for phase 15. Returns
    (results, forwards run, {"imgs": their dir, "rows": {file name: rev 0 row}})."""
    from PIL import Image

    rng = np.random.RandomState(12)
    cwd = os.getcwd()
    tmp = os.path.join(directory, "gen_cfeatures")
    os.makedirs(tmp)
    os.chdir(tmp)
    try:
        os.makedirs("imgs")
        n = 200
        for i in range(n):
            shape = (200 + (i % 7) * 23, 180 + (i % 5) * 31, 3)
            Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(
                f"imgs/img_{i:03d}.png")
        cfg = config_mod.CCIPConfig()
        pred = gen_cfeatures.Predictor(config=cfg, device=DEV)
        pred.load_model()
        t0 = time.perf_counter()
        pred.process_directory("imgs")
        first_s = time.perf_counter() - t0
        with open(artifacts.CFEATURES_CSV, encoding="utf-8") as f:
            paths = f.read().splitlines()
        check(sorted(paths) == [f"imgs/img_{i:03d}.png" for i in range(n)],
              "gen_cfeatures: the CSV does not list the 200 files")
        rev0 = similarity.SimilarityIndex.load(artifacts.cfeatures_index_name(0))
        check(len(rev0) == n and (rev0.norms > 0).all() and (rev0.stamps > 0).all(),
              "gen_cfeatures: rev 0 rows, norms or stamps")
        # the loader's batches: 64 files a batch, the tail padded with zeros
        feats = []
        for s in range(0, n, cfg.batch_size):
            imgs = [pred.gen_image_ndarray(p) for p in paths[s:s + cfg.batch_size]]
            imgs += [np.zeros_like(imgs[0])] * (cfg.batch_size - len(imgs))
            feats.append(pred.ccip_batch_extract_features(np.stack(imgs))[:n - s])
        direct = unit_rows(np.concatenate(feats))
        row_err = float(np.abs(np.asarray(rev0.matrix) - direct).max())
        check(row_err <= 1e-6, f"gen_cfeatures rows differ from direct extraction by {row_err}")
        t1 = time.perf_counter()
        pred.process_directory("imgs", datetime.date.today())
        after_s = time.perf_counter() - t1
        check(artifacts.get_current_cfeature_number() == 1, "--after made no revision 1")
        rev1 = similarity.SimilarityIndex.load(artifacts.cfeatures_index_name(1))
        check(len(rev1) == 2 * n, f"revision 1 holds {len(rev1)} rows, expected {2 * n}")
        check(np.array_equal(rev1.matrix[:n], rev0.matrix)
              and np.array_equal(rev1.norms[:n], rev0.norms)
              and np.array_equal(rev1.stamps[:n], rev0.stamps),
              "revision 1 did not copy the old rows verbatim")
        backups = [d for d in os.listdir(".") if os.path.isdir(d) and d[:8].isdigit()]
        check(len(backups) == 1, f"--after backups: {backups}")
        res = dict(images=n, batch=cfg.batch_size, first_run_s=first_s,
                   first_run_img_s=n / first_s, after_run_s=after_s,
                   rows_vs_direct_max_diff=row_err, revision_rows=len(rev1))
        print("gen_cfeatures " + json.dumps(res), flush=True)
        rows = {os.path.basename(p): np.array(r) for p, r in zip(paths, rev0.matrix)}
        del pred
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    forwards = 3 * 4   # each run and the direct extraction: 4 batches of 64
    return res, forwards, dict(imgs=os.path.join(tmp, "imgs"), rows=rows)


# ---------------------------------------------------------------- query serving


def query_bound(d, f, w, q, b):
    """(bound ms, bound_by) of one query-scores launch: each input read once
    (rows, term and contribution matrices, packed queries), each of the four
    (B, D) outputs written once; f32 FMAs of the matvec against the f32 peak."""
    nbytes = d * (4 * f + 8 * w) + b * (4 * q + f + 1) * 4 + 4 * b * d * 4
    flops = 2 * b * d * f
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def query_case(torch, fq, d, f, w, q, b, rng, ids_mode="mixed"):
    """A random index and b packed queries on the card. Each row's term ids are
    distinct (an arithmetic progression modulo a prime vocabulary), unused
    slots carry the sentinel id, every 7th row is duplicated into the next, and
    the queries mix plain, weighted, required, excluded, unused and
    out-of-vocabulary slots, with ids drawn partly from the rows. ``ids_mode``
    "same" gives the b queries one id list (each its own vector), "disjoint"
    gives them lists with no id in common."""
    vocab = 4999
    lens = rng.integers(0, w + 1, d)
    start, step = rng.integers(0, vocab, (d, 1)), rng.integers(1, vocab, (d, 1))
    term = ((start + step * np.arange(w)) % vocab).astype(np.int32)
    unused = np.arange(w)[None, :] >= lens[:, None]
    term[unused] = vocab
    contrib = (3 * rng.random((d, w), dtype=np.float32)).astype(np.float32)
    contrib[unused] = 0
    matrix = rng.standard_normal((d, f), dtype=np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    dup = np.arange(0, d - 1, 7)
    for a in (matrix, term, contrib):
        a[dup + 1] = a[dup]
    head = term[:64][term[:64] < vocab]

    def draw_ids():
        pool = np.unique(np.concatenate([head, rng.integers(0, vocab + 20, 2 * q)]))
        return rng.choice(pool, min(int(rng.integers(1, q + 1)), len(pool)), replace=False)

    def draw_weights(ids):
        return {int(t): (1, 3, MAGIC + 1, -1)[int(rng.integers(4))] for t in ids}

    if ids_mode == "same":
        lists = [draw_weights(draw_ids())] * b
    elif ids_mode == "disjoint":
        pool = rng.permutation(np.unique(np.concatenate(
            [head, rng.integers(0, vocab, 4 * q * b)])))
        per = min(q, len(pool) // b)
        lists = [draw_weights(pool[i * per:(i + 1) * per]) for i in range(b)]
    packed = []
    for i in range(b):
        weights = draw_weights(draw_ids()) if ids_mode == "mixed" else lists[i]
        vec = rng.standard_normal(f).astype(np.float32)
        packed.append(fq.pack_query(vec / np.linalg.norm(vec), weights, vocab, MAGIC, q))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    return dev(matrix), dev(term), dev(contrib), dev(np.stack(packed)), dup


def check_query_scores(torch, qs, args, dup, label: str) -> float:
    got = qs.query_scores(*args)
    torch.cuda.synchronize()
    want = qs.query_scores_reference(*args)
    err = 0.0
    for name, g, p in zip(("sims", "bm25"), got[:2], want[:2]):
        rel = ((g - p).abs() / p.abs().clamp_min(1.0)).max().item()
        check(torch.isfinite(g).all().item(), f"non-finite {name} at {label}")
        check(rel <= QUERY_TOL, f"query_scores {name}: {rel} > {QUERY_TOL} at {label}")
        err = max(err, (g - p).abs().max().item())
    for name, g, p in zip(("excl_hits", "req_hits"), got[2:], want[2:]):
        check(g.dtype == torch.int32 and torch.equal(g, p), f"{name} differ at {label}")
    idx = torch.from_numpy(dup).to(DEV)
    for g in got:
        check(torch.equal(g[:, idx], g[:, idx + 1]), f"duplicate rows differ at {label}")
    m, t, c, p = args
    for i in range(p.shape[0] if p.shape[0] > 1 else 0):    # a query alone = in its batch
        one = qs.query_scores(m, t, c, p[i:i + 1].contiguous())
        check(all(torch.equal(o[0], g[i]) for o, g in zip(one, got)),
              f"query {i} alone and in its batch differ at {label}")
    return err


def query_plan(qs, build):
    """The kernel's own report of the launch it makes for a shape: R rows a
    ring stage, stages, dynamic shared memory a block, blocks an SM, grid
    (None where the shape does not fit)."""
    fn = build.load(qs.KERNEL).aiis_query_scores_plan
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def plan(d, f, w, q, b):
        out = (ctypes.c_int * 5)()
        if fn(256, 256, 256, d, f, w, q, b, out):     # only the bases' alignment is read
            return None
        return dict(zip(("rows", "stages", "smem_bytes", "blocks_per_sm", "grid"), out))
    return plan


def ptxas_report(log: str, kernel: str = "query_scores_kernel") -> dict:
    """Registers and spill stores of each form of ``kernel`` (float4 or scalar
    rows; the scoring kernel at B = 1 or 2..8, matvecs_kernel at kB = 1, 2,
    4, 8 query slots) in nvcc's -Xptxas -v output; empty where this process
    found the library built."""
    forms, form = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(query_scores_kernel|matvecs_kernel)"
                      r"ILb([01])ELi(\d+)E", line)
        if m:
            rows, batch = ("scalar", "float4")[int(m.group(2))], m.group(3)
            if m.group(1) != kernel:
                form = None
            elif kernel == "query_scores_kernel":
                form = f"{rows} B{'=1' if batch == '1' else '<=8'}"
            else:
                form = f"{rows} kB={batch}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and form:
            forms.setdefault(form, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and form:
            forms.setdefault(form, {})["registers"] = int(m.group(1))
    return forms


def old_route(torch, qs, matrix, vecs):
    """The sims of the scoring kernel with no term slots: the route that the
    matvecs kernel replaced, whose bits it must give."""
    d, b = matrix.shape[0], vecs.shape[0]
    packed = torch.cat([vecs, vecs.new_zeros((b, 1))], dim=1)
    empty = matrix.new_empty((d, 0))
    return qs.query_scores(matrix, empty.to(torch.int32), empty, packed)[0]


def matvecs_bound(d, f, b):
    """(bound ms, bound_by) of one matvecs launch: the rows and the B vectors
    read once, the (B, D) scores written once; 2 B D F f32 flops."""
    t_bytes = (d * f + b * f + b * d) * 4 / PEAK_BYTES * 1e3
    t_ops = 2 * b * d * f / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_matvecs(torch, qs, matrix, vecs, label: str) -> float:
    """One launch of the matvecs kernel: torch.equal to the old route,
    within QUERY_TOL (relative) of the plain version, each query the same
    bits alone as in its batch. Returns max |kernel - plain|."""
    got = qs.matvecs(matrix, vecs)
    torch.cuda.synchronize()
    check(torch.equal(got, old_route(torch, qs, matrix, vecs)),
          f"matvecs differ from the scoring kernel's bits at {label}")
    plain = qs.plain_matvecs(matrix, vecs)
    rel = ((got - plain).abs() / plain.abs().clamp_min(1.0)).max().item()
    check(rel <= QUERY_TOL, f"matvecs: {rel} > {QUERY_TOL} from plain at {label}")
    for i in range(vecs.shape[0] if vecs.shape[0] > 1 else 0):
        check(torch.equal(qs.matvecs(matrix, vecs[i:i + 1])[0], got[i]),
              f"matvecs: query {i} alone and in its batch differ at {label}")
    return (got - plain).abs().max().item()


def time_matvecs(torch, qs, matrix, vecs, iters: int = 20) -> dict:
    """The matvecs kernel, the old route (the scoring kernel with no term
    slots) and the one library call for the same product (torch.mv at B=1,
    torch.mm above), timed in turns on the same inputs: kernel, old, library,
    library, old, kernel, each the mean of ``iters`` launches; beside the
    bound."""
    d, f = matrix.shape
    b = vecs.shape[0]
    lib = ((lambda: torch.mv(matrix, vecs[0])) if b == 1
           else (lambda: torch.mm(matrix, vecs.T)))
    fns = dict(ms=lambda: qs.matvecs(matrix, vecs),
               old_route_ms=lambda: old_route(torch, qs, matrix, vecs), library_ms=lib)
    runs: dict = {k: [] for k in fns}
    for k in ("ms", "old_route_ms", "library_ms", "library_ms", "old_route_ms", "ms"):
        runs[k].append(cuda_ms(fns[k], iters=iters))
    bound, by = matvecs_bound(d, f, b)
    res = {k: sum(v) / 2 for k, v in runs.items()}
    res.update(runs={k: v for k, v in runs.items()}, bound_ms=bound, bound_by=by,
               share_of_bound=bound / res["ms"],
               library=("torch.mv" if b == 1 else "torch.mm"))
    return res


def matvecs_plan(qs, build):
    """The matvecs kernel's own report of its launch: R rows a warp group,
    groups a warp, dynamic shared memory a block, blocks an SM, grid."""
    fn = build.load(qs.KERNEL).aiis_matvecs_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def plan(d, f, b):
        out = (ctypes.c_int * 5)()
        if fn(256, d, f, b, out):       # only the base's alignment is read
            return None
        return dict(zip(("rows", "groups_per_warp", "smem_bytes", "blocks_per_sm", "grid"),
                        out))
    return plan


def phase_matvecs(torch, qs, build) -> dict:
    """Phase 7's second kernel, matvecs (the rerank product and the 1 - cos):
    gates against the old route and the plain version at every B in 1..8 on
    edge shapes (ragged last groups, F = 1 and 7, duplicate rows), at bases
    that are not 16-byte aligned; then timed at D=1M, F=300 and F=768, B=1,
    beside the old route and torch.mv, and at F=300, B=8 beside the old route,
    torch.mm and the plain version; its launch plan and registers."""
    g = torch.Generator(device=DEV).manual_seed(77)
    max_err, n = 0.0, 0
    for d in (1, 31, 33, 97, 100_003):
        for f in (1, 7, 300, 768):
            m = torch.nn.functional.normalize(torch.randn(d, f, device=DEV, generator=g), dim=1)
            if d > 7:
                dup = torch.arange(0, d - 1, 7, device=DEV)
                m[dup + 1] = m[dup]
            vecs = torch.randn(8, f, device=DEV, generator=g)
            for b in range(1, 9):
                got = qs.matvecs(m, vecs[:b])
                check(torch.equal(got, old_route(torch, qs, m, vecs[:b])),
                      f"matvecs differ from the scoring kernel's bits at D={d} F={f} B={b}")
                if d > 7:
                    check(torch.equal(got[:, dup], got[:, dup + 1]),
                          f"matvecs: duplicate rows differ at D={d} F={f} B={b}")
                n += 1
            max_err = max(max_err, check_matvecs(torch, qs, m, vecs, f"D={d} F={f} B=8"))
    for f, offset in ((7, 7), (300, 1), (768, 2)):
        buf = torch.empty(20_011 * f + offset, device=DEV)
        m = buf[offset:].view(20_011, f)
        check(m.data_ptr() % 16 != 0, f"the F={f} view is 16-byte aligned")
        m.copy_(torch.nn.functional.normalize(torch.randn(20_011, f, device=DEV, generator=g),
                                              dim=1))
        for b in (1, 2, 5, 8):
            max_err = max(max_err, check_matvecs(torch, qs, m, torch.randn(
                b, f, device=DEV, generator=g), f"unaligned base F={f} B={b}"))
            n += 1
    print(f"kernel matvecs: {n} shapes equal to the old route bit for bit, max|kernel-plain| "
          f"{max_err:.3e} (tol {QUERY_TOL} relative), duplicate rows bit-equal, each query "
          "alone equal to its batch", flush=True)

    d = QUERY_DOCS
    plan = matvecs_plan(qs, build)
    times = {}
    for f in (300, 768):
        m = torch.nn.functional.normalize(torch.randn(d, f, device=DEV, generator=g), dim=1)
        vec = torch.nn.functional.normalize(torch.randn(1, f, device=DEV, generator=g), dim=1)
        max_err = max(max_err, check_matvecs(torch, qs, m, vec, f"D={d} F={f} B=1"))
        times[f"F={f} B=1"] = time_matvecs(torch, qs, m, vec)
        if f == 300:
            plain_ms = cuda_ms(lambda: qs.plain_matvecs(m, vec), iters=3, warmup=1)
            # the rerank product of a batch of 8, in turns with torch.mm
            vecs = torch.nn.functional.normalize(
                torch.randn(8, f, device=DEV, generator=g), dim=1)
            max_err = max(max_err, check_matvecs(torch, qs, m, vecs, f"D={d} F={f} B=8"))
            times[f"F={f} B=8"] = time_matvecs(torch, qs, m, vecs)
            times[f"F={f} B=8"]["plain_ms"] = cuda_ms(lambda: qs.plain_matvecs(m, vecs),
                                                      iters=3, warmup=1)
        del m
        torch.cuda.empty_cache()
    main = times["F=300 B=1"]
    print(f"kernel matvecs D={d} " + json.dumps(dict(
        main_shape="F=300 B=1", plain_ms=plain_ms, times=times,
        plan={f"F={f} B={b}": plan(d, f, b) for f in (300, 768) for b in (1, 2, 4, 8)},
        ptxas=ptxas_report(build.build_logs.get(qs.KERNEL, ""), "matvecs_kernel"))),
        flush=True)
    return dict(name="matvecs", route="cuda",
                source="anime_illust_image_searcher_tpu_torch/csrc/query_scores.cu",
                replaces="anime_illust_image_searcher_tpu/ops/fused_query.py:357",
                max_abs_err=max_err, ms=main["ms"], plain_ms=plain_ms,
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], old_route_ms=main["old_route_ms"],
                share_of_bound=main["share_of_bound"])


def phase_query_kernels(torch, qs, fq, build) -> dict:
    """The kernel against its plain version at edge shapes and at the edges of
    its ring (ragged last tiles, a base the bulk copy cannot take, 8 queries
    with one id list or disjoint lists, the largest shared memory), then
    timings at the main path's D=1M, F=300, W=32, with the design's
    parameters."""
    rng = np.random.default_rng(7)
    plan = query_plan(qs, build)
    combos = [(8, 8, 1, 300), (32, 64, 3, 7), (40, 256, 8, 300),
              (32, 8, 8, 7), (8, 256, 3, 300), (40, 64, 1, 300)]
    max_err, n = 0.0, 0

    def held(case, label, dup=None):
        nonlocal max_err, n
        m, t, c, p, case_dup = case
        max_err = max(max_err, check_query_scores(
            torch, qs, (m, t, c, p), case_dup if dup is None else dup, label))
        n += 1

    for d in CHECK_DOCS:
        for w, q, b, f in combos:
            held(query_case(torch, fq, d, f, w, q, b, rng), f"D={d} F={f} W={w} Q={q} B={b}")
    # a last tile of 1 row and of R - 1 rows at each combo's R
    for w, q, b, f in combos:
        rows = plan(1, f, w, q, b)["rows"]
        for d in (3 * rows + 1, 5 * rows - 1):
            held(query_case(torch, fq, d, f, w, q, b, rng),
                 f"ragged D={d} (R={rows}) F={f} W={w} Q={q} B={b}")
    # rows 1.. of an F=7 matrix: a base 28 bytes past 16-byte alignment
    for w in (8, 3):
        m, t, c, p, dup = query_case(torch, fq, 1001, 7, w, 64, 3, rng)
        m, t, c = m[1:], t[1:], c[1:]
        check(m.data_ptr() % 16 != 0, "the F=7 row slice is 16-byte aligned")
        held((m, t, c, p, None), f"unaligned base D=1000 F=7 W={w}", dup=dup[dup >= 1] - 1)
    # 8 queries that hold one id list, and 8 with no id in common
    for mode in ("same", "disjoint"):
        for q in (8, 256):
            held(query_case(torch, fq, 100_003, 300, 32, q, 8, rng, ids_mode=mode),
                 f"B=8 {mode} ids D=100003 F=300 W=32 Q={q}")
    # Q=256, B=8 at the largest F (a multiple of 4) whose ring still fits
    f_max = next(f for f in range(8192, 0, -4) if plan(1, f, 32, 256, 8))
    largest = plan(20_011, f_max, 32, 256, 8)
    held(query_case(torch, fq, 20_011, f_max, 32, 256, 8, rng),
         f"largest shared memory F={f_max} W=32 Q=256 B=8 ({largest['smem_bytes']} bytes)")
    print(f"kernel query_scores: {n} shapes against plain, max|kernel-plain| "
          f"{max_err:.3e} (tol {QUERY_TOL} relative), hit counts exact, duplicate rows "
          "bit-equal, each query alone equal to its batch", flush=True)

    d, f, w = QUERY_DOCS, 300, 32
    g = torch.Generator(device=DEV).manual_seed(7)
    matrix = torch.nn.functional.normalize(torch.randn(d, f, device=DEV, generator=g), dim=1)
    term = torch.randint(0, 10_000, (d, w), device=DEV, generator=g, dtype=torch.int32)
    contrib = torch.rand(d, w, device=DEV, generator=g)
    timings, packed = {}, {}
    for q in (8, 64, 256):
        rows = []
        for _ in range(8):
            ids = rng.choice(10_000, 5 if q == 8 else q - 8, replace=False)
            vec = rng.standard_normal(f).astype(np.float32)
            rows.append(fq.pack_query(vec / np.linalg.norm(vec),
                                      {int(i): 1 for i in ids}, 10_000, MAGIC, q))
        packed[q] = torch.from_numpy(np.stack(rows)).to(DEV)
        for b in (1, 8):
            args = (matrix, term, contrib, packed[q][:b].contiguous())
            timings[(b, q)] = cuda_ms(lambda: qs.query_scores(*args), iters=20)
    args = (matrix, term, contrib, packed[8][:1].contiguous())     # the main shape
    runs = [cuda_ms(lambda: qs.query_scores(*args), iters=20) for _ in range(2)]
    ms = sum(runs) / 2
    plain_ms = cuda_ms(lambda: qs.query_scores_reference(*args), iters=3, warmup=1)
    plain8_ms = cuda_ms(lambda: qs.query_scores_reference(matrix, term, contrib, packed[8]),
                        iters=2, warmup=1)
    bound_ms, bound_by = query_bound(d, f, w, 8, 1)
    rows = {f"B={b} Q={q}": dict(ms=v, bound_ms=query_bound(d, f, w, q, b)[0])
            for (b, q), v in sorted(timings.items())}
    design = {f"B={b} Q={q}": plan(d, f, w, q, b) for b in (1, 8) for q in (8, 256)}
    del matrix, term, contrib
    torch.cuda.empty_cache()
    print(f"kernel query_scores D={d} F={f} W={w} " + json.dumps(dict(
        main_shape="B=1 Q=8", ms=ms, runs=runs, plain_ms=plain_ms, plain_B8_ms=plain8_ms,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms, shapes=rows,
        design=design, largest_smem=dict(F=f_max, **largest),
        ptxas=ptxas_report(build.build_logs.get(qs.KERNEL, "")))), flush=True)
    # the scoring form has no single PyTorch call that computes it: no library_ms
    return dict(name="query_scores", route="cuda",
                source="anime_illust_image_searcher_tpu_torch/csrc/query_scores.cu",
                replaces="anime_illust_image_searcher_tpu/ops/fused_query.py:218",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def zipf_cdf(vocab: int) -> np.ndarray:
    p = 1.0 / (np.arange(vocab) + 10.0)      # Zipf-like tag frequencies (bench_query.py:42)
    return np.cumsum(p / p.sum())


def distinct_tags(rng, cdf, rows: int, k: int):
    """(rows, k) Zipf-like tag draws, each row's distinct tags first in the
    order drawn, and each row's count of distinct tags."""
    cand = np.minimum(np.searchsorted(cdf, rng.random((rows, k))), len(cdf) - 1).astype(np.int32)
    order = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, order, 1)
    dup_sorted = np.zeros(cand.shape, bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = np.empty_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, 1)
    keep = np.argsort(dup, axis=1, kind="stable")
    return np.take_along_axis(cand, keep, 1), (~dup).sum(axis=1)


def synth_collection(n_docs: int, vocab: int, f: int, n_long: int, seed: int):
    """A tagged collection: a (D, 64) table of each doc's distinct Zipf-like
    tags padded with ``vocab`` (10-30 tags a doc, ``n_long`` docs 48-64), the
    tag counts, unit doc vectors and their norms in [0.5, 2.5)."""
    rng = np.random.default_rng(seed)
    cdf = zipf_cdf(vocab)
    full = np.full((n_docs, 64), vocab, np.int32)
    tags, n_distinct = distinct_tags(rng, cdf, n_docs, 40)
    full[:, :40] = tags
    lens = np.minimum(rng.integers(10, 31, n_docs), n_distinct)
    long_docs = rng.choice(n_docs, n_long, replace=False)
    tags, n_distinct = distinct_tags(rng, cdf, n_long, 96)
    full[long_docs] = tags[:, :64]
    lens[long_docs] = np.minimum(rng.integers(48, 65, n_long), n_distinct)
    full[np.arange(64)[None, :] >= lens[:, None]] = vocab
    unit = rng.standard_normal((n_docs, f), dtype=np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    norms = rng.uniform(0.5, 2.5, n_docs).astype(np.float32)
    return full, lens, unit, norms, rng


def make_queries(rng, cdf, n: int, n_terms=(1, 5)):
    """Tag-id queries {id: weight}: 1-5 Zipf-like tags with weight 1 or 2; 30%
    also require one tag, 20% exclude one."""
    out = []
    for _ in range(n):
        k = int(rng.integers(n_terms[0], n_terms[1] + 1))
        ids = []
        while len(ids) < k + 2:
            t = int(min(np.searchsorted(cdf, rng.random()), len(cdf) - 1))
            if t not in ids:
                ids.append(t)
        q = {t: int(rng.integers(1, 3)) for t in ids[:k]}
        if rng.random() < 0.3:
            q[ids[k]] = MAGIC + 1
        if rng.random() < 0.2:
            q[ids[k + 1]] = -1
        out.append(q)
    return out


def query_text(tokens, q) -> str:
    """A query as a user types it: ``tag``, ``tag:2``, ``tag:+1`` (required),
    ``tag:-1`` (excluded)."""
    return " ".join(tokens[t] + ("" if w == 1 else ":+1" if w > MAGIC
                                 else ":-1" if w < 0 else f":{w}")
                    for t, w in q.items())


def rows_agree(a: np.ndarray, b: np.ndarray, fq, k: int) -> bool:
    """Two fast-program rows: the same top-10 ids, result ids equal except
    adjacent swaps where the scores differ by less than 1e-6, scores within
    QUERY_TOL."""
    ta, tb = fq.unpack_result(a, k), fq.unpack_result(b, k)
    if not np.array_equal(ta[1], tb[1]) or not np.allclose(ta[2], tb[2], rtol=0, atol=QUERY_TOL):
        return False
    ia, ib, vb = ta[3].copy(), tb[3], tb[2]
    for i in range(len(ia) - 1):
        if ia[i] != ib[i] and (ia[i], ia[i + 1]) == (ib[i + 1], ib[i]) \
                and abs(vb[i] - vb[i + 1]) < 1e-6:
            ia[i], ia[i + 1] = ia[i + 1], ia[i]
    return bool(np.array_equal(ia, ib))


def write_chain(directory: str, config_mod, dictionary_mod, bm25_mod, n_docs: int,
                vocab: int, f: int, prefix: str):
    """A tagged collection written as the loaders read it: the idx csv, the
    dictionary and doc2vec pickles (with the tag-vector table), the
    similarity index with its norms, and the five BM25 pickles; then the BM25
    serve cache derived from them (what the engine's first start writes), so
    the engine maps the device arrays from disk instead of unpickling a dict
    a doc. Doc i's file is ``{prefix}/{i:07d}.png``. Returns the tag names
    and the generator."""
    import pickle

    from anime_illust_image_searcher_tpu_torch.index import artifacts as names

    full, lens, unit, norms, rng = synth_collection(n_docs, vocab, f, max(1, n_docs // 2000), 9)
    tokens = [f"tag_{i:05d}" for i in range(vocab)]
    docs = [row[:n].tolist() for row, n in zip(full, lens)]
    del full

    def path(name):
        return os.path.join(directory, name)

    def dump(name, obj):
        with open(path(name), "wb") as fh:
            pickle.dump(obj, fh)

    with open(path(names.DOC2VEC_IDX_CSV), "w", encoding="utf-8") as fh:
        fh.writelines(f"{prefix}/{i:07d}.png,{','.join(map(tokens.__getitem__, doc))}\n"
                      for i, doc in enumerate(docs))
    df = np.bincount(np.concatenate([np.asarray(d, np.int64) for d in docs]), minlength=vocab)
    d = dictionary_mod.TagDictionary()
    d.token2id = {t: i for i, t in enumerate(tokens)}
    d.id2token = list(tokens)
    d.dfs = {int(i): int(df[i]) for i in np.flatnonzero(df)}
    d.num_docs = n_docs
    dump(names.DOC2VEC_DICTIONARY, d)
    dump(names.DOC2VEC_MODEL, {
        "cfg": config_mod.Doc2VecConfig(vector_size=f), "tokens": tokens,
        "counts": np.maximum(df, 1).astype(np.int64),
        "syn1neg": rng.standard_normal((vocab, f), dtype=np.float32),
        "docvecs": unit * norms[:, None], "corpus_count": n_docs, "train_fp": None,
        "tag_vectors": rng.standard_normal((vocab + 1, f), dtype=np.float32)})
    np.save(path(names.DOC2VEC_INDEX + ".npy"), unit)
    np.save(path(names.DOC2VEC_INDEX + ".norms.npy"), norms)
    with open(path(names.DOC2VEC_INDEX + ".meta.json"), "w", encoding="utf-8") as fh:
        json.dump({"num_features": f, "num_docs": n_docs, "format": "aiis-tpu-simindex-v1"}, fh)
    with open(path(names.DOC2VEC_INDEX), "w", encoding="utf-8") as fh:
        fh.write("aiis-tpu-simindex-v1\n")
    del unit, norms
    idf = np.log(1 + (n_docs - df + 0.5) / (df + 0.5))
    stats = bm25_mod.BM25Stats(
        corpus=[dict.fromkeys(doc, 1) for doc in docs],
        idf={int(i): float(idf[i]) for i in np.flatnonzero(df)},
        avgdl=float(lens.mean()), num_docs=n_docs, doc_lengths=lens.astype(np.int64))
    for name, value in ((names.BM25_CORPUS, stats.corpus), (names.BM25_IDF, stats.idf),
                        (names.BM25_AVGDL, stats.avgdl), (names.BM25_D, stats.num_docs),
                        (names.BM25_DOC_LENGTHS, stats.doc_lengths)):
        dump(name, value)
    cfg = config_mod.BM25Config()
    bm25_mod.BM25DeviceIndex.from_stats(stats, vocab_size=vocab, cfg=cfg).write_cache(directory, cfg)
    return tokens, rng


def phase_chain(torch, webui, config_mod, dictionary_mod, bm25_mod, directory: str):
    """Write the 1M-doc chain and load it into the port's web server (and so
    its engine) on the card. Returns the server, the tag names and the
    generator."""
    t0 = time.perf_counter()
    tokens, rng = write_chain(directory, config_mod, dictionary_mod, bm25_mod,
                              QUERY_DOCS, 10_000, 300, os.path.join(directory, "img"))
    t1 = time.perf_counter()
    ui = webui.WebUIServer(directory=directory, device=DEV)
    engine = ui.load()
    t2 = time.perf_counter()
    docs = engine._docs
    term_mat, overflow = docs.term_mat[0], docs.overflow[0]
    check(overflow is not None and term_mat.shape[1] == 32, "the long docs did not spill")
    on_card = sum(t.numel() * t.element_size()
                  for t in (docs.matrix[0], term_mat, docs.contrib_mat[0]))
    info = dict(docs=QUERY_DOCS, pairs=int(len(engine.bm25.doc_ids)),
                dense_width=int(term_mat.shape[1]), overflow_pairs=int(len(engine.bm25.ov_doc)),
                overflow_docs=int(overflow[0].numel()), index_gb_on_card=on_card / 1e9,
                chain_write_s=t1 - t0, engine_load_s=t2 - t1)
    print("query corpus " + json.dumps(info), flush=True)
    return ui, tokens, rng


def wall_ms(fn, iters: int) -> float:
    """Mean host wall of ``fn`` (which ends in a copy to the host)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(torch, fn) -> dict:
    """``fn`` once under torch.profiler: wall ms, device ms summed over the
    CUDA kernels and copies, the busy share, device ms by group, the two K5
    kernels' share of it, the number of device events and of host calls that
    wait for the card (a scalar read, a stream or device synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - w0) * 1e3
    groups: dict = {}
    events = syncs = 0
    for e in prof.key_averages():
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                     "cudaDeviceSynchronize"):
            syncs += e.count
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            events += e.count
            low = e.key.lower()
            g = ("query_scores kernel" if "query_scores_kernel" in e.key
                 else "matvecs kernel" if "matvecs_kernel" in e.key
                 else "topk/sort" if any(t in low for t in ("topk", "sort", "radix", "select"))
                 else "memcpy" if "memcpy" in low else "other elementwise/reduce")
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    total = sum(groups.values())
    return dict(wall_ms=wall, device_ms=total if total else "not measured",
                busy_share=total / wall if total else "not measured",
                kernel_share_of_device=(groups.get("query_scores kernel", 0.0)
                                        + groups.get("matvecs kernel", 0.0)) / total
                if total else "not measured", groups=groups, device_events=events,
                host_waits=syncs)


def phase_query_gates(torch, fq, qs, engine, tokens, rng) -> dict:
    """On the 1M-doc engine, outside the counted path: the kernel path equals
    the plain path on 4 queries, the exact (full-sort) program agrees with the
    prefix program on 1, and the two programs' costs at B=1 and B=8, in turns."""
    k, topn = engine.cfg.search.rerank_top_k, engine.cfg.search.topn
    cdf = zipf_cdf(len(tokens))
    gate = [engine._pack_fused(query_text(tokens, q)) for q in make_queries(rng, cdf, 4)]
    kernel_rows = [engine._dispatch_fused(p, topn) for p in gate]
    saved = fq.query_scores, fq.matvecs
    fq.query_scores, fq.matvecs = qs.query_scores_reference, qs.plain_matvecs
    try:
        plain_rows = [engine._dispatch_fused(p, topn) for p in gate]
    finally:
        fq.query_scores, fq.matvecs = saved
    for i, (a, b) in enumerate(zip(kernel_rows, plain_rows)):
        check(rows_agree(a, b, fq, k), f"query {i}: the kernel path and the plain path disagree")
    exact = engine._dispatch_fused(gate[0], topn, exact=True)
    _, top_f, rv_f, ri_f, (first, second, count) = fq.unpack_result(kernel_rows[0], k)
    _, top_e, rv_e, ri_e, cut = fq.unpack_result_exact(exact, k)
    check(np.array_equal(top_f, top_e) and np.array_equal(ri_f, ri_e)
          and rv_f.tobytes() == rv_e.tobytes(), "exact and prefix programs rank differently")
    n_list = k + len(rv_f)
    resolved = second if count >= 2 else (None if count == 0 else cut)
    check(min(n_list, cut) == (n_list if resolved is None else min(n_list, resolved)),
          f"elbow: prefix flags {(first, second, count)} vs full-list cut {cut}")
    print(f"query gates: 4 queries kernel path = plain path, exact = prefix program "
          f"(flags {first, second, count}, cut {cut})", flush=True)

    # what the second program costs: wall per dispatch (H2D, program, D2H) in
    # turns fast, exact, exact, fast; device time of 5 dispatches each
    packed8 = np.stack([engine._pack_fused(query_text(tokens, q))
                        for q in make_queries(rng, cdf, 8)])
    costs = {}
    for label, packed in (("B=1", packed8[0]), ("B=8", packed8)):
        runs: dict = {False: [], True: []}
        for exact_flag in (False, True, True, False):
            runs[exact_flag].append(wall_ms(
                lambda: engine._dispatch_fused(packed, topn, exact=exact_flag), 20))
        dev = {flag: device_profile(torch, lambda: [engine._dispatch_fused(packed, topn, exact=flag)
                                                    for _ in range(5)])["device_ms"]
               for flag in (False, True)}
        dev = {flag: v / 5 if isinstance(v, float) else v for flag, v in dev.items()}
        costs[label] = dict(fast_wall_ms=sum(runs[False]) / 2, exact_wall_ms=sum(runs[True]) / 2,
                            fast_runs=runs[False], exact_runs=runs[True],
                            fast_device_ms=dev[False], exact_device_ms=dev[True])
    print("query programs " + json.dumps(costs), flush=True)
    return costs


class DispatchMeter:
    """Counts the fused-program dispatches (fast and exact) that the engine
    makes through ops/fused_query and, while ``timing`` is set, brackets each
    with CUDA events. A dispatch launches the query-scores kernel once (the
    scores), then the matvecs kernel once (the rerank product)."""

    def __init__(self, torch, fq):
        import threading

        self.torch, self.fq = torch, fq
        self.saved = (fq.fused_normal_query, fq.fused_normal_query_exact)
        self.lock = threading.Lock()
        self.count, self.timing, self.events = 0, False, []

    def _wrap(self, fn):
        def dispatch(*args, **kwargs):
            with self.lock:
                self.count += 1
            if not self.timing:
                return fn(*args, **kwargs)
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            with self.lock:
                self.events.append((start, end))
            return out
        return dispatch

    def __enter__(self):
        self.fq.fused_normal_query, self.fq.fused_normal_query_exact = map(self._wrap, self.saved)
        return self

    def __exit__(self, *exc):
        self.fq.fused_normal_query, self.fq.fused_normal_query_exact = self.saved

    def take_ms(self):
        """The event ms of each dispatch since the last call."""
        self.torch.cuda.synchronize()
        with self.lock:
            events, self.events = self.events, []
        return [s.elapsed_time(e) for s, e in events]


def pcts(xs) -> dict:
    return dict(p50=float(np.percentile(xs, 50)), p99=float(np.percentile(xs, 99)),
                mean=float(np.mean(xs)), n=len(xs))


def phase_query_main(torch, qs, engine, tokens, rng, meter) -> dict:
    """Queries through the engine on the 1M-doc chain: 256 single queries
    (SearchEngine.find_similar_documents, then SearchEngine.search's result
    assembly and NG-word filter), 32 batches of 8
    (find_similar_documents_batch), a 40-term and a 200-term query, and a
    profiled window. Each dispatch is timed on the card as well."""
    cdf = zipf_cdf(len(tokens))
    topn = engine.cfg.search.topn
    texts = [query_text(tokens, q) for q in make_queries(rng, cdf, 256)]
    batches = [[query_text(tokens, q) for q in make_queries(rng, cdf, 8)] for _ in range(32)]
    big = [query_text(tokens, q) for q in make_queries(rng, cdf, 1, (40, 40))
           + make_queries(rng, cdf, 1, (200, 200))]
    check([len(engine._pack_fused(t)) for t in big] == [4 * 64 + 301, 4 * 256 + 301],
          "big-query buckets")
    for t in texts[:4]:                        # warm-up
        engine.search(t)
    exact0, dispatches0 = engine.exact_cut_dispatches, meter.count
    launches0, mv0 = qs.query_scores.launches, qs.matvecs.launches
    meter.take_ms()
    meter.timing = True

    find, assemble, n_results = [], [], []
    for t in texts:
        h0 = time.perf_counter()
        sims = engine.find_similar_documents(t, topn=topn)
        h1 = time.perf_counter()
        infos = engine.search(t, similar_docs=sims)
        find.append((h1 - h0) * 1e3)
        assemble.append((time.perf_counter() - h1) * 1e3)
        n_results.append(len(infos))
        check(len(infos) > 0 and all(np.isfinite(i.similarity) for i in infos),
              f"{t!r}: no results or a non-finite score")
    single_ev = meter.take_ms()
    batch_find, batch_assemble = [], []
    for b in batches:
        h0 = time.perf_counter()
        outs = engine.find_similar_documents_batch(b, topn=topn)
        h1 = time.perf_counter()
        for t, o in zip(b, outs):
            check(not isinstance(o, Exception), f"{t!r} failed in a batch: {o!r}")
            engine.search(t, similar_docs=o)
        batch_find.append((h1 - h0) * 1e3)
        batch_assemble.append((time.perf_counter() - h1) * 1e3)
    batch_ev = meter.take_ms()
    big_ms = []
    for t in big:
        h0 = time.perf_counter()
        infos = engine.search(t)
        big_ms.append((time.perf_counter() - h0) * 1e3)
        check(all(np.isfinite(i.similarity) for i in infos), f"{t!r}: a non-finite score")
    big_ev = meter.take_ms()
    meter.timing = False
    window = device_profile(torch, lambda: ([engine.search(t) for t in texts[:8]],
                                            [engine.find_similar_documents_batch(b, topn=topn)
                                             for b in batches[:2]]))
    launches = qs.query_scores.launches - launches0
    mv_launches = qs.matvecs.launches - mv0
    dispatches = meter.count - dispatches0
    exact_cuts = engine.exact_cut_dispatches - exact0
    want = len(texts) + len(batches) + len(big) + 8 + 2 + exact_cuts
    check(dispatches == want, f"{dispatches} dispatches, expected {want}")
    check(launches == dispatches and mv_launches == dispatches,
          f"phase 8: query_scores launched {launches} times and matvecs {mv_launches}, "
          f"expected one each a dispatch, {dispatches}")
    res = dict(
        single=dict(find_ms=pcts(find), assemble_ms=pcts(assemble),
                    engine_ms=pcts([a + b for a, b in zip(find, assemble)]),
                    program_event_ms=pcts(single_ev), results=float(np.mean(n_results))),
        batch8=dict(find_ms=pcts(batch_find), assemble_ms=pcts(batch_assemble),
                    program_event_ms=pcts(batch_ev),
                    engine_ms_per_query=(np.mean(batch_find) + np.mean(batch_assemble)) / 8),
        q64_bucket=dict(engine_ms=big_ms[0], program_event_ms=big_ev[0]),
        q256_bucket=dict(engine_ms=big_ms[1], program_event_ms=big_ev[-1]),
        profiled_window=dict(queries="8 single + 2 batches of 8", **window),
        exact_cut_dispatches=exact_cuts, dispatches=dispatches, launches=launches,
        matvecs_launches=mv_launches)
    print("query " + json.dumps(res), flush=True)
    return res


_SERVE_CLIENT = """
import hashlib, json, sys, threading, time, urllib.request
url, queries = sys.argv[1], json.loads(sys.argv[2])
n_threads, per_thread = int(sys.argv[3]), int(sys.argv[4])
mode = sys.argv[5] if len(sys.argv) > 5 else "normal"

def ask(i):
    h0 = time.perf_counter()
    req = urllib.request.Request(url, data=json.dumps({"query": queries[i],
                                                       "search_mode": mode}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        data = json.loads(r.read())
    ms = (time.perf_counter() - h0) * 1e3
    results = data.get("results") or []
    return [i, ms, data.get("latency_ms"), len(results), data.get("error"),
            hashlib.sha256(json.dumps(results).encode()).hexdigest()]

def run(jobs):
    out = [[] for _ in jobs]
    def work(t):
        for i in jobs[t]:
            out[t].append(ask(i))
    threads = [threading.Thread(target=work, args=(t,)) for t in range(len(jobs))]
    w0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return [time.perf_counter() - w0, [r for o in out for r in o]]

n = len(queries)
warm = run([[t % n] for t in range(n_threads)])
window = run([[(t * per_thread + j) % n for j in range(per_thread)] for t in range(n_threads)])
print(json.dumps({"warm": warm, "window": window}))
"""


def serve_requests(webui, ui, queries, threads: int, per_thread: int,
                   mode: str = "normal") -> tuple:
    """Serve ``ui`` over HTTP on a free local port while a client process of
    its own runs ``_SERVE_CLIENT`` (a burst of one request a thread, then
    ``threads`` x ``per_thread`` requests); stop the server. Returns (warm
    rows, window seconds, window rows)."""
    import threading
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), webui.make_handler(ui))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/search"
    try:
        r = subprocess.run([sys.executable, "-c", _SERVE_CLIENT, url, json.dumps(queries),
                            str(threads), str(per_thread), mode],
                           capture_output=True, text=True, timeout=600)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    check(r.returncode == 0, f"serve client failed: {r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    (_, warm), (wall, window) = out["warm"], out["window"]
    check(len(warm) == threads and len(window) == threads * per_thread,
          f"served {len(warm)} + {len(window)} requests, expected {threads} + "
          f"{threads * per_thread}")
    return warm, wall, window


def check_served(engine, queries, rows, mode: str = "normal") -> None:
    """Every served answer (a digest of its JSON) equals engine.search's."""
    import hashlib

    for i, q in enumerate(queries):
        want = [dict(file_path=h.file_path, doc_id=h.doc_id, similarity=h.similarity,
                     tags=h.tags) for h in engine.search(q, search_mode=mode)]
        digest = hashlib.sha256(json.dumps(want).encode()).hexdigest()
        got = [row for row in rows if row[0] == i]
        check(len(got) > 0 and len(want) > 0, f"serve: {q!r} not served or found nothing")
        for _, _, _, n, err, dg in got:
            check(err is None and n == len(want) and dg == digest,
                  f"serve: {mode} {q!r} differs from engine.search ({err})")


def phase_serve(torch, webui, qs, ui, tokens, rng, meter) -> dict:
    """The port's web server on the card over the same 1M-doc engine, from a
    client process of its own: a burst of 16 concurrent /api/search requests
    (the micro-batcher coalesces them), then 16 threads sending 32 requests
    each. Every answer is held to engine.search run directly."""
    engine = ui.engine
    threads, per_thread = 16, 32
    pool = [query_text(tokens, q) for q in make_queries(rng, zipf_cdf(len(tokens)), 64)]
    launches0, mv0, dispatches0 = qs.query_scores.launches, qs.matvecs.launches, meter.count
    warm, wall, window = serve_requests(webui, ui, pool, threads, per_thread)
    # read before the checks below, whose engine.search calls are not served traffic
    launches, mv_launches = qs.query_scores.launches - launches0, qs.matvecs.launches - mv0
    dispatches = meter.count - dispatches0
    n_req = len(warm) + len(window)
    check(dispatches > 0 and launches == dispatches and mv_launches == dispatches,
          f"phase 9: query_scores launched {launches} times and matvecs {mv_launches}, "
          f"expected one each a dispatch, {dispatches}")
    check_served(engine, pool, warm + window)
    lat = [row[1] for row in window]
    res = dict(docs=QUERY_DOCS, client_threads=threads, requests=len(window),
               requests_per_s=len(window) / wall, latency_ms=pcts(lat),
               server_latency_ms=pcts([row[2] for row in window]),
               requests_per_dispatch=n_req / dispatches, dispatches=dispatches,
               launches=launches, matvecs_launches=mv_launches, distinct_queries=len(pool),
               results_per_query=float(np.mean([row[3] for row in window])))
    print("serve " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- character mode


def write_cfeature_index(torch, directory, prefix, tops, artifacts, rng, stamp, fdim=768):
    """A cfeature index over every doc of the chain, written as gen_cfeatures
    writes it: seeded unit rows in a shuffled order (row r holds doc perm[r]),
    norms in [0.5, 2.5), every row stamped ``stamp``. Each query's top-10 docs
    and 300 other docs share a direction (a character with a few hundred
    images), so the rerank finds matches; every other row is random."""
    n = QUERY_DOCS
    g = torch.Generator(device=DEV).manual_seed(13)
    rows = torch.randn(n, fdim, device=DEV, generator=g)
    perm = rng.permutation(n)
    row_of_doc = np.empty(n, np.int64)
    row_of_doc[perm] = np.arange(n)
    for top in tops:
        members = np.unique(np.concatenate([top, rng.choice(n, 300, replace=False)]))
        base = torch.nn.functional.normalize(torch.randn(fdim, device=DEV, generator=g), dim=0)
        noise = torch.randn(len(members), fdim, device=DEV, generator=g) * (0.1 / fdim) ** 0.5
        rows[torch.from_numpy(row_of_doc[members]).to(DEV)] = base + noise
    name = os.path.join(directory, artifacts.cfeatures_index_name(0))
    np.save(name + ".npy", torch.nn.functional.normalize(rows, dim=1).cpu().numpy())
    del rows
    np.save(name + ".norms.npy", (torch.rand(n, device=DEV, generator=g) * 2 + 0.5).cpu().numpy())
    np.save(name + ".stamps.npy", np.full(n, stamp, np.float64))
    with open(name + ".meta.json", "w", encoding="utf-8") as fh:
        json.dump({"build_started": stamp, "num_features": fdim, "num_docs": n,
                   "format": "aiis-tpu-simindex-v1"}, fh)
    with open(name, "w", encoding="utf-8") as fh:
        fh.write("aiis-tpu-simindex-v1\n")
    with open(os.path.join(directory, artifacts.CFEATURES_CSV), "w", encoding="utf-8") as fh:
        fh.writelines(f"{prefix}/{d:07d}.png\n" for d in perm)
    return n * fdim * 4


def check_rerank_diffs(torch, qs, caformer, args, out) -> dict:
    """One timed character query's rerank at F=768 against its plain version:
    the query's own mean feature through the kernel's rerank form (``matvecs``,
    as every character 1 - cos runs) and through ``plain_matvecs`` over every
    cfeature row, then the program's candidates (the ``cap`` smallest diffs)
    and its match count against the plain 1 - cos of the same rows."""
    features, docid_to_row, thresh, k, cap = args[4:9]
    cf_matrix, cf_norms = features.matrix[0], features.norms[0]
    row = out.cpu().numpy()
    check(row[2 * k] == 1, "the checked character query did not gather its top-10 rows")
    rows = docid_to_row[torch.from_numpy(row[k:2 * k].astype(np.int64)).to(DEV)]
    mean = caformer.ccip_mean_feature_from_rows_op(cf_matrix, cf_norms, rows,
                                                   torch.ones_like(rows, dtype=torch.bool))
    q = mean.double()
    q = (q / torch.linalg.vector_norm(q)).float()[None]      # as _one_minus_cos normalizes
    got = qs.matvecs(cf_matrix, q)[0]
    plain = qs.plain_matvecs(cf_matrix, q)[0]
    full_err = (got - plain).abs().max().item()
    check(full_err <= QUERY_TOL, f"rerank 1 - cos at F=768: |kernel-plain| {full_err} > "
                                 f"{QUERY_TOL} over {cf_matrix.shape[0]} rows")
    plain_diffs = 1.0 - plain
    cand_idx = torch.from_numpy(row[2 * k + 2:2 * k + 2 + cap].astype(np.int64)).to(DEV)
    cand_diffs = torch.from_numpy(row[2 * k + 2 + cap:]).to(DEV)
    cand_err = (cand_diffs - plain_diffs[cand_idx].double()).abs().max().item()
    check(cand_err <= QUERY_TOL, f"candidate diffs vs plain 1 - cos: {cand_err} > {QUERY_TOL}")
    # the candidates are the cap smallest plain diffs, up to ties within the tolerance
    cap_th = torch.kthvalue(plain_diffs, cap).values.item()
    check(cand_diffs.max().item() <= cap_th + 2 * QUERY_TOL,
          f"a candidate's diff {cand_diffs.max().item()} is past the plain {cap}th {cap_th}")
    count, plain_count = int(row[2 * k + 1]), int((plain_diffs < thresh).sum().item())
    near = int(((plain_diffs - thresh).abs() <= QUERY_TOL).sum().item())
    check(abs(count - plain_count) <= near,
          f"match count {count} vs plain {plain_count} (+-{near} within the tolerance)")
    return dict(rows=cf_matrix.shape[0], F=cf_matrix.shape[1], max_abs_err=full_err,
                candidate_max_abs_err=cand_err, count=count, plain_count=plain_count)


def phase_character(torch, fq, qs, fa, caformer, rerank_ccip, artifacts, webui, ui, tokens,
                    rng, directory) -> dict:
    """Character mode over phase 8's 1M-doc chain. Set-up (not counted): each
    query's top-10 docs from an untimed stage-A pass, the cfeature index, the
    top-10 files on disk with mtimes before the rows' stamps, the reranker as
    WebUIServer.load wires it, and the lazy loads of a first query. Counted:
    64 single character queries through the engine, 8 one- vs two-dispatch
    pairs, 4 queries with a stale top-10 file (the live CAFormer forward at
    k=10) and 16 character requests through the web server."""
    from PIL import Image

    engine = ui.engine
    s = engine.cfg.search
    k, topn = s.rerank_top_k, s.topn
    prefix = os.path.join(directory, "img")
    texts = [query_text(tokens, q) for q in make_queries(rng, zipf_cdf(len(tokens)), 84)]
    timed, compare, stale, served = texts[:64], texts[64:72], texts[72:76], texts[76:84]
    t0 = time.perf_counter()
    tops = []
    for t in texts:
        packed, _ = engine._pack_fused_with_query(t)
        with torch.inference_mode():
            out = fq.fused_character_top(
                engine._docs, torch.from_numpy(packed[None]).to(DEV), s.bm25_weight,
                s.doc2vec_weight, k)[0].cpu().numpy()
        tops.append(out[k:].astype(np.int64))
    stamp = time.time() - 60
    index_bytes = write_cfeature_index(torch, directory, prefix, tops, artifacts, rng, stamp)
    os.makedirs(prefix, exist_ok=True)
    for d in np.unique(np.concatenate(tops)):
        path = f"{prefix}/{d:07d}.png"
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(path)
        os.utime(path, (stamp - 100, stamp - 100))
    t1 = time.perf_counter()
    check(ui.has_character_mode(), "the web server does not offer character mode")
    reranker = rerank_ccip.CCIPReranker(directory=directory, config=engine.cfg, engine=engine)
    engine.cfeature_reranker = reranker
    engine.find_similar_documents(timed[0], topn, CHARACTER)   # the lazy loads
    t2 = time.perf_counter()
    os.environ["AIIS_RERANK_LIVE"] = "1"                        # warm the live path once
    try:
        engine.find_similar_documents(timed[0], topn, CHARACTER)
    finally:
        del os.environ["AIIS_RERANK_LIVE"]
    on_card = reranker.cfeatures_idx.device_matrix()
    check(on_card.shape == (QUERY_DOCS, 768) and on_card.device.type == DEV,
          "cfeature rows not on the card")

    qs.reset_launches()
    dh32_0 = fa.mha_attention.launches[32]
    cfd0, fb0 = engine.character_fused_dispatches, reranker.one_dispatch_fallbacks
    full = []
    orig_full = reranker.predictor.rerank_diffs_from_rows
    reranker.predictor.rerank_diffs_from_rows = \
        lambda *a, **kw: full.append(1) or orig_full(*a, **kw)
    events, probe, orig_prog = [], [], caformer._character_query_matches_impl

    def timed_prog(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig_prog(*a, **kw)
        end.record()
        events.append((start, end))
        if not probe:
            probe.append((a, out))
        return out

    # the web server's micro-batches reach the batched program: B queries in
    # one pass (the single program runs it at B = 1, not counted here)
    batched, orig_batch = [], caformer.ccip_character_query_matches_batch_op

    def counted_batch(*a, **kw):
        if a[1].shape[0] > 1:                  # the packed batch
            batched.append(a[1].shape[0])
        return orig_batch(*a, **kw)

    caformer._character_query_matches_impl = timed_prog
    caformer.ccip_character_query_matches_batch_op = counted_batch
    try:
        find, assemble, matches = [], [], []
        for t in timed:
            h0 = time.perf_counter()
            sims = engine.find_similar_documents(t, topn, CHARACTER)
            h1 = time.perf_counter()
            infos = engine.search(t, search_mode=CHARACTER, similar_docs=sims)
            find.append((h1 - h0) * 1e3)
            assemble.append((time.perf_counter() - h1) * 1e3)
            matches.append(len(sims) - k)
            # the top-10 keep their fused scores (-inf where a required tag is
            # missing, as in the reference); the matches' 1 - diff are finite
            check(len(sims) >= k and len(infos) <= len(sims)
                  and not any(np.isnan(v) for _, v in sims[:k])
                  and all(np.isfinite(v) for _, v in sims[k:]),
                  f"{t!r}: a short or NaN character answer")
        torch.cuda.synchronize()
        prog_ms = [a.elapsed_time(b) for a, b in events]
        for t in compare:
            one = engine.find_similar_documents(t, topn, CHARACTER)
            os.environ["AIIS_CHAR_ONE_DISPATCH"] = "0"
            try:
                two = engine.find_similar_documents(t, topn, CHARACTER)
            finally:
                del os.environ["AIIS_CHAR_ONE_DISPATCH"]
            check(one == two, f"{t!r}: one-dispatch and two-dispatch answers differ")
        stale_ms = []
        for t, top in zip(stale, tops[72:76]):
            path, fb = f"{prefix}/{top[0]:07d}.png", reranker.one_dispatch_fallbacks
            os.utime(path, (stamp + 1000, stamp + 1000))
            try:
                h0 = time.perf_counter()
                sims = engine.find_similar_documents(t, topn, CHARACTER)
                stale_ms.append((time.perf_counter() - h0) * 1e3)
            finally:
                os.utime(path, (stamp - 100, stamp - 100))
            check(reranker.one_dispatch_fallbacks == fb + 1 and len(sims) >= k,
                  f"{t!r}: a stale top-10 file did not take the live path")
        warm, wall, window = serve_requests(webui, ui, served, 4, 4, CHARACTER)
    finally:
        caformer._character_query_matches_impl = orig_prog
        caformer.ccip_character_query_matches_batch_op = orig_batch
        reranker.predictor.rerank_diffs_from_rows = orig_full
    launches, mv_launches = qs.query_scores.launches, qs.matvecs.launches
    dh32 = fa.mha_attention.launches[32] - dh32_0
    n_queries = engine.character_fused_dispatches - cfd0
    fallbacks = reranker.one_dispatch_fallbacks - fb0
    passes = n_queries - sum(batched) + len(batched)
    # a pass: stage A's scores, then one 1 - cos; a fallback's live forward and
    # a full-diffs dispatch: one more 1 - cos each
    check(launches == passes and mv_launches == passes + fallbacks + len(full),
          f"phase 13: query_scores launched {launches} times and matvecs {mv_launches}, "
          f"expected {passes} passes ({n_queries} queries, {len(batched)} batched passes of "
          f"{sum(batched)}) and passes + {fallbacks} fallbacks + {len(full)} full-diffs "
          "dispatches")
    check(dh32 == 18 * len(stale), f"{dh32} Dh=32 launches for {len(stale)} live forwards")
    rerank_check = check_rerank_diffs(torch, qs, caformer, *probe[0])   # launches not counted
    print("character rerank vs plain " + json.dumps(rerank_check), flush=True)
    check_served(engine, served, warm + window, CHARACTER)
    profiled = device_profile(torch, lambda: [engine.search(t, search_mode=CHARACTER)
                                              for t in timed[:8]])
    res = dict(docs=QUERY_DOCS, cfeature_gb_on_card=index_bytes / 1e9,
               setup_s=t1 - t0, lazy_load_s=t2 - t1,
               single=dict(find_ms=pcts(find), assemble_ms=pcts(assemble),
                           engine_ms=pcts([a + b for a, b in zip(find, assemble)]),
                           program_event_ms=pcts(prog_ms),
                           matches=dict(mean=float(np.mean(matches)), min=int(np.min(matches)),
                                        max=int(np.max(matches)))),
               stale_file_ms=stale_ms, one_vs_two_dispatch_equal=len(compare),
               serve=dict(requests=len(warm) + len(window),
                          requests_per_s=len(window) / wall,
                          latency_ms=pcts([row[1] for row in window])),
               profiled_window=dict(queries="8 single", **profiled),
               rerank_vs_plain=rerank_check,
               queries=n_queries, batched_passes=batched, fallbacks=fallbacks,
               full_diffs_dispatches=len(full), launches=launches,
               matvecs_launches=mv_launches, live_forwards=len(stale) + 1)   # + the warm-up's
    print("character " + json.dumps(res), flush=True)
    return res, dict(texts=texts, reranker=reranker)


# ---------------------------------------------------------------- 15. CCIP from ONNX

METRIC_H = 1024           # the learned metric's hidden width (an absdiff MLP at F=768)
METRIC_TOL = 1e-5         # |learned metric on the card - numpy executor|: f32 sums
METRIC_THRESHOLD = 0.72   # metrics.json: the reranker matches below 0.72 / 1.5
METRIC_ROWS = 4096        # rows held against the numpy executor


def export_feat_graph(opb, model, img_size: int):
    """The export-style model_feat graph of a port CAFormer, as a PyTorch
    export of the metaformer CAFormer writes it: metaformer state-dict names;
    each Linear on a >2-D activation folded into a pre-transposed
    ``onnx::MatMul_N`` initializer fed to a MatMul node, in forward order,
    with attention's two weight-less MatMuls beside the qkv one; the head's
    Linears as Gemm nodes under their names; the zero biases of the
    bias-free layers (block Linears, LayerNorms, the depthwise conv) left
    out. The converter reads only the initializers and the MatMul/Gemm
    order, so no other node is written."""
    state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    g = opb.GraphP(name="model_feat")
    n_mm = [0]

    def put(name, key, bias_free=False):
        arr = state.pop(key)
        if bias_free:
            check(not arr.any(), f"{key} is not zero: it cannot be left out of the export")
        else:
            g.initializers[name] = arr

    def matmul(key, attention=False):
        name = f"onnx::MatMul_{1000 + n_mm[0]}"
        n_mm[0] += 1
        g.initializers[name] = np.ascontiguousarray(state.pop(key).T)
        g.nodes.append(opb.NodeP(op_type="MatMul", inputs=[f"x_{name}", name],
                                 outputs=[f"y_{name}"]))
        for j in range(2 if attention else 0):   # q @ k^T and p @ v: no weights
            g.nodes.append(opb.NodeP(op_type="MatMul", inputs=[f"a{j}_{name}", f"b{j}_{name}"],
                                     outputs=[f"c{j}_{name}"]))

    def norm(name, key):
        put(f"{name}.weight", f"{key}.weight")
        put(f"{name}.bias", f"{key}.bias", bias_free=True)

    put("downsample_layers.0.conv.weight", "stem.weight")
    put("downsample_layers.0.conv.bias", "stem.bias")
    norm("downsample_layers.0.post_norm", "stem_norm")
    cfg = model.cfg
    for s in range(4):
        if s:
            norm(f"downsample_layers.{s}.pre_norm", f"downsample_{s}_norm")
            put(f"downsample_layers.{s}.conv.weight", f"downsample_{s}.weight")
            put(f"downsample_layers.{s}.conv.bias", f"downsample_{s}.bias")
        for b in range(cfg.depths[s]):
            src, dst = f"stage{s}_block{b}", f"stages.{s}.{b}"
            norm(f"{dst}.norm1", f"{src}.norm1")
            if cfg.num_heads[s]:
                matmul(f"{src}.mixer.qkv.weight", attention=True)
                put("", f"{src}.mixer.qkv.bias", bias_free=True)
                matmul(f"{src}.mixer.proj.weight")
                put(f"{dst}.token_mixer.proj.bias", f"{src}.mixer.proj.bias")
            else:
                matmul(f"{src}.mixer.pw1.weight")
                put("", f"{src}.mixer.pw1.bias", bias_free=True)
                for leaf in ("scale", "bias"):
                    put(f"{dst}.token_mixer.act1.{leaf}", f"{src}.mixer.act.{leaf}")
                put(f"{dst}.token_mixer.dwconv.weight", f"{src}.mixer.dw.weight")
                put("", f"{src}.mixer.dw.bias", bias_free=True)
                matmul(f"{src}.mixer.pw2.weight")
                put("", f"{src}.mixer.pw2.bias", bias_free=True)
            if cfg.res_scale_stages[s]:
                for r in ("res_scale1", "res_scale2"):
                    put(f"{dst}.{r}.scale", f"{src}.{r}")
            norm(f"{dst}.norm2", f"{src}.norm2")
            matmul(f"{src}.mlp.fc1.weight")
            put("", f"{src}.mlp.fc1.bias", bias_free=True)
            for leaf in ("scale", "bias"):
                put(f"{dst}.mlp.act.{leaf}", f"{src}.mlp.act.{leaf}")
            matmul(f"{src}.mlp.fc2.weight")
            put("", f"{src}.mlp.fc2.bias", bias_free=True)
    norm("norm", "norm")
    for name, key in (("head.fc1", "head_fc1"), ("head.norm", "head_norm"),
                      ("head.fc2", "head_fc2")):
        put(f"{name}.weight", f"{key}.weight")
        put(f"{name}.bias", f"{key}.bias")
        if name != "head.norm":
            g.nodes.append(opb.NodeP(op_type="Gemm", inputs=[f"x_{name}", f"{name}.weight",
                                                             f"{name}.bias"],
                                     outputs=[f"y_{name}"],
                                     attributes={"transB": opb.AttrP.make("transB", 1)}))
    check(not state, f"parameters left out of the export: {sorted(state)[:5]}")
    g.inputs.append(("input", (None, 3, img_size, img_size)))
    g.outputs.append(("output", (None, cfg.feature_dim)))
    return g


def metric_graph(opb, f: int, h: int, seed: int = 15):
    """A learned pairwise metric in the layout of a PyTorch export: the rows
    L2-normalized, then diff[i, j] = relu(|a_i - a_j| @ W1 + b1) @ W2 + b2,
    squeezed to (N, N) through Shape/Gather/Unsqueeze/Concat/Reshape
    plumbing. W1 and W2 are positive, so the diff grows with the L1 distance
    of the unit rows (about L1 / 40): a character's cluster lies far below
    METRIC_THRESHOLD / 1.5, random rows far above it."""
    rng = np.random.default_rng(seed)
    g = opb.GraphP(name="model_metrics")
    g.initializers.update(
        W1=(np.abs(rng.standard_normal((f, h))) / (0.7979 * f)).astype(np.float32),
        b1=np.zeros(h, np.float32),
        W2=np.full((h, 1), f / (40.0 * h), np.float32),
        b2=np.zeros(1, np.float32),
        ax_row=np.asarray([1], np.int64), ax_col=np.asarray([0], np.int64),
        i0=np.asarray(0, np.int64), i1=np.asarray(1, np.int64))
    node = opb.NodeP
    g.nodes.extend([
        node(op_type="ReduceL2", inputs=["feats"], outputs=["nrm"],
             attributes={"axes": opb.AttrP.make("axes", [1]),
                         "keepdims": opb.AttrP.make("keepdims", 1)}),
        node(op_type="Div", inputs=["feats", "nrm"], outputs=["unit"]),
        node(op_type="Unsqueeze", inputs=["unit", "ax_row"], outputs=["a"]),
        node(op_type="Unsqueeze", inputs=["unit", "ax_col"], outputs=["b"]),
        node(op_type="Sub", inputs=["a", "b"], outputs=["d"]),
        node(op_type="Abs", inputs=["d"], outputs=["ad"]),
        node(op_type="MatMul", inputs=["ad", "W1"], outputs=["h0"]),
        node(op_type="Add", inputs=["h0", "b1"], outputs=["h1"]),
        node(op_type="Relu", inputs=["h1"], outputs=["h2"]),
        node(op_type="MatMul", inputs=["h2", "W2"], outputs=["m0"]),
        node(op_type="Add", inputs=["m0", "b2"], outputs=["m1"]),
        node(op_type="Shape", inputs=["m1"], outputs=["shp"]),
        node(op_type="Gather", inputs=["shp", "i0"], outputs=["n0"],
             attributes={"axis": opb.AttrP.make("axis", 0)}),
        node(op_type="Gather", inputs=["shp", "i1"], outputs=["n1"],
             attributes={"axis": opb.AttrP.make("axis", 0)}),
        node(op_type="Unsqueeze", inputs=["n0", "ax_col"], outputs=["n0u"]),
        node(op_type="Unsqueeze", inputs=["n1", "ax_col"], outputs=["n1u"]),
        node(op_type="Concat", inputs=["n0u", "n1u"], outputs=["tgt"],
             attributes={"axis": opb.AttrP.make("axis", 0)}),
        node(op_type="Reshape", inputs=["m1", "tgt"], outputs=["diff"]),
    ])
    g.inputs.append(("feats", (None, f)))
    g.outputs.append(("diff", (None, None)))
    return g


def phase_ccip_onnx(torch, fa, qs, caformer, config_mod, rerank_ccip, webui, ui, char_ctx,
                    gen_ctx, directory) -> tuple:
    """The published-file path on the card, from synthetic files of the
    published layout: phase 11's seeded CAFormer-24 written as an
    export-style model_feat.onnx, an absdiff-MLP model_metrics.onnx (F=768,
    H=1024) and a metrics.json, converted by cli.convert_ccip. Gates: the
    converted weights equal the seeded ones bit for bit, and so do the
    features of CCIPPredictor(model_dir) on 16 images; gen_cfeatures
    --model-dir on phase 12's PNGs gives phase 12's rows; the learned metric
    on phase 13's 1M cfeature rows agrees with the numpy executor on 4,096
    of them. Timed: the learned metric a query (and its peak memory), 64
    character queries through the engine with it; then, with 1 - cos, 32
    bursts of 8 through the batched character program (each answer equal to
    the query's single-query answer) and 16 client threads of character
    requests through the web server. Returns (results, forwards run,
    query_scores launch times at the character path's B, kept apart from
    the counts)."""
    from anime_illust_image_searcher_tpu_torch.cli import convert_ccip, gen_cfeatures
    from anime_illust_image_searcher_tpu_torch.index import artifacts, similarity
    from anime_illust_image_searcher_tpu_torch.models import ccip as ccip_mod
    from anime_illust_image_searcher_tpu_torch.models import ccip_weights
    from anime_illust_image_searcher_tpu_torch.models import onnx_pb as opb

    engine = ui.engine
    k, topn = engine.cfg.search.rerank_top_k, engine.cfg.search.topn
    reranker13 = char_ctx["reranker"]
    texts = char_ctx["texts"]
    rng = np.random.RandomState(15)
    cfg = config_mod.CCIPConfig()
    work = os.path.join(directory, "ccip_onnx")
    os.makedirs(work)

    # 1. the published files' layout, written by the port's ONNX writer
    t0 = time.perf_counter()
    seeded = ccip_mod.CCIPPredictor(cfg, device=DEV)       # phase 11's seeded weights
    seeded.load_model()
    feat_path = os.path.join(work, "model_feat.onnx")
    opb.save_model(opb.ModelP(graph=export_feat_graph(opb, seeded.model, cfg.image_size)),
                   feat_path)
    mgraph = metric_graph(opb, cfg.feature_dim, METRIC_H)
    metric_path = os.path.join(work, "model_metrics.onnx")
    opb.save_model(opb.ModelP(graph=mgraph), metric_path)
    with open(os.path.join(work, "metrics.json"), "w", encoding="utf-8") as fh:
        json.dump({"threshold": METRIC_THRESHOLD}, fh)
    dest = os.path.join(work, "ckpt")
    t1 = time.perf_counter()
    rc = convert_ccip.main(["--feat", feat_path, "--metrics", metric_path, "--metrics-json",
                            os.path.join(work, "metrics.json"), "--dest", dest,
                            "--skip-forward-check"], device=DEV)
    t2 = time.perf_counter()
    check(rc == 0, f"cli.convert_ccip returned {rc}")
    check(os.path.exists(os.path.join(dest, "model_metrics.onnx")),
          "the learned metric was not shipped with the checkpoint")

    # 2. weights and features: the seeded model's, bit for bit
    ccfg, state, thr = ccip_weights.load_ccip_checkpoint(dest)
    want = seeded.model.state_dict()
    check(sorted(state) == sorted(want), "converted keys differ from the seeded model's")
    differ = [key for key in want if state[key].shape != want[key].shape
              or not torch.equal(state[key], want[key].float().cpu())]
    check(not differ, f"converted weights differ from the seeded ones: {differ[:5]}")
    base = caformer.CAFormerConfig()
    check(ccfg.dims == base.dims and ccfg.depths == base.depths
          and ccfg.num_heads == base.num_heads and thr == METRIC_THRESHOLD
          and all(ccfg.mlp_hidden_of(s, b) == base.mlp_hidden_of(s, b)
                  and (base.num_heads[s]
                       or ccfg.sepconv_hidden_of(s, b) == base.sepconv_hidden_of(s, b))
                  for s in range(4) for b in range(base.depths[s])),
          f"the converted config is not CAFormer-24's: {ccfg}")
    converted = ccip_mod.CCIPPredictor(cfg, model_dir=dest, device=DEV)
    converted.load_model()
    check(converted.uses_learned_metric(), "the converted checkpoint's metric is not learned")
    imgs = rng.randint(0, 256, (16, 384, 384, 3), dtype=np.uint8)
    f_seed = seeded.ccip_batch_extract_features(imgs)
    f_conv = converted.ccip_batch_extract_features(imgs)
    feat_diff = float(np.abs(f_seed - f_conv).max())
    check(np.isfinite(f_conv).all() and np.array_equal(f_seed, f_conv),
          f"features of the converted model differ from the seeded model's by {feat_diff}")
    forwards = 2
    del seeded
    torch.cuda.empty_cache()

    # 3. gen_cfeatures --model-dir on phase 12's PNGs: phase 12's rows
    gen_dir = os.path.join(work, "gen")
    os.makedirs(gen_dir)
    cwd = os.getcwd()
    os.chdir(gen_dir)
    try:
        t3 = time.perf_counter()
        gen_cfeatures.main(["--dir", gen_ctx["imgs"], "--model-dir", dest], device=DEV)
        gen_s = time.perf_counter() - t3
        with open(artifacts.CFEATURES_CSV, encoding="utf-8") as fh:
            paths = fh.read().splitlines()
        rev0 = similarity.SimilarityIndex.load(artifacts.cfeatures_index_name(0))
    finally:
        os.chdir(cwd)
    check(sorted(os.path.basename(p) for p in paths) == sorted(gen_ctx["rows"]),
          "gen_cfeatures --model-dir did not index phase 12's PNGs")
    gen_err = max(float(np.abs(np.asarray(r) - gen_ctx["rows"][os.path.basename(p)]).max())
                  for p, r in zip(paths, rev0.matrix))
    check(gen_err <= 1e-6, f"gen_cfeatures --model-dir rows differ from phase 12's by {gen_err}")
    forwards += -(-len(paths) // cfg.batch_size)
    convert_res = dict(card=smi_line(), feat_onnx_mb=os.path.getsize(feat_path) / 2 ** 20,
                       write_s=t1 - t0, convert_s=t2 - t1, initializers=len(state),
                       weights_bit_equal=True, features_bit_equal=True, images=len(imgs),
                       gen_cfeatures=dict(images=len(paths), seconds=gen_s,
                                          rows_vs_phase12_max_diff=gen_err))
    print("ccip convert " + json.dumps(convert_res), flush=True)

    # 4. the learned metric over phase 13's 1M cfeature rows
    index = reranker13.cfeatures_idx
    cf_dev, norms_dev = index.device_matrix(), index.device_norms()
    top_files = [engine.image_files_name_tags_arr[d].split(",")[0]
                 for d, _ in engine.find_similar_documents(texts[0], topn, CHARACTER)[:k]]
    rows = torch.tensor([reranker13._row_of[p] for p in top_files], device=DEV)
    query = caformer.ccip_mean_feature_from_rows_op(cf_dev, norms_dev, rows,
                                                    torch.ones_like(rows, dtype=torch.bool))
    q_np = query.cpu().numpy()
    t4 = time.perf_counter()
    diffs = converted.ccip_differences_vs_index(index.matrix, q_np)   # numpy in, numpy out
    vs_index_s = time.perf_counter() - t4
    sample = np.concatenate([rows.cpu().numpy(), rng.choice(len(index), METRIC_ROWS - k,
                                                            replace=False)])
    ref = np.asarray([ccip_weights.execute_graph(mgraph, {"feats": np.stack(
        [q_np, np.asarray(index.matrix[r], np.float32)])})[0][0, 1] for r in sample])
    metric_err = float(np.abs(diffs[sample] - ref).max())
    check(diffs.shape == (len(index),) and np.isfinite(diffs).all()
          and metric_err <= METRIC_TOL,
          f"learned metric vs the numpy executor: {metric_err} > {METRIC_TOL}")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metric_ms = cuda_ms(lambda: converted._metric_vs_index(cf_dev, query), iters=3, warmup=1)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    n_rows, f = cf_dev.shape
    # each row's 2-row graph: 4 pairs of |a - b| @ W1 (F x H) and @ W2 (H x 1)
    metric_bound = n_rows * 4 * 2 * f * (METRIC_H + 1) / PEAK_F32_FLOPS * 1e3
    learned = rerank_ccip.CCIPReranker(directory=directory, config=engine.cfg, engine=engine,
                                       predictor=converted)
    for attr in ("cfeature_filepath_idx", "cfeatures_idx", "_row_of", "_row_stamps",
                 "_all_norms_known"):
        setattr(learned, attr, getattr(reranker13, attr))   # phase 13's loaded index
    engine.cfeature_reranker = learned
    try:
        check(engine._character_one_dispatch_inputs() is None,
              "the one-dispatch 1 - cos program serves a learned metric")
        learned_ms, learned_matches = [], []
        for t in texts[:64]:
            h0 = time.perf_counter()
            sims = engine.find_similar_documents(t, topn, CHARACTER)
            learned_ms.append((time.perf_counter() - h0) * 1e3)
            learned_matches.append(len(sims) - k)
            scores = [v for _, v in sims[k:]]
            check(len(sims) >= k and all(np.isfinite(scores))
                  and scores == sorted(scores, reverse=True),
                  f"{t!r}: a malformed learned-metric answer")
    finally:
        engine.cfeature_reranker = reranker13
    # (a query whose required or excluded tags filter every cluster member
    # out has no matches, with either metric)
    check(max(learned_matches) > 0, "the learned metric matched no row in 64 queries")
    metric_res = dict(card=smi_line(), rows=n_rows, F=f, H=METRIC_H,
                      chunk_rows=ccip_weights.METRIC_CHUNK_ROWS,
                      vs_executor=dict(rows=len(sample), max_abs_err=metric_err,
                                       tol=METRIC_TOL),
                      metric_ms=metric_ms, metric_bound_ms=metric_bound,
                      metric_bound_by="operations", peak_gb=peak_gb,
                      vs_index_numpy_s=vs_index_s,
                      engine=dict(queries=len(learned_ms), engine_ms=pcts(learned_ms),
                                  matches=dict(mean=float(np.mean(learned_matches)),
                                               min=int(min(learned_matches)),
                                               max=int(max(learned_matches)))))
    print("learned metric " + json.dumps(metric_res), flush=True)
    del converted, learned
    torch.cuda.empty_cache()

    # 5. the batched character program (1 - cos): 32 bursts of 8
    bursts = [[texts[i] for i in rng.choice(len(texts), 8, replace=False)] for _ in range(32)]
    engine.find_similar_documents_batch(bursts[0], topn, CHARACTER)   # warm the batched shapes
    burst_ms, single_ms = [], []
    for burst in bursts:
        h0 = time.perf_counter()
        outs = engine.find_similar_documents_batch(burst, topn, CHARACTER)
        burst_ms.append((time.perf_counter() - h0) * 1e3)
        for t, out in zip(burst, outs):
            h0 = time.perf_counter()
            one = engine.find_similar_documents(t, topn, CHARACTER)
            single_ms.append((time.perf_counter() - h0) * 1e3)
            check(out == one, f"{t!r}: the batched answer differs from the single-query one")

    # 6. character requests through the web server's micro-batcher
    served = texts[:16]
    sizes, orig_batch = [], engine.find_similar_documents_batch

    def counted(docs, topn=50, search_mode="normal"):
        if search_mode == CHARACTER:
            sizes.append(len(docs))
        return orig_batch(docs, topn, search_mode)

    engine.find_similar_documents_batch = counted
    try:
        warm, wall, window = serve_requests(webui, ui, served, 16, 8, CHARACTER)
    finally:
        del engine.find_similar_documents_batch
    check_served(engine, served, warm + window, CHARACTER)
    passes = sum(-(-n // 8) for n in sizes)
    batch_res = dict(card=smi_line(), bursts=len(bursts), burst=8,
                     burst_ms=pcts(burst_ms), ms_per_query=sum(burst_ms) / (8 * len(bursts)),
                     single_ms=pcts(single_ms), answers_equal=8 * len(bursts),
                     serve=dict(threads=16, requests=len(warm) + len(window),
                                requests_per_s=len(window) / wall,
                                latency_ms=pcts([row[1] for row in window]),
                                batch_calls=len(sizes), requests_per_call=sum(sizes) / len(sizes),
                                device_passes=passes,
                                requests_per_pass=sum(sizes) / passes))
    return convert_res, metric_res, batch_res, forwards


def time_character_kernels(torch, qs, engine, texts, cf_dev) -> dict:
    """The K5 kernels at the character path's batch sizes (after the counted
    run; these launches are not counted): the matvecs kernel on the 1M
    cfeature rows at B = 2, 4, 8, held to the old route's bits and to the
    plain version, timed in turns with the old route (the query-scores kernel
    with no term slots) and torch.mm over the same B vectors, beside the
    plain version; and the scoring kernel (stage A) at B = 8 on the chain."""
    out = {}
    gen = torch.Generator(device=DEV).manual_seed(151)
    f = cf_dev.shape[1]
    for b in (2, 4, 8):
        vecs = torch.nn.functional.normalize(
            torch.randn(b, f, device=DEV, generator=gen), dim=1)
        err = check_matvecs(torch, qs, cf_dev, vecs, f"the cfeature rows, B={b}")
        res = time_matvecs(torch, qs, cf_dev, vecs, iters=10)
        res.update(plain_ms=cuda_ms(lambda: qs.plain_matvecs(cf_dev, vecs), iters=1, warmup=1),
                   max_abs_err=err)
        out[f"matvecs B={b}"] = res
    docs = engine._docs
    matrix, term_mat, contrib_mat = docs.matrix[0], docs.term_mat[0], docs.contrib_mat[0]
    packed = [engine._pack_fused(t) for t in texts[:8]]
    buflen = max(p.shape[0] for p in packed)
    mt = (buflen - engine.model.vector_size - 1) // 4
    batch = torch.from_numpy(np.stack([engine._pack_fused(t, max_terms=mt)
                                       for t in texts[:8]])).to(DEV)
    ms = cuda_ms(lambda: qs.query_scores(matrix, term_mat, contrib_mat, batch), iters=10)
    bound, by = query_bound(matrix.shape[0], matrix.shape[1], term_mat.shape[1], mt, 8)
    out["scores B=8"] = dict(ms=ms, Q=mt, bound_ms=bound, bound_by=by)
    return out


# ---------------------------------------------------------------- 14. index build

D2V_TOL = 1e-5          # max |card - CPU| of trained docvecs/syn1neg and inferred vectors
TRAIN_DOCS = 20_000     # gates 2 and 4: genmodel twice, then an engine over the chain
PARITY_DOCS = 2_000     # gate 3: card against CPU training
TRAIN_BUDGET_S = 30.0   # the timed 1M-doc training runs as many epochs as fit
INFER_DOCS = 16_384     # timed inference at infer_epochs=100


def tag_docs(n_docs: int, vocab: int, seed: int):
    """Tag documents from the Zipf-like generators of phase 8: each doc's
    10-30 distinct tags (``tag_{id:05d}``), the tag names and the generator."""
    rng = np.random.default_rng(seed)
    tags, n_distinct = distinct_tags(rng, zipf_cdf(vocab), n_docs, 40)
    lens = np.minimum(rng.integers(10, 31, n_docs), n_distinct)
    tokens = [f"tag_{i:05d}" for i in range(vocab)]
    docs = [[tokens[t] for t in row[:n]] for row, n in zip(tags.tolist(), lens.tolist())]
    return docs, tokens, rng


def write_tags_file(directory: str, docs) -> None:
    with open(os.path.join(directory, "tags-wd-tagger.txt"), "w", encoding="utf-8") as fh:
        fh.writelines(f"/img/{i:07d}.png,{','.join(d)}\n" for i, d in enumerate(docs))


def run_genmodel(genmodel, directory: str, args) -> float:
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        t0 = time.perf_counter()
        genmodel.main(args, device=DEV)
        return time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def artifact_bytes(directory: str) -> dict:
    """Every file of an artifact chain but the serve caches' manifests (which
    record the pickles' mtimes), by relative path."""
    out = {}
    for root, _, files in os.walk(directory):
        for f in files:
            if f != "manifest.json":
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, directory)] = fh.read()
    return out


def draws(torch, d2v, prng, dev, vocab, words, mask, seeds):
    """One training step's and one inference epoch's keys and draws, each
    computed on ``dev`` from a key made there: the step keys (fold_in,
    split), the uniforms, the keep masks and the negatives (integer and bit
    paths)."""
    keep_prob = torch.from_numpy(vocab.keep_prob).to(dev)
    cum = torch.from_numpy(vocab.cum_table).to(dev)
    keys = d2v._step_keys(prng.PRNGKey(1, device=dev), 0, 1)[0]
    w = torch.from_numpy(words).to(dev).long()
    m = torch.from_numpy(mask).to(dev)
    out = dict(train_keys=keys, train_u=prng.uniform(keys[1], (*w.shape, 5)),
               train_live=d2v._downsample_mask(keys[0], keep_prob, w, m),
               train_negs=d2v._sample_negatives(keys[1], cum, (*w.shape, 5)))
    epoch_key = prng.fold_in(prng.PRNGKey(0, device=dev), 99)[None]
    k = prng.split(d2v._doc_keys(epoch_key, torch.from_numpy(seeds).to(dev))[0])
    iw, im = w[:len(seeds), :32], m[:len(seeds), :32]
    out.update(infer_keys=k, infer_u=prng.uniform(k[:, 0], (32,)),
               infer_live=d2v._downsample_mask(k[:, 0], keep_prob, iw, im),
               infer_negs=d2v._sample_negatives(k[:, 1], cum, (32, 5)))
    return {n: t.cpu() for n, t in out.items()}


def cuda_time(torch, fn, iters: int = 20) -> float:
    """Mean CUDA-event ms of ``fn`` over ``iters`` runs after 3 warm-ups."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def count_work(torch, d2v, fn) -> dict:
    """Runs ``fn`` with d2v._sgns_pairs and d2v._accumulate wrapped to count,
    from the draws the program itself makes, the work its data needs: the
    live (doc, word) and (doc, negative) pairs, the nonzero accumulator
    entries (what a sparse syn1 update touches), the distinct syn1 rows each
    call reads, and every row that any call reads."""
    saved, saved_acc = d2v._sgns_pairs, d2v._accumulate
    pairs, nnz, rows, touched = [], [], [], [None]

    def counting(dvec, syn1, words, live, negs, lr, need_pairs=True):
        out = saved(dvec, syn1, words, live, negs, lr, need_pairs)
        neg_live = live[..., None] * (negs != words[..., None])
        ids = torch.cat([words[live > 0], negs[neg_live > 0]]).unique()
        if touched[0] is None:
            touched[0] = torch.zeros(syn1.shape[0], dtype=torch.bool, device=syn1.device)
        touched[0][ids] = True
        pairs.append(live.sum() + neg_live.sum())
        rows.append(ids.numel())
        return out

    def accumulating(ids, gs, v):
        acc = saved_acc(ids, gs, v)
        nnz.append((acc != 0).sum())
        return acc

    d2v._sgns_pairs, d2v._accumulate = counting, accumulating
    try:
        fn()
    finally:
        d2v._sgns_pairs, d2v._accumulate = saved, saved_acc
    return dict(calls=len(pairs), pairs=float(sum(p.item() for p in pairs)),
                acc_nnz=float(sum(n.item() for n in nnz)), rows_per_call=float(np.mean(rows)),
                rows_touched=int(touched[0].sum().item()))


K9_GROUPS = ("rng_and_draws", "gathers", "sigmoid_einsum", "scatter", "acc_t_dvec_matmul",
             "other")
K9_FUNCTIONS = ("_step_keys", "_downsample_mask", "_sample_negatives", "_sgd_step",
                "_sgns_pairs", "_accumulate", "_apply_step", "_apply_syn1_update")


def k9_group(op: str, fn) -> str:
    """The group of a top-level aten op ``op`` called from the port's
    function ``fn`` (one of K9_FUNCTIONS, the innermost, or None)."""
    if fn in ("_step_keys", "_downsample_mask", "_sample_negatives"):
        return "rng_and_draws"
    if fn in ("_sgns_pairs", "_sgd_step") and op == "aten::index":
        return "gathers"
    if fn == "_sgns_pairs" and op in ("aten::einsum", "aten::sigmoid", "aten::rsub",
                                      "aten::mul", "aten::ne", "aten::add"):
        return "sigmoid_einsum"
    if fn in ("_sgns_pairs", "_sgd_step", "_accumulate", "_apply_step"):
        # the accumulator's zeros, the id/value cats, both index_put_s, and
        # over a mesh the gather of the shards' rows
        return "scatter"
    if fn == "_apply_syn1_update":
        return "acc_t_dvec_matmul"
    return "other"


def device_ms_by_group(prof, ops: dict) -> dict:
    """Every kernel's device ms in a profile taken under K9's FnLabels, by the
    K9 group of the top-level aten op that launched it; ``ops`` gets each
    such op's first chain of profiler parents, for a failure's message."""
    groups = dict.fromkeys(K9_GROUPS, 0.0)
    for e in prof.events():
        us = sum(k.duration for k in e.kernels)
        if not us:
            continue
        op = e
        while op.cpu_parent is not None and op.cpu_parent.name.startswith("aten::"):
            op = op.cpu_parent
        groups[k9_group(op.name, labelled_function(op, "k9"))] += us / 1e3
        if not ops.get(op.name):
            chain, p = [], e
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            ops[op.name] = chain
    return groups


def device_time(torch, prof) -> tuple:
    """(device ms, kernels) of a profile: every CUDA event's own time, and
    the launches that are not copies or memsets."""
    dev_ms, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            dev_ms += e.self_device_time_total / 1e3
            if "memcpy" not in e.key.lower() and "memset" not in e.key.lower():
                kernels += e.count
    return dev_ms, kernels


def k9_state(d2v, mesh, docs, cfg, b: int = 512) -> tuple:
    """The training state of ``docs`` (a multiple of ``b``) on ``mesh``, as
    Doc2VecModel.train places it, from a seeded doc-vector init and a zero
    syn1: (vocab, state, mask)."""
    vocab = d2v.Vocab.build(docs, cfg)
    ids = [[vocab.token2id[t] for t in d] for d in docs]
    words_np, mask_np = d2v.pad_corpus(ids, cfg.max_doc_len)
    nb = len(docs) // b
    init = np.random.RandomState(0).rand(len(docs), cfg.vector_size).astype(np.float32)
    state = d2v._train_state(
        mesh, (init - 0.5) / cfg.vector_size,
        np.zeros((len(vocab), cfg.vector_size), np.float32),
        np.arange(len(docs), dtype=np.int64).reshape(nb, b), words_np.reshape(nb, b, -1),
        mask_np.reshape(nb, b, -1), vocab.keep_prob, vocab.cum_table, cfg.seed)
    return vocab, state, mask_np


def step_profile(torch, d2v, prng, docs, cfg) -> dict:
    """Full-width training steps (B=512, L=128, K=5, dim 300, the 10k-tag
    vocabulary) on 40 batches of the corpus, through the real epoch loop
    (d2v._train_epoch): ms a step on CUDA events; one profiled 40-step epoch
    (busy share, kernels a step); a second, its K9_FUNCTIONS labelled, whose
    kernels' device time is bucketed by group; and the step's bound from
    the work an epoch's own draws need."""
    from torch.profiler import ProfilerActivity, profile

    from anime_illust_image_searcher_tpu_torch.parallel.mesh import device_mesh

    b, k, nb = 512, cfg.negative, 40
    vocab, state, mask_np = k9_state(d2v, device_mesh(DEV), docs[:nb * b], cfg, b)
    lr = float(np.float32(cfg.alpha))

    def epoch():
        d2v._train_epoch(state, 0, lr, k)

    step_ms = cuda_time(torch, epoch, 3) / nb
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, kernels = device_time(torch, prof)
    with FnLabels(torch, "k9", [(d2v, f) for f in K9_FUNCTIONS]), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch()
        torch.cuda.synchronize()
    chains = {}
    groups = {g: ms / nb for g, ms in device_ms_by_group(prof, chains).items()}
    check(all(groups[g] > 0 for g in K9_GROUPS[:-1]),
          f"index build: the profiled step's groups {groups} lack one; the ops that "
          f"launched kernels, each with its parents: {chains}")
    # the bound, from what this epoch's draws need: each live (doc, word) and
    # (doc, negative) pair's logit and d_doc dot products (2·2·dim) and each
    # nonzero accumulator entry's syn1 row update (2·dim), f32 at 67 TFLOP/s;
    # against the bytes, each input read once and each output written once:
    # the distinct syn1 rows a step touches (read and written), the batch's
    # doc rows (read and written), the unpadded words and mask
    work = count_work(torch, d2v, epoch)
    check(work["calls"] == nb, f"index build: counted {work['calls']} steps, expected {nb}")
    v, dim, l = len(vocab), cfg.vector_size, cfg.max_doc_len
    step_flop = (2 * 2 * dim * work["pairs"] + 2 * dim * work["acc_nnz"]) / nb
    step_bytes = (2 * work["rows_per_call"] * dim * 4 + 2 * b * dim * 4
                  + float(mask_np.sum()) / nb * (4 + 4))
    bound = max(step_bytes / PEAK_BYTES, step_flop / PEAK_F32_FLOPS) * 1e3
    # what the step as written streams: the gathered rows (B·L·(K+1) + B of
    # dim f32) and the dense (B, V) accumulator, at the HBM rate
    gather_bytes = (b * l * (k + 1) + b) * dim * 4 + b * v * 4
    return dict(step_ms=step_ms, device_ms_by_group=groups,
                device_ms_per_step=sum(groups.values()), profiled_steps=nb,
                window_wall_ms=wall, window_device_ms=dev_ms if dev_ms else "not measured",
                busy_share=dev_ms / wall if dev_ms else "not measured",
                kernels_per_step=kernels / nb, bound_ms=bound,
                bound_by="operations" if step_flop / PEAK_F32_FLOPS > step_bytes / PEAK_BYTES
                else "bytes", step_gflop=step_flop / 1e9, step_mb=step_bytes / 1e6,
                live_pairs_per_step=work["pairs"] / nb, acc_nnz_per_step=work["acc_nnz"] / nb,
                syn1_rows_per_step=work["rows_per_call"], gathered_bytes=gather_bytes,
                gathered_at_hbm_ms=gather_bytes / PEAK_BYTES * 1e3, vocab=v)


def infer_profile(torch, model, docs) -> dict:
    """One ``infer_vectors`` call over ``docs`` under torch.profiler: wall,
    device time, the busy share and the kernels it launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.infer_vectors(docs)
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, kernels = device_time(torch, prof)
    return dict(wall_ms=wall, device_ms=dev_ms if dev_ms else "not measured",
                busy_share=dev_ms / wall if dev_ms else "not measured",
                kernels_per_call=kernels)


def phase_index_gates(torch, genmodel, d2v, prng, engine_mod, config_mod, tmp) -> dict:
    """Gates 1-4 of the index build on a 20,000-doc tags file."""
    docs, tokens, rng = tag_docs(TRAIN_DOCS, 10_000, 14)
    cfg = config_mod.Doc2VecConfig()
    # 1. the draws of a training step and an inference epoch: card = CPU
    vocab = d2v.Vocab.build(docs, cfg)
    ids = [[vocab.token2id[t] for t in d] for d in docs[:512]]
    words, mask = d2v.pad_corpus(ids, cfg.max_doc_len)
    seeds = np.array([[s & 0xFFFFFFFF, s >> 32] for s in
                      (d2v._stable_doc_seed(d, cfg.seed) for d in ids[:256])], np.int64)
    on_card = draws(torch, d2v, prng, DEV, vocab, words, mask, seeds)
    on_cpu = draws(torch, d2v, prng, "cpu", vocab, words, mask, seeds)
    for name in on_card:
        check(torch.equal(on_card[name], on_cpu[name]), f"index build: {name} differ card vs CPU")
    # the accumulator of a step whose 6-word vocabulary makes most pairs
    # collide: five builds bit-equal (index_add_'s float atomics, beside it,
    # need not be)
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(512, 300, generator=g).to(DEV), torch.randn(6, 300, generator=g).to(DEV),
            torch.randint(0, 6, (512, 128), generator=g).to(DEV),
            (torch.rand(512, 128, generator=g) < 0.8).float().to(DEV),
            torch.randint(0, 6, (512, 128, 5), generator=g).to(DEV), 0.025)
    accs = [d2v._sgns_grads(*args)[1] for _ in range(5)]
    check(all(torch.equal(accs[0], a) for a in accs[1:]), "index build: the accumulator differs")
    idx = torch.randint(0, 1000, (400_000,), generator=g).to(DEV)
    val = torch.randn(400_000, generator=g).to(DEV)
    add = [torch.zeros(1000, device=DEV).index_add_(0, idx, val) for _ in range(5)]
    # 2. genmodel twice on the card: every artifact byte-equal
    runs = []
    for r in range(2):
        d = os.path.join(tmp, f"build{r}")
        os.makedirs(d)
        write_tags_file(d, docs)
        runs.append(run_genmodel(genmodel, d, ["--epochs", "2"]))
    first, second = (artifact_bytes(os.path.join(tmp, f"build{r}")) for r in range(2))
    check(sorted(first) == sorted(second) and "doc2vec_model" in first,
          f"index build: the runs wrote different files {sorted(first)} {sorted(second)}")
    differ = [n for n in first if first[n] != second[n]]
    check(not differ, f"index build: training is not deterministic on the card: {differ}")
    # 3. card against CPU: training 2 epochs and inference at 100 epochs
    small = docs[:PARITY_DOCS]
    cfg2 = dataclasses.replace(cfg, epochs=2)
    card = d2v.Doc2VecModel.train(small, cfg2, device=DEV)
    cpu = d2v.Doc2VecModel.train(small, cfg2, device="cpu")
    train_err = max(float(np.abs(card.docvecs - cpu.docvecs).max()),
                    float(np.abs(card.syn1neg - cpu.syn1neg).max()))
    infer_err = float(np.abs(card.infer_vectors(small[:256]) - cpu.infer_vectors(small[:256])).max())
    check(train_err <= D2V_TOL and infer_err <= D2V_TOL,
          f"index build: card vs CPU train {train_err:.3e}, infer {infer_err:.3e} > {D2V_TOL}")
    # 4. an engine on the card over the built chain: 8 queries, batched = alone
    engine = engine_mod.SearchEngine(os.path.join(tmp, "build0"), device=DEV)
    picks = rng.choice(len(docs), 8, replace=False)
    queries = [" ".join(docs[i][:1 + j % 3]) for j, i in enumerate(picks)]
    batch = engine.find_similar_documents_batch(queries, topn=engine.cfg.search.topn)
    for q, sims in zip(queries, batch):
        check(not isinstance(sims, Exception), f"index build: {q!r} failed: {sims!r}")
        got = [(h.doc_id, h.similarity) for h in engine.search(q, similar_docs=sims)]
        want = [(h.doc_id, h.similarity) for h in engine.search(q)]
        check(len(want) > 0 and got == want and all(np.isfinite(s) for _, s in want),
              f"index build: {q!r} batched differs from engine.search")
    res = dict(draws_equal=sorted(on_card), accumulator_equal_x5=True,
               index_add_equal_x5=all(torch.equal(add[0], t) for t in add[1:]),
               genmodel_s=runs, docs=TRAIN_DOCS,
               train_card_vs_cpu_max_abs=train_err, infer_card_vs_cpu_max_abs=infer_err,
               tol=D2V_TOL, served=len(queries))
    print("index build gates " + json.dumps(res), flush=True)
    return res


def phase_index_timed(torch, d2v, prng, config_mod) -> tuple:
    """The published defaults (Doc2VecConfig(): dim 300, negative 5,
    max_doc_len 128, batch 512) on phase 8's 1M-doc collection: a step
    profile, then Doc2VecModel.train for as many epochs as ~30 s allow (the
    depth cut), then inference over 16,384 of the docs at infer_epochs=100.
    Returns the results and the docs."""
    cfg = config_mod.Doc2VecConfig()
    full, lens, _, _, _ = synth_collection(QUERY_DOCS, 10_000, 300, max(1, QUERY_DOCS // 2000), 9)
    tokens = [f"tag_{i:05d}" for i in range(10_000)]
    docs = [[tokens[t] for t in row[:n]] for row, n in zip(full.tolist(), lens.tolist())]
    del full
    prof = step_profile(torch, d2v, prng, docs, cfg)
    steps_per_epoch = -(-len(docs) // 512)
    epochs = max(1, int(TRAIN_BUDGET_S * 1e3 / (prof["step_ms"] * steps_per_epoch)))
    saved = d2v._train_epoch
    epoch_ms = []

    def timed_epoch(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        saved(*args, **kwargs)
        end.record()
        end.synchronize()
        epoch_ms.append(start.elapsed_time(end))

    d2v._train_epoch = timed_epoch
    try:
        t0 = time.perf_counter()
        model = d2v.Doc2VecModel.train(docs, dataclasses.replace(cfg, epochs=epochs), device=DEV)
        train_s = time.perf_counter() - t0
    finally:
        d2v._train_epoch = saved
    check(len(epoch_ms) == epochs and np.isfinite(model.docvecs).all()
          and model.docvecs.shape == (QUERY_DOCS, 300), "index build: the 1M-doc training")
    ms_step = float(np.mean(epoch_ms)) / steps_per_epoch
    sample = docs[:INFER_DOCS]
    model.infer_vectors(sample[:512])                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = model.infer_vectors(sample)
    infer_s = time.perf_counter() - t0
    check(vecs.shape == (INFER_DOCS, 300) and np.isfinite(vecs).all(), "index build: inference")
    # the bound, from what the call's own draws need (an untimed call over
    # the same docs): each live (doc, word) and (doc, negative) pair's logit
    # and d_doc dot products (2·2·dim f32) at 67 TFLOP/s, against the bytes:
    # every syn1 row any epoch reads, once, the vectors in and out, the
    # docs' tags
    work = count_work(torch, d2v, lambda: model.infer_vectors(sample))
    infer_flop = 2 * 2 * 300 * work["pairs"]
    n_tags = sum(len(d) for d in sample)
    infer_bytes = work["rows_touched"] * 300 * 4 + 2 * INFER_DOCS * 300 * 4 + n_tags * 8
    infer_bound_ms = max(infer_flop / PEAK_F32_FLOPS, infer_bytes / PEAK_BYTES) * 1e3
    iprof = infer_profile(torch, model, sample[:2048])
    res = dict(docs=QUERY_DOCS, config="Doc2VecConfig() defaults: dim 300, negative 5, "
               "max_doc_len 128, batch 512", vocab=len(model.vocab),
               docvecs_gb_on_card=QUERY_DOCS * 300 * 4 / 1e9,
               epochs_run=epochs, epochs_cut_from=cfg.epochs, steps_per_epoch=steps_per_epoch,
               ms_per_step=ms_step, steps_per_s=1e3 / ms_step, epoch_event_ms=epoch_ms,
               train_wall_s=train_s, train_setup_s=train_s - sum(epoch_ms) / 1e3,
               step=prof, infer=dict(docs=INFER_DOCS, epochs=cfg.infer_epochs,
                                     wall_s=infer_s, docs_per_s=INFER_DOCS / infer_s,
                                     bound_ms=infer_bound_ms,
                                     bound_by="operations" if infer_flop / PEAK_F32_FLOPS
                                     > infer_bytes / PEAK_BYTES else "bytes",
                                     gflop=infer_flop / 1e9, live_pairs=work["pairs"],
                                     tags=n_tags,
                                     profiled_call=dict(docs=2048, **iprof)))
    print("index build " + json.dumps(res), flush=True)
    return res, docs


def phase_reinfer(torch, engine_mod, qs, ui, tokens, rng, directory) -> dict:
    """The re-inference branches over phase 8's 1M-doc chain: 16 queries
    each under AIIS_REFERENCE_PRF=1 (an engine of its own), of 300 terms,
    and through the default path (which must stay the fused program and
    infer nothing); engine ms p50/p99, each answer equal to engine.search."""
    engine = ui.engine
    cdf = zipf_cdf(len(tokens))
    normal = [query_text(tokens, q) for q in make_queries(rng, cdf, 16)]
    wide = [" ".join(tokens[t] for t in rng.choice(len(tokens), 300, replace=False))
            for _ in range(16)]
    os.environ["AIIS_REFERENCE_PRF"] = "1"
    try:
        t0 = time.perf_counter()
        prf_engine = engine_mod.SearchEngine(directory, device=DEV)
        prf_load_s = time.perf_counter() - t0
    finally:
        del os.environ["AIIS_REFERENCE_PRF"]
    inferred = []
    model_infer = engine.model.infer_vectors

    def counting(docs, epochs=None):
        inferred.append(len(docs))
        return model_infer(docs, epochs)

    def run(eng, texts, fused):
        ms = []
        for t in texts:
            check(eng.fused_path_available(t) == fused, f"reinfer: {t[:40]!r} took the wrong path")
            h0 = time.perf_counter()
            sims = eng.find_similar_documents(t, topn=eng.cfg.search.topn)
            ms.append((time.perf_counter() - h0) * 1e3)
            got = [(h.doc_id, h.similarity) for h in eng.search(t, similar_docs=sims)]
            want = [(h.doc_id, h.similarity) for h in eng.search(t)]
            check(len(want) > 0 and got == want and all(np.isfinite(s) for _, s in want),
                  f"reinfer: {t[:40]!r} differs from engine.search")
        return pcts(ms)

    engine.model.infer_vectors = counting
    try:
        launches0, mv0 = qs.query_scores.launches, qs.matvecs.launches
        default = run(engine, normal, True)
        check(not inferred and qs.query_scores.launches - launches0 >= 2 * len(normal)
              and qs.matvecs.launches - mv0 >= 2 * len(normal),
              f"reinfer: the default path inferred {inferred} or left the fused program")
        wide_res = run(engine, wide, False)
        check(len(inferred) == 2 * len(wide) and all(n == 10 for n in inferred),
              f"reinfer: the 300-term PRF inferred {inferred}")
    finally:
        del engine.model.infer_vectors
    res = dict(reference_prf=dict(engine_ms=run(prf_engine, normal, False), load_s=prf_load_s),
               terms_300=dict(engine_ms=wide_res), default_fused=dict(engine_ms=default),
               docs=QUERY_DOCS, queries_each=16)
    del prf_engine
    print("reinfer " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- 19. data-parallel Doc2Vec

DP_D2V_EPOCHS = 1          # phase 19's depth cut: one epoch a mesh at 1M docs
DP_D2V_INFER = 4_096       # docs inferred on each mesh at infer_epochs=100
DP_D2V_TOL = dict(rtol=1e-4, atol=1e-5)   # JAX's own dp tolerance, the gate if bits differ
DP_D2V_WINDOW = 20         # steps of the profiled window a mesh (busy share)


def d2v_window(torch, d2v, mesh, docs, cfg) -> dict:
    """DP_D2V_WINDOW steps of ``docs`` through the epoch loop on ``mesh``,
    once to warm and once under torch.profiler: wall and device ms a step,
    the busy share, kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    nb = min(DP_D2V_WINDOW, len(docs) // 512)
    _, state, _ = k9_state(d2v, mesh, docs[:nb * 512], cfg)
    lr = float(np.float32(cfg.alpha))
    d2v._train_epoch(state, 0, lr, cfg.negative)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d2v._train_epoch(state, 0, lr, cfg.negative)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms, kernels = device_time(torch, prof)
    return dict(steps=nb, wall_ms_per_step=wall / nb,
                device_ms_per_step=dev_ms / nb if dev_ms else "not measured",
                busy_share=dev_ms / wall if dev_ms else "not measured",
                kernels_per_step=kernels / nb)


class GroupOfOne:
    """An NCCL (gloo on the CPU) process group of one, started from
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE=1, RANK=0 as torchrun sets them (its
    backend and start-up seconds kept), and destroyed on exit with the
    environment restored. ``label`` prefixes its failures."""

    NAMES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

    def __init__(self, distributed, label: str) -> None:
        self.distributed, self.label = distributed, label

    def __enter__(self) -> "GroupOfOne":
        import socket

        import torch.distributed as dist

        self.saved = {k: os.environ.get(k) for k in self.NAMES}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                          RANK="0")
        try:
            t0 = time.perf_counter()
            check(self.distributed.initialize() is True,
                  f"{self.label}: initialize started no group")
            self.init_s = time.perf_counter() - t0
            self.backend = dist.get_backend()
            check(self.backend == ("nccl" if DEV == "cuda" else "gloo"),
                  f"{self.label}: backend {self.backend}")
        except BaseException:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_d2v_way(torch, d2v, mesh, docs, cfg) -> tuple:
    """One way of phase 19: Doc2VecModel.train on ``docs`` over ``mesh`` (no
    mesh: on the card) with each epoch on CUDA events, then infer_vectors
    over DP_D2V_INFER docs (a 512-doc warm-up first) and the profiled
    training window. Returns the model, the inferred vectors and the
    numbers."""
    from anime_illust_image_searcher_tpu_torch.parallel.mesh import device_mesh

    saved = d2v._train_epoch
    epoch_ms = []

    def timed_epoch(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        saved(*args, **kwargs)
        end.record()
        end.synchronize()
        epoch_ms.append(start.elapsed_time(end))

    d2v._train_epoch = timed_epoch
    try:
        t0 = time.perf_counter()
        model = d2v.Doc2VecModel.train(docs, cfg, device=DEV if mesh is None else None,
                                       mesh=mesh)
        train_s = time.perf_counter() - t0
    finally:
        d2v._train_epoch = saved
    check(len(epoch_ms) == cfg.epochs and model.mesh is mesh
          and model.docvecs.shape == (len(docs), cfg.vector_size)
          and np.isfinite(model.docvecs).all() and np.isfinite(model.syn1neg).all(),
          f"phase 19: training over {mesh}")
    steps = -(-len(docs) // 512)
    sample = docs[:DP_D2V_INFER]
    model.infer_vectors(sample[:512])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = model.infer_vectors(sample)
    infer_s = time.perf_counter() - t0
    check(vecs.shape == (DP_D2V_INFER, cfg.vector_size) and np.isfinite(vecs).all(),
          f"phase 19: inference over {mesh}")
    t0 = time.perf_counter()
    window = d2v_window(torch, d2v, mesh or device_mesh(DEV), docs, cfg)
    shards = 1 if mesh is None else mesh.total_shards
    b, l, k, dim = 512, cfg.max_doc_len, cfg.negative, cfg.vector_size
    out = dict(shards=shards, ms_per_step=float(np.mean(epoch_ms)) / steps,
               epoch_event_ms=epoch_ms, train_wall_s=train_s,
               train_setup_s=train_s - sum(epoch_ms) / 1e3,
               # each step gathers its dvec and d_doc rows and its (id, gradient) pairs
               gathered_bytes_per_step=0 if shards == 1 else b * (2 * dim * 4 + l * (k + 1) * 12),
               infer=dict(docs=DP_D2V_INFER, wall_s=infer_s, docs_per_s=DP_D2V_INFER / infer_s),
               window=window, window_s=time.perf_counter() - t0)
    return model, vecs, out


def compare_d2v(label: str, got, want) -> dict:
    """The gate of a mesh's run against the no-mesh run: docvecs, syn1neg and
    the inferred vectors bit-equal, or within DP_D2V_TOL with the max abs
    difference kept."""
    out = {}
    for name, a, b in (("docvecs", got[0].docvecs, want[0].docvecs),
                       ("syn1neg", got[0].syn1neg, want[0].syn1neg),
                       ("inferred", got[1], want[1])):
        same = bool(np.array_equal(a, b))
        diff = 0.0 if same else float(np.abs(a - b).max())
        check(same or np.allclose(a, b, **DP_D2V_TOL), f"phase 19: {label} {name} is {diff} "
              f"from no mesh, beyond rtol {DP_D2V_TOL['rtol']} / atol {DP_D2V_TOL['atol']}")
        out[name] = dict(bit_equal=same, max_abs=diff)
    return out


def phase_dp_doc2vec(torch, genmodel, d2v, config_mod, docs, tmp, smi) -> dict:
    """Phase 19: Doc2VecModel.train and infer_vectors over meshes at the
    published defaults on phase 14's 1M-doc collection, cut to one epoch: no
    mesh, the card named twice, and an NCCL group of one at 2 shards, each
    held against no mesh; then genmodel --data-parallel on phase 14's gate
    corpus against phase 14's plain build, and train_gather_bf16 (a line of
    its own)."""
    from anime_illust_image_searcher_tpu_torch.parallel import distributed
    from anime_illust_image_searcher_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(config_mod.Doc2VecConfig(), epochs=DP_D2V_EPOCHS)
    res = dict(card=smi, docs=len(docs), epochs=DP_D2V_EPOCHS, config="Doc2VecConfig() "
               "defaults: dim 300, negative 5, max_doc_len 128, batch 512",
               infer_docs=DP_D2V_INFER, tol=DP_D2V_TOL)
    parts_s = {}

    def mark(name: str, t0: float) -> float:
        now = time.perf_counter()
        parts_s[name] = now - t0
        return now

    t0 = time.perf_counter()
    ref = dp_d2v_way(torch, d2v, None, docs, cfg)
    res["none"] = ref[2]
    t0 = mark("none", t0)
    twice = dp_d2v_way(torch, d2v, mesh_mod.make_mesh(devices=[DEV] * 2), docs, cfg)
    t0 = mark("card_twice", t0)
    res["card_twice"] = dict(twice[2], vs_none=compare_d2v("card twice", twice, ref))
    del twice
    t0 = mark("card_twice_compare", t0)
    with GroupOfOne(distributed, "phase 19") as group_of_one:
        mesh = mesh_mod.make_mesh(devices=[DEV] * 2)
        check(mesh.distributed and (mesh.rank, mesh.world_size) == (0, 1), f"phase 19: {mesh}")
        group = dp_d2v_way(torch, d2v, mesh, docs, cfg)
        t0 = mark("group_of_one", t0)
        res["group_of_one"] = dict(group[2], backend=group_of_one.backend,
                                   vs_none=compare_d2v("NCCL group", group, ref))
    del group, ref
    t0 = mark("group_compare", t0)
    # genmodel --data-parallel on phase 14's gate corpus, against its plain build0
    gate_docs, _, _ = tag_docs(TRAIN_DOCS, 10_000, 14)
    d = os.path.join(tmp, "build_dp")
    os.makedirs(d)
    write_tags_file(d, gate_docs)
    cli_s = run_genmodel(genmodel, d, ["--epochs", "2", "--data-parallel"])
    want, got = artifact_bytes(os.path.join(tmp, "build0")), artifact_bytes(d)
    model_files = {"doc2vec_model", "doc2vec_model.trained_fp"}
    check(sorted(want) == sorted(got), f"phase 19: genmodel --data-parallel wrote "
          f"{sorted(got)}, the plain build {sorted(want)}")
    differ = [n for n in want if n not in model_files and want[n] != got[n]]
    check(not differ, f"phase 19: genmodel --data-parallel's {differ} differ from the plain "
          "build's")
    shards = dp_cards(torch)
    check(got["doc2vec_model.trained_fp"].endswith(f":dp{shards}".encode()),
          "phase 19: the data-parallel model's fingerprint lacks its mark")
    res["genmodel"] = dict(docs=TRAIN_DOCS, seconds=cli_s, shards=shards,
                           files_equal=len(want) - len(model_files))
    t0 = mark("genmodel", t0)
    # train_gather_bf16: on the card (no mesh and the card twice) against the CPU
    small = gate_docs[:1024]
    bcfg = dataclasses.replace(cfg, train_gather_bf16=True)
    card = d2v.Doc2VecModel.train(small, bcfg, device=DEV)
    runs = dict(card_twice=d2v.Doc2VecModel.train(small, bcfg,
                                                  mesh=mesh_mod.make_mesh(devices=[DEV] * 2)),
                cpu=d2v.Doc2VecModel.train(small, bcfg, device="cpu"),
                f32_gathers=d2v.Doc2VecModel.train(small, cfg, device=DEV))
    diffs = {name: max(float(np.abs(m.docvecs - card.docvecs).max()),
                       float(np.abs(m.syn1neg - card.syn1neg).max()))
             for name, m in runs.items()}
    bits = {name: bool(np.array_equal(m.docvecs, card.docvecs)
                       and np.array_equal(m.syn1neg, card.syn1neg)) for name, m in runs.items()}
    check(diffs["cpu"] <= D2V_TOL and diffs["card_twice"] <= D2V_TOL
          and diffs["f32_gathers"] > 0,
          f"phase 19: train_gather_bf16 on the card vs {diffs} (tol {D2V_TOL}; the f32 "
          "gathers must differ)")
    bf16 = dict(docs=len(small), epochs=bcfg.epochs, max_abs_vs_card=diffs, bit_equal=bits,
                tol=D2V_TOL, seconds=time.perf_counter() - t0)
    print("dp doc2vec bf16 " + json.dumps(bf16), flush=True)
    res["bf16"] = bf16
    mark("bf16", t0)
    res["seconds"] = time.perf_counter() - t_phase
    res["seconds_by_part"] = parts_s
    print("dp doc2vec " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- data parallel

DP_TAG_TOL = 2e-2         # max |probs of a B/2 shard - the same rows at B|: another GEMM path
DP_INDEX_ROWS = 1_000_000  # phase 17d: the index a user's collection reaches, 300-d f32
DP_TOP_K = 100
DP_SHARDS = (1, 2, 4)      # meshes of 1, 2 and 4 entries of the one card
DP_STAMP = 1.7e9           # gen_cfeatures' extraction stamp, held for byte-equal files


def dp_cards(torch) -> int:
    """The devices of a CLI's --data-parallel mesh: the visible cards."""
    return torch.cuda.device_count() if DEV == "cuda" else 1


def dp_meshes(mesh_mod):
    """Phase 17's three ways: no mesh, ``make_mesh()`` (the card alone) and a
    mesh that names the card twice."""
    return {"none": None, "one_card": mesh_mod.local_mesh(DEV),
            "card_twice": mesh_mod.make_mesh(devices=[DEV] * 2)}


def dp_way(torch, forward, pipeline, batches, counts, dh, per_forward, shards) -> dict:
    """One way of 17a/17c: a warm-up forward (its launches checked), 3
    batches through the CLI's depth-1 pipeline, 2 forwards on CUDA events
    with the input already on the card. Returns the first batch's outputs on
    the host and the times; ``counts[dh]`` is the launch count read."""
    before = counts[dh]
    forward(batches[0])
    torch.cuda.synchronize()
    check(counts[dh] - before == per_forward * shards,
          f"{shards} shard(s) launched the Dh={dh} kernel {counts[dh] - before} times in "
          f"one forward, expected {per_forward} a shard")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pipeline(batches)
    wall = time.perf_counter() - t0
    x = torch.from_numpy(batches[1]).to(DEV)
    fwd_ms = cuda_ms(lambda: forward(x), iters=2, warmup=0)
    b = batches[0].shape[0]
    return first, dict(img_s=len(batches) * b / wall, seconds=wall, forward_ms=fwd_ms,
                       forward_img_s=b / fwd_ms * 1e3)


def check_dp_shards(label: str, name: str, mesh, got, full, alone, batch) -> int:
    """A mesh's outputs on ``batch`` bit for bit: with one shard, the no-mesh
    outputs ``full``; with more, each shard's rows ``alone(rows)`` with no
    mesh (a B/n GEMM may take another cuBLAS path than B). Returns the
    forwards run alone."""
    n = mesh.shape["data"]
    m = batch.shape[0] // n
    for s in range(0, batch.shape[0], m):
        want = full if n == 1 else alone(batch[s:s + m])
        check(np.array_equal(got[s:s + m], want), f"{label}: rows {s}-{s + m} of the mesh "
              f"{name} differ from {'no mesh' if n == 1 else 'those rows run alone'}")
    return 0 if n == 1 else n


def phase_dp_tagging(torch, tagger_mod, config_mod, mesh_mod, fa) -> tuple:
    """17a: TaggerPredictor at full width, B=256, with no mesh, with
    ``make_mesh()`` and with a mesh that names the card twice. Returns
    (results, shard forwards run)."""
    cfg = config_mod.TaggerConfig()
    b = cfg.batch_size
    rng = np.random.RandomState(17)
    batches = [rng.randint(0, 256, (b, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
               for _ in range(3)]
    args = (cfg.general_thresh, cfg.general_mcut_enabled,
            cfg.character_thresh, cfg.character_mcut_enabled)
    res, got, forwards, base = {}, {}, 0, None
    meshes = dp_meshes(mesh_mod)
    for name, mesh in meshes.items():
        pred = tagger_mod.TaggerPredictor(cfg, device=DEV, mesh=mesh)
        pred.load_model()
        shards = pred.mesh.shape["data"]

        def forward(x, pred=pred):
            return pred._forward(x, thresholds=False)[0]

        def pipeline(batches, pred=pred):
            outs, pending, first = [], None, None
            for imgs in batches:
                devs = pred.predict_device(imgs)
                if first is None:
                    first = devs[0]
                if pending is not None:
                    outs.append(pred.finalize(pending, *args))
                pending = devs
            outs.append(pred.finalize(pending, *args))
            return first.cpu().numpy(), outs

        (probs, lines), res[name] = dp_way(torch, forward, pipeline, batches,
                                           fa.mha_attention.launches, 64, 24, shards)
        forwards += 6 * shards
        got[name] = (probs, lines)
        if mesh is None:
            base = pred
        else:
            del pred
    p0, lines0 = got["none"]
    check(np.isfinite(p0).all() and p0.shape[0] == b, "17a: non-finite or short probabilities")
    for name, mesh in meshes.items():
        if mesh is not None:
            forwards += check_dp_shards("17a", name, mesh, got[name][0], p0,
                                        base.predict_probs, batches[0])
    if meshes["one_card"].shape["data"] == 1:
        check(got["one_card"][1] == lines0, "17a: the one-card mesh's tag lines differ")
    p2 = got["card_twice"][0]
    err = float(np.abs(p2 - p0).max())
    check(err <= DP_TAG_TOL, f"17a: the two-entry mesh is {err} from the full batch")
    res.update(batch=b, card_twice_max_abs_diff_vs_full_batch=err,
               card_twice_lines_equal=sum(a == c for o, q in zip(got["card_twice"][1], lines0)
                                          for a, c in zip(o, q)))
    del base
    torch.cuda.empty_cache()
    return res, forwards


def phase_dp_tagging_cli(torch, tagging) -> tuple:
    """17b: cli.tagging over phase 5's 7 images at B=4, with and without
    --data-parallel: the tag files byte-equal. Returns (results, forwards)."""
    import contextlib
    import io

    from PIL import Image

    rng = np.random.RandomState(3)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("imgs")
            for i in range(7):
                shape = (300 + 20 * i, 200 + 30 * i, 3)      # padded to square, resized
                Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(
                    f"imgs/img_{i}.png")
            files = {}
            for name, extra in (("plain", []), ("data_parallel", ["--data-parallel"])):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    tagging.main(["--dir", "imgs", "--batch-size", "4"] + extra, device=DEV)
                print(out.getvalue().strip()[-400:], flush=True)
                with open("tags-wd-tagger.txt", "rb") as f:
                    files[name] = f.read()
                os.remove("tags-wd-tagger.txt")
            n = dp_cards(torch)
            check(f"data-parallel over {n} devices, batch {-(-4 // n) * n}" in out.getvalue(),
                  "17b: the CLI did not report its data-parallel mesh")
        finally:
            os.chdir(cwd)
    lines = files["plain"].decode().splitlines()
    check(len(lines) == 7, f"17b: {len(lines)} tag lines, expected 7")
    check(files["data_parallel"] == files["plain"],
          "17b: tagging --data-parallel wrote another tag file")
    torch.cuda.empty_cache()
    return dict(lines=len(lines), tag_file_bytes=len(files["plain"]), byte_equal=True), 4


def phase_dp_ccip(torch, ccip_mod, config_mod, mesh_mod, caformer, gen_cfeatures, fa,
                  imgs_dir, directory) -> tuple:
    """17c: CCIPPredictor, CAFormer-24 at B=64, the three ways; then
    gen_cfeatures with and without --data-parallel over phase 12's PNGs, the
    files byte-equal. Returns (results, shard forwards run)."""
    import contextlib
    import io
    import types

    cfg = config_mod.CCIPConfig()
    b = cfg.batch_size
    rng = np.random.RandomState(18)
    batches = [rng.randint(0, 256, (b, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
               for _ in range(3)]
    res, got, forwards, base = {}, {}, 0, None
    meshes = dp_meshes(mesh_mod)
    for name, mesh in meshes.items():
        pred = ccip_mod.CCIPPredictor(cfg, device=DEV, mesh=mesh)
        pred.load_model()
        shards = pred.mesh.shape["data"]

        def pipeline(batches, pred=pred):
            outs, pending = [], None
            for imgs in batches:
                dev = pred.ccip_extract_device(imgs)
                if pending is not None:
                    outs.append(pending.cpu().numpy())
                pending = dev
            outs.append(pending.cpu().numpy())
            return outs[0]

        def forward(x, pred=pred):
            return pred._forward(x)

        got[name], res[name] = dp_way(torch, forward, pipeline, batches,
                                      fa.mha_attention.launches, 32, 18, shards)
        forwards += 6 * shards
        if mesh is None:
            base = pred
        else:
            del pred
    f0, f2 = got["none"], got["card_twice"]
    check(np.isfinite(f0).all() and f0.shape == (b, cfg.feature_dim), "17c: features")
    for name, mesh in meshes.items():
        if mesh is not None:
            forwards += check_dp_shards("17c", name, mesh, got[name], f0,
                                        base.ccip_batch_extract_features, batches[0])
    err = float(np.abs(unit_rows(f2) - unit_rows(f0)).max())
    check(err <= CCIP_TOL, f"17c: the two-entry mesh's unit features are {err} from the "
          "full batch")
    del base
    torch.cuda.empty_cache()

    files, cwd, saved_time = {}, os.getcwd(), gen_cfeatures.time
    gen_cfeatures.time = types.SimpleNamespace(time=lambda: DP_STAMP)
    try:
        for name, extra in (("plain", []), ("data_parallel", ["--data-parallel"])):
            out_dir = os.path.join(directory, f"dp_gen_cfeatures_{name}")
            os.makedirs(out_dir)
            os.chdir(out_dir)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                gen_cfeatures.main(["--dir", imgs_dir] + extra, device=DEV)
            print(out.getvalue().strip()[-300:], flush=True)
            files[name] = {f: open(f, "rb").read() for f in sorted(os.listdir("."))}
            os.chdir(cwd)
        n = dp_cards(torch)
        check(f"cfeatures data-parallel over {n} devices, batch {-(-b // n) * n}"
              in out.getvalue(),
              "17c: gen_cfeatures did not report its data-parallel mesh")
    finally:
        os.chdir(cwd)
        gen_cfeatures.time = saved_time
    check(len(files["plain"]) == 6 and files["data_parallel"] == files["plain"],
          f"17c: gen_cfeatures --data-parallel wrote other files: {sorted(files['plain'])}")
    n_imgs = len(os.listdir(imgs_dir))
    forwards += 2 * -(-n_imgs // b)
    res.update(batch=b, card_twice_max_abs_diff_unit_vs_full_batch=err,
               gen_cfeatures=dict(images=n_imgs, files=sorted(files["plain"]),
                                  byte_equal=True))
    torch.cuda.empty_cache()
    return res, forwards


def dp_index_queries(idx, queries, ref, k, label) -> list:
    """Every query's top-k and scores through ``idx``, held bit for bit
    against ``ref`` [(vals, ids, scores)]; returns the top_k wall ms."""
    times = []
    for q, (rv, ri, rs) in zip(queries, ref):
        t0 = time.perf_counter()
        v, i = idx.top_k(q, k)
        times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(v, rv) and np.array_equal(i, ri),
              f"17{label}: top-{k} differs from the unsharded kernel's")
    check(np.array_equal(idx.scores(queries[0]), ref[0][2]),
          f"17{label}: scores differ from the unsharded kernel's")
    return times


def phase_dp_index(torch, qs, fq, mesh_mod, sharded_index, distributed) -> dict:
    """17d and 17e: a 1M-row, 300-d seeded unit index sharded over 1, 2 and 4
    entries of the card, then over a process group of one (NCCL); each held
    bit for bit against one unsharded ``matvecs`` + ``exact_top_k``, the
    kernel's scores within QUERY_TOL of ``plain_matvecs``. The matvecs
    kernel's count is set to 0 after the references, before the sharded
    runs."""
    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    matrix = rng.standard_normal((DP_INDEX_ROWS, 300), dtype=np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    queries = [matrix[i] for i in rng.choice(DP_INDEX_ROWS, 16, replace=False)]
    gen_s = time.perf_counter() - t0
    full = torch.from_numpy(matrix).to(DEV)
    ref, plain_err = [], 0.0
    for j, q in enumerate(queries):
        qv = torch.from_numpy(q).to(DEV)[None]
        s = qs.matvecs(full, qv)[0]
        v, i = fq.exact_top_k(s, DP_TOP_K)
        ref.append((v.cpu().numpy(), i.cpu().numpy(), s.cpu().numpy()))
        if j == 0:
            plain_err = float((s - qs.plain_matvecs(full, qv)[0]).abs().max())
    check(plain_err <= QUERY_TOL, f"17d: the kernel's scores are {plain_err} from plain")
    del full
    torch.cuda.empty_cache()
    qs.reset_launches()
    res = dict(rows=DP_INDEX_ROWS, dim=300, gb=matrix.nbytes / 1e9, k=DP_TOP_K,
               queries=len(queries), generate_s=gen_s, kernel_vs_plain_max_abs=plain_err)
    for n in DP_SHARDS:
        idx = sharded_index.ShardedSimilarityIndex(matrix, mesh_mod.make_mesh(devices=[DEV] * n))
        check(idx.rows == DP_INDEX_ROWS and len(idx.shards) == n, f"17d: {n} shards")
        dp_index_queries(idx, queries[:2], ref[:2], DP_TOP_K, "d")   # warm-up
        times = dp_index_queries(idx, queries, ref, DP_TOP_K, "d")
        res[f"shards_{n}_top_k_ms"] = pcts(times)
        del idx
        torch.cuda.empty_cache()
    with GroupOfOne(distributed, "17e") as group:
        info = distributed.process_info()
        local = torch.cuda.device_count() if DEV == "cuda" else 1
        check(info == dict(process_index=0, process_count=1, local_devices=local,
                           global_devices=local), f"17e: process_info {info}")
        mesh = mesh_mod.make_mesh(devices=[DEV] * 2)
        check(mesh.distributed and (mesh.rank, mesh.world_size) == (0, 1), f"17e: {mesh}")
        idx = sharded_index.ShardedSimilarityIndex(matrix, mesh)
        times = dp_index_queries(idx, queries, ref, DP_TOP_K, "e")
        res["group_of_one"] = dict(backend=group.backend, process_info=info,
                                   init_s=group.init_s, shards=2, top_k_ms=pcts(times))
        del idx
    torch.cuda.empty_cache()
    by_form = dict(qs.matvecs.launches_by_form)
    # a mesh's top-k or scores call launches once a shard: 2 warm-up queries
    # and 16 timed, each with one scores call, then 16 + 1 over the group
    want = (2 + 1 + len(queries) + 1) * sum(DP_SHARDS) + (len(queries) + 1) * 2
    check(by_form == ({"B=1": want} if DEV == "cuda" else {}) and qs.query_scores.launches == 0,
          f"17d/e: matvecs launches {by_form} (query_scores {qs.query_scores.launches}), "
          f"expected {want} at B=1 and none of query_scores")
    res["matvecs_launches"] = by_form
    return res


def phase_data_parallel(torch, tagger_mod, config_mod, tagging, ccip_mod, caformer,
                        gen_cfeatures, qs, fq, fa, imgs_dir, directory, smi) -> dict:
    """Phase 17: --data-parallel's path. Both kernels' counts are set to 0
    here and read by the caller after it."""
    from anime_illust_image_searcher_tpu_torch.parallel import distributed, sharded_index
    from anime_illust_image_searcher_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    fa.reset_launches()
    tag_res, fw64 = phase_dp_tagging(torch, tagger_mod, config_mod, mesh_mod, fa)
    cli_res, cli_fw = phase_dp_tagging_cli(torch, tagging)
    fw64 += cli_fw
    ccip_res, fw32 = phase_dp_ccip(torch, ccip_mod, config_mod, mesh_mod, caformer,
                                   gen_cfeatures, fa, imgs_dir, directory)
    check(fa.mha_attention.launches == {64: 24 * fw64, 32: 18 * fw32}
          and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
          f"phase 17: flash_attention launched {fa.mha_attention.launches} times (f32: "
          f"{fa.mha_attention.launches_f32}), expected 24 x {fw64} shard forwards at Dh=64 "
          f"and 18 x {fw32} at Dh=32")
    index_res = phase_dp_index(torch, qs, fq, mesh_mod, sharded_index, distributed)
    res = dict(tagging=tag_res, tagging_cli=cli_res, ccip=ccip_res, index=index_res,
               attention_launches=dict(fa.mha_attention.launches),
               seconds=time.perf_counter() - t0, card=smi)
    print("data parallel " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- 18. sharded engine

SHARD_COUNTS = (1, 2, 4)   # phase 18's meshes: 1, 2 and 4 entries of the one card
P18_SINGLE, P18_BATCHES, P18_EXACT, P18_CHAR, P18_BURSTS = 256, 32, 16, 64, 8


def share_reranker(rerank_ccip, src, engine):
    """A reranker for ``engine`` that reuses phase 13's loaded one: its
    predictor, its cfeature index (already on the card) and its tag maps, so
    that a mesh engine neither reloads 3 GB nor rebuilds a 1M-doc dict."""
    r = rerank_ccip.CCIPReranker(
        image_files_name_tags_arr=src.image_files_name_tags_arr,
        file_tag_index_dict=src.file_tag_index_dict,
        filepath_docid_dict=src.filepath_docid_dict,
        directory=src.directory, config=engine.cfg, engine=engine, predictor=src.predictor)
    for name in ("cfeature_filepath_idx", "cfeatures_idx", "_row_of", "_row_stamps",
                 "_all_norms_known"):
        setattr(r, name, getattr(src, name))
    return r


def sharded_run(engine, work, topn) -> tuple:
    """Phase 18's work through ``engine``: single queries (find + search,
    timed), batches of 8 (find_similar_documents_batch + search, timed), raw
    exact-program rows, single character queries (timed) and character
    bursts. Returns (answers, host ms)."""
    singles, batches, exact, chars, bursts = work
    ans = dict(single=[], batch=[], exact=[], char=[], burst=[])
    ms = dict(single=[], batch=[], char=[])
    for q in singles:
        h0 = time.perf_counter()
        sims = engine.find_similar_documents(q, topn=topn)
        engine.search(q, similar_docs=sims)
        ms["single"].append((time.perf_counter() - h0) * 1e3)
        ans["single"].append(sims)
    for b in batches:
        h0 = time.perf_counter()
        outs = engine.find_similar_documents_batch(b, topn=topn)
        for q, o in zip(b, outs):
            check(not isinstance(o, Exception), f"18: {q!r} failed in a batch: {o!r}")
            engine.search(q, similar_docs=o)
        ms["batch"].append((time.perf_counter() - h0) * 1e3)
        ans["batch"].append(outs)
    ans["exact"] = [engine._dispatch_fused(p, topn, exact=True).tobytes() for p in exact]
    for q in chars:
        h0 = time.perf_counter()
        ans["char"].append(engine.find_similar_documents(q, topn, CHARACTER))
        ms["char"].append((time.perf_counter() - h0) * 1e3)
    ans["burst"] = [engine.find_similar_documents_batch(b, topn, CHARACTER) for b in bursts]
    return ans, ms


def check_sharded(label: str, got: dict, want: dict) -> None:
    for key in got:
        check(got[key] == want[key][:len(got[key])],
              f"18{label}: the {key} answers differ from the unsharded engine's")


def counted_sharded_run(torch, qs, meter, engine, work, topn, n, label) -> tuple:
    """``sharded_run`` with both K5 counts set to 0 just before and read just
    after: a shard's query-scores launch and matvecs launch for each normal
    dispatch and for each one-dispatch character pass, one more matvecs launch
    for each full-diffs dispatch (the predictor's unsharded index), and no
    fallback."""
    reranker = engine.cfeature_reranker
    full, orig_full = [], reranker.predictor.rerank_diffs_from_rows
    reranker.predictor.rerank_diffs_from_rows = \
        lambda *a, **kw: full.append(1) or orig_full(*a, **kw)
    d0, c0, fb0 = meter.count, engine.character_one_dispatch_queries, \
        reranker.one_dispatch_fallbacks
    qs.reset_launches()
    try:
        ans, ms = sharded_run(engine, work, topn)
    finally:
        del reranker.predictor.rerank_diffs_from_rows
    torch.cuda.synchronize()
    launches = dict(qs.query_scores.launches_by_form)
    mv_launches = dict(qs.matvecs.launches_by_form)
    dispatches = meter.count - d0
    char_queries = engine.character_one_dispatch_queries - c0
    fallbacks = reranker.one_dispatch_fallbacks - fb0
    _, _, _, chars, bursts = work
    passes = len(chars) + sum(-(-len(b) // 8) for b in bursts)
    check(char_queries == len(chars) + sum(map(len, bursts)) and fallbacks == 0,
          f"18{label}: {char_queries} one-dispatch character queries, {fallbacks} fallbacks")
    want = n * (dispatches + passes)
    check(sum(launches.values()) == want and sum(mv_launches.values()) == want + len(full),
          f"18{label}: query-scores launched {launches} and matvecs {mv_launches}, expected "
          f"{n} shards x ({dispatches} dispatches + {passes} character passes) each, + "
          f"{len(full)} full diffs of matvecs")
    return ans, ms, dict(launches=launches, matvecs_launches=mv_launches, dispatches=dispatches,
                         character_passes=passes, full_diffs_dispatches=len(full))


def phase_sharded_engine(torch, qs, fq, webui, engine_mod, rerank_ccip, ui, char_ctx,
                         tokens, rng, directory, smi) -> dict:
    """Phase 18: SearchEngine(mesh=) over phase 8's 1M-doc chain and phase
    13's cfeature index. References from phase 8's unsharded engine (its
    answers and its times); then a WebUIServer(mesh=) over 1, 2 and 4
    entries of the card (its engine takes phase 13's loaded reranker), each
    with the query-scores count set to 0 before its work and read after, its
    answers bit-equal to the references, 64 requests served through it each
    equal to engine.search; then an NCCL group of one at 2 shards. The
    caller adds the launches to the kernels line."""
    from anime_illust_image_searcher_tpu_torch.parallel import distributed
    from anime_illust_image_searcher_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    ref_engine = ui.engine
    topn = ref_engine.cfg.search.topn
    cdf = zipf_cdf(len(tokens))
    singles = [query_text(tokens, q) for q in make_queries(rng, cdf, P18_SINGLE)]
    batches = [[query_text(tokens, q) for q in make_queries(rng, cdf, 8)]
               for _ in range(P18_BATCHES)]
    exact = [ref_engine._pack_fused(t) for t in singles[:P18_EXACT]]
    chars = char_ctx["texts"][:P18_CHAR]
    bursts = [[chars[i] for i in rng.choice(len(chars), 8, replace=False)]
              for _ in range(P18_BURSTS)]
    served = singles[:56]      # 8 client threads: a burst of 8, then 8 x 7 = 64 requests
    work = (singles, batches, exact, chars, bursts)
    ref_engine.find_similar_documents(singles[0], topn=topn)          # warm
    want, ref_ms = sharded_run(ref_engine, work, topn)
    ref_window = device_profile(torch, lambda: [ref_engine.search(t) for t in singles[:8]])
    res = dict(card=smi, docs=QUERY_DOCS, queries=dict(
        single=len(singles), batches_of_8=len(batches), exact_rows=len(exact),
        character=len(chars), character_bursts_of_8=len(bursts), served=len(served)),
        unsharded=dict(engine_ms=pcts(ref_ms["single"]), batch8_ms=pcts(ref_ms["batch"]),
                       character_ms=pcts(ref_ms["char"]),
                       profiled_window=dict(queries="8 single", **ref_window)))
    total_launches = total_mv = 0
    with DispatchMeter(torch, fq) as meter:
        for n in SHARD_COUNTS:
            t0 = time.perf_counter()
            mesh = mesh_mod.make_mesh(devices=[DEV] * n)
            srv = webui.WebUIServer(directory=directory, device=DEV, mesh=mesh)
            engine = srv.load()
            check(engine.mesh is mesh and len(engine._docs.matrix) == n
                  and all(m.device.type == DEV for m in engine._docs.matrix),
                  f"18: the engine's index is not in {n} shards on the card")
            engine.cfeature_reranker = share_reranker(rerank_ccip, char_ctx["reranker"], engine)
            load_s = time.perf_counter() - t0
            engine.find_similar_documents(singles[0], topn=topn)                 # warm
            engine.find_similar_documents(chars[0], topn, CHARACTER)           # the cf shards
            got, ms, counts = counted_sharded_run(torch, qs, meter, engine, work, topn, n,
                                                  f" {n} shards")
            check_sharded(f" {n} shards", got, want)
            profiled = device_profile(torch, lambda: [engine.search(t) for t in singles[:8]])
            d0, l0, m0 = meter.count, qs.query_scores.launches, qs.matvecs.launches
            warm, wall, window = serve_requests(webui, srv, served, 8, 7)
            # read before check_served, whose engine.search calls are not served
            served_launches, served_dispatches = qs.query_scores.launches - l0, meter.count - d0
            served_mv = qs.matvecs.launches - m0
            check(served_launches == served_mv == n * served_dispatches and served_dispatches > 0,
                  f"18 {n} shards: {served_launches} query-scores and {served_mv} matvecs "
                  f"launches for {served_dispatches} served dispatches")
            total_launches += qs.query_scores.launches
            total_mv += qs.matvecs.launches
            check_served(engine, served, warm + window)
            res[f"shards_{n}"] = dict(
                engine_ms=pcts(ms["single"]), batch8_ms=pcts(ms["batch"]),
                character_ms=pcts(ms["char"]), load_s=load_s,
                profiled_window=dict(queries="8 single", **profiled),
                serve=dict(requests=len(warm) + len(window),
                           requests_per_s=len(window) / wall,
                           latency_ms=pcts([row[1] for row in window]),
                           dispatches=served_dispatches, launches=served_launches,
                           matvecs_launches=served_mv), **counts)
            del srv, engine, got
            torch.cuda.empty_cache()

        with GroupOfOne(distributed, "18") as group:
            mesh = mesh_mod.make_mesh(devices=[DEV] * 2)
            check(mesh.distributed and (mesh.rank, mesh.world_size) == (0, 1), f"18: {mesh}")
            engine = engine_mod.SearchEngine(directory, mesh=mesh)
            engine.cfeature_reranker = share_reranker(rerank_ccip, char_ctx["reranker"], engine)
            group_work = (singles[:64], batches[:8], exact, chars[:16], bursts[:2])
            engine.find_similar_documents(chars[0], topn, CHARACTER)           # warm
            got, ms, counts = counted_sharded_run(torch, qs, meter, engine, group_work, topn,
                                                  2, " NCCL")
            check_sharded(" NCCL", got, want)
            total_launches += sum(counts["launches"].values())
            total_mv += sum(counts["matvecs_launches"].values())
            res["group_of_one"] = dict(backend=group.backend, shards=2,
                                       engine_ms=pcts(ms["single"]),
                                       batch8_ms=pcts(ms["batch"]),
                                       character_ms=pcts(ms["char"]), **counts)
            del engine, got
    torch.cuda.empty_cache()
    res["launches"], res["matvecs_launches"] = total_launches, total_mv
    res["seconds"] = time.perf_counter() - t_phase
    print("sharded engine " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- packaging

ARCHIVE_STAMP = 1.7e9      # gen_cfeatures' extraction stamp in phase 20, held for byte-equal files
ARCHIVE_QUERIES = 8
ARCHIVE_CF_IMAGES = 16

# Phase 20's script, run in a process of its own with the port on PYTHONPATH
# (the archive, or the checkout for the tree's run): the kernels' first-use
# build, then cli.cmd_run's tagging, genmodel and gen_cfeatures and a
# WebUIServer answering queries from a client thread, each timed, with the
# kernels' launch counts set to 0 before it and read after it.
_PACKAGE_SCRIPT = """
import json, os, sys, threading, time, types, urllib.request
from http.server import ThreadingHTTPServer
t0 = time.perf_counter()
spec = json.loads(sys.argv[1])
import torch
import anime_illust_image_searcher_tpu_torch as pkg
from anime_illust_image_searcher_tpu_torch.cli import cmd_run, gen_cfeatures, webui
from anime_illust_image_searcher_tpu_torch.ops import _build
from anime_illust_image_searcher_tpu_torch.ops import flash_attention as fa
from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs
dev = spec["device"]
torch.zeros(1, device=dev)
out = dict(package_file=pkg.__file__, import_s=time.perf_counter() - t0)
t = time.perf_counter()
_build.build(spec["kernels"])
out["build_s"] = time.perf_counter() - t
out["libraries"] = {n: _build._paths(n)[1] for n in spec["kernels"]}


def counted(name, fn):
    fa.reset_launches()
    qs.reset_launches()
    t = time.perf_counter()
    fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    out[name] = dict(seconds=time.perf_counter() - t, attention=fa.mha_attention.launches,
                     attention_f32=fa.mha_attention.launches_f32,
                     query_scores=qs.query_scores.launches, matvecs=qs.matvecs.launches)


def cli(cwd, argv):
    os.chdir(cwd)
    sys.argv = ["cmd_run", *argv]
    cmd_run.main()


def serve():
    ui = webui.WebUIServer(spec["index_dir"], device=dev)
    ui.load()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), webui.make_handler(ui))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = "http://127.0.0.1:%d/api/search" % httpd.server_address[1]
    answers = []

    def client():
        for q in spec["queries"]:
            req = urllib.request.Request(url, data=json.dumps(
                {"query": q, "search_mode": "normal"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read()))

    asker = threading.Thread(target=client)
    asker.start()
    asker.join(timeout=300)
    httpd.shutdown()
    httpd.server_close()
    server.join(timeout=30)
    out["answers"] = answers


counted("tagging", lambda: cli(spec["tag_cwd"], ["tagging", "--dir", spec["tag_imgs"],
                                                 "--batch-size", "4"]))
if spec.get("genmodel_cwd"):
    counted("genmodel", lambda: cli(spec["genmodel_cwd"], ["genmodel", "--epochs", "2"]))
gen_cfeatures.time = types.SimpleNamespace(time=lambda: spec["stamp"])
counted("gen_cfeatures", lambda: cli(spec["cf_cwd"], ["gen_cfeatures", "--dir", spec["cf_imgs"]]))
counted("webui", serve)
print(json.dumps(out))
"""


def run_package(name: str, pythonpath: str, spec: dict, cache: str) -> dict:
    """``_PACKAGE_SCRIPT`` in a process of its own, PYTHONPATH ``pythonpath``
    alone, XDG_CACHE_HOME ``cache``, a temporary cwd; its output (the last
    line, JSON) with its wall time."""
    env = dict(os.environ, PYTHONPATH=pythonpath, XDG_CACHE_HOME=cache)
    with tempfile.TemporaryDirectory() as cwd:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _PACKAGE_SCRIPT, json.dumps(spec)], env=env,
                           cwd=cwd, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    tail = "\n".join(r.stdout.strip().splitlines()[-6:-1])
    print(f"phase 20 {name}: exit {r.returncode} in {wall:.1f} s; {tail[-600:]}", flush=True)
    check(r.returncode == 0, f"phase 20: the {name} run failed:\n{r.stdout[-3000:]}\n"
          f"{r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["process_s"] = wall
    return out


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def dir_bytes(directory: str) -> dict:
    """The files directly in ``directory``, by name."""
    return {f: file_bytes(os.path.join(directory, f)) for f in sorted(os.listdir(directory))
            if os.path.isfile(os.path.join(directory, f))}


def phase_packaging(torch, _build, fa, qs, caformer, config_mod, engine_mod, gen_ctx, tmp,
                    genmodel_tree_s, smi) -> dict:
    """Phase 20: the port's zipapp (packaging/build_zipapp_torch.py) built from
    this checkout and run on the card, held to the tree (see the module
    docstring); then CAFormer with fast_variance=True on the card against the
    CPU and tools/quant_report_torch.py at full width."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()      # the two processes below need the card's memory too
    root = os.path.join(tmp, "packaging")
    os.makedirs(root)
    pyz = os.path.join(root, "aiis_torch.pyz")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(REPO, "packaging", "build_zipapp_torch.py"),
                        "--out", pyz], capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"phase 20: the archive did not build:\n{r.stdout}{r.stderr}")
    archive_s = time.perf_counter() - t0
    # the inputs: phase 5's images, 16 of phase 12's PNGs, phase 14's gate corpus
    tag_imgs = os.path.join(root, "tag_imgs")
    write_cli_images(tag_imgs)
    cf_imgs = os.path.join(root, "cf_imgs")
    os.makedirs(cf_imgs)
    for f in sorted(os.listdir(gen_ctx["imgs"]))[:ARCHIVE_CF_IMAGES]:
        shutil.copyfile(os.path.join(gen_ctx["imgs"], f), os.path.join(cf_imgs, f))
    build0 = os.path.join(tmp, "build0")
    with open(os.path.join(build0, "tags-wd-tagger.txt"), encoding="utf-8") as f:
        gate_lines = f.read().splitlines()
    step = len(gate_lines) // ARCHIVE_QUERIES
    queries = [" ".join(gate_lines[j * step].split(",")[1:][:1 + j % 3])
               for j in range(ARCHIVE_QUERIES)]
    kernels = [fa.KERNEL, fa.KERNEL_F32, qs.KERNEL]
    runs, specs = {}, {}
    for name in ("archive", "tree"):
        spec = dict(kernels=kernels, tag_imgs=tag_imgs, cf_imgs=cf_imgs, queries=queries,
                    stamp=ARCHIVE_STAMP, device=DEV)
        for key in ("tag_cwd", "cf_cwd") + (("genmodel_cwd",) if name == "archive" else ()):
            spec[key] = os.path.join(root, f"{name}_{key[:-4]}")
            os.makedirs(spec[key])
        if name == "archive":
            shutil.copyfile(os.path.join(build0, "tags-wd-tagger.txt"),
                            os.path.join(spec["genmodel_cwd"], "tags-wd-tagger.txt"))
        spec["index_dir"] = spec.get("genmodel_cwd", build0)
        specs[name] = spec
        cache = os.path.join(root, f"{name}_cache")
        runs[name] = run_package(name, pyz if name == "archive" else REPO, spec, cache)
    arc, tree = runs["archive"], runs["tree"]
    cache_build = os.path.join(root, "archive_cache", "aiis_torch", "_build")

    # (a) the package came out of the archive, and the tree's out of the checkout
    check(arc["package_file"].startswith(pyz + os.sep),
          f"phase 20: the archive's package is {arc['package_file']}")
    check(tree["package_file"].startswith(REPO + os.sep),
          f"phase 20: the tree's package is {tree['package_file']}")
    # (b) the archive's outputs against the tree's
    tag_files = [file_bytes(os.path.join(specs[n]["tag_cwd"], "tags-wd-tagger.txt"))
                 for n in ("archive", "tree")]
    check(tag_files[0] == tag_files[1] and tag_files[0].count(b"\n") == 7,
          "phase 20: the archive's tag file differs from the tree's")
    cf_files = [dir_bytes(specs[n]["cf_cwd"]) for n in ("archive", "tree")]
    check(cf_files[0] == cf_files[1] and "charactor-featues-idx.csv" in cf_files[0],
          f"phase 20: the archive's cfeature files differ from the tree's: {sorted(cf_files[0])}")
    want, got = artifact_bytes(build0), artifact_bytes(specs["archive"]["genmodel_cwd"])
    differ = sorted(n for n in set(want) | set(got) if want.get(n) != got.get(n))
    check(not differ, f"phase 20: the archive's genmodel artifacts differ from phase 14's: {differ}")
    engine = engine_mod.SearchEngine(build0, device=DEV)
    for i, q in enumerate(queries):
        want_rows = json.loads(json.dumps(
            [dict(file_path=h.file_path, doc_id=h.doc_id, similarity=h.similarity, tags=h.tags)
             for h in engine.search(q)]))
        for name, run in runs.items():
            ans = run["answers"][i] if i < len(run["answers"]) else {}
            check(ans.get("error") is None and ans.get("results") == want_rows and want_rows,
                  f"phase 20: the {name}'s served answer to {q!r} differs from engine.search")
    del engine
    # (c) each kernel built in the fresh cache under the tree's library name,
    # and launched from the archive
    for n in kernels:
        lib = arc["libraries"][n]
        check(lib == os.path.join(cache_build, os.path.basename(_build._paths(n)[1]))
              and os.path.exists(lib),
              f"phase 20: the archive built {n} as {lib}, the tree as {_build._paths(n)[1]}")
    launches = dict(tagging_dh64=arc["tagging"]["attention"]["64"],
                    gen_cfeatures_dh32=arc["gen_cfeatures"]["attention"]["32"],
                    webui_query_scores=arc["webui"]["query_scores"],
                    webui_matvecs=arc["webui"]["matvecs"])
    check(all(v > 0 for v in launches.values()), f"phase 20: launches from the archive {launches}")
    check(launches["tagging_dh64"] == 24 * 2 and launches["gen_cfeatures_dh32"] == 18
          and launches["webui_query_scores"] == launches["webui_matvecs"],
          f"phase 20: launches from the archive {launches}, expected 48, 18 and one "
          "query-scores and one matvecs launch a dispatch")
    # (d) the first-use build and each CLI's wall time, archive and tree
    step_names = ("tagging", "gen_cfeatures", "webui")
    res = dict(card=smi, archive_build_s=archive_s,
               archive_kib=os.path.getsize(pyz) / 1024,
               first_use_build_s=dict(archive=arc["build_s"], tree=tree["build_s"]),
               import_s=dict(archive=arc["import_s"], tree=tree["import_s"]),
               process_s=dict(archive=arc["process_s"], tree=tree["process_s"]),
               cli_s={k: dict(archive=arc[k]["seconds"], tree=tree[k]["seconds"])
                      for k in step_names},
               genmodel_s=dict(archive=arc["genmodel"]["seconds"], tree_phase14=genmodel_tree_s),
               libraries={n: os.path.basename(arc["libraries"][n]) for n in kernels},
               launches=launches, queries=len(queries), images=dict(
                   tagging=7, gen_cfeatures=ARCHIVE_CF_IMAGES),
               genmodel_files_equal=len(want), cfeature_files_equal=len(cf_files[0]))
    print("packaging " + json.dumps(res), flush=True)
    # (e) CAFormer with one-pass LayerNorms on the card against the CPU, and
    # the int8 report at full width
    res["fast_variance"] = phase_ccip_parity(torch, caformer, config_mod, fast_variance=True,
                                             batch=8)
    import contextlib
    import importlib.util
    import io

    t0 = time.perf_counter()
    tool = importlib.util.spec_from_file_location(
        "quant_report_torch", os.path.join(REPO, "tools", "quant_report_torch.py"))
    quant_report = importlib.util.module_from_spec(tool)
    tool.loader.exec_module(quant_report)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = quant_report.main(["--batch", "32", "--device", DEV])
    printed = printed.getvalue().splitlines()
    line = [x for x in printed if x.startswith("quant report ")]
    check(rc == 0 and len(line) == 1, "phase 20: quant_report_torch printed no report:\n"
          + "\n".join(printed[-20:]))
    quant = json.loads(line[0][len("quant report "):])
    check(quant["images"] == 32 and quant["device"].startswith(DEV)
          and 0 < quant["prob_delta_max"] < 1, f"phase 20: the int8 report {quant}")
    for x in printed[-3:]:
        print(x, flush=True)
    torch.cuda.empty_cache()
    res["quant_report"] = dict(quant, seconds=time.perf_counter() - t0)
    res["seconds"] = time.perf_counter() - t_phase
    print("packaging fast_variance " + json.dumps(res["fast_variance"]) + " quant "
          + json.dumps(res["quant_report"]) + f" phase {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------- 21. the model hub

HUB_TAG_CLASSES = 10861           # WD-EVA02-Large's selected_tags.csv
HUB_CHARACTERS = 2800             # its last rows: category 4 (characters)
HUB_RATINGS = ("general", "sensitive", "questionable", "explicit")
HUB_LOGIT_BIAS = -3.0            # the seeded head's bias: a tagger's rare positives


class SwapModule:
    """``sys.modules[name] = value`` for a ``with`` block (``None`` makes any
    import of it raise), then what was there is put back."""

    _absent = object()

    def __init__(self, name: str, value) -> None:
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = sys.modules.get(self.name, self._absent)
        sys.modules[self.name] = self.value
        return self.value

    def __exit__(self, *exc):
        if self.saved is self._absent:
            sys.modules.pop(self.name, None)
        else:
            sys.modules[self.name] = self.saved
        return False


class StubHub:
    """A stand-in ``huggingface_hub`` for one phase (the card's machine has
    none, and no network): ``snapshot_download`` and ``hf_hub_download`` copy
    from local directories that stand for repos ({repo id: directory}), as the
    real functions lay files out under ``local_dir``; each call is recorded
    with its seconds. ``with`` puts it in ``sys.modules`` and puts back what
    was there."""

    def __init__(self, repos: dict) -> None:
        self.repos = repos
        self.calls: list = []

    def snapshot_download(self, repo_id, local_dir=None, allow_patterns=None):
        t0 = time.perf_counter()
        src = self.repos[repo_id]
        os.makedirs(local_dir, exist_ok=True)
        for name in sorted(os.listdir(src)):
            if allow_patterns is None or any(fnmatch.fnmatch(name, p) for p in allow_patterns):
                shutil.copyfile(os.path.join(src, name), os.path.join(local_dir, name))
        self.calls.append(dict(fn="snapshot_download", repo=repo_id,
                               seconds=time.perf_counter() - t0))
        return local_dir

    def hf_hub_download(self, repo_id, filename, local_dir=None):
        t0 = time.perf_counter()
        src = os.path.join(self.repos[repo_id], filename)
        if not os.path.exists(src):
            raise FileNotFoundError(f"{repo_id} has no {filename}")
        dst = os.path.join(local_dir, filename)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        self.calls.append(dict(fn="hf_hub_download", repo=repo_id, file=filename,
                               seconds=time.perf_counter() - t0))
        return dst

    def __enter__(self):
        module = types.ModuleType("huggingface_hub")
        module.snapshot_download = self.snapshot_download
        module.hf_hub_download = self.hf_hub_download
        self._swap = SwapModule("huggingface_hub", module)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        return self._swap.__exit__(*exc)


def eva02_timm_shapes(cfg) -> list:
    """(name, shape, kind) of a timm-named EVA02 state dict in the published
    WD tagger layout (SwiGLU ``fc1_g``/``fc1_x`` with its sub-LayerNorm, no
    attention sub-LN, ``fc_norm`` + head): tests/test_torch_checkpoint.py's
    ``timm_state_dict`` at full width. kind: fan-in of a weight, or
    "scale"/"bias"/"embed"/"logit_bias"."""
    d, h, p = cfg.embed_dim, cfg.mlp_hidden_dim, cfg.patch_size
    out = [("patch_embed.proj.weight", (d, 3, p, p), 3 * p * p),
           ("patch_embed.proj.bias", (d,), "bias"),
           ("cls_token", (1, 1, d), "embed"),
           ("pos_embed", (1, cfg.num_patches + 1, d), "embed")]
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            out += [(f"{b}.{ln}.weight", (d,), "scale"), (f"{b}.{ln}.bias", (d,), "bias")]
        out += [(f"{b}.attn.q_proj.weight", (d, d), d), (f"{b}.attn.q_proj.bias", (d,), "bias"),
                (f"{b}.attn.k_proj.weight", (d, d), d),
                (f"{b}.attn.v_proj.weight", (d, d), d), (f"{b}.attn.v_proj.bias", (d,), "bias"),
                (f"{b}.attn.proj.weight", (d, d), d), (f"{b}.attn.proj.bias", (d,), "bias"),
                (f"{b}.mlp.fc1_g.weight", (h, d), d), (f"{b}.mlp.fc1_g.bias", (h,), "bias"),
                (f"{b}.mlp.fc1_x.weight", (h, d), d), (f"{b}.mlp.fc1_x.bias", (h,), "bias"),
                (f"{b}.mlp.norm.weight", (h,), "scale"), (f"{b}.mlp.norm.bias", (h,), "bias"),
                (f"{b}.mlp.fc2.weight", (d, h), h), (f"{b}.mlp.fc2.bias", (d,), "bias")]
    out += [("fc_norm.weight", (d,), "scale"), ("fc_norm.bias", (d,), "bias"),
            ("head.weight", (cfg.num_classes, d), d),
            ("head.bias", (cfg.num_classes,), "logit_bias")]
    return out


def write_tagger_repo(torch, eva02, weights, directory: str, seed: int = 21) -> dict:
    """A seeded full-width ``model.safetensors`` (F32, the safetensors layout:
    an 8-byte header length, a JSON header padded to 8 bytes, the buffers in
    header order) and a ``selected_tags.csv`` of 10,861 rows (4 ratings,
    general tags, then characters). The values are drawn on the card and
    written one tensor at a time: weights N(0, 1/fan-in), LayerNorm scales
    1 + N(0, 0.02²), the head's biases HUB_LOGIT_BIAS + N(0, 0.02²) (so that a
    line holds tens of tags, not thousands), the rest N(0, 0.02²). Returns the config the port's
    ``detect_config_from_state_dict`` reads from the header's shapes and the
    file's size."""
    cfg = eva02.Eva02Config()
    shapes = eva02_timm_shapes(cfg)
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, shape, _ in shapes:
        n = 4 * int(np.prod(shape))
        header[name] = dict(dtype="F32", shape=list(shape), data_offsets=[offset, offset + n])
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(directory)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    path = os.path.join(directory, "model.safetensors")
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for _, shape, kind in shapes:
            x = torch.randn(shape, device=DEV, generator=gen)
            if kind == "scale":
                x = 1.0 + 0.02 * x
            elif kind in ("bias", "embed"):
                x = 0.02 * x
            elif kind == "logit_bias":
                x = 0.02 * x + HUB_LOGIT_BIAS
            else:
                x = x * kind ** -0.5
            f.write(x.cpu().numpy().astype("<f4").tobytes())
    n_general = HUB_TAG_CLASSES - len(HUB_RATINGS) - HUB_CHARACTERS
    with open(os.path.join(directory, "selected_tags.csv"), "w", encoding="utf-8") as f:
        f.write("tag_id,name,category,count\n")
        for i, r in enumerate(HUB_RATINGS):
            f.write(f"{9999990 + i},{r},9,0\n")
        for i in range(n_general):
            f.write(f"{i},general tag {i},0,{n_general - i}\n")
        for i in range(HUB_CHARACTERS):
            f.write(f"{100000 + i},character_{i}_(series),4,{HUB_CHARACTERS - i}\n")
    detected = weights.detect_config_from_state_dict(
        {name: types.SimpleNamespace(shape=shape) for name, shape, _ in shapes})
    return dict(config=detected, bytes=os.path.getsize(path))


class TimedAttr:
    """Wraps ``module.name`` (a function) for a ``with`` block so that each
    call's seconds are appended to ``seconds``."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def in_dir(directory: str, fn):
    """``fn()`` run with ``directory`` (made here) as the cwd; its wall seconds
    (the CLIs end on host copies of their results, so the card's work is in it)."""
    os.makedirs(directory)
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def expect_offline(fn, what: str) -> str:
    """``fn()`` must raise RuntimeError naming --model-dir; returns its message."""
    try:
        fn()
    except RuntimeError as e:
        check("--model-dir" in str(e), f"phase 21: {what}'s offline error names no "
              f"--model-dir: {e}")
        return str(e)
    fail(f"phase 21: {what} with no huggingface_hub and an empty cache did not raise")


def phase_hub(torch, fa, tagging, gen_cfeatures, eva02, config_mod, artifacts, similarity,
              gen_ctx, tmp, smi) -> dict:
    """Phase 21: ``--model-repo`` on the card through a stand-in
    ``huggingface_hub`` (the card's machine has neither the package nor a
    network). The tagger: a seeded full-width WD-EVA02-Large checkpoint in the
    published layout stands for the repo; ``tagging --model-dir`` on it, then
    ``tagging --model-repo`` into an empty ``$AIIS_MODEL_CACHE`` (one
    snapshot), then again (a cache hit: no hub call), each on phase 5's 7
    images at B=4: the three tag files byte-equal, 24 Dh=64 launches a
    forward. CCIP: phase 15's export-style model_feat.onnx and metrics.json
    stand for the repo; ``gen_cfeatures --model-repo`` on phase 12's 200
    PNGs converts into the cache: config.json byte-equal to phase 15's
    converted one, the threshold phase 15's, the rows phase 15's
    ``--model-dir`` rows within its gate, 18 Dh=32 launches a forward; a
    second fetch is a cache hit. Offline: with ``huggingface_hub`` blocked,
    both CLIs' ``--model-repo`` into an empty cache raise a RuntimeError
    naming --model-dir and write nothing."""
    from anime_illust_image_searcher_tpu_torch.models import hub, weights

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "hub")
    os.makedirs(root)
    saved_cache = os.environ.get("AIIS_MODEL_CACHE")
    res = dict(card=smi)
    try:
        # the tagger: its repo, --model-dir, --model-repo, the cache hit
        t0 = time.perf_counter()
        repo = write_tagger_repo(torch, eva02, weights, os.path.join(root, "tagger_repo"))
        res["checkpoint_write_s"] = time.perf_counter() - t0
        res["checkpoint_gb"] = repo["bytes"] / 1e9
        check(repo["config"] == eva02.Eva02Config(),
              f"phase 21: the checkpoint's detected config is not Eva02Config(): {repo['config']}")
        imgs = os.path.join(root, "tag_imgs")
        write_cli_images(imgs)
        tag_argv = ["--dir", imgs, "--batch-size", "4"]
        os.environ["AIIS_MODEL_CACHE"] = os.path.join(root, "cache")
        tag_repo = hub.DEFAULT_TAGGER_REPO
        files, cli_s, launches = {}, {}, {}
        with StubHub({tag_repo: os.path.join(root, "tagger_repo")}) as stub, \
                TimedAttr(tagging, "fetch_tagger_repo") as fetch:
            for name, extra in (("model_dir", ["--model-dir", os.path.join(root, "tagger_repo")]),
                                ("model_repo", ["--model-repo", tag_repo]),
                                ("cache_hit", ["--model-repo", tag_repo])):
                stub.calls.clear()
                fa.reset_launches()
                cwd = os.path.join(root, f"tag_{name}")
                cli_s[name] = in_dir(cwd, lambda: tagging.main(tag_argv + extra, device=DEV))
                launches[name] = dict(fa.mha_attention.launches)
                check(fa.mha_attention.launches == {64: 24 * 2, 32: 0}
                      and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
                      f"phase 21: tagging {name} launched {fa.mha_attention.launches} "
                      f"(f32 {fa.mha_attention.launches_f32}), expected 48 at Dh=64")
                files[name] = file_bytes(os.path.join(cwd, "tags-wd-tagger.txt"))
                want_calls = 1 if name == "model_repo" else 0
                check(len(stub.calls) == want_calls,
                      f"phase 21: tagging {name} made {len(stub.calls)} hub calls, "
                      f"expected {want_calls}")
                if name == "model_repo":
                    res["tagger_fetch"] = dict(stub.calls[0], fetch_s=fetch.seconds[-1])
                torch.cuda.empty_cache()
        dest = os.path.join(root, "cache", tag_repo.replace("/", "__"))
        check(sorted(os.listdir(dest)) == ["model.safetensors", "selected_tags.csv"]
              and os.path.getsize(os.path.join(dest, "model.safetensors")) == repo["bytes"],
              f"phase 21: the tagger's cache dir holds {os.listdir(dest)}")
        check(files["model_repo"] == files["model_dir"] == files["cache_hit"]
              and files["model_dir"].count(b"\n") == 7,
              "phase 21: tagging --model-repo's tag file differs from --model-dir's")
        res["tagging"] = dict(images=7, batch=4, cli_s=cli_s, launches=launches,
                              tag_file_bytes=len(files["model_dir"]),
                              tags_per_line=files["model_dir"].count(b",") / 7)
        os.remove(os.path.join(dest, "model.safetensors"))
        shutil.rmtree(os.path.join(root, "tagger_repo"))

        # CCIP: phase 15's files as the repo, gen_cfeatures --model-repo
        work15 = os.path.join(tmp, "ccip_onnx")
        ccip_repo = os.path.join(root, "ccip_repo")
        os.makedirs(os.path.join(ccip_repo, hub.DEFAULT_CCIP_MODEL))
        for f in ("model_feat.onnx", "metrics.json"):
            os.symlink(os.path.join(work15, f),
                       os.path.join(ccip_repo, hub.DEFAULT_CCIP_MODEL, f))
        cfg = config_mod.CCIPConfig()
        with StubHub({hub.DEFAULT_CCIP_REPO: ccip_repo}) as stub, \
                TimedAttr(gen_cfeatures, "fetch_ccip_repo") as fetch:
            fa.reset_launches()
            gen_cwd = os.path.join(root, "cf_model_repo")
            gen_s = in_dir(gen_cwd, lambda: gen_cfeatures.main(
                ["--dir", gen_ctx["imgs"], "--model-repo", hub.DEFAULT_CCIP_REPO], device=DEV))
            gen_launches = dict(fa.mha_attention.launches)
            n = len(gen_ctx["rows"])
            forwards = -(-n // cfg.batch_size)
            check(fa.mha_attention.launches == {64: 0, 32: 18 * forwards}
                  and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
                  f"phase 21: gen_cfeatures --model-repo launched "
                  f"{fa.mha_attention.launches}, expected 18 x {forwards} at Dh=32")
            check([c["file"] for c in stub.calls] == [
                f"{hub.DEFAULT_CCIP_MODEL}/model_feat.onnx", f"{hub.DEFAULT_CCIP_MODEL}/metrics.json"],
                f"phase 21: gen_cfeatures --model-repo's hub calls {stub.calls}")
            ccip_calls = list(stub.calls)
            stub.calls.clear()
            cdest = hub.fetch_ccip_repo(hub.DEFAULT_CCIP_REPO)
            check(stub.calls == [], f"phase 21: a second CCIP fetch called the hub: {stub.calls}")
        check(file_bytes(os.path.join(cdest, "config.json"))
              == file_bytes(os.path.join(work15, "ckpt", "config.json")),
              "phase 21: the fetched config.json differs from phase 15's converted one")
        thr = json.loads(file_bytes(os.path.join(cdest, "config.json")))["threshold"]
        check(thr == METRIC_THRESHOLD, f"phase 21: threshold {thr}, phase 15's {METRIC_THRESHOLD}")

        def rows(directory):
            with open(os.path.join(directory, artifacts.CFEATURES_CSV), encoding="utf-8") as fh:
                paths = fh.read().splitlines()
            idx = similarity.SimilarityIndex.load(
                os.path.join(directory, artifacts.cfeatures_index_name(0)))
            return {os.path.basename(p): np.asarray(r) for p, r in zip(paths, idx.matrix)}

        got, want = rows(gen_cwd), rows(os.path.join(work15, "gen"))
        check(sorted(got) == sorted(want) and len(got) == n,
              "phase 21: gen_cfeatures --model-repo indexed other files than phase 15")
        row_err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        check(row_err <= 1e-6, f"phase 21: --model-repo rows differ from phase 15's by {row_err}")
        res["ccip"] = dict(images=n, batch=cfg.batch_size, hub_calls=ccip_calls,
                           fetch_convert_s=fetch.seconds[-1], cli_s=gen_s,
                           launches=gen_launches, threshold=thr,
                           rows_vs_phase15_max_diff=row_err, config_json_equal=True)
        torch.cuda.empty_cache()

        # offline: no huggingface_hub, an empty cache
        os.environ["AIIS_MODEL_CACHE"] = os.path.join(root, "empty_cache")
        off_cwd = os.path.join(root, "offline")
        os.makedirs(off_cwd)
        with SwapModule("huggingface_hub", None):
            res["offline"] = dict(
                tagging=expect_offline(lambda: in_dir(os.path.join(off_cwd, "t"), lambda: (
                    tagging.main(tag_argv + ["--model-repo", tag_repo], device=DEV))),
                    "tagging --model-repo"),
                gen_cfeatures=expect_offline(lambda: in_dir(os.path.join(off_cwd, "c"), lambda: (
                    gen_cfeatures.main(["--dir", imgs, "--model-repo", hub.DEFAULT_CCIP_REPO],
                                       device=DEV))), "gen_cfeatures --model-repo"))
        check(not os.path.exists(os.path.join(root, "empty_cache"))
              and all(os.listdir(os.path.join(off_cwd, d)) == [] for d in ("t", "c")),
              "phase 21: an offline --model-repo run wrote files")
    finally:
        if saved_cache is None:
            os.environ.pop("AIIS_MODEL_CACHE", None)
        else:
            os.environ["AIIS_MODEL_CACHE"] = saved_cache
    res["launches"] = dict(dh64=sum(v[64] for v in res["tagging"]["launches"].values()),
                           dh32=res["ccip"]["launches"][32])
    res["seconds"] = time.perf_counter() - t_phase
    print("hub " + json.dumps(res), flush=True)
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    sys.path.insert(0, REPO)
    try:
        from anime_illust_image_searcher_tpu_torch import config as config_mod
        from anime_illust_image_searcher_tpu_torch.cli import tagging
        from anime_illust_image_searcher_tpu_torch.models import eva02, tagger as tagger_mod
        from anime_illust_image_searcher_tpu_torch.ops import _build
        from anime_illust_image_searcher_tpu_torch.ops import flash_attention as fa
        from anime_illust_image_searcher_tpu_torch.ops import fused_query as fq
        from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs
        from anime_illust_image_searcher_tpu_torch.index import bm25_index, dictionary
        from anime_illust_image_searcher_tpu_torch.index import artifacts, similarity
        from anime_illust_image_searcher_tpu_torch.cli import gen_cfeatures, webui
        from anime_illust_image_searcher_tpu_torch.models import caformer, ccip as ccip_mod
        from anime_illust_image_searcher_tpu_torch.search import rerank_ccip
        from anime_illust_image_searcher_tpu_torch.cli import genmodel
        from anime_illust_image_searcher_tpu_torch.models import doc2vec as d2v
        from anime_illust_image_searcher_tpu_torch.search import engine as engine_mod
        from anime_illust_image_searcher_tpu_torch.utils import prng
        from anime_illust_image_searcher_tpu_torch.data import ingest, native_ingest
        from anime_illust_image_searcher_tpu_torch.ops import quant
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build every kernel of the path (one nvcc per source, started together)
    t0 = time.perf_counter()
    _build.build([fa.KERNEL, fa.KERNEL_F32, qs.KERNEL])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    # 2 + 2b. each kernel against its plain version (the attention kernel at
    # head dims 64 and 32)
    sm_ghz = max_sm_ghz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_kernels(torch, fa, gen, sm_ghz), phase_kernels_dh32(torch, fa, gen, sm_ghz)]
    # 2c. the f32 attention kernel at head dims 64 and 32 (its entries join
    # the kernels line last)
    f32_kernels = phase_kernels_f32(torch, fa, gen, sm_ghz)

    # 3 + 3b. the model on the card against the model on the CPU, bf16 and f32
    phase_parity(torch, eva02, tagger_mod)
    phase_parity_f32(torch, eva02)

    # 4 + 5. the main path, with the launch counts read around it
    fa.reset_launches()
    main_res, forwards = phase_main(torch, tagger_mod, config_mod, eva02, fa)
    forwards += phase_cli(torch, tagging, config_mod)
    launches = fa.mha_attention.launches[64]
    check(fa.mha_attention.launches == {64: 24 * forwards, 32: 0}
          and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
          f"flash_attention launched {fa.mha_attention.launches} times (f32: "
          f"{fa.mha_attention.launches_f32}), expected 24 x {forwards} forwards at Dh=64")
    kernels[0]["launches"] = launches

    # 4b. the f32 tagger (compute_dtype="float32") at full width, B=64, with
    # one forward profiled by kernel group, then the CLI in f32, with both
    # counts set to 0 just before
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    f32_res, forwards = phase_main(torch, tagger_mod, config_mod, eva02, fa,
                                   compute_dtype="float32", batch_size=64, profile=True)
    forwards += phase_cli(torch, tagging, config_mod, compute_dtype="float32")
    check(fa.mha_attention.launches_f32 == {64: 24 * forwards, 32: 0}
          and fa.mha_attention.launches == {64: 0, 32: 0},
          f"phase 4b: the f32 kernel launched {fa.mha_attention.launches_f32} times, the "
          f"bf16 kernel {fa.mha_attention.launches}, expected 24 x {forwards} f32 forwards")
    f32_kernels[0]["launches"] = fa.mha_attention.launches_f32[64]

    # 6. where the time of one forward goes
    phase_profile(torch, tagger_mod, config_mod)

    # 16. tagging end to end: the native decode pool, scaled and subprocess
    # decode, the int8 EVA02, --profile (counts its own Dh=64 launches)
    e2e_res, int8_res = phase_tagging(torch, tagging, tagger_mod, config_mod, eva02, quant,
                                      ingest, native_ingest, fa)
    kernels[0]["launches"] += e2e_res["attention_launches"][64]

    # 7. the query kernel and the matvecs kernel against their plain
    # versions (matvecs also against the query kernel's bits), and their times
    kernels.append(phase_query_kernels(torch, qs, fq, _build))
    kernels.append(phase_matvecs(torch, qs, _build))

    # 8 + 9. the engine and the web server over a 1M-doc artifact chain, with
    # both K5 counts set to 0 before the served traffic and read after it
    with tempfile.TemporaryDirectory() as tmp:
        ui, tokens, rng = phase_chain(torch, webui, config_mod, dictionary, bm25_index, tmp)
        programs = phase_query_gates(torch, fq, qs, ui.engine, tokens, rng)
        with DispatchMeter(torch, fq) as meter:
            qs.reset_launches()
            query_res = phase_query_main(torch, qs, ui.engine, tokens, rng, meter)
            serve_res = phase_serve(torch, webui, qs, ui, tokens, rng, meter)
        query_launches = query_res["launches"] + serve_res["launches"]
        mv_launches = query_res["matvecs_launches"] + serve_res["matvecs_launches"]

        # 10-12. the CCIP encoder: card against CPU, then its main path (the
        # predictor, the CLI) with the Dh=32 count set to 0 just before it
        phase_ccip_parity(torch, caformer, config_mod)
        # 10b. CAFormer-24 in f32 through the f32 kernel, counts set to 0 before it
        fa.reset_launches()
        ccip_f32_res, forwards = phase_ccip_f32(torch, ccip_mod, config_mod, caformer, fa)
        check(fa.mha_attention.launches_f32 == {64: 0, 32: 18 * forwards}
              and fa.mha_attention.launches == {64: 0, 32: 0},
              f"phase 10b: the f32 kernel launched {fa.mha_attention.launches_f32} times, "
              f"the bf16 kernel {fa.mha_attention.launches}, expected 18 x {forwards} "
              "f32 CAFormer forwards")
        f32_kernels[1]["launches"] = fa.mha_attention.launches_f32[32]
        fa.reset_launches()
        ccip_res, ccip_forwards = phase_ccip_main(torch, ccip_mod, config_mod, caformer, fa)
        gen_res, gen_forwards, gen_ctx = phase_gen_cfeatures(
            torch, gen_cfeatures, config_mod, artifacts, similarity, tmp)

        # 13. character mode over the 1M-doc chain (counts its own launches)
        char_res, char_ctx = phase_character(torch, fq, qs, fa, caformer, rerank_ccip,
                                             artifacts, webui, ui, tokens, rng, tmp)
        dh32 = fa.mha_attention.launches[32]
        forwards32 = ccip_forwards + gen_forwards + char_res["live_forwards"]
        check(fa.mha_attention.launches == {64: 0, 32: 18 * forwards32}
              and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
              f"flash_attention launched {fa.mha_attention.launches} times in "
              f"phases 11-13, expected 18 x {forwards32} CAFormer forwards at Dh=32")
        kernels[1]["launches"] = dh32
        kernels[2]["launches"] = query_launches + char_res["launches"]
        kernels[3]["launches"] = mv_launches + char_res["matvecs_launches"]
        kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"],
                                        char_res["rerank_vs_plain"]["max_abs_err"])

        # 17. --data-parallel: the predictors over meshes, both CLIs, the
        # sharded index (all three counts set to 0 inside it, read here)
        dp_res = phase_data_parallel(torch, tagger_mod, config_mod, tagging, ccip_mod,
                                     caformer, gen_cfeatures, qs, fq, fa, gen_ctx["imgs"],
                                     tmp, smi)
        kernels[0]["launches"] += dp_res["attention_launches"][64]
        kernels[1]["launches"] += dp_res["attention_launches"][32]
        kernels[3]["launches"] += sum(dp_res["index"]["matvecs_launches"].values())

        # 18. the sharded engine: normal and character queries over row shards
        # of the chain and of phase 13's cfeatures, and WebUIServer(mesh=)
        # (the query-scores count set to 0 before each mesh's work, read after)
        p18 = phase_sharded_engine(torch, qs, fq, webui, engine_mod, rerank_ccip, ui,
                                   char_ctx, tokens, rng, tmp, smi)
        kernels[2]["launches"] += p18["launches"]
        kernels[3]["launches"] += p18["matvecs_launches"]

        # 15. CCIP from the published files' layout: convert, the learned
        # metric, the batched character program (all counts set to 0 here)
        fa.reset_launches()
        qs.reset_launches()
        convert_res, metric_res, batch_res, forwards15 = phase_ccip_onnx(
            torch, fa, qs, caformer, config_mod, rerank_ccip, webui, ui, char_ctx, gen_ctx, tmp)
        by_form = dict(qs.query_scores.launches_by_form)
        mv_by_form = dict(qs.matvecs.launches_by_form)
        check(fa.mha_attention.launches == {64: 0, 32: 18 * forwards15}
              and fa.mha_attention.launches_f32 == {64: 0, 32: 0},
              f"flash_attention launched {fa.mha_attention.launches} times in phase 15, "
              f"expected 18 x {forwards15} CAFormer forwards at Dh=32")
        check(any(by_form.get(f"scores B={b}", 0) for b in range(2, 9))
              and any(mv_by_form.get(f"B={b}", 0) for b in range(2, 9)),
              f"phase 15 launched no batched form of a kernel: query_scores {by_form}, "
              f"matvecs {mv_by_form}")
        check(not any(k.startswith("matvecs") for k in by_form),
              f"phase 15 took the old matvecs route through query_scores: {by_form}")
        kernels[1]["launches"] += fa.mha_attention.launches[32]
        kernels[2]["launches"] += qs.query_scores.launches
        kernels[3]["launches"] += qs.matvecs.launches
        batch_res["query_scores_launches"] = by_form
        batch_res["matvecs_launches"] = mv_by_form
        batch_res["kernel_times"] = time_character_kernels(
            torch, qs, ui.engine, char_ctx["texts"], char_ctx["reranker"].cfeatures_idx.device_matrix())
        batch_res["single_query_p50_phase13_find_ms"] = char_res["single"]["find_ms"]["p50"]
        print("character batch " + json.dumps(batch_res), flush=True)
        del char_ctx

        # 14. the index build: its gates on a 20,000-doc tags file, the timed
        # 1M-doc training and inference, then the re-inference branches over
        # phase 8's chain
        gates = phase_index_gates(torch, genmodel, d2v, prng, engine_mod, config_mod, tmp)
        build_res, d2v_docs = phase_index_timed(torch, d2v, prng, config_mod)
        reinfer_res = phase_reinfer(torch, engine_mod, qs, ui, tokens, rng, tmp)
        del ui
        torch.cuda.empty_cache()

        # 19. data-parallel Doc2Vec: training and inference over meshes at 1M
        # docs, genmodel --data-parallel, train_gather_bf16
        d2v_res = phase_dp_doc2vec(torch, genmodel, d2v, config_mod, d2v_docs, tmp, smi)
        del d2v_docs

        # 20. packaging: the port's zipapp built from this checkout, its CLIs
        # and web server run from it on the card (launches counted in its
        # process) and held to the tree's; CAFormer fast_variance; the int8 report
        pack_res = phase_packaging(torch, _build, fa, qs, caformer, config_mod, engine_mod,
                                   gen_ctx, tmp, gates["genmodel_s"][0], smi)
        kernels[0]["launches"] += pack_res["launches"]["tagging_dh64"]
        kernels[1]["launches"] += pack_res["launches"]["gen_cfeatures_dh32"]
        kernels[2]["launches"] += pack_res["launches"]["webui_query_scores"]
        kernels[3]["launches"] += pack_res["launches"]["webui_matvecs"]

        # 21. the model hub: --model-repo on tagging (a full-width checkpoint in
        # the published layout) and gen_cfeatures (phase 15's ONNX files)
        # through a stand-in huggingface_hub, counts set to 0 before each CLI run
        hub_res = phase_hub(torch, fa, tagging, gen_cfeatures, eva02, config_mod, artifacts,
                            similarity, gen_ctx, tmp, smi)
        kernels[0]["launches"] += hub_res["launches"]["dh64"]
        kernels[1]["launches"] += hub_res["launches"]["dh32"]
    torch.cuda.empty_cache()

    one = query_res["single"]
    mv = kernels[3]
    print(f"summary: {main_res['img_s']:.2f} img/s end to end at B={main_res['batch']} "
          f"(MFU {100 * main_res['mfu']:.2f}%), forward alone {main_res['forward_img_s']:.2f} "
          f"img/s (MFU {100 * main_res['forward_mfu']:.2f}% of 989 TFLOP/s bf16); 1M-doc "
          f"engine: a query p50 {one['engine_ms']['p50']:.3f} ms, p99 "
          f"{one['engine_ms']['p99']:.3f} ms (program on the card p50 "
          f"{one['program_event_ms']['p50']:.3f} ms), a batch of 8 "
          f"{query_res['batch8']['engine_ms_per_query']:.3f} ms a query; exact program "
          f"{programs['B=1']['exact_wall_ms']:.3f} vs fast {programs['B=1']['fast_wall_ms']:.3f} "
          f"ms at B=1; matvecs kernel {mv['ms']:.4f} ms at F=300 B=1 (old route "
          f"{mv['old_route_ms']:.4f}, torch.mv {mv['library_ms']:.4f}, bound "
          f"{mv['bound_ms']:.4f}); serve {serve_res['requests_per_s']:.1f} requests/s, p50 "
          f"{serve_res['latency_ms']['p50']:.1f} ms over {serve_res['requests']}; CCIP "
          f"CAFormer-24 {ccip_res['img_s']:.1f} img/s end to end at B={ccip_res['batch']}, "
          f"forward alone {ccip_res['forward_img_s']:.1f} img/s (MFU "
          f"{100 * ccip_res['forward_mfu']:.2f}%); gen_cfeatures "
          f"{gen_res['first_run_img_s']:.1f} img/s with decode; character query p50 "
          f"{char_res['single']['engine_ms']['p50']:.3f} ms, p99 "
          f"{char_res['single']['engine_ms']['p99']:.3f} ms; batched character program "
          f"{batch_res['ms_per_query']:.3f} ms a query in bursts of 8; learned metric "
          f"{metric_res['metric_ms']:.1f} ms a query over 1M rows; index build at 1M docs "
          f"{build_res['ms_per_step']:.3f} ms a step ({build_res['steps_per_s']:.1f} steps/s, "
          f"{build_res['epochs_run']} epochs), inference {build_res['infer']['docs_per_s']:.1f} "
          f"docs/s; PRF re-inference p50 "
          f"{reinfer_res['reference_prf']['engine_ms']['p50']:.1f} ms (AIIS_REFERENCE_PRF), "
          f"{reinfer_res['terms_300']['engine_ms']['p50']:.1f} ms (300 terms); tagging end to "
          f"end over {e2e_res['images']} images "
          + ", ".join(f"{r['img_s']:.1f} img/s ({name})" for name, r in e2e_res["runs"].items())
          + f"; decode alone {e2e_res['decode']['pillow_threads']['img_s']:.1f} img/s (Pillow), "
          f"{e2e_res['decode']['native'].get('img_s', 'no library')} (native); int8 forward "
          f"{int8_res['forward_ms']:.1f} ms against bf16 {int8_res['bf16_forward_ms']:.1f} at "
          f"B={int8_res['batch']}; f32 tagging {f32_res['img_s']:.2f} img/s end to end at "
          f"B={f32_res['batch']}, forward alone {f32_res['forward_img_s']:.2f} img/s; f32 CCIP "
          f"forward alone {ccip_f32_res['forward_img_s']:.1f} img/s at B={ccip_f32_res['batch']}; "
          f"f32 attention {f32_kernels[0]['ms']:.4f} ms (SDPA f32 "
          f"{f32_kernels[0]['library_ms']:.4f}, bound {f32_kernels[0]['bound_ms']:.4f} as "
          f"{F32_PASSES} x TF32, {f32_kernels[0]['ffma_bound_ms']:.4f} as FFMA) at "
          f"B=32 Dh=64; data parallel (phase 17) tagging forward "
          f"{dp_res['tagging']['none']['forward_img_s']:.2f} img/s with no mesh, "
          f"{dp_res['tagging']['one_card']['forward_img_s']:.2f} on make_mesh(), "
          f"{dp_res['tagging']['card_twice']['forward_img_s']:.2f} on the card twice, "
          f"sharded top-{DP_TOP_K} over 1M rows p50 "
          + ", ".join(f"{dp_res['index'][f'shards_{n}_top_k_ms']['p50']:.3f}"
                      for n in DP_SHARDS)
          + f" ms at {'/'.join(map(str, DP_SHARDS))} shards; sharded engine (phase 18) "
          f"p50 {p18['unsharded']['engine_ms']['p50']:.3f} ms unsharded, "
          + ", ".join(f"{p18[f'shards_{n}']['engine_ms']['p50']:.3f}" for n in SHARD_COUNTS)
          + f" ms at {'/'.join(map(str, SHARD_COUNTS))} shards; data-parallel Doc2Vec "
          f"(phase 19) ms a step {d2v_res['none']['ms_per_step']:.3f} no mesh, "
          f"{d2v_res['card_twice']['ms_per_step']:.3f} on the card twice, "
          f"{d2v_res['group_of_one']['ms_per_step']:.3f} over the NCCL group, inference "
          + "/".join(f"{d2v_res[w]['infer']['docs_per_s']:.1f}"
                     for w in ("none", "card_twice", "group_of_one"))
          + f" docs/s; the archive (phase 20): first-use build "
          f"{pack_res['first_use_build_s']['archive']:.1f} s, tagging / gen_cfeatures / webui "
          + " / ".join(f"{pack_res['cli_s'][k]['archive']:.1f}"
                       for k in ("tagging", "gen_cfeatures", "webui"))
          + " s (tree " + " / ".join(f"{pack_res['cli_s'][k]['tree']:.1f}"
                                     for k in ("tagging", "gen_cfeatures", "webui"))
          + f" s), genmodel {pack_res['genmodel_s']['archive']:.1f} s; the hub (phase 21): "
          f"checkpoint write {hub_res['checkpoint_write_s']:.1f} s, tagger fetch "
          f"{hub_res['tagger_fetch']['fetch_s']:.1f} s, CCIP fetch + convert "
          f"{hub_res['ccip']['fetch_convert_s']:.1f} s, tagging --model-dir / --model-repo / "
          "cache hit " + " / ".join(f"{hub_res['tagging']['cli_s'][k]:.1f}"
                                    for k in ("model_dir", "model_repo", "cache_hit"))
          + f" s, gen_cfeatures --model-repo {hub_res['ccip']['cli_s']:.1f} s; on {smi}",
          flush=True)
    kernels += f32_kernels
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the f32 entries also carry their pass count, the FFMA bound and both shares
    # and matvecs the old route's time beside its own
    extra = ("passes", "share_of_bound", "ffma_bound_ms", "share_of_ffma_bound", "old_route_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in keys or k in kern}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
