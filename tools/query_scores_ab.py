#!/usr/bin/env python3
"""This checkout's query-scores kernels against another revision's, on one
NVIDIA card: bit identity and time.

    python3 tools/query_scores_ab.py --other PATH/TO/other/query_scores.cu

Builds both sources with the same nvcc flags (ops/_build.py), puts the same
inputs through both at chip_smoke.py's phase 7 shapes (D=1M, F=300, W=32;
B=1/8 x Q=8/64/256, the queries' ids weighted, required and excluded) through
each side's ``aiis_query_scores``, and the rerank and 1 - cos products (no
term slots: F=300 and F=768 at B=1 and 8) through this checkout's
``aiis_matvecs`` and the other side's ``aiis_matvecs``, or, where the other
revision has none, its ``aiis_query_scores`` with W = Q = 0 (the route
aiis_matvecs replaced).
Checks that each output is torch.equal between the two (or prints the first
difference), and times them in turns (other, this, this, other), each the
mean of 20 launches. Prints the card's name and power limit, one ``ab {json}``
line a shape and an ``ab summary {json}`` line; exits 1 if any output
differs. Imports the port only (torch, numpy), never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = 1000


def run(torch, fn, matrix, term, contrib, packed):
    """One launch through a bound ``aiis_query_scores``: the four (B, D) outputs."""
    d, f = matrix.shape
    b, buflen = packed.shape
    outs = [torch.empty((b, d), dtype=dt, device=matrix.device)
            for dt in (torch.float32, torch.float32, torch.int32, torch.int32)]
    err = fn(matrix.data_ptr(), term.data_ptr(), contrib.data_ptr(), packed.data_ptr(),
             d, f, term.shape[1], (buflen - f - 1) // 4, b, *(o.data_ptr() for o in outs),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"query_scores launch failed: CUDA error {err}")
    return outs


def run_matvecs(torch, fn, matrix, vecs):
    """One launch through a bound ``aiis_matvecs``: the (B, D) sims."""
    d, f = matrix.shape
    out = torch.empty((vecs.shape[0], d), dtype=torch.float32, device=matrix.device)
    err = fn(matrix.data_ptr(), vecs.data_ptr(), d, f, vecs.shape[0], out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"matvecs launch failed: CUDA error {err}")
    return [out]


def cuda_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def first_difference(torch, a, b):
    """None if a and b are equal, else (query, doc, a's value, b's value)."""
    if torch.equal(a, b):
        return None
    i = int((a != b).flatten().nonzero()[0])
    q, d = divmod(i, a.shape[1])
    return [q, d, a[q, d].item(), b[q, d].item()]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another revision's csrc/query_scores.cu")
    ap.add_argument("--docs", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, REPO)
    from anime_illust_image_searcher_tpu_torch.ops import _build
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs
    from anime_illust_image_searcher_tpu_torch.ops.fused_query import pack_query

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    this_lib = _build.load(qs.KERNEL)
    this, this_mv = qs._bind(this_lib), qs._bind_matvecs(this_lib)
    other_lib = _build.load_other(os.path.abspath(args.other), qs.KERNEL)
    other = qs._bind(other_lib)
    other_mv = qs._bind_matvecs(other_lib) if hasattr(other_lib, "aiis_matvecs") else None

    d, f, w = args.docs, 300, 32
    g = torch.Generator(device="cuda").manual_seed(7)
    matrix = torch.nn.functional.normalize(torch.randn(d, f, device="cuda", generator=g), dim=1)
    term = torch.randint(0, 10_000, (d, w), device="cuda", generator=g, dtype=torch.int32)
    contrib = torch.rand(d, w, device="cuda", generator=g)
    rng = np.random.default_rng(7)
    cases = []
    for q in (8, 64, 256):
        rows = []
        for _ in range(8):
            ids = rng.choice(10_000, 5 if q == 8 else q - 8, replace=False)
            weights = {int(i): (1, 3, MAGIC + 1, -1)[int(rng.integers(4))] for i in ids}
            vec = rng.standard_normal(f).astype(np.float32)
            rows.append(pack_query(vec / np.linalg.norm(vec), weights, 10_000, MAGIC, q))
        packed = torch.from_numpy(np.stack(rows)).cuda()
        for b in (1, 8):
            cases.append((f"B={b} Q={q}", (matrix, term, contrib, packed[:b].contiguous())))

    results, same = {}, True

    def measure(label, run_other, run_this):
        nonlocal same
        a, b = run_other(), run_this()
        diffs = {n: first_difference(torch, x, y)
                 for n, x, y in zip(("sims", "bm25", "excl_hits", "req_hits"), a, b)}
        same = same and all(v is None for v in diffs.values())
        t = [cuda_ms(torch, run_other), cuda_ms(torch, run_this),
             cuda_ms(torch, run_this), cuda_ms(torch, run_other)]
        res = dict(equal=all(v is None for v in diffs.values()), first_difference=diffs,
                   other_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2, turns_ms=t)
        results[label] = res
        print(f"ab {label} " + json.dumps(res), flush=True)

    def products(m):
        """This side's aiis_matvecs against the other's (or its W = Q = 0 route)."""
        for b in (1, 8):
            vecs = torch.nn.functional.normalize(
                torch.randn(b, m.shape[1], device="cuda", generator=g), dim=1)
            empty = m.new_empty((m.shape[0], 0))
            old = (m, empty.to(torch.int32), empty,
                   torch.cat([vecs, vecs.new_zeros((b, 1))], 1))
            measure(f"matvecs F={m.shape[1]} B={b}",
                    (lambda: run_matvecs(torch, other_mv, m, vecs)) if other_mv
                    else (lambda: run(torch, other, *old)[:1]),
                    lambda: run_matvecs(torch, this_mv, m, vecs))

    for label, case in cases:
        measure(label, lambda: run(torch, other, *case), lambda: run(torch, this, *case))
    products(matrix)
    del cases, matrix, term, contrib
    torch.cuda.empty_cache()
    products(torch.nn.functional.normalize(torch.randn(d, 768, device="cuda", generator=g),
                                           dim=1))
    print("ab summary " + json.dumps(dict(
        card=smi, docs=d, all_equal=same,
        other_products="aiis_matvecs" if other_mv else "aiis_query_scores W=Q=0",
        this_over_other={k: v["this_ms"] / v["other_ms"] for k, v in results.items()})),
        flush=True)
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
