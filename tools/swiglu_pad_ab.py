#!/usr/bin/env python3
"""EVA02-L's SwiGLU GEMMs at padded hidden widths, in turns on one NVIDIA card.

    python3 tools/swiglu_pad_ab.py [--batch 256] [--rounds 6] [--dtype bfloat16]
                                   [--widths 2730,2736,2752,2816]

One block's three GEMMs at the tagger's shapes (M = batch x 1025 tokens,
D = 1024): ``w1`` and ``w2`` (D -> hidden) and ``w3`` (hidden -> D), each with
its bias, in ``--dtype`` through ``F.linear``, for each hidden width in turns,
round after round (the first width, then the rest, then back), each round
timed on CUDA events over ``--iters`` calls of the three. Then one call of the
three a width under torch.profiler: each kernel's name and device ms, and
whether a name is an sm80 ``mma.sync`` kernel (``cutlass_80`` or ``s16816``).
Then the whole MLP in turns: the port's ``SwiGLU`` module as a model of that
dtype builds it (``padded_hidden``), and the same weights by hand at the
published width 2730 and at 2730 rounded up to 8 (the route the module takes
when it pads). Operations are counted at 2730 whatever the width, so the
roofline share is of the work the model needs. TF32 stays off, as the port
sets it.

Prints the card's name and power limit, ``swiglu gemm {json}`` a width,
``swiglu module {json}`` and a ``swiglu summary {json}`` line, which names the
width with the least GEMM time. Imports the port (torch only), never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, TOKENS, HIDDEN = 1024, 1025, 2730
PEAK = {"bfloat16": 989e12, "float32": 67e12}     # H100 SXM: dense tensor bf16, f32 FMA
SM80 = ("cutlass_80", "s16816")


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else f"nvidia-smi failed: {r.stderr.strip()}"


def card_kernels(torch, fn):
    """(name, device ms) of every kernel one call of ``fn`` ran on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def timed_ms(torch, fn, iters: int) -> float:
    """Device ms a call of ``fn``, over ``iters`` calls on CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256, help="images a batch (M = batch x 1025)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5, help="calls of the three GEMMs a timing")
    ap.add_argument("--widths", default="2730,2736,2752,2816")
    ap.add_argument("--dtype", choices=sorted(PEAK), default="bfloat16")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, REPO)
    from anime_illust_image_searcher_tpu_torch.device import resolve_device
    from anime_illust_image_searcher_tpu_torch.models import eva02
    from anime_illust_image_searcher_tpu_torch.ops.quant import ALIGN, round_up

    print(smi_line(), flush=True)
    dev, dt = resolve_device("cuda"), getattr(torch, args.dtype)
    m = args.batch * TOKENS
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, D, device=dev, dtype=dt, generator=gen)
    flop = 3 * 2 * m * D * HIDDEN
    roof_ms = flop / PEAK[args.dtype] * 1e3

    widths = [int(w) for w in args.widths.split(",")]
    ops = {}
    for hp in widths:
        w12 = torch.randn(2, hp, D, device=dev, dtype=dt, generator=gen) * D ** -0.5
        b12 = torch.zeros(2, hp, device=dev, dtype=dt)
        w3 = torch.randn(D, hp, device=dev, dtype=dt, generator=gen) * hp ** -0.5
        b3 = torch.zeros(D, device=dev, dtype=dt)
        h = torch.randn(m, hp, device=dev, dtype=dt, generator=gen)

        def three(w12=w12, b12=b12, w3=w3, b3=b3, h=h):
            F.linear(x, w12[0], b12[0])
            F.linear(x, w12[1], b12[1])
            F.linear(h, w3, b3)
        three()
        ops[hp] = three
    torch.cuda.synchronize()

    times = {hp: [] for hp in widths}
    for r in range(args.rounds):
        order = widths if r % 2 == 0 else widths[::-1]
        for hp in order:
            times[hp].append(timed_ms(torch, ops[hp], args.iters))

    gemm = {}
    for hp in widths:
        kernels = card_kernels(torch, ops[hp])
        med = statistics.median(times[hp])
        gemm[hp] = med
        print("swiglu gemm " + json.dumps({
            "hidden": hp, "batch": args.batch, "ms_median": round(med, 4),
            "ms_rounds": [round(t, 4) for t in times[hp]],
            "roofline_pct": round(100 * roof_ms / med, 2),
            "sm80": any(s in n for n, _ in kernels for s in SM80),
            "kernels": [[n[:120], round(t, 4)] for n, t in kernels]}), flush=True)
        del ops[hp]
        torch.cuda.empty_cache()

    # the port's SwiGLU as a model of this dtype builds it, against the same
    # weights by hand at the published width and at the padded one
    cfg = eva02.Eva02Config(dtype=dt)
    mlp = eva02.SwiGLU(cfg, device=dev)
    with torch.no_grad():
        for lin in (mlp.w1, mlp.w2, mlp.w3):
            w = lin.published(lin.weight) if isinstance(lin, eva02.PaddedLinear) else lin.weight
            b = lin.published(lin.bias) if isinstance(lin, eva02.PaddedLinear) else lin.bias
            w.normal_(0.0, w.shape[1] ** -0.5, generator=gen)
            b.normal_(0.0, 0.02, generator=gen)
    sd = mlp.state_dict()
    xb = x.view(args.batch, TOKENS, D)

    def by_hand(hp):
        pad = hp - HIDDEN
        w1, w2 = (F.pad(sd[f"{k}.weight"], (0, 0, 0, pad)) for k in ("w1", "w2"))
        b1, b2 = (F.pad(sd[f"{k}.bias"], (0, pad)) for k in ("w1", "w2"))
        w3 = F.pad(sd["w3.weight"], (0, pad))

        def fn():
            h = F.silu(F.linear(xb, w1, b1)) * F.linear(xb, w2, b2)
            n = F.layer_norm(h[..., :HIDDEN].float(), (HIDDEN,), sd["norm.weight"],
                             sd["norm.bias"], cfg.layer_norm_eps)
            if not pad:
                return F.linear(n.to(dt), w3, sd["w3.bias"])
            y = torch.empty(n.shape[:-1] + (hp,), dtype=dt, device=dev)
            y[..., HIDDEN:].zero_()
            y[..., :HIDDEN] = n
            return F.linear(y, w3, sd["w3.bias"])
        return fn

    arms = {"port": lambda: mlp(xb), "unpadded": by_hand(HIDDEN),
            "padded": by_hand(round_up(HIDDEN, ALIGN))}
    with torch.inference_mode():
        outs = {name: fn().float() for name, fn in arms.items()}
        scale = outs["unpadded"].abs().max().item()
        gap = {name: (o - outs["unpadded"]).abs().max().item() for name, o in outs.items()}
        del outs
        mod = {name: [] for name in arms}
        for r in range(args.rounds):
            for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
                mod[name].append(timed_ms(torch, arms[name], args.iters))
        kern = {name: card_kernels(torch, fn) for name, fn in arms.items()}
    med = {k: statistics.median(v) for k, v in mod.items()}
    print("swiglu module " + json.dumps({
        "dtype": args.dtype, "hidden": HIDDEN, "port_hidden_padded": mlp.hidden_padded,
        "batch": args.batch, "max_abs_gap_to_unpadded": gap, "max_abs_out": scale,
        "ms_median": {k: round(v, 4) for k, v in med.items()},
        "ms_rounds": {k: [round(t, 4) for t in v] for k, v in mod.items()},
        "kernels": {k: [[n[:120], round(t, 4)] for n, t in v] for k, v in kern.items()}}),
        flush=True)
    best = min(gemm, key=gemm.get)
    print("swiglu summary " + json.dumps({
        "card": smi_line(), "dtype": args.dtype, "roofline_ms": round(roof_ms, 4),
        "gemm_ms": {hp: round(t, 4) for hp, t in gemm.items()}, "fastest": best,
        "module_ms": {k: round(v, 4) for k, v in med.items()}}), flush=True)


if __name__ == "__main__":
    main()
