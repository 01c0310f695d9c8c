#!/usr/bin/env python3
"""This checkout's f32 attention kernel against another revision's, on one
NVIDIA card: gates, times, and the f32 forwards' device time by kernel group.

    python3 tools/attention_f32_ab.py --other PATH/TO/other/flash_attention_f32.cu

Builds both sources with the port's nvcc flags (ops/_build.py) and routes
``mha_attention``'s f32 inputs through each in turn. Holds each to
chip_smoke.py's phase 2c gates (within 1e-5 of the plain f32 version, an
error against f64 at most twice the plain version's plus 1e-6) at Dh=64
S = 1, 65, 129, 1025 and on the CAFormer's qkv views at S = 144 and 576;
times both in turns (other, this, this, other) at phase 2c's three shapes
beside both bounds (3 TF32 passes on the tensor cores, FFMA); then, with each
kernel (other, this), times one full-width f32 tagger forward (through
``predict_device``, with MCut's thresholds) and one f32 CAFormer-24 forward
at B=64 on CUDA events and profiles one of each under
torch.profiler: device ms by chip_smoke.py's kernel groups and the attention
kernel's share. Prints the card's name and power limit, both builds' ptxas
register and spill lines, ``ab {json}`` lines and an ``ab summary {json}``
line; exits 1 if either kernel misses a gate.
Imports the port and chip_smoke.py (torch, numpy), never JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another revision's csrc/flash_attention_f32.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from anime_illust_image_searcher_tpu_torch import config as config_mod
    from anime_illust_image_searcher_tpu_torch.models import caformer, ccip as ccip_mod
    from anime_illust_image_searcher_tpu_torch.models import tagger as tagger_mod
    from anime_illust_image_searcher_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    print(smi, flush=True)
    sm_ghz = cs.max_sm_ghz()
    kernels = {"other": fa._bind(fa._build.load_other(os.path.abspath(args.other),
                                                      fa.KERNEL_F32), "aiis_flash_attention_f32"),
               "this": fa._kernel(torch.float32)}
    for name in (fa.KERNEL_F32 + "_other", fa.KERNEL_F32):   # ptxas -v: registers, spills
        print(f"nvcc {name}:\n" + "\n".join(
            line for line in fa._build.build_logs.get(name, "").splitlines()
            if "Compiling entry" in line or "registers" in line or "spill" in line), flush=True)

    @contextlib.contextmanager
    def routed(name):
        """``mha_attention``'s f32 inputs through kernel ``name``."""
        saved = fa._kernel_fns[torch.float32]
        fa._kernel_fns[torch.float32] = kernels[name]
        try:
            yield
        finally:
            fa._kernel_fns[torch.float32] = saved

    gen = torch.Generator(device="cuda").manual_seed(0)
    gates_ok, results = True, {}
    cases = [(2, 16, s, 64) for s in (1, 65, 129, 1025)] + [(2, 16, 144, 32), (2, 10, 576, 32)]
    for b, h, s, dh in cases:
        if dh == 64:
            q, k, v = (torch.randn(b, h, s, dh, generator=gen, device="cuda") for _ in range(3))
        else:
            q, k, v = cs.qkv_views(torch, gen, b, h, s, pad=7, dtype=torch.float32)
        plain = fa.attention_reference(q, k, v)
        exact = cs.f64_attention(torch, q, k, v)
        plain_err = (plain.double() - exact).abs().max().item()
        res = dict(plain_vs_f64=plain_err)
        for name in kernels:
            with routed(name):
                got = fa.mha_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got - plain).abs().max().item()
            kern_err = (got.double() - exact).abs().max().item()
            ok = (torch.isfinite(got).all().item() and err <= cs.F32_KERNEL_TOL
                  and kern_err <= 2 * plain_err + 1e-6)
            gates_ok = gates_ok and ok
            res[name] = dict(vs_plain=err, vs_f64=kern_err, gates=ok)
        print(f"ab gates B={b} H={h} S={s} Dh={dh} " + json.dumps(res), flush=True)

    for label, (b, h, s, dh) in (("eva02", (32, 16, 1025, 64)), ("stage3", (64, 10, 576, 32)),
                                 ("stage4", (64, 16, 144, 32))):
        if dh == 64:
            q, k, v = (torch.randn(b, h, s, dh, generator=gen, device="cuda") for _ in range(3))
        else:
            q, k, v = cs.qkv_views(torch, gen, b, h, s, pad=7, dtype=torch.float32)
        iters = 10 if dh == 64 else 30
        turns = []
        for name in ("other", "this", "this", "other"):
            with routed(name):
                turns.append(cs.cuda_ms(lambda: fa.mha_attention(q, k, v), iters=iters))
        bound_ms, _, _ = cs.attention_bound(b, h, s, dh, 4, sm_ghz, cs.F32_PASSES)
        ffma_bound_ms, _, _ = cs.attention_bound(b, h, s, dh, 4, sm_ghz)
        other_ms, this_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        results[label] = dict(B=b, H=h, S=s, Dh=dh, other_ms=other_ms, this_ms=this_ms,
                              turns_ms=turns, bound_ms=bound_ms, ffma_bound_ms=ffma_bound_ms,
                              this_share_of_bound=bound_ms / this_ms,
                              other_share_of_ffma_bound=ffma_bound_ms / other_ms)
        print(f"ab {label} " + json.dumps(results[label]), flush=True)
        del q, k, v
    torch.cuda.empty_cache()

    def forwards(label, fwd, group):
        """fwd's ms on CUDA events and one profile of it, with each kernel."""
        out = {}
        for name in ("other", "this"):
            with routed(name):
                fwd()
                ms = cs.cuda_ms(fwd, iters=2, warmup=0)
                prof = cs.profile_groups(torch, fwd, group)
            attn, device = prof["groups"].get("attention kernel"), prof["device_ms"]
            out[name] = dict(forward_ms=ms, attention_ms=attn,
                             attention_share=attn / device if attn else "not measured",
                             profile=prof)
        results[label] = out
        print(f"ab {label} " + json.dumps(out), flush=True)

    cfg = config_mod.TaggerConfig(compute_dtype="float32", batch_size=64)
    pred = tagger_mod.TaggerPredictor(cfg, device="cuda")
    pred.load_model()
    x = torch.randint(0, 256, (64, 448, 448, 3), dtype=torch.uint8, generator=gen.manual_seed(2),
                      device="cuda")

    forwards("tagger f32 B=64 forward", lambda: pred.predict_device(x), cs._kernel_group)
    del pred, x
    torch.cuda.empty_cache()

    ccfg = config_mod.CCIPConfig()
    pred = ccip_mod.CCIPPredictor(ccfg, model_cfg=caformer.CAFormerConfig(dtype=torch.float32),
                                  device="cuda")
    pred.load_model()
    x = torch.randint(0, 256, (64, 384, 384, 3), dtype=torch.uint8, generator=gen.manual_seed(6),
                      device="cuda")
    forwards("caformer-24 f32 B=64 forward",
             lambda: caformer.extract_features(pred.model, x, *pred.replicated.consts),
             cs._ccip_group)
    del pred, x
    torch.cuda.empty_cache()

    print("ab summary " + json.dumps(dict(
        card=smi, gates_ok=gates_ok,
        this_over_other={k: (v["this_ms"] / v["other_ms"] if "this_ms" in v
                             else v["this"]["forward_ms"] / v["other"]["forward_ms"])
                         for k, v in results.items()})), flush=True)
    sys.exit(0 if gates_ok else 1)


if __name__ == "__main__":
    main()
