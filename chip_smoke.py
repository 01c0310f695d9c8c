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
  3. parity  — a full-width, depth-2 EVA02 with one set of seeded weights: the
               card (bf16, kernel) against the CPU (f32, plain), probabilities
               within 2e-2;
  4. main    — TaggerPredictor on the card at full width (WD-EVA02-Large: 448²,
               24 blocks, 1024-d, 16 heads, 10861 classes), seeded weights,
               synthetic labels, B=256: a warm-up, 3 timed batches through the
               CLI's depth-1 pipeline, 2 forwards timed on the card; prints
               img/s and MFU;
  5. cli     — cli.tagging.Predictor.process_directory on 7 images at B=4 (the
               tail batch is padded): 7 tag lines.
  6. profile — one B=256 predict under torch.profiler: device time by kernel.

The kernel launch counts are set to 0 just before phase 4 and read just after
phase 5: each kernel of the path must have launched (24 attention launches per
forward). The last two lines are a ``kernels`` JSON object and the device line
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
GFLOP_PER_IMAGE = 723.5        # EVA02-L matmul FLOPs per 448² image (ARCHITECTURE.md §7a)
KERNEL_TOL = 2e-2              # max |kernel - plain bf16| on N(0,1) inputs
PARITY_TOL = 2e-2              # max |probs bf16 card - probs f32 CPU|


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


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


def phase_kernels(torch, fa, gen) -> dict:
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
    flops = 4 * b * h * s * s * dh
    nbytes = 4 * b * h * s * dh * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"kernel flash_attention B={b} H={h} S={s} Dh={dh}: kernel {ms:.4f} ms "
          f"(runs {kernel_runs[0]:.4f}, {kernel_runs[1]:.4f}), {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound_ms / ms:.1f}% of the bound; sdpa {library_ms:.4f} ms (runs "
          f"{sdpa_runs[0]:.4f}, {sdpa_runs[1]:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    return dict(name="flash_attention", route="cuda",
                source="anime_illust_image_searcher_tpu_torch/csrc/flash_attention.cu",
                replaces="anime_illust_image_searcher_tpu/ops/flash_attention.py:109",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=library_ms)


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


def phase_main(torch, tagger_mod, config_mod, eva02, fa) -> dict:
    """Full-width tagging at B=256: a warm-up, 3 batches through the depth-1
    pipeline of cli.tagging (queue batch N, then assemble batch N-1's lines),
    and 2 forwards timed on the card alone. 6 forwards in all."""
    cfg = config_mod.TaggerConfig()
    pred = tagger_mod.TaggerPredictor(cfg, device="cuda")
    pred.load_model()
    check(pred.model_cfg == eva02.Eva02Config(), f"not the full config: {pred.model_cfg}")
    b = cfg.batch_size
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 256, (b, 448, 448, 3), dtype=np.uint8) for _ in range(3)]
    args = (cfg.general_thresh, cfg.general_mcut_enabled,
            cfg.character_thresh, cfg.character_mcut_enabled)
    before = fa.mha_attention.launches
    warm = pred.predict(batches[0], *args)
    check(fa.mha_attention.launches - before == pred.model_cfg.depth,
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
    check(torch.isfinite(pending[0]).all().item(), "non-finite probabilities")
    h0 = time.perf_counter()
    outs.append(pred.finalize(pending, *args))
    host_s += time.perf_counter() - h0
    wall = time.perf_counter() - t0
    check(outs[0] == warm, "two identical batches gave different tag lines")
    check(all(len(o) == b for o in outs), "wrong number of tag lines")

    x = torch.from_numpy(batches[1]).to("cuda")

    def forward():
        with torch.inference_mode():
            tagger_mod._predict_probs(pred.model, x, pred._mean, pred._std)

    fwd_ms = cuda_ms(forward, iters=2, warmup=0)
    img_s = 3 * b / wall
    res = dict(batch=b, batches_timed=3, seconds=wall, img_s=img_s,
               mfu=img_s * GFLOP_PER_IMAGE * 1e9 / PEAK_BF16_FLOPS,
               finalize_s_per_batch=host_s / 3,
               tags_per_line=float(np.mean([len(l.split(",")) for o in outs for l in o])),
               forward_ms=fwd_ms,
               forward_img_s=b / fwd_ms * 1e3,
               forward_mfu=b / fwd_ms * 1e3 * GFLOP_PER_IMAGE * 1e9 / PEAK_BF16_FLOPS,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("tagging " + json.dumps(res), flush=True)
    del pred, x
    torch.cuda.empty_cache()
    return res


def phase_cli(torch, tagging, config_mod) -> int:
    rng = np.random.RandomState(3)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("imgs")
            try:
                from PIL import Image
            except ImportError:
                Image = None
            if Image is not None:
                print("cli: PNG images through Pillow", flush=True)
                for i in range(7):
                    shape = (300 + 20 * i, 200 + 30 * i, 3)      # padded to square, resized
                    Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(
                        f"imgs/img_{i}.png")
                cfg, decode_fn = config_mod.TaggerConfig(batch_size=4), None
            else:
                print("cli: no Pillow; .npy arrays through PrefetchLoader's decode_fn", flush=True)
                for i in range(7):
                    np.save(f"imgs/img_{i}.npy", rng.randint(0, 256, (448, 448, 3), dtype=np.uint8))
                cfg = config_mod.TaggerConfig(batch_size=4, extensions=(".npy",))
                decode_fn = np.load
            pred = tagging.Predictor(config=cfg, device="cuda")
            pred.process_directory("imgs", decode_fn=decode_fn)
            with open(cfg.output_file, encoding="utf-8") as f:
                lines = [line for line in f.read().splitlines() if line]
            check(len(lines) == 7, f"cli wrote {len(lines)} lines, expected 7")
            check(all(line.startswith("imgs/img_") for line in lines), "cli line paths")
            print(f"cli: 7 lines, first: {lines[0][:120]}", flush=True)
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
    from torch.profiler import ProfilerActivity, profile

    pred = tagger_mod.TaggerPredictor(config_mod.TaggerConfig(), device="cuda")
    pred.load_model()
    imgs = np.random.RandomState(4).randint(0, 256, (256, 448, 448, 3), dtype=np.uint8)
    pred.predict_probs(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_probs(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    groups: dict = {}
    for us, key, _ in rows:
        g = _kernel_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    out = dict(wall_ms=wall_ms,
               device_ms=total / 1e3 if total else "not measured",
               busy_share=total / 1e3 / wall_ms if total else "not measured",
               groups=groups,
               top=[dict(name=k[:80], ms=us / 1e3, count=n) for us, k, n in rows[:10]])
    print("profile " + json.dumps(out), flush=True)
    del pred
    torch.cuda.empty_cache()


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
    _build.build([fa.KERNEL])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    # 2. each kernel against its plain version
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_kernels(torch, fa, gen)]

    # 3. the model on the card against the model on the CPU
    phase_parity(torch, eva02, tagger_mod)

    # 4 + 5. the main path, with the launch counts read around it
    fa.mha_attention.launches = 0
    main_res = phase_main(torch, tagger_mod, config_mod, eva02, fa)
    cli_forwards = phase_cli(torch, tagging, config_mod)
    launches = fa.mha_attention.launches
    forwards = 6 + cli_forwards
    check(launches == 24 * forwards,
          f"flash_attention launched {launches} times, expected 24 x {forwards} forwards")
    kernels[0]["launches"] = launches

    # 6. where the time of one forward goes
    phase_profile(torch, tagger_mod, config_mod)

    print(f"summary: {main_res['img_s']:.2f} img/s end to end at B={main_res['batch']} "
          f"(MFU {100 * main_res['mfu']:.2f}%), forward alone {main_res['forward_img_s']:.2f} "
          f"img/s (MFU {100 * main_res['forward_mfu']:.2f}% of 989 TFLOP/s bf16), on {smi}",
          flush=True)
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
