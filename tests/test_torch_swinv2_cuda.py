"""The SwinV2 tagger on the card, at its published widths (SwinV2-B at 448,
window 14) and B=2: the window shift kernels against the roll-and-partition
route bit for bit, the q/k/v preparation kernel against its plain route, the
attention through SDPA's memory-efficient or cuDNN
kernel (never the math route, and no copy of the bias), the tables built at
load and not in a forward, and one forward against the plain f32 reference.

Marked ``cuda``: they skip without an NVIDIA card. This file imports neither
JAX nor the JAX package:

    python -m pytest tests/test_torch_swinv2_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu_torch.models import swinv2, tagger
from anime_illust_image_searcher_tpu_torch.ops import window_attention, window_shift
from anime_illust_image_searcher_tpu_torch.utils import profiling
from portbench import harness, trace
from portbench import weights as bench_weights
from portbench.reference import swinv2 as ref
from portbench.reference.common import strict_f32

CFG = harness.load("configs", "wd-swinv2-tagger-v3.json")
LIMITS = harness.load("cells", "tag.swinv2b.b256.json")["limits"]
GROUPS = trace.KernelGroups(os.path.join(harness.BENCH_DIR, "kernel_groups"))
ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the window shift kernels and SDPA's kernels")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seeded():
    """The cell's seeded leaves at the published widths (on the card), the
    port loaded from them in bf16, and two images."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    params = bench_weights.draw(ref.leaves(CFG), 2 ** 31 + 5, dev)
    _, cats = ref.labels(CFG, 2 ** 31 + 5)
    ref.calibrate_head(params, CFG, cats)
    m = CFG["model"]
    cfg = swinv2.SwinV2Config(
        img_size=m["img_size"], patch_size=m["patch_size"], embed_dim=m["embed_dim"],
        depths=tuple(m["depths"]), num_heads=tuple(m["num_heads"]),
        window_size=m["window_size"], cpb_hidden=m["cpb_hidden"],
        num_classes=m["num_classes"], dtype=torch.bfloat16)
    model = swinv2.SwinV2(cfg, device=dev)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    gen = torch.Generator(device=dev).manual_seed(11)
    imgs = torch.randint(0, 256, (2, 448, 448, 3), generator=gen, device=dev, dtype=torch.uint8)
    return params, model.eval(), imgs


def roll_partition(x, w, shift):
    b, r, _, c = x.shape
    y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    return y.view(b, r // w, w, r // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, (r // w) ** 2, w * w, c)


@pytest.mark.cuda
@pytest.mark.parametrize("res,c,shift", [(112, 128, 0), (112, 128, 7), (56, 256, 7),
                                         (28, 512, 7), (28, 6, 7), (12, 3, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_shift_kernels_equal_roll_and_partition(cuda, res, c, shift, dtype):
    """Both kernels bit for bit against torch.roll + the permute copies, at
    the three stages' shapes (B=2) and at rows of 12 and 6 bytes (narrower
    vectors); the inverse also from a token-major strided input, as the
    attention hands it over."""
    w = 14 if res % 14 == 0 else 4
    x = torch.randn(2, res, res, c, device=cuda).to(dtype)
    window_shift.reset_launches()
    part = window_shift.window_partition(x, w, shift)
    assert torch.equal(part, roll_partition(x, w, shift))
    assert torch.equal(window_shift.window_reverse(part, res, w, shift), x)
    token_major = part.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(window_shift.window_reverse(token_major, res, w, shift), x)
    torch.cuda.synchronize()
    assert window_shift.launches == {"partition": 1, "reverse": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("n_win,heads", [(64, 4), (16, 8), (4, 16), (1, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unit_qkv_kernel_matches_plain(cuda, n_win, heads, dtype):
    """The kernel against ``unit_qkv_reference`` at the four stages' shapes
    (B=2, Dh=32): v bit for bit; the unit q (a logit scale of up to 100
    folded in) and k within one rounding of the output type: the norm is the
    same f32 sum of 32 squares in another order, so the f32 factor differs
    by a few f32 ulps, and the product can land on the other side of a
    rounding boundary: one bf16 ulp (at most 2^-7 of the value) in bf16, 8
    f32 ulps (2^-20) in f32. Token-major outputs, one launch."""
    g = torch.Generator(device=cuda).manual_seed(n_win)
    qkv = torch.randn(2, n_win, 196, 3 * heads * 32, device=cuda, generator=g).to(dtype)
    scale = torch.exp(torch.linspace(0.5, 4.6, heads, device=cuda))
    window_attention.reset_launches()
    got = window_attention.unit_qkv(qkv, scale, heads)
    want = window_attention.unit_qkv_reference(qkv, scale, heads)
    torch.cuda.synchronize()
    assert window_attention.unit_qkv.launches == 1
    assert got[0].transpose(1, 2).is_contiguous()
    assert torch.equal(got[2], want[2])
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        err = ((a.float() - b.float()).abs() - rel * b.float().abs()).max()
        assert err <= 1e-30, err


@pytest.mark.cuda
def test_forward_kernels_and_tables(cuda, seeded):
    """One profiled forward at B=2: 24 attention kernels of SDPA's memory-
    efficient or cuDNN backend (the attention group of kernel_groups/), no
    softmax or bmm of the math route, no norm reduction and no pad of the
    bias; 44 window shift kernels (2 a block of stages 1-3) and 24 q/k/v
    preparations; no ``swinv2.bias_tables`` span; 24 counted attention
    launches."""
    _, model, imgs = seeded
    mean = torch.full((3,), 0.5, device=cuda)
    with torch.inference_mode():
        tagger._predict_probs(model, imgs, mean, mean)          # first calls outside the trace
        torch.cuda.synchronize()
        window_attention.reset_launches()
        profiling.clear()
        with torch.profiler.profile(activities=ACTS) as prof:
            tagger._predict_probs(model, imgs, mean, mean)
            torch.cuda.synchronize()
    assert "swinv2.bias_tables" not in profiling.recorded()
    assert window_attention.window_attention.launches == {32: 24}
    card = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    attention = [n for n in card if GROUPS(n) == "attention"]
    window = [n for n in card if GROUPS(n) == "window"]
    print("attention kernels:", sorted(set(attention)))
    assert len(attention) == 24, sorted(set(card))
    assert sum("window_shift" in n for n in window) == 44, sorted(set(window))
    assert sum("window_qkv_unit" in n for n in window) == 24, sorted(set(window))
    low = [n.lower() for n in card]
    assert not [n for n in low if any(k in n for k in ("softmax", "bmm", "constant_pad",
                                                       "normtwo"))], sorted(set(card))


@pytest.mark.cuda
def test_forward_matches_reference(cuda, seeded):
    """The bf16 forward's logits against the f32 reference on the same
    weights and pixels: the RMS over classes of the gap lies under the cell's
    logit_rms limit, which the fp8 control exceeds."""
    params, model, imgs = seeded
    mean = torch.full((3,), 0.5, device=cuda)
    with torch.inference_mode():
        got = tagger._predict_probs(model, imgs, mean, mean).double()
    with strict_f32():
        want = ref.probs({k: v.float() for k, v in params.items()}, CFG, imgs, 1).double()

    def logit(p):
        p = p.clamp(1e-37, 1 - 1e-4)
        return torch.log(p) - torch.log1p(-p)

    gap = float(((logit(got) - logit(want)) ** 2).mean(dim=1).sqrt().max())
    print(f"logit_rms {gap:.4f} (limit {LIMITS['logit_rms']})")
    assert np.isfinite(gap) and gap < LIMITS["logit_rms"]
