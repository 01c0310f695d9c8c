"""EVA02-L's SwiGLU on the card: its GEMMs at the padded hidden width.

Marked ``cuda``: they skip without an NVIDIA card (which GEMM kernel cuBLAS
picks is a fact of the card). This file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_swiglu_cuda.py --noconftest -q
"""

import pytest
import torch

from anime_illust_image_searcher_tpu_torch.models import eva02
from anime_illust_image_searcher_tpu_torch.utils import profiling

SM80 = ("cutlass_80", "s16816")    # the sm80 mma.sync GEMMs an unaligned width falls back to


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: cuBLAS's choice of GEMM kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_swiglu_gemms_leave_the_sm80_fallback(cuda):
    """One EVA02-L SwiGLU forward at B=2 (2,050 tokens) at the real widths
    runs no sm80 GEMM, is one padded-forward span, and gives the unpadded
    forward's output within bf16 rounding."""
    cfg = eva02.Eva02Config()
    mlp = eva02.SwiGLU(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for lin in (mlp.w1, mlp.w2, mlp.w3):
            lin.published(lin.weight).normal_(0.0, lin.in_features ** -0.5, generator=gen)
            lin.published(lin.bias).normal_(0.0, 0.02, generator=gen)
    assert mlp.hidden_padded == eva02.padded_hidden(cfg) == 2736
    x = torch.randn(2, 1025, cfg.embed_dim, device=cuda, dtype=torch.bfloat16, generator=gen)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        mlp(x)                                  # cuBLAS's first call outside the trace
        torch.cuda.synchronize()
        profiling.clear()
        with torch.profiler.profile(activities=acts) as prof:
            got = mlp(x)
            torch.cuda.synchronize()
        assert {k: v["count"] for k, v in profiling.recorded().items()} \
            == {"swiglu.pad_2730_to_2736": 1}
        sd = mlp.state_dict()
        assert tuple(sd["w1.weight"].shape) == (2730, 1024)
        assert tuple(sd["w3.weight"].shape) == (1024, 2730)
        g = torch.nn.functional.linear(x, sd["w1.weight"].contiguous(), sd["w1.bias"])
        u = torch.nn.functional.linear(x, sd["w2.weight"].contiguous(), sd["w2.bias"])
        y = torch.nn.functional.layer_norm((torch.nn.functional.silu(g) * u).float(), (2730,),
                                           sd["norm.weight"], sd["norm.bias"], cfg.layer_norm_eps)
        want = torch.nn.functional.linear(y.bfloat16(), sd["w3.weight"].contiguous(), sd["w3.bias"])
    card = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    gemms = [n for n in card if any(s in n.lower() for s in ("gemm", "nvjet", "xmma", "cutlass"))]
    assert len(gemms) >= 3, card
    assert not [n for n in gemms if any(s in n for s in SM80)], gemms
    assert torch.isfinite(got).all()
    # one bf16 rounding of the output (2^-8 relative) plus the sums' order
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
