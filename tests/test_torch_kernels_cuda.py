"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA card (a CUDA kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import pytest
import torch

from anime_illust_image_searcher_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [
    (4, 16, 1025), (1, 16, 100), (2, 16, 257),
    # the tiling's edges: 64-key tiles, 128 query rows a block (64 a warpgroup)
    (2, 16, 1), (2, 16, 64), (2, 16, 65), (2, 16, 127), (2, 16, 128), (2, 16, 129),
    (8, 16, 1025),   # 1152 blocks of 256 threads: more than one wave on 132 SMs
])
def test_kernel_matches_plain_on_card(cuda, b, h, s):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, 64, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    before = tfa.mha_attention.launches
    got = tfa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.mha_attention.launches == before + 1
    plain = tfa.attention_reference(q, k, v).float()
    exact = tfa.attention_reference(q.float(), k.float(), v.float())
    assert (got.float() - plain).abs().max().item() <= 2e-2
    kern_err = (got.float() - exact).abs().max().item()
    plain_err = (plain - exact).abs().max().item()
    assert kern_err <= 2 * plain_err + 1e-3


@pytest.mark.cuda
def test_kernel_takes_head_split_views(cuda):
    """(B, S, H*Dh) projections split into heads without a copy."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 3, 1025, 16 * 64, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(3, 1025, 16, 64).transpose(1, 2) for t in x)
    got = tfa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (3, 16, 1025, 64)
    assert got.transpose(1, 2).is_contiguous()   # a (B, S, H, Dh) buffer
    plain = tfa.attention_reference(q, k, v).float()
    assert (got.float() - plain).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        tfa.mha_attention(q, q, q)                      # f32
    q32 = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tfa.mha_attention(q32, q32, q32)                # Dh=32 not built yet


@pytest.mark.cuda
def test_tiny_tagger_on_card_matches_cpu(cuda):
    """A small EVA02 (head dim 64) in bf16 through the kernel on the card gives
    the probabilities of the f32 plain model on the CPU, within bf16 rounding."""
    import dataclasses

    import numpy as np

    from anime_illust_image_searcher_tpu_torch.models import eva02, tagger

    cfg = dataclasses.replace(eva02.tiny_test_config(), embed_dim=128, mlp_hidden_dim=340)
    cpu = eva02.Eva02(cfg, device="cpu")
    eva02.init_params(cpu, seed=0)
    card = eva02.Eva02(dataclasses.replace(cfg, dtype=torch.bfloat16), device=cuda)
    card.load_state_dict(cpu.state_dict())
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 56, 56, 3),
                                                             dtype=np.uint8))
    half = [0.5, 0.5, 0.5]
    before = tfa.mha_attention.launches
    with torch.inference_mode():
        want = tagger._predict_probs(cpu.eval(), imgs, torch.tensor(half), torch.tensor(half))
        got = tagger._predict_probs(card.eval(), imgs.to(cuda), torch.tensor(half, device=cuda),
                                    torch.tensor(half, device=cuda)).cpu()
    assert tfa.mha_attention.launches == before + cfg.depth
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-2
