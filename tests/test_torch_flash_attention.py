"""The port's attention (ops/flash_attention.py) against the JAX package's.

On the CPU the port's wrapper takes its plain version; it is held against the
JAX plain reference and the Pallas kernel (interpret mode) at the shapes of
tests/test_flash_attention.py. The CUDA kernel itself is held against the plain
version in tests/test_torch_kernels_cuda.py, which runs only on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu.ops import flash_attention as jfa
from anime_illust_image_searcher_tpu_torch.ops import flash_attention as tfa

SHAPES = [
    (1, 2, 128, 64),
    (2, 2, 256, 64),
    (1, 1, 100, 64),   # non-multiple seq -> padding path
    (2, 4, 257, 32),   # cls-token-style odd length
    (1, 2, 144, 32),   # CAFormer stage 4 (12² tokens, head dim 32)
    (1, 2, 576, 32),   # CAFormer stage 3 (24² tokens)
]


def qkv(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,s,dh", SHAPES)
def test_plain_matches_jax_reference_f32(b, h, s, dh, rng):
    q, k, v = qkv(rng, (b, h, s, dh))
    want = np.asarray(jfa.attention_reference(*map(jnp.asarray, (q, k, v))))
    got = tfa.attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,s,dh", SHAPES)
def test_wrapper_matches_pallas_interpret_f32(b, h, s, dh, rng):
    q, k, v = qkv(rng, (b, h, s, dh))
    want = np.asarray(jfa.mha_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    got = tfa.mha_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert tfa.mha_attention.launches == before  # CPU tensors launch no kernel
    assert tfa.mha_attention.launches_f32 == before_f32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_matches_jax(rng):
    """bf16 in, bf16 out, held as tests/test_flash_attention.py holds bf16."""
    q, k, v = qkv(rng, (1, 2, 128, 64))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jfa.mha_attention(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.mha_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s", [144, 576])
def test_bf16_dh32_matches_jax(rng, s):
    """The CAFormer's head dim in bf16, held as the Dh=64 case above."""
    q, k, v = qkv(rng, (1, 2, s, 32))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jfa.mha_attention(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.mha_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_head_dims_are_64_and_32():
    assert tfa.HEAD_DIMS == (64, 32)
    tfa.reset_launches()
    assert tfa.mha_attention.launches == {64: 0, 32: 0}
    assert tfa.mha_attention.launches_f32 == {64: 0, 32: 0}


def test_padding_keys_do_not_leak(rng):
    """Ragged S: the output for real tokens equals the JAX kernel's."""
    q, k, v = qkv(rng, (1, 1, 130, 64))
    want = np.asarray(jfa.mha_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.mha_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert got.shape == (1, 1, 130, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_never_launch(rng):
    tfa.reset_launches()
    for dh in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv(rng, (1, 2, 65, dh)))
            assert tfa.mha_attention(q, k, v).dtype == dtype
    assert tfa.mha_attention.launches == {64: 0, 32: 0}
    assert tfa.mha_attention.launches_f32 == {64: 0, 32: 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("devices", [("meta", "meta", "meta"), ("cpu", "meta", "cpu")])
def test_non_cpu_tensors_must_take_the_kernel(devices, dtype):
    """A tensor off the CPU takes the kernel of its dtype or raises: there is
    no fallback."""
    q, k, v = (torch.zeros(1, 2, 8, 64, dtype=dtype, device=d) for d in devices)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.mha_attention(q, k, v)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3,                             # no kernel takes f16
    (torch.bfloat16, torch.float32, torch.bfloat16),  # one kernel a call
    (torch.float32, torch.float32, torch.bfloat16),
])
def test_dtypes_without_a_kernel_raise(dtypes):
    """Off the CPU, q, k and v share bf16 or f32, or the call raises before
    any kernel is built."""
    q, k, v = (torch.zeros(1, 2, 8, 64, dtype=t, device="meta") for t in dtypes)
    with pytest.raises(TypeError, match="dtype|bfloat16 or float32"):
        tfa.mha_attention(q, k, v)


def test_each_dtype_has_its_own_source_and_entry():
    """bf16 and f32 bind C entries of the same argument list in two sources,
    each instantiated at every head dim of HEAD_DIMS."""
    import re

    from anime_illust_image_searcher_tpu_torch.ops import _build

    assert {d: k[0] for d, k in tfa._KERNELS.items()} == {
        torch.bfloat16: tfa.KERNEL, torch.float32: tfa.KERNEL_F32}
    signatures = []
    for name, entry, _ in tfa._KERNELS.values():
        with open(f"{_build.CSRC_DIR}/{name}.cu", encoding="utf-8") as f:
            src = f.read()
        m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)", src, re.S)
        assert m, entry
        signatures.append(re.sub(r"\s+", " ", m.group(1)))
        for dh in tfa.HEAD_DIMS:
            assert f"if (Dh == {dh}) return launch<{dh}>" in src
    assert signatures[0] == signatures[1]
