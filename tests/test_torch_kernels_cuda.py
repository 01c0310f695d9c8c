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
    from anime_illust_image_searcher_tpu_torch.device import resolve_device

    return resolve_device("cuda")   # also pins f32 matmuls and convs to full f32


def f64_attention(q, k, v):
    """Attention in f64: the yardstick of the f32 kernel and its plain version."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v)


def assert_f32_kernel_matches(q, k, v, dh):
    """One f32 launch against the plain f32 version (1e-5 on N(0,1) inputs)
    and against f64: the kernel's error at most twice the plain version's
    plus 1e-6. Returns the kernel's output."""
    bf16_before, before = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    got = tfa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert tfa.mha_attention.launches == bf16_before
    assert tfa.mha_attention.launches_f32 == {**before, dh: before[dh] + 1}
    plain = tfa.attention_reference(q, k, v)
    exact = f64_attention(q, k, v)
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= 1e-5
    kern_err = (got.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    assert kern_err <= 2 * plain_err + 1e-6, (kern_err, plain_err)
    return got


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
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    got = tfa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.mha_attention.launches == {64: before[64] + 1, 32: before[32]}
    assert tfa.mha_attention.launches_f32 == before_f32
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
    half = torch.zeros(1, 2, 8, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        tfa.mha_attention(half, half, half)             # f16 has no kernel
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        tfa.mha_attention(q, q.to(torch.bfloat16), q)   # mixed dtypes
    for dtype in (torch.bfloat16, torch.float32):
        q16 = torch.zeros(1, 2, 8, 16, dtype=dtype, device=cuda)
        with pytest.raises(ValueError):
            tfa.mha_attention(q16, q16, q16)            # Dh=16 is not built
    x = torch.zeros(1, 8, 2 * 32 + 4, dtype=torch.bfloat16, device=cuda)
    q32 = x[..., 4:].view(1, 8, 2, 32).transpose(1, 2)  # 8-byte base, 136-byte rows
    with pytest.raises(ValueError):
        tfa.mha_attention(q32, q32, q32)
    x = torch.zeros(1, 8, 2 * 32 + 4, device=cuda)
    f32 = x[..., 2:66].view(1, 8, 2, 32).transpose(1, 2)  # f32: only the base is off
    assert f32.data_ptr() % 16 == 8 and all(st % 4 == 0 for st in f32.stride()[:3])
    with pytest.raises(ValueError):
        tfa.mha_attention(f32, f32, f32)
    x = torch.zeros(1, 8, 2 * 32 + 2, device=cuda)
    rows = x[..., :64].view(1, 8, 2, 32).transpose(1, 2)  # 264-byte rows: stride 66
    with pytest.raises(ValueError):
        tfa.mha_attention(rows, rows, rows)


# ------------------------------------------------------------- f32 (Dh 64, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2, s) for s in (1, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                                                   1025)]
                         + [(8, 1025)])   # 1152 blocks at one an SM: more than one wave
def test_f32_kernel_matches_plain_on_card(cuda, b, s):
    """Dh=64 at the tiling's edges (128 query rows a block, 64 a warpgroup,
    64-key tiles)."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, 16, s, 64, generator=g, device=cuda) for _ in range(3))
    assert_f32_kernel_matches(q, k, v, 64)


@pytest.mark.cuda
def test_f32_kernel_takes_head_split_views(cuda):
    """The EVA02 layout: heads split off (B, S, H*Dh) f32 projections."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(3, 3, 1025, 16 * 64, generator=g, device=cuda)
    q, k, v = (t.view(3, 1025, 16, 64).transpose(1, 2) for t in x)
    got = assert_f32_kernel_matches(q, k, v, 64)
    assert got.transpose(1, 2).is_contiguous()   # a (B, S, H, Dh) buffer


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [
    (2, 2, 1), (2, 2, 63), (2, 2, 64), (2, 2, 65), (2, 2, 127), (2, 2, 128), (2, 2, 129),
    (2, 2, 255), (2, 2, 256), (2, 2, 257),      # 128 query rows a block
    (2, 16, 144), (2, 10, 576),                 # CAFormer-24 stages 4 and 3 at 384²
    (64, 16, 144),                              # stage 4 at B=64: 2048 blocks, several waves
])
def test_f32_dh32_kernel_on_qkv_views_matches_plain(cuda, b, h, s):
    """Dh=32 on the head-split views of a (B, N, 3C) f32 qkv projection, with
    garbage in the rows past S and between the heads' views."""
    c = 32 * h
    g = torch.Generator(device=cuda).manual_seed(s)
    buf = torch.randn(b, s + 7, 3 * c, generator=g, device=cuda)
    q, k, v = buf[:, :s].view(b, s, 3, h, 32).permute(2, 0, 3, 1, 4).unbind(0)
    assert q.stride() == (buf.stride(0), 32, 3 * c, 1) and k.data_ptr() - q.data_ptr() == 4 * c
    assert_f32_kernel_matches(q, k, v, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 1])    # head dim 32 and 64
def test_tiny_f32_tagger_on_card_matches_cpu(cuda, heads):
    """A small f32 EVA02 through the f32 kernel on the card gives the CPU's
    logits within 5e-5 x max(1, |logit|), the off-CPU f32 bound of
    tests/test_eva02_oracle.py."""
    import dataclasses

    import numpy as np

    from anime_illust_image_searcher_tpu_torch.models import eva02

    cfg = dataclasses.replace(eva02.tiny_test_config(), num_heads=heads)
    assert cfg.dtype == torch.float32
    cpu = eva02.Eva02(cfg, device="cpu")
    eva02.init_params(cpu, seed=0)
    card = eva02.Eva02(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 56, 56, 3).astype(np.float32))
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    want = eva02.forward_logits(cpu.eval(), x)
    got = eva02.forward_logits(card.eval(), x.to(cuda)).cpu()
    assert tfa.mha_attention.launches == before
    dh = cfg.embed_dim // cfg.num_heads
    assert tfa.mha_attention.launches_f32 == {**before_f32, dh: before_f32[dh] + cfg.depth}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).abs() <= 5e-5 * want.abs().clamp_min(1)).all(), \
        (got - want).abs().max().item()


@pytest.mark.cuda
def test_tiny_f32_caformer_on_card_matches_cpu(cuda):
    """A small f32 CAFormer (attention at Dh=32) through the f32 kernel on the
    card gives the CPU's unit features within 5e-5."""
    import dataclasses

    import numpy as np

    from anime_illust_image_searcher_tpu_torch.models import caformer

    cfg = dataclasses.replace(caformer.tiny_test_config(), num_heads=(0, 0, 3, 4),
                              dims=(16, 32, 96, 128), feature_dim=64)
    assert cfg.dtype == torch.float32
    cpu = caformer.CAFormer(cfg, device="cpu")
    caformer.init_params(cpu, seed=0)
    card = caformer.CAFormer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    imgs = np.random.RandomState(0).randint(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    want = caformer.extract_features(cpu, torch.from_numpy(imgs), mean, std)
    got = caformer.extract_features(card, torch.from_numpy(imgs).to(cuda), mean, std).cpu()
    assert tfa.mha_attention.launches == before
    assert tfa.mha_attention.launches_f32 == {64: before_f32[64], 32: before_f32[32] + 2}
    unit = lambda f: f / f.norm(dim=-1, keepdim=True)  # noqa: E731
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (unit(got) - unit(want)).abs().max().item() <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [
    (2, 10, 576), (2, 16, 144),                 # CAFormer-24 stages 3 and 4 at 384²
    (2, 2, 1), (2, 2, 63), (2, 2, 64), (2, 2, 65), (2, 2, 127), (2, 2, 128), (2, 2, 129),
    (64, 16, 144),                              # 1024 blocks: more than one wave
])
def test_dh32_kernel_on_qkv_views_matches_plain(cuda, b, h, s):
    """Dh=32 (64-byte swizzle) on the head-split views of a (B, N, 3C) qkv
    projection, as the CAFormer's attention mixer hands them over, with
    garbage (not zeros) in the rows past S and between the heads' views."""
    c = 32 * h
    g = torch.Generator(device=cuda).manual_seed(s)
    buf = torch.randn(b, s + 7, 3 * c, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = buf[:, :s].view(b, s, 3, h, 32).permute(2, 0, 3, 1, 4).unbind(0)
    assert q.stride() == (buf.stride(0), 32, 3 * c, 1) and k.data_ptr() - q.data_ptr() == 2 * c
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    got = tfa.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.mha_attention.launches == {64: before[64], 32: before[32] + 1}
    assert tfa.mha_attention.launches_f32 == before_f32
    plain = tfa.attention_reference(q, k, v).float()
    exact = tfa.attention_reference(q.float(), k.float(), v.float())
    assert torch.isfinite(got.float()).all()
    assert (got.float() - plain).abs().max().item() <= 2e-2
    kern_err = (got.float() - exact).abs().max().item()
    plain_err = (plain - exact).abs().max().item()
    assert kern_err <= 2 * plain_err + 1e-3


@pytest.mark.cuda
def test_tiny_caformer_on_card_matches_cpu(cuda):
    """A small CAFormer (attention at Dh=32) in bf16 through the kernel on the
    card gives the unit features of the f32 plain model on the CPU."""
    import dataclasses

    import numpy as np

    from anime_illust_image_searcher_tpu_torch.models import caformer

    cfg = dataclasses.replace(caformer.tiny_test_config(), num_heads=(0, 0, 3, 4),
                              dims=(16, 32, 96, 128), feature_dim=64)
    cpu = caformer.CAFormer(cfg, device="cpu")
    caformer.init_params(cpu, seed=0)
    card = caformer.CAFormer(dataclasses.replace(cfg, dtype=torch.bfloat16), device=cuda)
    card.load_state_dict(cpu.state_dict())
    imgs = np.random.RandomState(0).randint(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    want = caformer.extract_features(cpu, torch.from_numpy(imgs), mean, std)
    got = caformer.extract_features(card, torch.from_numpy(imgs).to(cuda), mean, std).cpu()
    assert tfa.mha_attention.launches == {64: before[64], 32: before[32] + 2}
    assert tfa.mha_attention.launches_f32 == before_f32
    unit = lambda f: f / f.norm(dim=-1, keepdim=True)  # noqa: E731
    assert torch.isfinite(got).all()
    # an element of a unit F-d vector is about F^-1/2 (0.125 here): allow 15%
    # of it, and each cosine 0.999 (an H100 reads 1.05e-2 and 0.99955)
    err = (unit(got) - unit(want)).abs().max().item()
    cos = (unit(got) * unit(want)).sum(-1).min().item()
    assert err <= 0.15 * cfg.feature_dim ** -0.5 and cos >= 0.999, (err, cos)


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
    before, before_f32 = dict(tfa.mha_attention.launches), dict(tfa.mha_attention.launches_f32)
    with torch.inference_mode():
        want = tagger._predict_probs(cpu.eval(), imgs, torch.tensor(half), torch.tensor(half))
        got = tagger._predict_probs(card.eval(), imgs.to(cuda), torch.tensor(half, device=cuda),
                                    torch.tensor(half, device=cuda)).cpu()
    assert tfa.mha_attention.launches == {64: before[64] + cfg.depth, 32: before[32]}
    assert tfa.mha_attention.launches_f32 == before_f32
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-2


def _query_inputs(d, f, w, q, b, seed, device, ids="mixed"):
    """A random index (unit rows, sentinel-padded term rows, duplicate rows)
    and b packed queries of q slots with required, excluded, weighted and
    unused slots, as ops/fused_query.pack_query writes them. ``ids`` "same"
    gives the b queries one id list (each its own vector), "disjoint" gives
    them lists with no id in common."""
    import numpy as np

    from anime_illust_image_searcher_tpu_torch.ops.fused_query import pack_query

    rng = np.random.RandomState(seed)
    vocab = 500
    matrix = rng.standard_normal((d, f)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    lens = rng.randint(0, w + 1, d)
    term = np.full((d, w), vocab, np.int32)
    contrib = np.zeros((d, w), np.float32)
    for i in range(d):
        term[i, :lens[i]] = rng.choice(vocab, lens[i], replace=False)
        contrib[i, :lens[i]] = rng.rand(lens[i]) * 3
    for i in range(0, d - 1, 7):           # duplicate rows
        matrix[i + 1], term[i + 1], contrib[i + 1] = matrix[i], term[i], contrib[i]

    def draw(pool):
        return {int(t): [1, 2, 1001, -1][int(rng.randint(4))] for t in pool}

    if ids == "same":
        lists = [draw(rng.choice(vocab + 10, q, replace=False))] * b
    elif ids == "disjoint":
        per, pool = min(q, (vocab + 10) // b), rng.permutation(vocab + 10)
        lists = [draw(pool[i * per:(i + 1) * per]) for i in range(b)]
    packed = []
    for i in range(b):
        weights = (draw(rng.choice(vocab + 10, min(q, int(rng.randint(1, q + 1))), replace=False))
                   if ids == "mixed" else lists[i])
        vec = rng.standard_normal(f).astype(np.float32)
        packed.append(pack_query(vec / np.linalg.norm(vec), weights, vocab, 1000, q))
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(matrix), t(term), t(contrib), t(np.stack(packed))


def _assert_query_scores_match_plain(args, dup_rows):
    """One launch against the plain version (1e-5 relative, exact hit counts),
    duplicate rows (each i of ``dup_rows`` with i + 1) bit-equal, and each
    query of a batch the same bits alone."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    before = qs.query_scores.launches
    got = qs.query_scores(*args)
    torch.cuda.synchronize()
    assert qs.query_scores.launches == before + 1
    want = qs.query_scores_reference(*args)
    for g, p in zip(got[:2], want[:2]):
        assert torch.allclose(g, p, rtol=1e-5, atol=1e-6)
    for g, p in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32 and torch.equal(g, p)
    for i in dup_rows:                     # duplicate rows tie bit for bit
        for t in got:
            assert torch.equal(t[:, i], t[:, i + 1])
    m, t, c, p = args
    for b in range(p.shape[0] if p.shape[0] > 1 else 0):
        one = qs.query_scores(m, t, c, p[b:b + 1].contiguous())
        assert all(torch.equal(o[0], g[b]) for o, g in zip(one, got)), b


def _ring_plan(f, w, q, b):
    """The kernel's report of its launch for a shape: R rows a ring stage,
    stages, shared memory a block, blocks an SM, grid; None if it does not fit."""
    import ctypes

    from anime_illust_image_searcher_tpu_torch.ops import _build
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    fn = _build.load(qs.KERNEL).aiis_query_scores_plan
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    if fn(256, 256, 256, 1000, f, w, q, b, out):   # 16-byte aligned bases
        return None
    return dict(zip(("rows", "stages", "smem_bytes", "blocks_per_sm", "grid"), out))


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,w,q,b", [
    (1, 300, 32, 8, 1), (31, 7, 8, 64, 3), (33, 300, 40, 256, 8),
    (1000, 300, 32, 8, 8), (1000, 7, 40, 64, 1), (100_003, 300, 32, 256, 3),
])
def test_query_scores_kernel_matches_plain_on_card(cuda, d, f, w, q, b):
    args = _query_inputs(d, f, w, q, b, seed=d + q, device=cuda)
    _assert_query_scores_match_plain(args, range(0, d - 1, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("f,w,q,b,tail", [
    (300, 32, 8, 1, 1), (300, 32, 8, 1, -1), (7, 8, 64, 3, 1), (7, 8, 64, 3, -1),
    (300, 40, 256, 8, 1), (300, 40, 256, 8, -1), (768, 8, 8, 1, -1),
])
def test_query_scores_ragged_last_tile(cuda, f, w, q, b, tail):
    """D = 3R + 1 and 3R - 1 at the shape's R rows a stage: the last tile
    holds 1 or R - 1 rows, which the consumers load themselves."""
    rows = _ring_plan(f, w, q, b)["rows"]
    assert rows % 4 == 0
    d = 3 * rows + tail
    args = _query_inputs(d, f, w, q, b, seed=d, device=cuda)
    _assert_query_scores_match_plain(args, range(0, d - 1, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 3])
def test_query_scores_base_not_16_byte_aligned(cuda, w):
    """Rows 1.. of an F=7 matrix start 28 bytes in (and, at W=3, its term
    rows 12 bytes in): no bulk copy can take them."""
    m, t, c, p = _query_inputs(1001, 7, w, 64, 3, seed=w, device=cuda)
    m, t, c = m[1:], t[1:], c[1:]
    assert m.data_ptr() % 16 != 0
    _assert_query_scores_match_plain((m, t, c, p), range(6, 999, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("ids,q", [("same", 8), ("same", 256), ("disjoint", 8),
                                   ("disjoint", 256)])
def test_query_scores_eight_queries_one_or_disjoint_id_lists(cuda, ids, q):
    """The id union at its smallest (8 copies of one list: every entry held
    by all 8 queries) and its largest (no id in common)."""
    args = _query_inputs(20_000, 300, 32, q, 8, seed=q, device=cuda, ids=ids)
    _assert_query_scores_match_plain(args, range(0, 19_999, 7))


@pytest.mark.cuda
def test_query_scores_q256_b8_at_the_largest_shared_memory(cuda):
    """The widest F (a multiple of 4) whose ring still fits beside the query
    data of 8 queries of 256 slots."""
    f = next(f for f in range(8192, 0, -4) if _ring_plan(f, 32, 256, 8))
    assert _ring_plan(f, 32, 256, 8)["smem_bytes"] > 200 * 1024
    args = _query_inputs(3001, f, 32, 256, 8, seed=f, device=cuda)
    _assert_query_scores_match_plain(args, range(0, 3000, 7))


@pytest.mark.cuda
def test_query_scores_shared_memory_past_48k_in_any_order(cuda):
    """Wide query vectors take more than 48 KB of shared memory a block. The
    kernel keeps its grid per shape and its shared-memory allowance only
    grows, so a smaller wide shape after a larger one still launches."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    for f in (1500, 2400, 1500, 2000):     # 80.8, 109.6, 80.8, 96.8 KB at B=8, Q=256
        args = _query_inputs(500, f, 16, 256, 8, seed=f, device=cuda)
        got = qs.query_scores(*args)
        want = qs.query_scores_reference(*args)
        for g, p in zip(got[:2], want[:2]):
            assert torch.allclose(g, p, rtol=1e-5, atol=1e-6), f
        for g, p in zip(got[2:], want[2:]):
            assert torch.equal(g, p), f


@pytest.mark.cuda
def test_query_scores_kernel_refuses_what_it_does_not_take(cuda):
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    m, t, c, p = _query_inputs(10, 8, 8, 8, 1, seed=0, device=cuda)
    with pytest.raises(ValueError):
        qs.query_scores(m, t, c, p.repeat(9, 1))               # B = 9
    with pytest.raises(TypeError):
        qs.query_scores(m, t.float(), c, p)
    with pytest.raises(ValueError):
        qs.query_scores(m.cpu(), t, c, p)


@pytest.mark.cuda
def test_fused_query_with_overflow_is_deterministic_on_card(cuda):
    """Docs past the dense width spill to the COO overflow; the same query run
    twice gives the same bits, and the card agrees with the CPU."""
    import numpy as np

    from anime_illust_image_searcher_tpu_torch.index.bm25_index import (
        BM25DeviceIndex, BM25Stats)
    from anime_illust_image_searcher_tpu_torch.ops import fused_query as fq

    rng = np.random.RandomState(1)
    corpus = [{int(t): 1 for t in rng.choice(300, rng.randint(3, 9), replace=False)}
              for _ in range(3000)]
    for i in (0, 1500):                    # 2 long docs: the dense width stays 32
        corpus[i] = {int(t): 2 for t in rng.choice(300, 60, replace=False)}
    lengths = np.array([sum(c.values()) for c in corpus])
    idf = {t: 1.0 + t / 300 for t in range(300)}
    idx = BM25DeviceIndex.from_stats(
        BM25Stats(corpus, idf, float(lengths.mean()), 3000, lengths), vocab_size=300)
    assert len(idx.ov_doc) > 0
    matrix = rng.standard_normal((3000, 24)).astype(np.float32)
    norms = np.linalg.norm(matrix, axis=1).astype(np.float32)
    matrix /= norms[:, None]
    spilled = [int(t) for t in idx.ov_term[:8]]
    vec = rng.standard_normal(24).astype(np.float32)
    packed = np.stack([fq.pack_query(vec / np.linalg.norm(vec),
                                     {spilled[0]: 1, spilled[1]: 1001, spilled[2]: 2},
                                     300, 1000, 8)])

    def run(device):
        tm, cm = idx.to_device_dense(device)
        docs = fq.Shards.single(torch.from_numpy(matrix).to(device),
                                torch.from_numpy(norms).to(device), tm, cm,
                                idx.overflow_device(device))
        return fq.fused_normal_query(docs, torch.from_numpy(packed).to(device),
                                     0.5, 0.5, 0.7, 0.3, topn=800, k=10).cpu().numpy()

    first, second = run(cuda), run(cuda)
    assert first.tobytes() == second.tobytes()
    cpu = run("cpu")
    np.testing.assert_array_equal(fq.decode_ids(first[0, 10:20]), fq.decode_ids(cpu[0, 10:20]))
    np.testing.assert_allclose(first[0, :10], cpu[0, :10], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(1, 300), (33, 7), (100_003, 300),
                                 (33, 768), (100_003, 768)])   # F=768: the CCIP rerank
def test_matvecs_kernel_matches_plain_for_any_batch(cuda, d, f):
    """The rerank product: the kernel with no term slots, at the Doc2Vec
    width and the CCIP feature width. Each query's scores
    are the same bits alone and in a batch of 8."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    g = torch.Generator(device=cuda).manual_seed(d)
    matrix = torch.nn.functional.normalize(torch.randn(d, f, generator=g, device=cuda), dim=1)
    vecs = torch.randn(8, f, generator=g, device=cuda)
    before, scoring = qs.matvecs.launches, qs.query_scores.launches
    batch = qs.matvecs(matrix, vecs)
    torch.cuda.synchronize()
    assert qs.matvecs.launches == before + 1 and qs.query_scores.launches == scoring
    assert torch.allclose(batch, qs.plain_matvecs(matrix, vecs), rtol=1e-5, atol=1e-6)
    for b in range(8):
        assert torch.equal(qs.matvecs(matrix, vecs[b:b + 1])[0], batch[b])


def _old_route(qs, matrix, vecs):
    """The sims of the scoring kernel with no term slots: the route the
    matvecs kernel replaced, whose bits it keeps."""
    d, b = matrix.shape[0], vecs.shape[0]
    packed = torch.cat([vecs, vecs.new_zeros((b, 1))], dim=1)
    empty = matrix.new_empty((d, 0))
    return qs.query_scores(matrix, empty.to(torch.int32), empty, packed)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 33, 100_003])
@pytest.mark.parametrize("f", [1, 7, 300, 768, 1024, 2048])
def test_matvecs_kernel_gives_the_old_routes_bits(cuda, d, f):
    """For every B in 1..8 the matvecs kernel equals the scoring kernel with
    no term slots bit for bit, one launch of its own a call (float4 rows
    where F % 4 == 0, scalar rows else; ragged last groups at any D; past 48
    KB of query vectors in shared memory at F=2048, B > 6)."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    g = torch.Generator(device=cuda).manual_seed(f * 7 + d)
    matrix = torch.nn.functional.normalize(torch.randn(d, f, generator=g, device=cuda), dim=1)
    vecs = torch.randn(8, f, generator=g, device=cuda)
    for b in range(1, 9):
        want = _old_route(qs, matrix, vecs[:b])
        before = dict(qs.matvecs.launches_by_form)
        got = qs.matvecs(matrix, vecs[:b])
        torch.cuda.synchronize()
        assert qs.matvecs.launches_by_form == {**before, f"B={b}": before.get(f"B={b}", 0) + 1}
        assert got.shape == (b, d) and torch.equal(got, want), (b, d, f)


@pytest.mark.cuda
@pytest.mark.parametrize("f,offset", [(7, 7), (300, 1), (768, 1), (768, 2)])
def test_matvecs_kernel_at_an_unaligned_base(cuda, f, offset):
    """A matrix whose base is not 16-byte aligned (rows 1.. of an F=7
    matrix, or an F % 4 == 0 matrix ``offset`` floats into its buffer) takes
    the scalar rows and still gives the old route's bits."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    d = 20_011
    g = torch.Generator(device=cuda).manual_seed(f + offset)
    buf = torch.empty(d * f + offset, device=cuda)
    matrix = buf[offset:].view(d, f)
    assert matrix.data_ptr() % 16 != 0
    matrix.copy_(torch.nn.functional.normalize(torch.randn(d, f, generator=g, device=cuda),
                                               dim=1))
    vecs = torch.randn(8, f, generator=g, device=cuda)
    for b in (1, 2, 3, 8):
        got = qs.matvecs(matrix, vecs[:b])
        assert torch.equal(got, _old_route(qs, matrix, vecs[:b])), b
        assert torch.allclose(got, qs.plain_matvecs(matrix, vecs[:b]), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 8])
def test_matvecs_kernel_duplicate_rows_tie(cuda, b):
    """Duplicate rows score identical bits wherever they sit in the kernel's
    row groups (the elbow cut relies on it)."""
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    d, f = 50_021, 300
    g = torch.Generator(device=cuda).manual_seed(b)
    matrix = torch.randn(d, f, generator=g, device=cuda)
    dup = torch.arange(0, d - 1, 7, device=cuda)
    matrix[dup + 1] = matrix[dup]
    matrix[-1] = matrix[0]                 # the first group's and the last, ragged one's
    out = qs.matvecs(matrix, torch.randn(b, f, generator=g, device=cuda))
    assert torch.equal(out[:, dup], out[:, dup + 1]) and torch.equal(out[:, 0], out[:, -1])


@pytest.mark.cuda
def test_matvecs_refuses_nine_vectors(cuda):
    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    before = qs.matvecs.launches
    with pytest.raises(ValueError, match="1..8"):
        qs.matvecs(torch.zeros(64, 300, device=cuda), torch.zeros(9, 300, device=cuda))
    assert qs.matvecs.launches == before


@pytest.mark.cuda
def test_fused_query_alone_equals_batched_on_card(cuda):
    """A query's output row is the same bits alone and in a batch of 5."""
    from anime_illust_image_searcher_tpu_torch.ops import fused_query as fq

    m, t, c, p = _query_inputs(20_000, 300, 32, 64, 5, seed=3, device=cuda)
    norms = torch.rand(m.shape[0], device=cuda) + 0.5
    args = (0.5, 0.5, 0.7, 0.3)
    docs = fq.Shards.single(m, norms, t, c)
    batch = fq.fused_normal_query(docs, p, *args, topn=800, k=10)
    for b in range(5):
        one = fq.fused_normal_query(docs, p[b:b + 1], *args, topn=800, k=10)
        assert torch.equal(one[0].view(torch.int32), batch[b].view(torch.int32)), b


@pytest.mark.cuda
def test_launch_count_is_exact_under_threads(cuda):
    """The web server calls the kernel from many threads: every launch is
    counted, and no thread sees another's outputs."""
    import sys
    import threading

    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs

    args = _query_inputs(2000, 300, 32, 8, 1, seed=5, device=cuda)
    want = qs.query_scores(*args)
    before, errors = qs.query_scores.launches, []

    def work():
        for _ in range(20):
            got = qs.query_scores(*args)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                errors.append("outputs differ")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert qs.query_scores.launches == before + 16 * 20


@pytest.mark.cuda
def test_query_scores_past_2_31_matrix_elements(cuda):
    """D=7.5M rows of 300 floats: 2.25e9 elements, past 32-bit offsets. Rows
    at both ends and in the middle agree with the plain version."""
    import numpy as np

    from anime_illust_image_searcher_tpu_torch.ops import query_scores as qs
    from anime_illust_image_searcher_tpu_torch.ops.fused_query import pack_query

    d, f, vocab = 7_500_000, 300, 1000
    g = torch.Generator(device=cuda).manual_seed(11)
    matrix = torch.randn(d, f, device=cuda, generator=g)
    term = torch.randint(0, vocab, (d, 8), device=cuda, generator=g, dtype=torch.int32)
    contrib = torch.rand(d, 8, device=cuda, generator=g)
    rng = np.random.RandomState(11)
    packed = torch.from_numpy(np.stack([
        pack_query(rng.standard_normal(f).astype(np.float32),
                   {int(t): w for t, w in zip(rng.choice(vocab, 3, replace=False), (1, 1001, -1))},
                   vocab, 1000, 8) for _ in range(2)])).to(cuda)
    rows = torch.tensor([0, 1, d // 2, d - 2, d - 1], device=cuda)
    for b in (1, 2):
        got = qs.query_scores(matrix, term, contrib, packed[:b].contiguous())
        want = qs.query_scores_reference(matrix[rows], term[rows], contrib[rows],
                                         packed[:b].contiguous())
        for g_, w_ in zip(got, want):
            assert torch.allclose(g_[:, rows].float(), w_.float(), rtol=1e-5, atol=1e-5)
    vecs = packed[:2, 32:32 + f].contiguous()
    sims = qs.matvecs(matrix, vecs)
    assert torch.allclose(sims[:, rows], qs.plain_matvecs(matrix[rows], vecs),
                          rtol=1e-5, atol=1e-5)
    assert torch.equal(sims, _old_route(qs, matrix, vecs))


# ------------------------------------------------------------- int8 (K11)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2050, 1024, 1024), (2050, 1024, 2730), (2050, 2730, 1024),
                                   (1, 42, 42), (16, 8, 8), (17, 2730, 2730)])
def test_int8_product_on_card_is_exact(cuda, m, k, n):
    """torch._int_mm on zero-padded operands equals the exact product."""
    from anime_illust_image_searcher_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    got = quant.int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, quant.plain_int8_mm(a, b))
    assert torch.equal(got.cpu(), quant.plain_int8_mm(a.cpu(), b.cpu()))


@pytest.mark.cuda
def test_int8_linear_on_card_matches_cpu(cuda):
    from anime_illust_image_searcher_tpu_torch.ops import quant

    g = torch.Generator(device=cuda).manual_seed(3)
    layer = quant.Int8Linear(2730, 1024, device=cuda)
    layer.set_weight(torch.randn(1024, 2730, generator=g, device=cuda) * 0.02)
    cpu_layer = quant.Int8Linear(2730, 1024)
    cpu_layer.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    x = torch.randn(3, 1025, 2730, generator=g, device=cuda)
    with torch.inference_mode():
        got, want = layer(x).cpu(), cpu_layer(x.cpu())
    assert got.dtype == torch.bfloat16 and got.shape == (3, 1025, 1024)
    assert torch.equal(got, want)      # the same divides, roundings and exact sums
