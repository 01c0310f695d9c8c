"""The port's EVA02 (PyTorch) against the JAX package's, on one set of weights.

The JAX params are made by the JAX package's init and then perturbed with numpy
the way tests/test_eva02_oracle.py randomizes its replica (norm scales near 1,
fan-in-scaled kernels), so attention is peaked and a wrong rope layout shows.
``from_jax_params`` carries them across. Both run in f32 on the CPU, with the
JAX attention through its plain XLA reference; logits must agree to 1e-5.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu.models import eva02 as jeva
from anime_illust_image_searcher_tpu_torch.models import eva02 as teva
from anime_illust_image_searcher_tpu_torch.models.weights import from_jax_params
from anime_illust_image_searcher_tpu_torch.utils import profiling


def perturb(params, seed):
    """Structure-aware randomization of a flax Eva02 param tree (numpy out)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = np.shape(x)
        if any("norm" in n for n in names[:-1]) or names[-1].startswith("gamma"):
            if names[-1] in ("scale",) or names[-1].startswith("gamma"):
                return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if names[-1] == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if names[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (2.0 / np.sqrt(fan_in) * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def torch_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return teva.Eva02Config(**fields)


def run_both(jcfg, seed, images):
    params = perturb(jeva.init_params(jcfg, seed=0, use_pallas=False), seed)
    want = np.asarray(jeva.forward_logits(params, jnp.asarray(images), jcfg, use_pallas=False))
    tcfg = torch_cfg(jcfg)
    model = teva.Eva02(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    got = teva.forward_logits(model.eval(), torch.from_numpy(images)).numpy()
    return got, want, model, tcfg, params


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(3).rand(2, 56, 56, 3).astype(np.float32)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(global_pool="token"),
    dict(scale_attn_inner=True, use_layer_scale=True),
    dict(scale_attn_inner=True, use_layer_scale=True, global_pool="token"),
    # unaligned SwiGLU hidden widths, which f32 runs unpadded
    dict(mlp_hidden_dim=114),
    dict(mlp_hidden_dim=58, scale_attn_inner=True, use_layer_scale=True, global_pool="token"),
])
def test_logits_match_jax(variant, images):
    jcfg = dataclasses.replace(jeva.tiny_test_config(), **variant)
    got, want, *_ = run_both(jcfg, seed=5, images=images)
    assert got.shape == (2, jcfg.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the fixture is not degenerate: logits spread over O(1)
    assert np.std(want) > 0.1


@pytest.mark.parametrize("variant", [
    dict(mlp_hidden_dim=114),
    dict(mlp_hidden_dim=58, scale_attn_inner=True, use_layer_scale=True, global_pool="token"),
])
def test_padded_bf16_logits_match_jax(variant, images):
    """In bf16 an unaligned SwiGLU runs padded (114 -> 120, 58 -> 64); its
    logits stay within bf16 rounding of the JAX package's bf16 forward (0.03
    of logits spread over 2.2-2.4 here), as the aligned width's do."""
    jcfg = dataclasses.replace(jeva.tiny_test_config(), dtype=jnp.bfloat16, **variant)
    params = perturb(jeva.init_params(jcfg, seed=0, use_pallas=False), 5)
    want = np.asarray(jeva.forward_logits(params, jnp.asarray(images), jcfg, use_pallas=False),
                      np.float32)
    tcfg = dataclasses.replace(torch_cfg(jcfg), dtype=torch.bfloat16)
    model = teva.Eva02(tcfg, device="cpu")
    assert isinstance(model.blocks[0].mlp.w3, teva.PaddedLinear)
    model.load_state_dict(from_jax_params(params, tcfg))
    got = teva.forward_logits(model.eval(), torch.from_numpy(images)).float().numpy()
    assert np.abs(got - want).max() <= 0.1
    assert np.std(want) > 0.1


def test_wrong_rope_layout_is_caught(images):
    """Permuting the q/k rows once more (a wrong rope layout) must break parity:
    the perturbed weights make the forward rope-sensitive."""
    jcfg = jeva.tiny_test_config()
    got, want, model, tcfg, params = run_both(jcfg, seed=7, images=images)
    sd = from_jax_params(params, tcfg)
    perm = np.concatenate([h * tcfg.head_dim + teva.rope_half_permutation(tcfg.head_dim)
                           for h in range(tcfg.num_heads)])
    for i in range(tcfg.depth):
        for key in (f"blocks.{i}.attn.q_proj.weight", f"blocks.{i}.attn.q_proj.bias",
                    f"blocks.{i}.attn.k_proj.weight"):
            sd[key] = sd[key][torch.from_numpy(perm)]
    model.load_state_dict(sd)
    wrong = teva.forward_logits(model, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(wrong - want).max() > 0.1


def test_probs_match_jax(images):
    jcfg = jeva.tiny_test_config()
    params = perturb(jeva.init_params(jcfg, seed=0, use_pallas=False), 9)
    want = np.asarray(jeva.forward_probs(params, jnp.asarray(images), jcfg, use_pallas=False))
    tcfg = torch_cfg(jcfg)
    model = teva.Eva02(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg))
    got = teva.forward_probs(model.eval(), torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rope_tables_match_jax():
    for grid, dh, ref in [((4, 4), 32, (4, 4)), ((32, 32), 64, (16, 16)), ((3, 5), 16, None)]:
        js, jc = jeva.build_rope_cat(grid, dh, 10000.0, ref)
        ts, tc = teva.build_rope_cat(grid, dh, 10000.0, ref)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(teva.rope_half_permutation(64),
                                  jeva.rope_half_permutation(64))


def test_apply_rope_matches_jax(rng):
    x = rng.randn(2, 3, 16, 32).astype(np.float32)
    sin, cos = (rng.randn(16, 32).astype(np.float32) for _ in range(2))
    want = np.asarray(jeva.apply_rope_cat(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos)))
    got = teva.apply_rope_cat(torch.from_numpy(x), torch.from_numpy(sin), torch.from_numpy(cos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_config_mirrors_jax():
    j, t = jeva.Eva02Config(), teva.Eva02Config()
    jf = {f.name for f in dataclasses.fields(j)}
    assert jf == {f.name for f in dataclasses.fields(t)}
    for name in jf - {"dtype"}:
        assert getattr(j, name) == getattr(t, name), name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    jt, tt = jeva.tiny_test_config(), teva.tiny_test_config()
    for name in jf - {"dtype"}:
        assert getattr(jt, name) == getattr(tt, name), name
    assert tt.dtype == torch.float32
    assert (t.grid_size, t.num_patches, t.head_dim) == (j.grid_size, j.num_patches, j.head_dim)


def test_carried_knobs_refused():
    with pytest.raises(NotImplementedError):
        teva.Eva02(dataclasses.replace(teva.tiny_test_config(), rope_variant="idrow"))
    # int8 is ported (tests/test_torch_quant.py); a quant mode neither package has is not
    with pytest.raises(NotImplementedError):
        teva.Eva02(dataclasses.replace(teva.tiny_test_config(), quant="int4"))


def test_seeded_init_distributions():
    """Seeded init is reproducible and follows flax's distributions."""
    cfg = dataclasses.replace(teva.tiny_test_config(), embed_dim=128, mlp_hidden_dim=256)
    a, b = teva.Eva02(cfg), teva.Eva02(cfg)
    teva.init_params(a, seed=0)
    teva.init_params(b, seed=0)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.blocks[0].mlp.w3.weight                 # lecun normal, fan_in 256
    assert abs(w.std().item() - (1 / 256) ** 0.5) < 0.01
    assert w.abs().max().item() <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(a.blocks[0].attn.q_proj.bias == 0)
    assert torch.all(a.blocks[0].norm1.weight == 1)
    assert a.pos_embed.abs().max().item() <= 0.04
    assert abs(a.pos_embed.std().item() - 0.02 * 0.8796) < 0.003


def test_unaligned_hidden_is_padded_behind_the_published_layout(images):
    """A bf16 hidden width off a multiple of 8 runs padded: zero pad rows and
    columns, a state dict of the published shapes, one padded forward a block,
    and a model saved and loaded again gives the same logits bit for bit."""
    cfg = dataclasses.replace(teva.tiny_test_config(), mlp_hidden_dim=114, dtype=torch.bfloat16)
    model = teva.Eva02(cfg).eval()
    teva.init_params(model, seed=1)
    mlp = model.blocks[0].mlp
    assert (mlp.hidden, mlp.hidden_padded) == (114, teva.padded_hidden(cfg)) == (114, 120)
    assert tuple(mlp.w1.weight.shape) == (120, 64) and tuple(mlp.w3.weight.shape) == (64, 120)
    assert not mlp.w1.weight[114:].any() and not mlp.w1.bias[114:].any()
    assert not mlp.w3.weight[:, 114:].any()
    sd = model.state_dict()
    for i in range(cfg.depth):
        p = f"blocks.{i}.mlp"
        assert tuple(sd[f"{p}.w1.weight"].shape) == tuple(sd[f"{p}.w2.weight"].shape) == (114, 64)
        assert tuple(sd[f"{p}.w1.bias"].shape) == (114,)
        assert tuple(sd[f"{p}.w3.weight"].shape) == (64, 114)
    x = torch.from_numpy(images)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        want = teva.forward_logits(model, x)
    assert {k: v["count"] for k, v in profiling.recorded().items()} \
        == {"swiglu.pad_114_to_120": cfg.depth}
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    again = teva.Eva02(cfg)
    again.load_state_dict(torch.load(buf))
    assert torch.equal(teva.forward_logits(again.eval(), x), want)
    assert not again.blocks[1].mlp.w2.weight[114:].any()


def test_padded_init_draws_the_unpadded_bits(images, monkeypatch):
    """init_params draws the published shapes in the same order with the
    same fan-in, so a padded model's state dict is the unpadded model's bit
    for bit, and its logits agree to bf16 rounding."""
    cfg = dataclasses.replace(teva.tiny_test_config(), mlp_hidden_dim=58, dtype=torch.bfloat16)
    padded = teva.Eva02(cfg).eval()
    teva.init_params(padded, seed=3)
    assert isinstance(padded.blocks[0].mlp.w3, teva.PaddedLinear)
    with monkeypatch.context() as m:
        m.setattr(teva, "padded_hidden", lambda c: c.mlp_hidden_dim)
        plain = teva.Eva02(cfg).eval()
    assert type(plain.blocks[0].mlp.w3) is torch.nn.Linear
    teva.init_params(plain, seed=3)
    want, got = plain.state_dict(), padded.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    x = torch.from_numpy(images)
    np.testing.assert_allclose(teva.forward_logits(padded, x).float().numpy(),
                               teva.forward_logits(plain, x).float().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(teva.tiny_test_config(), dtype=torch.bfloat16),   # hidden 112
    dataclasses.replace(teva.tiny_test_config(), mlp_hidden_dim=114),     # f32
    dataclasses.replace(teva.tiny_test_config(), mlp_hidden_dim=114, quant="int8",
                        dtype=torch.bfloat16),
])
def test_aligned_f32_or_int8_hidden_builds_no_padding(cfg, images):
    """An aligned hidden width, and any width in f32, keeps plain nn.Linears
    at the published shape; the int8 path keeps its own Int8Linears, which pad
    their own operands."""
    model = teva.Eva02(cfg).eval()
    teva.init_params(model, seed=0)
    mlp = model.blocks[0].mlp
    assert mlp.hidden_padded == mlp.hidden == cfg.mlp_hidden_dim
    assert not any(isinstance(m, teva.PaddedLinear) for m in model.modules())
    if cfg.quant == "none":
        hid = cfg.mlp_hidden_dim
        assert type(mlp.w1) is torch.nn.Linear
        assert tuple(mlp.w1.weight.shape) == (hid, 64) and tuple(mlp.w3.weight.shape) == (64, hid)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        teva.forward_logits(model, torch.from_numpy(images))
    assert profiling.recorded() == {}
