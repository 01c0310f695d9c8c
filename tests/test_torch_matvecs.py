"""The port's matvecs (ops/query_scores.matvecs: the rerank product and every
character 1 - cos) against the JAX package, on the CPU.

On the card ``matvecs`` launches its own kernel (``aiis_matvecs`` in
csrc/query_scores.cu; tests/test_torch_kernels_cuda.py holds it to the
scoring kernel's bits there). On CPU tensors it is ``plain_matvecs``, which
these tests hold byte for byte, and which they hold against the JAX
package's full-f32 dots: the rerank product ``jnp.dot(matrix, mean,
precision=HIGHEST)`` (ops/fused_query.py:357) and the batched row-gather
1 - cos (models/caformer.py:306, :329, vmapped at :497), within rtol 1e-5 and
atol 1e-6 (f32 sums taken in another order; the port also averages and
normalizes the query feature in f64). Bad arguments raise before anything
is built or launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu.models import caformer as jc
from anime_illust_image_searcher_tpu_torch.models import caformer as tc
from anime_illust_image_searcher_tpu_torch.ops import _build
from anime_illust_image_searcher_tpu_torch.ops import query_scores as tqs

RTOL, ATOL = 1e-5, 1e-6
D = 131          # rows: not a multiple of the kernel's 32-row groups


def unit_rows(rng, n, f):
    m = rng.standard_normal((n, f)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test if anything tries to build or load a kernel library."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel library was built or loaded")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("f", [7, 300, 768])
@pytest.mark.parametrize("b", [1, 2, 5, 8])
def test_cpu_matvecs_is_the_plain_version_byte_for_byte(no_build, b, f):
    """CPU tensors take ``plain_matvecs``: the same bytes, no launch, and
    each query the same bytes alone as in its batch."""
    rng = np.random.default_rng(100 * b + f)
    matrix = torch.from_numpy(unit_rows(rng, D, f))
    vecs = torch.from_numpy(rng.standard_normal((b, f)).astype(np.float32))
    before = (tqs.matvecs.launches, dict(tqs.matvecs.launches_by_form))
    got = tqs.matvecs(matrix, vecs)
    assert (tqs.matvecs.launches, tqs.matvecs.launches_by_form) == before
    assert got.dtype == torch.float32 and got.shape == (b, D)
    assert got.numpy().tobytes() == tqs.plain_matvecs(matrix, vecs).numpy().tobytes()
    for i in range(b):
        assert tqs.matvecs(matrix, vecs[i:i + 1])[0].numpy().tobytes() == got[i].numpy().tobytes()


@pytest.mark.parametrize("f", [7, 300, 768])
@pytest.mark.parametrize("b", range(1, 9))
def test_matvecs_matches_the_jax_rerank_dot(b, f):
    """Each of B queries against ``jnp.dot(matrix, mean, precision=HIGHEST)``
    on the same unit rows and unit query vectors."""
    rng = np.random.default_rng(10 * b + f)
    matrix = unit_rows(rng, D, f)
    vecs = unit_rows(rng, b, f)
    got = tqs.matvecs(torch.from_numpy(matrix), torch.from_numpy(vecs)).numpy()
    for i in range(b):
        want = np.asarray(jnp.dot(jnp.asarray(matrix), jnp.asarray(vecs[i]),
                                  preferred_element_type=jnp.float32,
                                  precision=jax.lax.Precision.HIGHEST))
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f", [7, 300, 768])
@pytest.mark.parametrize("b", range(1, 9))
def test_one_minus_cos_matches_jax(b, f):
    """The batched row-gather 1 - cos of B queries (each the valid-masked
    mean of its k gathered raw features) through the port's op, whose
    product is ``matvecs``, against the JAX op."""
    rng = np.random.default_rng(1000 + 10 * b + f)
    k = 10
    index = unit_rows(rng, D, f)
    norms = (rng.random(D) + 0.5).astype(np.float32)
    row_ids = rng.integers(0, D, (b, k)).astype(np.int32)
    valid = rng.random((b, k)) < 0.8
    valid[:, 0] = True
    want = np.asarray(jc.ccip_rerank_diffs_from_rows_batch_op(
        jnp.asarray(index), jnp.asarray(norms), jnp.asarray(row_ids), jnp.asarray(valid)))
    got = tc.ccip_rerank_diffs_from_rows_batch_op(
        torch.from_numpy(index), torch.from_numpy(norms),
        torch.from_numpy(row_ids.astype(np.int64)), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (b, D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _bad(kind):
    """(matrix, vecs, error) for one kind of bad call."""
    m, v = torch.zeros(40, 12), torch.zeros(2, 12)
    meta = lambda t: t.to("meta")  # noqa: E731
    return {
        "B=9": (m, torch.zeros(9, 12), ValueError),
        "B=0": (m, torch.zeros(0, 12), ValueError),
        "f64 matrix": (m.double(), v, TypeError),
        "f16 vecs": (m, v.half(), TypeError),
        "non-contiguous matrix": (torch.zeros(12, 40).T, v, ValueError),
        "mismatched F": (m, torch.zeros(2, 11), ValueError),
        "1-D vecs": (m, torch.zeros(12), ValueError),
        "CUDA request without a card": (meta(m), meta(v), ValueError),
        "CPU matrix, off-CPU vecs": (m, meta(v), ValueError),
        "B=9 off the CPU": (meta(m), meta(torch.zeros(9, 12)), ValueError),
    }[kind]


@pytest.mark.parametrize("kind", ["B=9", "B=0", "f64 matrix", "f16 vecs", "non-contiguous matrix",
                                  "mismatched F", "1-D vecs", "CUDA request without a card",
                                  "CPU matrix, off-CPU vecs", "B=9 off the CPU"])
def test_bad_arguments_raise_before_any_launch(no_build, kind):
    """Each bad call raises before a kernel is built, loaded or launched (the
    meta device stands for a card this machine does not have): there is no
    fallback to the plain version or the CPU."""
    matrix, vecs, error = _bad(kind)
    before = tqs.matvecs.launches
    with pytest.raises(error, match="matvecs"):
        tqs.matvecs(matrix, vecs)
    assert tqs.matvecs.launches == before


def test_reset_launches_zeroes_both_kernels_counts():
    """``reset_launches`` covers the scoring kernel's counts and matvecs'."""
    tqs.query_scores.launches, tqs.query_scores.launches_by_form["scores B=1"] = 3, 3
    tqs.matvecs.launches, tqs.matvecs.launches_by_form["B=2"] = 5, 5
    tqs.reset_launches()
    assert (tqs.query_scores.launches, tqs.query_scores.launches_by_form) == (0, {})
    assert (tqs.matvecs.launches, tqs.matvecs.launches_by_form) == (0, {})
