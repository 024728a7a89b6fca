"""The port's small-matrix ops against the reference's, in float32.

Every function is unrolled in the reference's op order, so the results
are bit-equal (``assert_array_equal``, NaN where the reference has NaN)
for the unrolled sizes. Two exceptions, each stated at its test: the
general-n inverse (n > 3) is LAPACK on both sides, held to 1e-5 of the
inverse's largest entry; and the broadcast-multiply-reduce products sum
their small axis in either library's order, held to 4 ulps (rtol 5e-7)
where they are not bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.ops import smallmat as jsm
from gpu_se_tpu_torch.ops import smallmat as tsm

SIZES = [1, 2, 3, 5]


def _spd(n, batch=64, seed=0):
    rng = np.random.default_rng([n, seed])
    a = rng.standard_normal((batch, n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, 1, 2)
            + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _hard(n):
    """SPD, singular, zero, indefinite and NaN matrices."""
    mats = [_spd(n, batch=8)]
    ones = np.ones((1, n, n), np.float32)               # rank 1
    mats += [ones, np.zeros((1, n, n), np.float32),
             -np.eye(n, dtype=np.float32)[None]]
    nan = np.eye(n, dtype=np.float32)[None].copy()
    nan[0, 0, 0] = np.nan
    mats.append(nan)
    return np.concatenate(mats)


def _lanes(m):
    return np.ascontiguousarray(m.transpose(1, 2, 0))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_cholesky_small_bit_equal(n):
    for m in (_spd(n), _hard(n)):
        _eq(tsm.cholesky_small(torch.from_numpy(m)),
            jsm.cholesky_small(jnp.asarray(m)))
        _eq(tsm.cholesky_small_lanes(torch.from_numpy(_lanes(m))),
            jsm.cholesky_small_lanes(jnp.asarray(_lanes(m))))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_inv_small_bit_equal(n):
    for m in (_spd(n), _hard(n)):
        with np.errstate(all="ignore"):
            _eq(tsm.inv_small(torch.from_numpy(m)),
                jsm.inv_small(jnp.asarray(m)))
            _eq(tsm.inv_small_jittered(torch.from_numpy(m)),
                jsm.inv_small_jittered(jnp.asarray(m)))
            _eq(tsm.inv_small_lanes(torch.from_numpy(_lanes(m))),
                jsm.inv_small_lanes(jnp.asarray(_lanes(m))))
            _eq(tsm.inv_small_jittered_lanes(torch.from_numpy(_lanes(m))),
                jsm.inv_small_jittered_lanes(jnp.asarray(_lanes(m))))


@pytest.mark.parametrize("n", [4, 5])
def test_inv_small_general_n(n):
    """n > 3 goes to LAPACK on both sides: within 1e-5 of the largest
    entry, and the jittered forms leave a healthy matrix untouched."""
    m = _spd(n)
    want = np.asarray(jsm.inv_small(jnp.asarray(m)))
    for got in (tsm.inv_small(torch.from_numpy(m)).numpy(),
                tsm.inv_small_lanes(torch.from_numpy(_lanes(m))).numpy()
                .transpose(2, 0, 1)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    _eq(tsm.inv_small_jittered(torch.from_numpy(m)),
        tsm.inv_small(torch.from_numpy(m)))
    _eq(tsm.inv_small_jittered_lanes(torch.from_numpy(_lanes(m))),
        tsm.inv_small_lanes(torch.from_numpy(_lanes(m))))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_jittered_inverse_is_finite_on_degenerate_input(n):
    """Singular and zero matrices: finite, as the reference's. A zero
    matrix gets a zero inverse for n >= 2 (its jittered determinant
    underflows) and ``1 / tiny`` for n = 1."""
    m = _hard(n)[8:11]                           # rank 1, zero, -I
    for got in (tsm.inv_small_jittered(torch.from_numpy(m)),
                tsm.inv_small_jittered_lanes(
                    torch.from_numpy(_lanes(m))).permute(2, 0, 1)):
        assert torch.isfinite(got).all()
    assert not torch.isfinite(tsm.inv_small(torch.from_numpy(m[:2]))).all()
    want = (torch.zeros(1, n, n) if n > 1
            else torch.full((1, 1, 1), 1.0 / torch.finfo(torch.float32).tiny))
    assert torch.equal(tsm.inv_small_jittered(torch.zeros(1, n, n)), want)


@pytest.mark.parametrize("n", SIZES)
def test_products_vs_reference(n):
    """bmm_small, weighted_outer_sum and weighted_sigma_mean: the small
    axis is summed by each library's reduction; within 4 ulps."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((32, n, n)).astype(np.float32)
    b = rng.standard_normal((32, n, n)).astype(np.float32)
    s = rng.standard_normal((32, 2 * n + 1, n)).astype(np.float32)
    w = rng.random(2 * n + 1).astype(np.float32)
    pairs = [
        (tsm.bmm_small(torch.from_numpy(a), torch.from_numpy(b)),
         jsm.bmm_small(jnp.asarray(a), jnp.asarray(b))),
        (tsm.weighted_outer_sum(torch.from_numpy(s), torch.from_numpy(w),
                                torch.from_numpy(s)),
         jsm.weighted_outer_sum(jnp.asarray(s), jnp.asarray(w),
                                jnp.asarray(s))),
        (tsm.weighted_sigma_mean(torch.from_numpy(w), torch.from_numpy(s)),
         jsm.weighted_sigma_mean(jnp.asarray(w), jnp.asarray(s))),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7,
                                   atol=4 * np.finfo(np.float32).eps
                                   * np.abs(want).max())


@pytest.mark.parametrize("n", SIZES)
def test_lanes_mirror_batched_exactly(n):
    """The port's lanes-last forms equal its batched forms bit for bit
    (the same ops in the same order, another layout)."""
    for m in (_spd(n), _hard(n)):
        lanes = torch.from_numpy(_lanes(m))
        batched = torch.from_numpy(m)
        _eq(tsm.cholesky_small_lanes(lanes).permute(2, 0, 1),
            tsm.cholesky_small(batched).numpy())
        if n <= 3:
            with np.errstate(all="ignore"):
                _eq(tsm.inv_small_lanes(lanes).permute(2, 0, 1),
                    tsm.inv_small(batched).numpy())
                _eq(tsm.inv_small_jittered_lanes(lanes).permute(2, 0, 1),
                    tsm.inv_small_jittered(batched).numpy())
