"""The port's blocked reductions against the JAX reference.

Both sides sum float32 in two levels with the same block rule, but each
library orders the sums inside a level its own way, so the results agree
within ``rtol=1e-6`` rather than bit for bit. The terms are positive, so
no sum cancels and the relative tolerance holds for every entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.ops import reduce as jred
from gpu_se_tpu_torch.ops import reduce as tred

SIZES = [1, 4099, 5000, 8192]


def _data(n, d=5):
    rng = np.random.default_rng(n)
    x = (0.5 + rng.random((n, d))).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    return x, w


@pytest.mark.parametrize("n, block", [(1, 1), (4099, 1), (5000, 8),
                                      (8192, 4096)])
def test_block_rule(n, block):
    assert tred._block(n, 4096) == block


@pytest.mark.parametrize("n", SIZES)
def test_blocked_sum_vs_jax(n):
    x, w = _data(n)
    for a in (x, w):
        got = tred.blocked_sum(torch.from_numpy(a)).numpy()
        want = np.asarray(jred.blocked_sum(jnp.asarray(a)))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", SIZES)
def test_weighted_mean_vs_jax(n):
    x, w = _data(n)
    got = tred.weighted_mean(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    want = np.asarray(jred.weighted_mean(jnp.asarray(w), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_outer_sum_vs_jax(n):
    x, w = _data(n)
    b = x * w[:, None]
    got = tred.blocked_outer_sum(torch.from_numpy(x),
                                 torch.from_numpy(b)).numpy()
    want = np.asarray(jred.blocked_outer_sum(jnp.asarray(x), jnp.asarray(b)))
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
