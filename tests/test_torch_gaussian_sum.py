"""The port's GaussianSum against the JAX reference.

Tolerances: ``create`` casts the same float64 host precompute to float32
on both sides, so the factors agree bit for bit. ``pdf_t`` and ``pdf``
agree to ``rtol=1e-5`` (``exp`` differs by a few ulps between the two
libraries). ``draw_t_from`` fed the reference's own normals and uniforms
agrees to ``rtol=1e-6, atol=1e-7``: the ``chol @ eps`` products sum in a
different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.distributions import GaussianSum as TGS

X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")

MIXTURES = {
    "x0": (np.stack([X_SS, X_SS]),
           np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
           np.array([0.75, 0.25])),
    "state_noise": (np.zeros((2, 5)),
                    np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                              np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
                    np.array([0.75, 0.25])),
    "measurement": (np.array([[1e-1, 0], [0, -1e-1]]),
                    np.array([[[6e-2, 0], [0, 8e-2]],
                              [[500, 100], [100, 700]]]),
                    np.array([0.85, 0.15])),
    "three_component": (np.array([[0.0, 1.0, -1.0], [2.0, 0.0, 0.5],
                                  [-1.0, -1.0, 0.0]]),
                        np.stack([np.eye(3) * 0.5,
                                  [[1.0, 0.3, 0.0], [0.3, 2.0, 0.1],
                                   [0.0, 0.1, 0.7]],
                                  np.diag([0.2, 0.1, 3.0])]),
                        np.array([0.2, 0.5, 0.3])),
}


def _pair(name):
    args = MIXTURES[name]
    return JGS.create(*args), TGS.create(*args)


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_create_factors_bit_equal(name):
    jgs, tgs = _pair(name)
    for field in FIELDS:
        got = getattr(tgs, field).numpy()
        want = np.asarray(getattr(jgs, field))
        assert got.dtype == want.dtype == np.float32, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_pdf_t_and_pdf_vs_jax(name):
    jgs, tgs = _pair(name)
    nx = jgs.n_dim
    rng = np.random.default_rng(1)
    mu = np.asarray(jgs.means)[0]
    spread = np.sqrt(np.diagonal(np.asarray(jgs.covariances)[0]))
    x = (mu[:, None] + 2.0 * spread[:, None]
         * rng.standard_normal((nx, 1000))).astype(np.float32)
    want = np.asarray(jgs.pdf_t(jnp.asarray(x)))
    got = tgs.pdf_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    want = np.asarray(jgs.pdf(jnp.asarray(x.T)))
    got = tgs.pdf(torch.from_numpy(x.T.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_mean_vs_jax(name):
    jgs, tgs = _pair(name)
    np.testing.assert_allclose(tgs.mean().numpy(), np.asarray(jgs.mean()),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["state_noise", "three_component"])
def test_draw_t_from_vs_jax_draw_t(name):
    """The reference's ``draw_t`` splits its key into (kc, kn): normals
    from kn, then a uniform (two components) or a categorical (more) from
    kc. Fed those numbers, the port draws the same samples."""
    jgs, _ = _pair(name)
    tgs = convert.gaussian_sum_from_numpy(
        *(np.asarray(getattr(jgs, f)) for f in FIELDS))
    size = 4096
    key = jax.random.PRNGKey(5)
    want = np.asarray(jgs.draw_t(key, size))
    kc, kn = jax.random.split(key)
    eps = np.array(jax.random.normal(kn, (jgs.n_dim, size), jnp.float32))
    if jgs.n_components == 2:
        pick = np.array(jax.random.uniform(kc, (size,), jnp.float32))
    else:
        pick = np.array(jax.random.categorical(
            kc, jnp.log(jgs.weights), shape=(size,)))
    got = tgs.draw_t_from(torch.from_numpy(eps), torch.from_numpy(pick))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["x0", "three_component"])
def test_draw_t_distribution(name):
    """The port's own stream: the mean and covariance of 2^16 draws match
    the mixture's within sampling error (4 standard errors)."""
    args = MIXTURES[name]
    tgs = TGS.create(*args)
    size = 2**16
    draws = tgs.draw_t(torch.Generator().manual_seed(0), size).numpy()
    assert draws.shape == (tgs.n_dim, size)
    means, covs, w = (np.asarray(a, np.float64) for a in args)
    w = w / w.sum()
    mu = w @ means
    d = means - mu
    cov = np.einsum("d,dij->ij", w, covs) + np.einsum("d,di,dj->ij", w, d, d)
    sd = np.sqrt(np.diag(cov))
    got_mu = draws.astype(np.float64).mean(axis=1)
    assert np.all(np.abs(got_mu - mu) < 4 * sd / np.sqrt(size))
    got_cov = np.cov(draws.astype(np.float64))
    # var of a sample covariance entry <= (cov_ii cov_jj + cov_ij^2) * kurtosis
    # slack; a factor 3 covers the mixtures' heavier tails
    se = np.sqrt(3 * (np.outer(sd**2, sd**2) + cov**2) / size)
    assert np.all(np.abs(got_cov - cov) < 4 * se)
