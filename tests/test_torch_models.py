"""The port's bioreactor model against the JAX reference.

Inputs are ``(5, T, 128)`` stacks made by numpy from a seed, with states
at and below the ``max(x, 0)`` clamps. Against ``xp=jnp`` (float32, run
eagerly) the tolerance is ``rtol=1e-6``: both sides run the same float32
ops in the same order and agree bit for bit on the CPU; a jitted or fused
reference may contract a multiply-add. Against ``xp=np`` the port runs
in float64 and agrees to float64 round-off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu_torch.models import bioreactor as tbio

X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
U = np.array([0.06, 0.2])
DT = 0.1


def _states(dtype, shape=(4, 128)):
    rng = np.random.default_rng(0)
    x = X_SS.reshape(5, 1, 1) * (1.0 + 0.3 * rng.standard_normal((5,) + shape))
    x = x + 0.05 * rng.standard_normal((5,) + shape)
    x[:, 0, :8] = 0.0            # on the clamp
    x[:4, 1, :8] = -1e-3         # below the clamp
    x[0, 2, :4] = -0.5
    return x.astype(dtype)


def _jax_f32(fn, x):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(U, jnp.float32)))


def _torch(fn, x, dtype):
    return fn(torch.from_numpy(x), torch.as_tensor(U, dtype=dtype)).numpy()


PAIRS = {
    "homeostatic_des": (
        lambda x, u, xp: jbio.homeostatic_des(x, u, DT, xp=xp),
        lambda x, u: tbio.homeostatic_des(x, u, DT)),
    "static_outputs": (
        lambda x, u, xp: jbio.static_outputs(x, u, xp=xp),
        tbio.static_outputs),
    "euler_step_low_n": (
        lambda x, u, xp: jbio.euler_step(x, u, DT, high_n=False, xp=xp),
        lambda x, u: tbio.euler_step(x, u, DT, high_n=False)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_elementwise_vs_jax_f32(name):
    jfn, tfn = PAIRS[name]
    x = _states(np.float32)
    want = _jax_f32(lambda a, u: jfn(a, u, jnp), x)
    got = _torch(tfn, x, torch.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_elementwise_vs_numpy_f64(name):
    jfn, tfn = PAIRS[name]
    x = _states(np.float64)
    want = jfn(x.copy(), U, np)
    got = _torch(tfn, x, torch.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_high_n_des_matches_reference():
    """(5, n) stacks: the reference's ``@`` takes a 2-d state; the port
    contracts the leading axis of any shape. Float32 tolerance 1e-5: the
    5x5 rate-matrix product sums in another order."""
    x = _states(np.float64).reshape(5, -1)
    want64 = jbio.high_n_des(x, U, xp=np)
    got64 = _torch(tbio.high_n_des, x, torch.float64)
    np.testing.assert_allclose(got64, want64, rtol=1e-12, atol=1e-15)
    x32 = x.astype(np.float32)
    want32 = _jax_f32(lambda a, u: jbio.high_n_des(a, u, xp=jnp), x32)
    got32 = _torch(tbio.high_n_des, x32, torch.float32)
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-6)
    stacked = _torch(tbio.high_n_des, x32.reshape(5, 4, 128), torch.float32)
    np.testing.assert_array_equal(stacked.reshape(5, -1), got32)


def test_euler_step_high_n_matches_numpy():
    x = _states(np.float64).reshape(5, -1)
    want = jbio.euler_step(x.copy(), U, DT, high_n=True, xp=np)
    got = tbio.euler_step(torch.from_numpy(x), torch.from_numpy(U), DT,
                          high_n=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert np.all(got[:4] >= 0.0)


def test_all_outputs_per_particle():
    """The reference scales one ``(5,)`` state; the port a ``(5, ...)``
    stack, one particle per column."""
    x = _states(np.float32).reshape(5, -1)
    got = tbio.all_outputs(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(jbio.all_outputs(jnp.asarray(x[:, k])))
                     for k in range(0, x.shape[1], 37)], axis=1)
    np.testing.assert_array_equal(got[:, ::37], want)
