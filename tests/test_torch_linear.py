"""The port's models and linearizer against the JAX reference, on the
CPU in float64.

Tolerances: the continuous Jacobians, ``find_SS`` and the discrete
matrices within 1e-12 absolute (one fsolve from the same start, and
``jacfwd`` of the same float64 ops, may differ only by round-off); the
finite-difference fallback within 1e-9; the host plant (``DEs``,
``step``, ``outputs``) bit for bit, since it runs the reference's
float64 ops in the same order.
"""
import numpy as np
import pytest
import scipy.signal
import torch

from gpu_se_tpu import models as ref_models
from gpu_se_tpu.models import linear as ref_linear
from gpu_se_tpu_torch import models
from gpu_se_tpu_torch.models import linear

X_GUESS = np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0])
U_BAR = np.array([0.04, 0.1])


@pytest.fixture(scope="module")
def x_bar():
    return ref_models.Bioreactor.find_SS(U_BAR, X_GUESS)


@pytest.mark.parametrize("u_op", [[0.04, 0.1], [0.06, 0.2]])
def test_find_ss_matches_reference(u_op):
    want = ref_models.Bioreactor.find_SS(np.array(u_op), X_GUESS)
    got = models.Bioreactor.find_SS(np.array(u_op), X_GUESS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[1] == X_GUESS[1]


@pytest.mark.parametrize("high_n", [False, True])
def test_exact_jacobians_match_reference(x_bar, high_n):
    """``torch.func.jacfwd`` of the hooks equals ``jax.jacfwd``'s,
    including the tie at ``Ce = 0``: both split ``max``'s derivative in
    half there, so the low-N ``A[3, 3]`` is ``-F_out / 2 = -0.07``."""
    ref = ref_models.Bioreactor(x_bar.copy(), high_N=high_n)
    port = models.Bioreactor(x_bar.copy(), high_N=high_n)
    want = ref_linear._jacobians_exact(ref, x_bar, U_BAR)
    got = linear._jacobians_exact(port, x_bar, U_BAR)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    if not high_n:
        assert x_bar[3] == 0.0
        assert got[0][3, 3] == pytest.approx(-0.07, abs=1e-15)


def test_des_hook_keeps_the_filter_path_value(x_bar):
    """The hook's ``max`` (``torch.maximum``) has the value of the
    filter's (``torch.clamp_min``): only its derivative differs."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(x_bar[:, None] + rng.standard_normal((5, 64)))
    x[:, :8] = 0.0
    u = torch.as_tensor(U_BAR)
    port = models.Bioreactor(x_bar.copy(), high_N=False)
    assert torch.equal(port.des(x, u), models.homeostatic_des(x, u, 1.0))
    port.high_N = True
    assert torch.equal(port.des(x, u), models.high_n_des(x, u))


def test_fd_jacobians_match_reference(x_bar):
    ref = ref_models.Bioreactor(x_bar.copy(), high_N=False)
    port = models.Bioreactor(x_bar.copy(), high_N=False)
    want = ref_linear._jacobians_fd(ref, x_bar, U_BAR)
    got = linear._jacobians_fd(port, x_bar, U_BAR)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    # and the exact path agrees with it, as the reference's does
    for e, f in zip(linear._jacobians_exact(port, x_bar, U_BAR), got):
        np.testing.assert_allclose(e, f, atol=1e-6)


@pytest.mark.parametrize("T", [1.0, 0.1])
def test_discrete_model_matches_reference(x_bar, T):
    plant = ref_models.Bioreactor.find_SS(np.array([0.06, 0.2]), X_GUESS)
    ref = ref_models.create_linear_model(
        ref_models.Bioreactor(plant.copy(), high_N=False), x_bar, U_BAR, T)
    port = models.create_linear_model(
        models.Bioreactor(plant.copy(), high_N=False), x_bar, U_BAR, T)
    for name in ("A", "B", "C", "D"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=0, atol=1e-12)
    for name in ("x_bar", "u_bar", "f_bar", "y_bar"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    if T == 1.0:
        assert port.A[0, 0] == pytest.approx(0.72648, rel=1e-4)
    assert models.LinearModel.create_LinearModel is not None
    port.select_subset([0, 2], [0, 1], [0, 2])
    ref.select_subset([0, 2], [0, 1], [0, 2])
    y = np.array([300.0, 40.0, 900.0, 1.0, 2.0])
    np.testing.assert_array_equal(port.yn2d(y), ref.yn2d(y))
    np.testing.assert_array_equal(port.xn2d(plant), ref.xn2d(plant))


@pytest.mark.parametrize("high_n", [False, True])
def test_host_plant_bit_equal(high_n):
    """``DEs``, ``step`` (with the ``>= 0`` clip) and the outputs equal
    the reference's numpy plant bit for bit over 200 steps."""
    x0 = ref_models.Bioreactor.find_SS(np.array([0.06, 0.2]), X_GUESS)
    ref = ref_models.Bioreactor(x0.copy(), high_N=high_n)
    port = models.Bioreactor(x0.copy(), high_N=high_n)
    rng = np.random.default_rng(1)
    for _ in range(200):
        u = rng.uniform(0.0, 0.3, size=2)
        np.testing.assert_array_equal(port.DEs(u), ref.DEs(u))
        ref.step(0.1, u)
        port.step(0.1, u)
        np.testing.assert_array_equal(port.X, ref.X)
        np.testing.assert_array_equal(port.outputs(u), ref.outputs(u))
    np.testing.assert_array_equal(port.raw_outputs(None), ref.raw_outputs(None))


def test_cstr_analytic_linearise():
    """The exact Jacobians equal the closed form (the reference's
    ``test_cstr_analytic_linearise``)."""
    X0 = np.array([1.0, 320.0])
    dt = 0.1
    lin = models.create_linear_model(models.CSTRModel(X0), X0, np.array([0.0]), dt)
    A, B, C, D = models.analytic_jacobians(X0, np.array([0.0]))
    Ad, Bd, Cd, Dd, _ = scipy.signal.cont2discrete((A, B, C, D), dt)
    for numeric, analytic in zip((lin.A, lin.B, lin.C, lin.D), (Ad, Bd, Cd, Dd)):
        assert np.max(np.abs(numeric - analytic)) < 1e-8
    ref = ref_models.create_linear_model(ref_models.CSTRModel(X0), X0,
                                         np.array([0.0]), dt)
    for name in ("A", "B", "C", "D"):
        np.testing.assert_allclose(getattr(lin, name), getattr(ref, name),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("cls, x, u", [
    ("TankModel", [50.0], [10.0]),
    ("DiagTank", [50.0, 20.0], [10.0, 3.0]),
    ("LinkedTanks", [50.0, 20.0], [10.0, 3.0]),
])
def test_tanks_match_reference(cls, x, u):
    x, u = np.array(x), np.array(u)
    ref = ref_models.create_linear_model(getattr(ref_models, cls)(x), x, u, 1.0)
    port = models.create_linear_model(getattr(models, cls)(x), x, u, 1.0)
    for name in ("A", "B", "C", "D", "f_bar", "y_bar"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=0, atol=1e-12)


def test_fd_fallback_without_hooks():
    """A model without pure hooks takes the central differences, as the
    reference's does."""
    class NoHooks(models.NonlinearModel):
        def __init__(self, X0):
            self.X = np.array(X0, dtype=float)
            self.t = 0.0

        def DEs(self, inputs):
            return np.array([-0.5 * self.X[0] ** 2 + inputs[0]])

        def outputs(self, inputs):
            return np.array(self.X[:1])

    lin = models.create_linear_model(NoHooks([2.0]), np.array([2.0]),
                                     np.array([1.0]), 1.0)
    want = scipy.signal.cont2discrete(
        (np.array([[-2.0]]), np.array([[1.0]]), np.array([[1.0]]),
         np.array([[0.0]])), 1.0)[0]
    np.testing.assert_allclose(lin.A, want, atol=1e-8)
