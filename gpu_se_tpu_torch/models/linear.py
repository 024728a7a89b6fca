"""Discrete LTI model and the linearization of nonlinear models.

Counterpart of ``gpu_se_tpu/models/linear.py``: the ``LinearModel``
container (matrices, linearization point, subset selection, deviation
transforms) and ``create_linear_model``, which takes exact Jacobians by
``torch.func.jacfwd`` on CPU float64 tensors when the model has pure
``des``/``out`` hooks and the adaptive central differences otherwise,
then discretizes them with ``scipy.signal.cont2discrete`` (zoh). All of
it is one-time host setup in float64.
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from gpu_se_tpu_torch.models.base import NonlinearModel


class LinearModel:
    """Discrete state-space model with linearization metadata.

    x_{k+1} = A x_k + B u_k (+ w_k),  y_k = C x_k + D u_k (+ v_k),
    all in deviation variables about ``(x_bar, u_bar)``.
    """

    def __init__(self, A, B, C, D, dt, x_bar, u_bar, f_bar, y_bar):
        A, B, C, D = [np.atleast_2d(np.asarray(m, dtype=float))
                      for m in (A, B, C, D)]
        self.A, self.B, self.C, self.D = A, B, C, D
        self.T = dt
        self.x_bar = np.asarray(x_bar, dtype=float)
        self.u_bar = np.asarray(u_bar, dtype=float)
        self.f_bar = np.asarray(f_bar, dtype=float)
        self.y_bar = np.asarray(y_bar, dtype=float)

        self.Nx = self.A.shape[0]
        self.Ni = self.B.shape[1]
        self.No = self.C.shape[0]

        self.states = list(range(self.Nx))
        self.inputs = list(range(self.Ni))
        self.outputs = list(range(self.No))

    # ------------------------------------------------------------------
    def select_subset(self, states, inputs, outputs):
        """Slice the model down to an MPC-relevant subsystem."""
        states, inputs, outputs = list(states), list(inputs), list(outputs)
        self.A = self.A[states][:, states]
        self.B = self.B[states][:, inputs]
        self.C = self.C[outputs][:, states]
        self.D = self.D[outputs][:, inputs]
        self.x_bar = self.x_bar[states]
        self.u_bar = self.u_bar[inputs]
        self.f_bar = self.f_bar[states]
        self.y_bar = self.y_bar[outputs]
        self.states, self.inputs, self.outputs = states, inputs, outputs
        self.Nx, self.Ni, self.No = len(states), len(inputs), len(outputs)

    # ------------------------------------------------------------------
    # Deviation-variable transforms
    def xd2n(self, x_hat):
        return x_hat + self.x_bar

    def xn2d(self, x, subselect=True):
        if subselect:
            return np.asarray(x)[self.states] - self.x_bar
        return x - self.x_bar

    def yd2n(self, y_hat):
        return y_hat + self.y_bar

    def yn2d(self, y, subselect=True):
        if subselect:
            return np.asarray(y)[self.outputs] - self.y_bar
        return y - self.y_bar

    def ud2n(self, u_hat):
        return u_hat + self.u_bar

    def un2d(self, u, subselect=True):
        if subselect:
            return np.asarray(u)[self.inputs] - self.u_bar
        return u - self.u_bar


# ----------------------------------------------------------------------
def _finite_difference_jacobian(g, tol=1e-8, x0=0.1):
    """Adaptive central difference: halve the step until the infinity-norm
    change of the estimate is below ``tol``."""
    x = x0
    gamma = (g(x) - g(-x)) / (2 * x)
    err = tol + 1.0
    while err > tol:
        x /= 2.0
        new_gamma = (g(x) - g(-x)) / (2 * x)
        err = np.max(np.abs(new_gamma - gamma))
        gamma = new_gamma
    return gamma


def _jacobians_fd(model: NonlinearModel, x_bar, u_bar):
    """Column-by-column central differencing on the stateful
    ``DEs``/``outputs`` methods."""
    old_X = model.X
    mats = []
    for fun in (lambda u: model.DEs(u), lambda u: model.outputs(u)):
        row = []
        for j, vec in enumerate((x_bar, u_bar)):
            model.X = np.array(x_bar, dtype=float)
            cols = []
            for k in range(len(vec)):
                def g(h, _k=k, _j=j):
                    if _j == 0:
                        pert = np.array(x_bar, dtype=float)
                        pert[_k] += h
                        model.X = pert
                        ans = fun(u_bar)
                        model.X = np.array(x_bar, dtype=float)
                        return np.asarray(ans, dtype=float)
                    pert = np.array(u_bar, dtype=float)
                    pert[_k] += h
                    return np.asarray(fun(pert), dtype=float)

                cols.append(_finite_difference_jacobian(g))
            row.append(np.array(cols).T)
        mats.append(row)
    model.X = old_X
    (A, B), (C, D) = mats
    return A, B, C, D


def _jacobians_exact(model: NonlinearModel, x_bar, u_bar):
    """Exact Jacobians by ``torch.func.jacfwd`` of the model's pure hooks
    on CPU float64 tensors."""
    xb = torch.as_tensor(np.asarray(x_bar, dtype=np.float64))
    ub = torch.as_tensor(np.asarray(u_bar, dtype=np.float64))
    jac = torch.func.jacfwd
    return tuple(
        jac(fn, argnums=arg)(xb, ub).numpy()
        for fn in (model.des, model.out) for arg in (0, 1))


def create_linear_model(model: NonlinearModel, x_bar, u_bar, T) -> LinearModel:
    """Linearize ``model`` about ``(x_bar, u_bar)`` and discretize (zoh).

    Exact Jacobians when the model exposes pure ``des``/``out`` hooks;
    otherwise the adaptive central differences. The canonical bioreactor
    linearization gives a discrete ``A[0, 0]`` of about 0.72648.
    """
    x_bar = np.asarray(x_bar, dtype=float)
    u_bar = np.asarray(u_bar, dtype=float)

    try:
        A, B, C, D = _jacobians_exact(model, x_bar, u_bar)
    except NotImplementedError:
        A, B, C, D = _jacobians_fd(model, x_bar, u_bar)

    Ad, Bd, Cd, Dd, _ = scipy.signal.cont2discrete((A, B, C, D), T)

    old_X = model.X
    model.X = np.array(x_bar, dtype=float)
    f_bar = np.asarray(model.DEs(u_bar), dtype=float)
    y_bar = np.asarray(model.outputs(u_bar), dtype=float)
    model.X = old_X

    return LinearModel(Ad, Bd, Cd, Dd, T, x_bar, u_bar, f_bar, y_bar)


# Reference-style alias
LinearModel.create_LinearModel = staticmethod(create_linear_model)
