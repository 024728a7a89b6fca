"""Bioreactor (CSTR) process model on stacked ``(5, ...)`` tensors.

Counterpart of ``gpu_se_tpu/models/bioreactor.py``. States
``[Cg, Cx, Cfa, Ce, Ch]`` ride the leading axis, anything after it is a
batch (the particle filter passes ``(5, n)``). The arithmetic is the
reference's, op for op and in the same order, so float32 results agree
bit for bit with the reference's eager ``xp=jnp`` path, on the CPU and
on a CUDA card; ``max(x, 0)`` becomes ``torch.clamp_min`` because the
reference's ``xp.maximum(tensor, 0.0)`` does not accept a torch tensor.

The :class:`Bioreactor` shell runs the host plant in float64 numpy
through these functions on CPU float64 tensors, and gives the linearizer
its pure ``des``/``out`` hooks. The hooks take ``max(x, 0)`` by
``torch.maximum``, whose forward derivative at a tie is 1/2, as
``jax.jacfwd``'s of ``jnp.maximum`` is; ``torch.clamp_min``'s is 1. The
canonical linearization point has ``Ce = 0`` exactly, where the two part.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from gpu_se_tpu_torch.models.base import NonlinearModel

# Molar masses of [glucose, biomass, fumaric acid, ethanol, H+] (g/mol)
MOLAR_MASSES = np.array([180.0, 24.6, 116.0, 46.0, 1.0])

_GAMMA, _BETA = 1.8, 0.1
# Stoichiometric rate matrix for the high-N growth regime
_RATE_MATRIX = np.array(
    [
        [1, 0, 0, 0, 0],
        [0, 0, 0, 1, 0],
        [0, 0, 0, 0, 1],
        [-6, 4, 7 / 3, 2, -6 * _GAMMA],
        [0, 12, -1, 0, 6 * _BETA],
    ]
)
_RATE_MATRIX_INV = np.linalg.inv(_RATE_MATRIX)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` by true division on every device. PyTorch's CUDA kernel
    multiplies by the reciprocal of a host-scalar divisor, which can be
    an ulp off the quotient; a divisor on the device takes the exact
    path. (Division by ``V = 1.0`` is exact either way.)"""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _clamp0(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0)


def _max0(v: torch.Tensor) -> torch.Tensor:
    """``max(v, 0)`` by ``torch.maximum``: the value of :func:`_clamp0`,
    and a forward derivative of 1/2 at ``v == 0``."""
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


def homeostatic_des(x: torch.Tensor, u: torch.Tensor, dt=1.0) -> torch.Tensor:
    """Low-nitrogen production-phase state deltas ``f(x, u) * dt``.

    ``x`` is ``(5, ...)``, ``u`` is ``(2,)`` ``[Fg_in, Fm_in]``; returns
    the state change over ``dt`` with the shape of ``x``.
    """
    return _homeostatic(x, u, dt, _clamp0)


def _homeostatic(x, u, dt, max0):
    """:func:`homeostatic_des` with ``max(., 0)`` taken by ``max0``."""
    Cg, Cx, Cfa, Ce, Ch = x[0], x[1], x[2], x[3], x[4]
    Cg = max0(Cg)
    Cx = max0(Cx)
    Cfa = max0(Cfa)
    Ce = max0(Ce)

    Fg_in, Fm_in = u[0], u[1]
    Cg_in = 5000.0 / 180.0
    F_out = Fg_in + Fm_in

    V = 1.0  # L

    rX = 0.0 * Cx
    rH = 280.0 / 180.0 - Cg

    # (molFA/min) = (gFA/gX/min)(molFA/gFA)(molX/Lv)(gX/molX)(Lv)
    rFA_max = 0.25 / 116.0 * Cx * 24.6 * V
    rFA = rFA_max * (Cg / (1e-2 + Cg))

    r_theta1_max = (0.4 - 0.25) / 180.0 * Cx * 24.6 * V
    r_theta1_req = r_theta1_max - (
        _div(_div(r_theta1_max, 2000.0), 0.28 / 180.0) * rH + 0.01 * Ch
    )
    r_theta1 = torch.minimum(
        r_theta1_max, max0(r_theta1_req)
    ) * (Cg / (1e-2 + Cg))

    r_E_max = 0.025 / 46.0 * Cx * 24.6 * V
    rE_req = r_theta1_req - r_theta1_max
    rE = torch.minimum(r_E_max, max0(rE_req))

    r_theta2_max = (0.1 - 0.025) / 180.0 * Cx * 24.6 * V
    r_theta2_req = r_theta1_req - r_theta1_max - rE
    r_theta2 = torch.minimum(r_theta2_max, max0(r_theta2_req))

    rG = -rFA * (116.0 / 180.0) - r_theta1 - rE * (46.0 / 180.0) - r_theta2

    dCg = (Fg_in * Cg_in - F_out * Cg + rG) / V * dt
    dCx = rX / V * dt
    dCfa = (-F_out * Cfa + rFA) / V * dt
    dCe = (-F_out * Ce + rE) / V * dt
    dCh = rH / V * dt

    return torch.stack([dCg, dCx, dCfa, dCe, dCh])


def high_n_des(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """High-nitrogen growth-phase state derivatives ``dx/dt``.

    The rate-matrix product contracts the leading axis, so any batch
    shape after it works (the reference's ``@`` takes ``(5,)`` or
    ``(5, n)``).
    """
    return _high_n(x, u, _clamp0)


def _high_n(x, u, max0):
    """:func:`high_n_des` with ``max(., 0)`` taken by ``max0``."""
    Cg = max0(x[0])
    Cx = max0(x[1])
    Cfa = max0(x[2])
    Ce = max0(x[3])

    Fg_in, Fm_in = u[0], u[1]
    Cg_in = 5000.0 / 180.0
    F_out = Fg_in + Fm_in
    V = 1.0

    monod = Cg / (1.0 + Cg)
    rhs = torch.stack(
        [_div(monod, 230.0), _div(monod, 12.0), _div(monod, 21.0),
         1.1 * monod, 0.0 * monod]
    )
    rate_inv = torch.as_tensor(_RATE_MATRIX_INV, dtype=x.dtype, device=x.device)
    rFAf, rTCA, rResp, rEf, rX = torch.tensordot(rate_inv, rhs, dims=1)

    rG = (-rFAf - rTCA - rEf - rX) * Cx * V
    rXs = 6.0 * rX * Cx * V
    rFA = 2.0 * rFAf * Cx * V
    rE = 2.0 * rEf * Cx * V

    dCg = (Fg_in * Cg_in - F_out * Cg + rG) / V
    dCx = rXs / V
    dCfa = (-F_out * Cfa + rFA) / V
    dCe = (-F_out * Ce + rE) / V
    dCh = 0.0 * Cg
    return torch.stack([dCg, dCx, dCfa, dCe, dCh])


def static_outputs(x: torch.Tensor, u=None) -> torch.Tensor:
    """Measurement function: glucose and fumaric-acid masses (mg/L),
    ``(2, ...)``."""
    del u
    return torch.stack([x[0] * 180.0, x[2] * 116.0])


def all_outputs(x: torch.Tensor) -> torch.Tensor:
    """All states scaled to mass concentrations; ``x`` is ``(5, ...)``.
    Each row times its mass as a host scalar: no copy from the host, so
    a CUDA graph can capture it."""
    return torch.stack([x[i] * m
                        for i, m in enumerate(MOLAR_MASSES.tolist())])


def euler_step(x: torch.Tensor, u: torch.Tensor, dt, high_n: bool = False):
    """One explicit-Euler plant step with the ``>= 0`` clip on the first
    four states."""
    if high_n:
        dx = high_n_des(x, u) * dt
    else:
        dx = homeostatic_des(x, u, dt)
    x_new = x + dx
    return torch.cat([torch.clamp_min(x_new[:4], 0.0), x_new[4:]])


# ----------------------------------------------------------------------
def _host(fn, *args) -> np.ndarray:
    """``fn`` of float64 numpy arguments, through CPU float64 tensors."""
    return fn(*(torch.as_tensor(np.asarray(a, dtype=np.float64))
                for a in args)).numpy()


class Bioreactor(NonlinearModel):
    """Stateful bioreactor shell over the regime functions, with the
    reference's constructor surface. The plant (``DEs``, ``step``,
    ``outputs``) is host float64 numpy; ``des`` and ``out`` are the
    linearizer's torch hooks."""

    def __init__(self, X0, t=0.0, high_N=True):
        self.X = np.array(X0, dtype=float)
        self.t = float(t)
        self.high_N = high_N

    def DEs(self, inputs):
        if self.high_N:
            return _host(high_n_des, self.X, inputs)
        return _host(homeostatic_des, self.X, inputs)

    def step(self, dt, inputs):
        self.t += dt
        self.X = self.X + self.DEs(inputs) * dt
        self.X[:4] = np.maximum(self.X[:4], 0.0)

    def outputs(self, inputs):
        del inputs
        return self.X * MOLAR_MASSES

    def raw_outputs(self, inputs):
        del inputs
        return self.X

    def des(self, x, u):
        if self.high_N:
            return _high_n(x, u, _max0)
        return _homeostatic(x, u, 1.0, _max0)

    def out(self, x, u):
        del u
        return all_outputs(x)

    # ------------------------------------------------------------------
    @staticmethod
    def homeostatic_DEs(x, u, dt=1.0):
        """Reference-named alias: the filters' ``f``."""
        return homeostatic_des(x, u, dt)

    @staticmethod
    def static_outputs(x, u):
        """Reference-named alias: the filters' ``g``."""
        return static_outputs(x, u)

    @staticmethod
    def find_SS(U_op, X0):
        """Steady state of the low-N regime near ``X0`` with the biomass
        ``X0[1]`` held fixed: one ``scipy.optimize.fsolve`` from ``X0``."""
        U_op = np.asarray(U_op, dtype=float)
        X0 = np.asarray(X0, dtype=float)

        def fun(x_ss):
            x = np.array(x_ss, dtype=float)
            x[1] = X0[1]
            return _host(homeostatic_des, x, U_op)

        res = np.asarray(scipy.optimize.fsolve(fun, X0), dtype=float)
        res[1] = X0[1]
        return res
