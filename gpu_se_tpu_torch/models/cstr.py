"""Exothermic CSTR model with a closed-form linearization.

Counterpart of ``gpu_se_tpu/models/cstr.py``, the plant whose analytic
Jacobians check the linearizer:

    dCa/dt = F/V (Ca0 - Ca) - k0 exp(-E/(R T)) Ca
    dT/dt  = F/V (Ta0 - T) - dH/(rho Cp) k0 exp(-E/(R T)) Ca + Q/(rho Cp V)

with output y = Ca. The pure functions take an array module ``xp``:
``torch`` for the linearizer's hooks, ``numpy`` for the host plant.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch.models.base import NonlinearModel

V, CA0, DH, E, RHO, R_GAS, TA0, K0, CP, F = (
    5.0, 1.0, -4.78e4, 8.314e4, 1e3, 8.314, 310.0, 72e7, 0.239, 0.1,
)


def cstr_des(x, u, xp=torch):
    """Pure state derivatives for states [Ca, T], input [Q]."""
    Ca, T = x[0], x[1]
    Q = u[0]
    k = K0 * xp.exp(-E / (R_GAS * T))
    dCa = F / V * (CA0 - Ca) - k * Ca
    dT = F / V * (TA0 - T) - DH / (RHO * CP) * k * Ca + Q / (RHO * CP * V)
    return xp.stack([dCa, dT])


def cstr_outputs(x, u, xp=torch):
    """Output: concentration Ca."""
    del u
    return xp.stack([x[0]])


def analytic_jacobians(x_bar, u_bar):
    """Closed-form continuous (A, B, C, D) at an operating point."""
    Ca, T = np.asarray(x_bar, dtype=float)
    del u_bar
    k = K0 * np.exp(-E / (R_GAS * T))
    A = np.array(
        [
            [-F / V - k, -k * Ca * E / (R_GAS * T**2)],
            [
                -DH / (RHO * CP) * k,
                -F / V - k * Ca * DH / (RHO * CP) * E / (R_GAS * T**2),
            ],
        ]
    )
    B = np.array([[0.0], [1.0 / (RHO * CP * V)]])
    C = np.array([[1.0, 0.0]])
    D = np.array([[0.0]])
    return A, B, C, D


class CSTRModel(NonlinearModel):
    """Stateful shell over the pure CSTR functions."""

    def __init__(self, X0, t=0.0):
        self.X = np.array(X0, dtype=float)
        self.t = float(t)

    def DEs(self, inputs):
        return cstr_des(self.X, np.asarray(inputs, dtype=float), xp=np)

    def outputs(self, inputs):
        return cstr_outputs(self.X, inputs, xp=np)

    def des(self, x, u):
        return cstr_des(x, u)

    def out(self, x, u):
        return cstr_outputs(x, u)
