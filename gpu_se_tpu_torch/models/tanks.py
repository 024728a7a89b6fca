"""Simple tank plants for closed-loop MPC tests.

Counterpart of ``gpu_se_tpu/models/tanks.py``, with the same plants: in
``DiagTank`` the second tank is nonlinear, as in the reference. The pure
functions take an array module ``xp``: ``torch`` for the linearizer's
hooks, ``numpy`` for the host plant.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch.models.base import NonlinearModel


def tank_des(x, u, linear=False, xp=torch):
    """Single tank: dh = (F_in - k sqrt(h A)) / A (or linear k h A)."""
    h = x[0]
    F_in = u[0]
    k, A = 0.1, 2.0
    if linear:
        dh = (F_in - k * h * A) / A
    else:
        dh = (F_in - k * xp.sqrt(h * A)) / A
    return xp.stack([dh])


def diag_tank_des(x, u, xp=torch):
    """Two decoupled tanks: tank 1 linear, tank 2 nonlinear."""
    d1 = tank_des(x[0:1], u[0:1], linear=True, xp=xp)
    d2 = tank_des(x[1:2], u[1:2], linear=False, xp=xp)
    return xp.concatenate([d1, d2])


def linked_tanks_des(x, u, linear=False, xp=torch):
    """Two coupled tanks."""
    h1, h2 = x[0], x[1]
    F1_in, F2_in = u[0], u[1]
    k1, k2, k_link = 0.1, 0.3, 0.05
    A1, A2 = 2.0, 8.0
    F_1to2 = k_link * (h1 - h2)
    if linear:
        dh1 = (F1_in - k1 * h1 * A1 - F_1to2) / A1
    else:
        dh1 = (F1_in - k1 * xp.sqrt(h1 * A1) + F_1to2) / A1
    dh2 = (F2_in - k2 * h2 * A2) / A2
    return xp.stack([dh1, dh2])


class TankModel(NonlinearModel):
    def __init__(self, X0, t0=0.0, linear=False):
        self.X = np.array(X0, dtype=float)
        self.t = float(t0)
        self.linear = linear

    def DEs(self, inputs):
        return tank_des(self.X, np.asarray(inputs, dtype=float), self.linear,
                        xp=np)

    def outputs(self, inputs):
        del inputs
        return np.array(self.X[:1])

    def des(self, x, u):
        return tank_des(x, u, self.linear)

    def out(self, x, u):
        del u
        return x[:1]


class DiagTank(NonlinearModel):
    def __init__(self, X0, t0=0.0):
        self.X = np.array(X0, dtype=float)
        self.t = float(t0)

    def DEs(self, inputs):
        return diag_tank_des(self.X, np.asarray(inputs, dtype=float), xp=np)

    def outputs(self, inputs):
        del inputs
        return np.array(self.X)

    def des(self, x, u):
        return diag_tank_des(x, u)

    def out(self, x, u):
        del u
        return x


class LinkedTanks(NonlinearModel):
    def __init__(self, X0, t0=0.0, linear=False):
        self.X = np.array(X0, dtype=float)
        self.t = float(t0)
        self.linear = linear

    def DEs(self, inputs):
        return linked_tanks_des(self.X, np.asarray(inputs, dtype=float),
                                self.linear, xp=np)

    def outputs(self, inputs):
        del inputs
        return np.array(self.X)

    def des(self, x, u):
        return linked_tanks_des(x, u, self.linear)

    def out(self, x, u):
        del u
        return x
