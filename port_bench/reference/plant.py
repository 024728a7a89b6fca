"""The bioreactor plant, written out again for the benchmark.

A frozen copy of the low-nitrogen (homeostatic) model that the port's
``models/bioreactor.py`` implements, so that no change to the program
moves the traffic or the reference. The arithmetic takes whatever the
caller passes: Python floats (the host trajectory), numpy arrays or
torch tensors (the reference's particles, float64). ``mx0`` and ``mn``
are the ``max(., 0)`` and ``min`` of that kind of number.

States ``[Cg, Cx, Cfa, Ce, Ch]`` (mol/L), inputs ``[Fg_in, Fm_in]``
(L/min); the measurement is ``[Cg * 180, Cfa * 116]`` (mg/L).
"""
from __future__ import annotations

import numpy as np
import scipy.optimize

MOLAR_MASSES = (180.0, 24.6, 116.0, 46.0, 1.0)
# the measured states and their masses
MEASURED = (0, 2)


def _float_ops():
    return (lambda v: v if v > 0.0 else 0.0), min


def _numpy_ops():
    return (lambda v: np.maximum(v, 0.0)), np.minimum


def torch_ops():
    import torch

    return (lambda v: torch.clamp_min(v, 0.0)), torch.minimum


def deltas(x, u, dt, ops=None):
    """The state change over ``dt``: ``f(x, u) * dt`` as a list of five,
    each of the shape of ``x[i]``."""
    mx0, mn = ops if ops is not None else _float_ops()
    cg, cx, cfa, ce, ch = x[0], x[1], x[2], x[3], x[4]
    cg, cx, cfa, ce = mx0(cg), mx0(cx), mx0(cfa), mx0(ce)
    fg, fm = u[0], u[1]
    f_out = fg + fm
    cg_in = 5000.0 / 180.0
    monod = cg / (1e-2 + cg)

    r_h = 280.0 / 180.0 - cg
    r_fa = 0.25 / 116.0 * cx * 24.6 * monod
    t1_max = (0.4 - 0.25) / 180.0 * cx * 24.6
    t1_req = t1_max - ((t1_max / 2000.0) / (0.28 / 180.0) * r_h + 0.01 * ch)
    t1 = mn(t1_max, mx0(t1_req)) * monod
    e_max = 0.025 / 46.0 * cx * 24.6
    r_e = mn(e_max, mx0(t1_req - t1_max))
    t2_max = (0.1 - 0.025) / 180.0 * cx * 24.6
    t2 = mn(t2_max, mx0(t1_req - t1_max - r_e))
    r_g = -r_fa * (116.0 / 180.0) - t1 - r_e * (46.0 / 180.0) - t2

    return [
        (fg * cg_in - f_out * cg + r_g) * dt,
        0.0 * cx * dt,
        (-f_out * cfa + r_fa) * dt,
        (-f_out * ce + r_e) * dt,
        r_h * dt,
    ]


def euler(x, u, dt, ops=None):
    """One explicit Euler step with the first four states clipped at 0."""
    mx0, _ = ops if ops is not None else _float_ops()
    d = deltas(x, u, dt, ops)
    return [mx0(x[i] + d[i]) if i < 4 else x[i] + d[i] for i in range(5)]


def measure(x):
    """``[Cg * 180, Cfa * 116]``."""
    return [x[0] * 180.0, x[2] * 116.0]


def steady_state(u, x_guess):
    """The steady state near ``x_guess`` with the biomass held at
    ``x_guess[1]``, by ``scipy.optimize.fsolve`` in float64."""
    u = np.asarray(u, dtype=float)
    x_guess = np.asarray(x_guess, dtype=float)

    def residual(x):
        x = np.array(x, dtype=float)
        x[1] = x_guess[1]
        return np.array(deltas(x, u, 1.0, _numpy_ops()))

    x = np.asarray(scipy.optimize.fsolve(residual, x_guess), dtype=float)
    x[1] = x_guess[1]
    return x


def jacobians(x_bar, u_bar, h=1e-6):
    """``(A, B)`` of ``dx/dt`` at ``(x_bar, u_bar)`` by central
    differences in float64 (a kink's slope comes out as the mean of its
    two sides)."""
    ops = _numpy_ops()
    x_bar = np.asarray(x_bar, dtype=float)
    u_bar = np.asarray(u_bar, dtype=float)

    def f(x, u):
        return np.array(deltas(x, u, 1.0, ops), dtype=float)

    def columns(vec, put):
        cols = []
        for k in range(vec.size):
            step = h * max(1.0, abs(vec[k]))
            hi, lo = vec.copy(), vec.copy()
            hi[k] += step
            lo[k] -= step
            cols.append((put(hi) - put(lo)) / (2 * step))
        return np.array(cols).T

    a = columns(x_bar, lambda x: f(x, u_bar))
    b = columns(u_bar, lambda u: f(x_bar, u))
    return a, b
