"""Bioreactor (CSTR) process model on stacked ``(5, ...)`` tensors.

Counterpart of ``gpu_se_tpu/models/bioreactor.py``. States
``[Cg, Cx, Cfa, Ce, Ch]`` ride the leading axis, anything after it is a
batch (the particle filter passes ``(5, n)``). The arithmetic is the
reference's, op for op and in the same order, so float32 results agree
bit for bit with the reference's eager ``xp=jnp`` path, on the CPU and
on a CUDA card; ``max(x, 0)`` becomes ``torch.clamp_min`` because the
reference's ``xp.maximum(tensor, 0.0)`` does not accept a torch tensor.
"""
from __future__ import annotations

import numpy as np
import torch

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


def homeostatic_des(x: torch.Tensor, u: torch.Tensor, dt=1.0) -> torch.Tensor:
    """Low-nitrogen production-phase state deltas ``f(x, u) * dt``.

    ``x`` is ``(5, ...)``, ``u`` is ``(2,)`` ``[Fg_in, Fm_in]``; returns
    the state change over ``dt`` with the shape of ``x``.
    """
    Cg, Cx, Cfa, Ce, Ch = x[0], x[1], x[2], x[3], x[4]
    Cg = torch.clamp_min(Cg, 0.0)
    Cx = torch.clamp_min(Cx, 0.0)
    Cfa = torch.clamp_min(Cfa, 0.0)
    Ce = torch.clamp_min(Ce, 0.0)

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
        r_theta1_max, torch.clamp_min(r_theta1_req, 0.0)
    ) * (Cg / (1e-2 + Cg))

    r_E_max = 0.025 / 46.0 * Cx * 24.6 * V
    rE_req = r_theta1_req - r_theta1_max
    rE = torch.minimum(r_E_max, torch.clamp_min(rE_req, 0.0))

    r_theta2_max = (0.1 - 0.025) / 180.0 * Cx * 24.6 * V
    r_theta2_req = r_theta1_req - r_theta1_max - rE
    r_theta2 = torch.minimum(r_theta2_max, torch.clamp_min(r_theta2_req, 0.0))

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
    Cg = torch.clamp_min(x[0], 0.0)
    Cx = torch.clamp_min(x[1], 0.0)
    Cfa = torch.clamp_min(x[2], 0.0)
    Ce = torch.clamp_min(x[3], 0.0)

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
    """All states scaled to mass concentrations; ``x`` is ``(5, ...)``."""
    masses = torch.as_tensor(MOLAR_MASSES, dtype=x.dtype, device=x.device)
    return x * masses.reshape((5,) + (1,) * (x.dim() - 1))


def euler_step(x: torch.Tensor, u: torch.Tensor, dt, high_n: bool = False):
    """One explicit-Euler plant step with the ``>= 0`` clip on the first
    four states."""
    if high_n:
        dx = high_n_des(x, u) * dt
    else:
        dx = homeostatic_des(x, u, dt)
    x_new = x + dx
    return torch.cat([torch.clamp_min(x_new[:4], 0.0), x_new[4:]])
