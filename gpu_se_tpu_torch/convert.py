"""Carry the reference package's parameters and state into the port.

The reference's objects arrive as numpy arrays (``np.asarray`` of each
field), so this module needs neither package's internals.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch.control.qp import QPConstants
from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.filters.gs_ukf import GSUKFState
from gpu_se_tpu_torch.filters.particle import PFState
from gpu_se_tpu_torch.filters.particle_tiled import (
    TiledPFState,
    untile_from_jax,
)


def gaussian_sum_from_numpy(means, covariances, weights, chol, inv_cov,
                            log_const, device="cuda") -> GaussianSum:
    """A :class:`GaussianSum` holding exactly the given float32 fields,
    so both sides use identical factors."""
    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GaussianSum(dev(means), dev(covariances), dev(weights),
                       dev(chol), dev(inv_cov), dev(log_const))


def tiled_state_from_numpy(tiled, nx: int,
                           generator: torch.Generator) -> TiledPFState:
    """The reference's ``(t_data, 1024)`` tiled state as a
    :class:`TiledPFState` on the generator's device."""
    x = untile_from_jax(np.asarray(tiled), nx).to(generator.device)
    return TiledPFState(x=x, generator=generator)


def pf_state_from_numpy(particles, weights,
                        generator: torch.Generator) -> PFState:
    """The reference's flat ``PFState`` fields (``particles (n, nx)``,
    ``weights (n,)``) as a :class:`PFState` on the generator's device,
    drawing from ``generator``."""
    def dev(a):
        return torch.tensor(np.asarray(a), device=generator.device)

    return PFState(dev(particles), dev(weights), generator)


def gsukf_state_from_numpy(means, covariances, weights,
                           generator: torch.Generator) -> GSUKFState:
    """The reference's ``GSUKFState`` fields (``means (N, nx)``,
    ``covariances (N, nx, nx)``, ``weights (N,)``) as a
    :class:`GSUKFState` on the generator's device, drawing from
    ``generator``."""
    def dev(a):
        return torch.tensor(np.asarray(a), device=generator.device)

    return GSUKFState(dev(means), dev(covariances), dev(weights), generator)


def qp_constants_from_numpy(device="cuda", **leaves) -> QPConstants:
    """A :class:`QPConstants` holding exactly the reference's
    ``QPConstants`` leaves, given by field name as numpy arrays (float32:
    the reference runs with x64 off), so both solvers use identical
    constants."""
    return QPConstants(**{
        name: torch.tensor(np.asarray(leaf), device=device)
        for name, leaf in leaves.items()})
