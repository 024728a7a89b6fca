"""Carry the reference package's parameters and state into the port.

The reference's objects arrive as numpy arrays (``np.asarray`` of each
field), so this module needs neither package's internals.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.filters.particle_tiled import (
    TiledPFState,
    untile_from_jax,
)


def gaussian_sum_from_numpy(means, covariances, weights, chol, inv_cov,
                            log_const, device="cpu") -> GaussianSum:
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
