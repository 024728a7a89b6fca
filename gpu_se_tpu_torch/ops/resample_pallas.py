"""The v1 merge resample entry.

Counterpart of ``gpu_se_tpu/ops/resample_pallas.py``, whose synchronous
Pallas ``_kernel`` computes the same function as the v3 kernel; both are
replaced by the CUDA kernel :func:`~gpu_se_tpu_torch.ops.resample_pallas3.cumsum_merge`.
This entry keeps v1's default geometry.

Reference names. The reference module's entry point and the function
that takes its place here:

- ``pallas_systematic_resample`` -> :func:`systematic_resample`:
  ``(particles, weights, r, block_slots)`` in the reference's order; no
  ``window`` or ``interpret``. Aliased.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops.resample_pallas3 import merge_entry


def systematic_resample(particles: torch.Tensor, weights: torch.Tensor, r,
                        block_slots: int = 512):
    """Fused systematic resample: returns ``(resampled (n, nx) float32,
    ancestors (n,) int32)``; ``n`` must be a multiple of
    ``block_slots``."""
    return merge_entry(particles, weights, r, block_slots)


# the reference's name: a call with its positional arguments gives the
# same result here
pallas_systematic_resample = systematic_resample
