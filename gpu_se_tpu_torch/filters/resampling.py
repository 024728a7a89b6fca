"""Plain systematic resampling in PyTorch: the oracles for the kernels.

Counterpart of ``systematic_positions``, ``systematic_resample_indices``
and ``sorted_row_gather`` in ``gpu_se_tpu/filters/resampling.py``.
``idx[i]`` is the smallest ``k`` with ``cs_k >= (i + r) / n``, ``cs`` the
cumsum normalized by its last entry, computed through the same
monotonized integer ``ends`` as the kernels.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops.resample_coarse import (
    ends_from_weights,
    indices_from_ends,
)


def systematic_positions(n: int, r, device="cpu") -> torch.Tensor:
    """Stratified positions ``u_i = (i + r) / n`` for a single uniform r."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i + r) / n


def systematic_resample_indices(weights: torch.Tensor, r) -> torch.Tensor:
    """(n,) int32 ancestor indices for systematic resampling."""
    return indices_from_ends(ends_from_weights(weights, r))


def sorted_row_gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``a[idx]`` for in-bounds ``idx``."""
    return torch.index_select(a, 0, idx.to(torch.int64))
