"""Monotonized integer segment ends, the input of every resample kernel.

Counterpart of ``ends_from_weights`` and ``indices_from_ends`` in
``gpu_se_tpu/ops/resample_coarse.py``. Particle ``k`` parents the output
slots ``(ends_{k-1}, ends_k]``, so the ancestor of slot ``i`` is
``#{k : ends_k < i}``.

The float32 cumsum is the one step whose rounding depends on the
implementation: the reference's and torch's cumsums round differently,
which moves ``ends`` by one at the few entries that sit on a slot
boundary. Everything downstream of ``ends`` is exact integer logic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SCAN_ROW = 1024


def _rows(v: torch.Tensor) -> torch.Tensor:
    """``v (n,)`` zero-padded at the end to whole rows of ``SCAN_ROW``."""
    m = -(-v.shape[0] // SCAN_ROW)
    return F.pad(v, (0, m * SCAN_ROW - v.shape[0])).reshape(m, SCAN_ROW)


def blocked_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Float32 inclusive cumsum of ``w (n,)`` that gives the same bits on
    every run, on the CPU and on a CUDA card.

    ``torch.cumsum`` of a 1-d CUDA tensor runs a decoupled look-back scan
    whose float association depends on timing, so ``ends`` would move at
    ties from run to run. A scan along the last dim of a 2-d tensor of
    two or more rows runs in a fixed order; so this scans rows of
    ``SCAN_ROW`` entries, then the row totals (as one row of two, beside
    a zero row), and adds each row's exclusive offset.
    """
    local = torch.cumsum(_rows(w), dim=1)
    totals = local[:, -1]
    incl = torch.cumsum(torch.stack([totals, torch.zeros_like(totals)]),
                        dim=1)[0]
    offsets = torch.cat([incl.new_zeros(1), incl[:-1]])
    return (local + offsets[:, None]).reshape(-1)[:w.shape[0]]


def blocked_cummax(e: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of the int32 ``e (n,)``, exact.

    ``torch.cummax`` of a 1-d CUDA tensor scans it as one row, in one
    thread block. This scans rows of ``SCAN_ROW`` entries in parallel,
    then the row maxima, and takes each row's max with the maxima of
    the rows before it.
    """
    local = torch.cummax(_rows(e), dim=1).values
    incl = torch.cummax(local[:, -1], dim=0).values
    before = torch.cat(
        [incl.new_full((1,), torch.iinfo(e.dtype).min), incl[:-1]])
    return torch.maximum(local, before[:, None]).reshape(-1)[:e.shape[0]]


def ends_from_weights(weights: torch.Tensor, r) -> torch.Tensor:
    """``clamp(cummax(floor(n * cs - r)), -1, n - 1)`` as int32, with
    ``cs`` the float32 cumsum of ``weights`` (:func:`blocked_cumsum`)
    divided by its last entry and ``r`` a float32 uniform in ``[0, 1)``.
    """
    n = weights.shape[0]
    cumsum = blocked_cumsum(weights)
    cumsum = cumsum / cumsum[-1]
    ends = torch.floor(n * cumsum - r).to(torch.int32)
    return torch.clamp(blocked_cummax(ends), -1, n - 1)


def indices_from_ends(ends: torch.Tensor) -> torch.Tensor:
    """Ancestor indices ``#{k : ends_k < i}`` for every slot ``i``: a
    sorted search of the slot numbers in the non-decreasing ``ends``."""
    slots = torch.arange(ends.shape[0], dtype=ends.dtype, device=ends.device)
    return torch.searchsorted(ends, slots, right=False).to(torch.int32)
