"""Monotonized integer segment ends, the input of every resample kernel,
and the coarse-window resample through a hand-written CUDA kernel.

Counterpart of ``gpu_se_tpu/ops/resample_coarse.py``. Particle ``k``
parents the output slots ``(ends_{k-1}, ends_k]``, so the ancestor of
slot ``i`` is ``#{k : ends_k < i}``.

The float32 cumsum is the one step whose rounding depends on the
implementation: the reference's and torch's cumsums round differently,
which moves ``ends`` by one at the few entries that sit on a slot
boundary. Everything downstream of ``ends`` is exact integer logic.

The kernel, :func:`coarse_gather` (``csrc/resample_coarse.cu``),
replaces the file's Pallas ``_kernel``: output chunk ``c`` of
:data:`BLOCK` slots draws only from the source rows between the chunk
boundaries ``o_c = #{k : ends_k < c * BLOCK}`` and ``o_{c+1}``. Each
CUDA block takes a run of chunks, knows its keys from two entries of
``o``, stages them and merges them with its slots; a block with more
keys than it stages searches device memory instead. The TPU kernel's
window is fixed, so the reference falls back to the XLA path when a
chunk's span overflows it; the CUDA kernel takes every input, and
:func:`coarse_systematic_resample` has no fallback. The wrapper takes
its plain version for CPU tensors and launches the kernel for CUDA
tensors; ``coarse_gather.launches`` counts launches.

Reference names. The reference module's kernel entry and the function
that takes its place here (no alias: their arguments differ):

- ``coarse_kernel`` -> :func:`coarse_gather`: ``(ends, o, payload)``
  with ``ends`` int32 and ``payload`` the ``(rows, n)`` float32 rows,
  where the reference takes ``(p8t, o, n, interpret)`` with ``p8t`` the
  packed ``(8, n)`` rows and ``ends`` as float32 in row 6. Returns
  ``(out (rows, n), anc)`` where the reference returns ``(out_t (8, n),
  anc)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.pytree import tree_flatten

SCAN_ROW = 1024
BLOCK = 128          # output slots per chunk
CPS = 16             # chunks per grid step of the reference kernel
MAX_COLS = 6         # payload columns the reference kernel carries


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
    """Inclusive running max of the integer or float ``e (n,)``, exact.

    ``torch.cummax`` of a 1-d CUDA tensor scans it as one row, in one
    thread block. This scans rows of ``SCAN_ROW`` entries in parallel,
    then the row maxima, and takes each row's max with the maxima of
    the rows before it (the first row's with the identity: the type's
    minimum, or ``-inf``).
    """
    local = torch.cummax(_rows(e), dim=1).values
    incl = torch.cummax(local[:, -1], dim=0).values
    identity = (-math.inf if e.dtype.is_floating_point
                else torch.iinfo(e.dtype).min)
    before = torch.cat([incl.new_full((1,), identity), incl[:-1]])
    return torch.maximum(local, before[:, None]).reshape(-1)[:e.shape[0]]


def ends_from_weights(weights: torch.Tensor, r) -> torch.Tensor:
    """``clamp(cummax(floor(n * cs - r)), -1, n - 1)`` as int32, with
    ``cs`` the float32 cumsum of ``weights`` (:func:`blocked_cumsum`)
    divided by its last entry and ``r`` a float32 uniform in ``[0, 1)``;
    then the run of entries tied with the last raised to ``n - 1``.

    Finite weights end at ``n - 1`` already. Weights that sum to 0 (or
    overflow) give a NaN cumsum, which converts to 0 as the reference's
    XLA converts it, so ``ends`` stops short of ``n - 1``; the reference's
    scatter and cummax then give every slot past ``ends[-1]`` the first
    entry of the last run. Raising that run to ``n - 1`` gives the same
    ancestors through ``#{k : ends_k < i}``, the contract of every
    gather kernel and plain version.
    """
    n = weights.shape[0]
    cumsum = blocked_cumsum(weights)
    cumsum = cumsum / cumsum[-1]
    ends = torch.floor(n * cumsum - r)
    # to int32 as the reference's XLA converts: NaN to 0, out of range
    # saturated; the clamp commutes with the cummax
    ends = torch.clamp(torch.nan_to_num(ends, nan=0.0), -1, n - 1)
    ends = blocked_cummax(ends.to(torch.int32))
    return torch.where(ends == ends[-1:], n - 1, ends)


def indices_from_ends(ends: torch.Tensor) -> torch.Tensor:
    """Ancestor indices ``#{k : ends_k < i}`` for every slot ``i``: a
    sorted search of the slot numbers in the non-decreasing ``ends``."""
    slots = torch.arange(ends.shape[0], dtype=ends.dtype, device=ends.device)
    return torch.searchsorted(ends, slots, right=False).to(torch.int32)


# ----------------------------------------------------------------------
# the coarse-window kernel and its plain version
# ----------------------------------------------------------------------
def chunk_boundaries(ends: torch.Tensor, n: int, b: int = BLOCK):
    """``o_c = #{k : ends_k < c * b}`` for ``c = 0 .. n / b``, int32."""
    qs = torch.arange(0, n + b, b, dtype=torch.int32, device=ends.device)
    return torch.searchsorted(ends, qs, out_int32=True)


def coarse_gather_plain(ends, o, payload):
    """Plain version of :func:`coarse_gather`."""
    anc = indices_from_ends(ends).clamp_max_(ends.shape[0] - 1)
    return torch.index_select(payload, 1, anc), anc


def coarse_gather(ends: torch.Tensor, o: torch.Tensor, payload: torch.Tensor):
    """Ancestors of every slot by a merge of its chunk's window of
    ``ends`` with the chunk's slots, and the payload's columns gathered
    by them.

    ``ends`` int32 ``(n,)`` non-decreasing, ``n`` a multiple of
    :data:`BLOCK`; ``o`` int32 ``(n / BLOCK + 1,)`` its
    :func:`chunk_boundaries`; ``payload`` float32 ``(rows, n)``. Returns
    ``out (rows, n)`` with ``out[:, i] = payload[:, anc_i]`` (an exact
    copy) and ``anc (n,)`` int32, ``anc_i = min(#{k : ends_k < i}, n -
    1)``.
    """
    dev = ends.device
    _build.check("ends", ends, torch.int32, 1, dev)
    _build.check("o", o, torch.int32, 1, dev)
    _build.check("payload", payload, torch.float32, 2, dev)
    n = ends.shape[0]
    if n == 0 or n % BLOCK or o.shape[0] != n // BLOCK + 1 \
            or payload.shape[1] != n:
        raise ValueError(f"ends ({n},), o {tuple(o.shape)}, payload "
                         f"{tuple(payload.shape)}: n must be a positive "
                         f"multiple of {BLOCK}")
    if not _build.on_cuda(ends):
        return coarse_gather_plain(ends, o, payload)
    lib = _build.load_library()
    rows = payload.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    anc = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_coarse_gather(
            ends.data_ptr(), o.data_ptr(), payload.data_ptr(), rows, n,
            out.data_ptr(), anc.data_ptr(), _build.stream(dev))
    _build.launch_check("coarse_gather", rc)
    coarse_gather.launches += 1
    return out, anc


coarse_gather.launches = 0


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------
def coarse_applicable(tree, n: int) -> bool:
    """The reference's gate: every leaf ``(n, ...)`` of a float32-exact
    dtype, at most :data:`MAX_COLS` columns in all, ``n`` a multiple of
    ``BLOCK * CPS`` and at least 2^13."""
    from gpu_se_tpu_torch.filters.resampling import f32_exact_dtype

    leaves = tree_flatten(tree)[0]
    if not leaves:
        return False
    total = 0
    for leaf in leaves:
        if leaf.dim() < 2 or leaf.shape[0] != n:
            return False
        if not f32_exact_dtype(leaf.dtype):
            return False
        total += math.prod(leaf.shape[1:])
    return total <= MAX_COLS and n % (BLOCK * CPS) == 0 and n >= 2**13


def coarse_systematic_resample(tree, weights: torch.Tensor, r):
    """Resample a tree of ``(n, ...)`` tensors through :func:`coarse_gather`;
    returns ``(tree, ancestors (n,) int32)``, bit-equal to the plain
    route given the same ``ends``. Every leaf rides the payload as
    float32: gate with :func:`coarse_applicable`."""
    from gpu_se_tpu_torch.ops.resample_pallas_block import (
        pack_rows,
        unpack_rows,
    )

    n = weights.shape[0]
    packed, meta = pack_rows(tree)
    if packed.shape[1] > MAX_COLS:
        raise ValueError(f"payload of {packed.shape[1]} columns exceeds "
                         f"{MAX_COLS}")
    ends = ends_from_weights(weights, r)
    out, anc = coarse_gather(ends, chunk_boundaries(ends, n),
                             packed.T.contiguous())
    return unpack_rows(out.T, meta), anc
