"""Integer-``ends`` block-merge resample through a hand-written CUDA kernel.

Counterpart of ``gpu_se_tpu/ops/resample_pallas_block.py``. The kernel,
:func:`ends_merge_round` (``csrc/resample_block.cu``), replaces both of
that file's Pallas kernels, ``_kernel`` and ``_kernel_pipelined``: they
compute one function and differ only in the TPU's DMA schedule.

One round advances a shard's carried merge state ``(counts (n_local, 1)
int32, acc (n_local, cols) float32, finalized (n_local, 1) float32)``
over one source block of the globally monotonized ``ends``, at global
slot offset ``slot0``; blocks fed in ascending order advance one merge.
After the last block ``counts`` holds the ancestors and ``acc[:, :nx]``
their rows. Single-device use is one round over the whole array. The
ancestors are ``#{k : ends_k < i}`` with exact int32 compares, so the
result is bit-equal to the plain resample given the same ``ends``.

:func:`packable_cols`, :func:`pack_rows` and :func:`unpack_rows` carry any
tree of ``(n, ...)`` tensors through the kernel as one ``(n, <=32)``
payload (the GSUKF bank: 5 means + 25 covariance entries).

The wrapper takes its plain version for CPU tensors and launches the
kernel for CUDA tensors, with no fallback from one to the other;
``ends_merge_round.launches`` counts launches.

Reference names. The reference module's entry points and the functions
that take their place here:

- ``pallas_block_resample_round`` -> :func:`block_resample_round`:
  ``(ends_block, parts_block, slot0, counts, acc, finalized,
  block_slots)`` in the reference's order; no ``window`` or
  ``interpret``. The state is updated in place and returned. Aliased.
- ``pallas_block_resample_round_pipelined`` ->
  :func:`block_resample_round_pipelined`: the same, with the default
  ``block_slots=256``; no ``gather_precision`` (the kernel copies).
  Aliased.
- ``pallas_systematic_resample_ends`` -> :func:`systematic_resample_ends`:
  ``(particles, weights, r)`` alike, then ``pipelined, block_slots``
  where the reference takes ``block_slots, window, interpret,
  pipelined``; so no alias.
"""
from __future__ import annotations

import math

import torch

from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights
from gpu_se_tpu_torch.pytree import tree_flatten, tree_unflatten

MAX_COLS = 32


def _cols_pad(nx: int) -> int:
    """Payload columns rounded up to 8, at most 32: the width of the
    reference's carried ``acc``."""
    if nx > MAX_COLS:
        raise ValueError(f"payload of {nx} columns exceeds the kernel's "
                         f"{MAX_COLS}")
    return ((nx + 7) // 8) * 8


def block_resample_state(n_local: int, nx: int = 8, device="cuda"):
    """Fresh carried state ``(counts, acc, finalized)`` for a round."""
    return (
        torch.zeros((n_local, 1), dtype=torch.int32, device=device),
        torch.zeros((n_local, _cols_pad(nx)), dtype=torch.float32,
                    device=device),
        torch.zeros((n_local, 1), dtype=torch.float32, device=device),
    )


# ----------------------------------------------------------------------
# the kernel and its plain version
# ----------------------------------------------------------------------
def ends_merge_round_plain(ends_block, parts_block, slot0: int, counts, acc,
                           finalized):
    """Plain version of :func:`ends_merge_round` (same in-place update)."""
    n_blk, nx = parts_block.shape
    if n_blk == 0:
        return counts, acc, finalized
    g = torch.arange(counts.shape[0], dtype=torch.int32,
                     device=counts.device) + slot0
    c = torch.searchsorted(ends_block, g, out_int32=True)
    take = ((c < n_blk) & (finalized[:, 0] == 0))[:, None]
    row = torch.index_select(parts_block, 0, c.clamp_max(n_blk - 1))
    acc[:, :nx] = torch.where(take, row, acc[:, :nx])
    counts += c[:, None]
    finalized.masked_fill_(take, 1.0)
    return counts, acc, finalized


def ends_merge_round(ends_block: torch.Tensor, parts_block: torch.Tensor,
                     slot0: int, counts: torch.Tensor, acc: torch.Tensor,
                     finalized: torch.Tensor):
    """Advance ``(counts, acc, finalized)`` over one source block, in
    place, and return them.

    ``ends_block`` int32 ``(n_blk,)`` ascending; ``parts_block`` float32
    ``(n_blk, nx)``; ``slot0`` the global index of local slot 0. For local
    slot ``s`` with ``c = #{j : ends_block[j] < slot0 + s}``: ``counts[s]
    += c``; if ``finalized[s] == 0`` and ``c < n_blk``, ``acc[s, :nx] =
    parts_block[c]`` (an exact copy) and ``finalized[s] = 1``.
    """
    dev = counts.device
    _build.check("ends_block", ends_block, torch.int32, 1, dev)
    _build.check("parts_block", parts_block, torch.float32, 2, dev)
    _build.check("counts", counts, torch.int32, 2, dev)
    _build.check("acc", acc, torch.float32, 2, dev)
    _build.check("finalized", finalized, torch.float32, 2, dev)
    n_blk, nx = parts_block.shape
    n_local = counts.shape[0]
    if ends_block.shape[0] != n_blk:
        raise ValueError(f"ends_block {tuple(ends_block.shape)} vs "
                         f"parts_block {tuple(parts_block.shape)}")
    if (counts.shape != (n_local, 1) or finalized.shape != (n_local, 1)
            or acc.shape[0] != n_local or acc.shape[1] < nx):
        raise ValueError(f"state counts {tuple(counts.shape)}, acc "
                         f"{tuple(acc.shape)}, finalized "
                         f"{tuple(finalized.shape)} vs {nx} columns")
    slot0 = int(slot0)
    if slot0 < -2**31 or slot0 + n_local > 2**31 - 1:
        raise ValueError(f"slots [{slot0}, {slot0 + n_local}) leave int32")
    if not _build.on_cuda(counts):
        return ends_merge_round_plain(ends_block, parts_block, slot0, counts,
                                      acc, finalized)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.gst_ends_merge_round(
            ends_block.data_ptr(), n_blk, parts_block.data_ptr(), nx, slot0,
            n_local, counts.data_ptr(), acc.data_ptr(), acc.shape[1],
            finalized.data_ptr(), _build.stream(dev))
    _build.launch_check("ends_merge_round", rc)
    ends_merge_round.launches += 1
    return counts, acc, finalized


ends_merge_round.launches = 0


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def _round(ends_block, parts_block, slot0, counts, acc, finalized,
           block_slots):
    n_local = counts.shape[0]
    nx = parts_block.shape[1]
    if n_local % block_slots:
        raise ValueError(f"n_local={n_local} is not a multiple of "
                         f"block_slots={block_slots}")
    if block_slots >= 2048:
        raise ValueError(f"block_slots={block_slots}: the reference's "
                         f"known-deadlock geometry")
    if acc.shape[1] != _cols_pad(nx):
        raise ValueError(f"carried acc has {acc.shape[1]} columns, payload "
                         f"needs {_cols_pad(nx)}")
    return ends_merge_round(
        ends_block.to(torch.int32).contiguous(),
        parts_block.to(torch.float32).contiguous(), slot0, counts, acc,
        finalized)


def block_resample_round(ends_block, parts_block, slot0, counts, acc,
                         finalized, block_slots: int = 128):
    """One merge round, with the geometry contract of the reference's
    synchronous ``pallas_block_resample_round`` (``n_local %
    block_slots == 0``, ``block_slots < 2048``, ``acc`` of
    ``_cols_pad(nx)`` columns). Updates the state in place, as the
    reference aliases it, and returns it."""
    return _round(ends_block, parts_block, slot0, counts, acc, finalized,
                  block_slots)


def block_resample_round_pipelined(ends_block, parts_block, slot0, counts,
                                   acc, finalized, block_slots: int = 256):
    """:func:`block_resample_round` with the default geometry of the
    reference's double-buffered ``pallas_block_resample_round_pipelined``;
    the same kernel."""
    return _round(ends_block, parts_block, slot0, counts, acc, finalized,
                  block_slots)


# the reference's names: a call with its positional arguments gives the
# same result here
pallas_block_resample_round = block_resample_round
pallas_block_resample_round_pipelined = block_resample_round_pipelined


def systematic_resample_ends(particles: torch.Tensor, weights: torch.Tensor,
                             r, pipelined: bool = True,
                             block_slots: int = 256):
    """Systematic resample in the integer ``ends`` domain, one round over
    the whole array. Returns ``(resampled (n, nx) in particles' dtype,
    ancestors (n,) int32)``."""
    n, nx = particles.shape
    ends = ends_from_weights(weights, r)
    state = block_resample_state(n, nx, particles.device)
    round_fn = (block_resample_round_pipelined if pipelined
                else block_resample_round)
    counts, acc, _ = round_fn(ends, particles, 0, *state,
                              block_slots=block_slots)
    anc = torch.clamp(counts[:, 0], 0, n - 1)
    return acc[:, :nx].to(particles.dtype), anc


# ----------------------------------------------------------------------
# row packing
# ----------------------------------------------------------------------
def packable_cols(tree) -> int:
    """Total payload columns of a tree of ``(n, ...)`` tensors, or 0 if
    a leaf is not at least 2-d over the same ``n`` or the total exceeds
    32."""
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return 0
    n = leaves[0].shape[0]
    total = 0
    for leaf in leaves:
        if leaf.dim() < 2 or leaf.shape[0] != n:
            return 0
        total += math.prod(leaf.shape[1:])
    return total if total <= MAX_COLS else 0


def pack_rows(tree):
    """``(packed (n, cols) float32, meta)``: the leaves flattened per row
    and concatenated in leaf order."""
    leaves, treedef = tree_flatten(tree)
    n = leaves[0].shape[0]
    mats = [leaf.reshape(n, -1).to(torch.float32) for leaf in leaves]
    meta = (treedef, [leaf.shape for leaf in leaves],
            [leaf.dtype for leaf in leaves])
    return (torch.cat(mats, dim=1) if len(mats) > 1 else mats[0]), meta


def unpack_rows(packed: torch.Tensor, meta):
    """The tree :func:`pack_rows` packed, from ``packed``'s rows."""
    treedef, shapes, dtypes = meta
    out, col = [], 0
    for shape, dtype in zip(shapes, dtypes):
        width = math.prod(shape[1:])
        out.append(packed[:, col:col + width].reshape(shape).to(dtype))
        col += width
    return tree_unflatten(treedef, out)
