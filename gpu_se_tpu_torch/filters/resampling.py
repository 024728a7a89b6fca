"""Systematic resampling: the plain oracles and the router over the kernels.

Counterpart of ``gpu_se_tpu/filters/resampling.py``. ``idx[i]`` is the
smallest ``k`` with ``cs_k >= (i + r) / n``, ``cs`` the cumsum normalized
by its last entry, computed through the same monotonized integer ``ends``
as the kernels (:func:`systematic_resample_indices` +
:func:`sorted_row_gather` is the plain route, the reference's XLA path).

:func:`systematic_resample` routes a tree of ``(n, ...)`` tensors as the
reference routes a pytree, with "the backend is TPU" read as "the
weights lie on a CUDA device": auto on CUDA tensors takes exactly the
reference's TPU routes, auto on CPU tensors the plain route. The gates
are the reference's, so the same shapes reach the same counterparts:

* ``"ends"``, and auto for multi-leaf trees whose leaves are all
  float32-exact and pack to <= 32 columns: the integer-``ends`` merge
  (``ops/resample_pallas_block``, kernel ``ends_merge_round``);
* ``"v4"``, and auto for a float32-exact ``(n, <=5)`` first leaf: the
  kernels ``compact`` and ``expand`` (``ops/resample_pallas4``);
* ``"v3"`` (and auto for other ``(n, <=8)`` first leaves) and ``"pallas"``
  (v1): the cumsum merge (``ops/resample_pallas3``, kernel
  ``cumsum_merge``); the remaining leaves reuse its ancestors;
* ``"coarse"`` (opt-in): trees of float32-exact leaves of <= 6 columns
  in all take the coarse-window search (``ops/resample_coarse``, kernel
  ``coarse_gather``);
* ``"bank"``: the Gaussian-bank entry of :func:`systematic_resample_bank`;
* ``"xla"``: the plain route.

A forced route on CPU tensors runs that route's plain versions.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops import resample_pallas as rp1
from gpu_se_tpu_torch.ops import resample_pallas3 as rp3
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4
from gpu_se_tpu_torch.ops.resample_coarse import (
    coarse_applicable,
    coarse_systematic_resample,
    ends_from_weights,
    indices_from_ends,
)
from gpu_se_tpu_torch.ops.resample_pallas_block import (
    pack_rows,
    packable_cols,
    systematic_resample_ends,
    unpack_rows,
)
from gpu_se_tpu_torch.pytree import tree_flatten, tree_map, tree_unflatten


def systematic_positions(n: int, r, device="cuda") -> torch.Tensor:
    """Stratified positions ``u_i = (i + r) / n`` for a single uniform r."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i + r) / n


def systematic_resample_indices(weights: torch.Tensor, r) -> torch.Tensor:
    """(n,) int32 ancestor indices for systematic resampling."""
    return indices_from_ends(ends_from_weights(weights, r))


def sorted_row_gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``a[idx]`` for in-bounds ``idx``."""
    return torch.index_select(a, 0, idx.to(torch.int64))


# ----------------------------------------------------------------------
# implementation selection
# ----------------------------------------------------------------------
IMPLS = ("auto", "xla", "ends", "v4", "v3", "pallas", "bank", "coarse")
_IMPL = "auto"
_KERNEL_BLOCK = 128        # block_slots of the v1/v3 routes
_ENDS_BLOCK = 256          # block_slots of the ends route


class impl:
    """Context manager forcing a resample route (one of :data:`IMPLS`)."""

    def __init__(self, name: str):
        if name not in IMPLS:
            raise ValueError(f"unknown resample route {name!r}; one of "
                             f"{IMPLS}")
        self.name = name

    def __enter__(self):
        global _IMPL
        self._prev = _IMPL
        _IMPL = self.name

    def __exit__(self, *exc):
        global _IMPL
        _IMPL = self._prev


def route() -> str:
    """The route in force (``"auto"`` unless :class:`impl` forces one):
    part of the key of a graphed function that resamples."""
    return _IMPL


def f32_exact_dtype(dtype: torch.dtype) -> bool:
    """True if a round trip through float32 is lossless: float32,
    bfloat16, float16 and the integers of at most 16 bits. The kernels
    carry their payload as float32."""
    return dtype in (torch.float32, torch.bfloat16, torch.float16,
                     torch.int8, torch.int16, torch.uint8, torch.uint16)


def _pack_dtypes_ok(tree) -> bool:
    """All leaves survive the packed kernels' float32 round trip."""
    return all(f32_exact_dtype(leaf.dtype) for leaf in tree_flatten(tree)[0])


def _auto_ends(tree) -> bool:
    """Auto routing on a card: a multi-leaf tree (the GSUKF means and
    covariances) of float32-exact leaves that packs to <= 32 columns
    takes the ``ends`` route as one packed payload."""
    return (len(tree_flatten(tree)[0]) > 1 and _pack_dtypes_ok(tree)
            and packable_cols(tree) > 0)


def _kernel_applicable(tree, n: int, on_cuda: bool) -> bool:
    """Whether a kernel route takes ``tree``; ``on_cuda`` stands for the
    reference's "the backend is TPU"."""
    leaves = tree_flatten(tree)[0]
    if not leaves:
        return False
    if n < 2**12 or _IMPL == "xla":
        return False
    # every route but v4 needs the aligned-n gate
    aligned = n % max(_KERNEL_BLOCK, 256) == 0
    if _IMPL == "ends":
        return aligned and _pack_dtypes_ok(tree) and packable_cols(tree) > 0
    if _IMPL == "coarse":
        return aligned and _pack_dtypes_ok(tree) and coarse_applicable(tree, n)
    first = leaves[0]
    first_ok = (first.dim() == 2 and first.shape[1] <= rp3.MAX_ROWS
                and f32_exact_dtype(first.dtype))
    if _IMPL == "v4":
        return first_ok and rp4.v4_applicable(first, n)
    if _IMPL in ("pallas", "v3"):
        return aligned and first_ok
    if not on_cuda:
        return False
    if first_ok and rp4.v4_applicable(first, n) and not _auto_ends(tree):
        return True
    return aligned and (first_ok or _auto_ends(tree))


def _use_bank_kernel(means, covs, n: int, on_cuda: bool) -> bool:
    return (_IMPL == "bank" or (_IMPL in ("auto", "v4") and on_cuda)) \
        and rp4.bank_applicable(means, covs, n)


def _uniform(weights: torch.Tensor) -> torch.Tensor:
    n = weights.shape[0]
    return torch.full((n,), 1.0 / n, dtype=weights.dtype,
                      device=weights.device)


def _draw_r(weights: torch.Tensor, generator: torch.Generator):
    return torch.rand((), generator=generator, dtype=torch.float32,
                      device=weights.device)


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def systematic_resample_bank_from_r(means, covs, weights, r):
    """:func:`systematic_resample_bank` at the uniform ``r``."""
    n = weights.shape[0]
    if _use_bank_kernel(means, covs, n, weights.device.type == "cuda"):
        new_means, new_covs, _ = rp4.systematic_resample_bank(
            means, covs, weights, r)
        return (new_means, new_covs), _uniform(weights)
    return systematic_resample_from_r((means, covs), weights, r)


def systematic_resample_bank(means: torch.Tensor, covs: torch.Tensor,
                             weights: torch.Tensor,
                             generator: torch.Generator):
    """Systematic resample of a Gaussian bank ``(means (n, nx), covs
    (n, nx, nx))``; ``covs`` must be exactly symmetric. Auto on CUDA
    tensors, ``"v4"`` on them and ``"bank"`` on any take the packed
    upper-triangle route (``compact`` + ``expand`` at ``nx + nx(nx+1)/2``
    rows); anything else the generic tree route. Returns ``((means,
    covs), uniform_weights)``."""
    return systematic_resample_bank_from_r(means, covs, weights,
                                           _draw_r(weights, generator))


def systematic_resample_from_r(tree, weights: torch.Tensor, r):
    """:func:`systematic_resample` at the uniform ``r`` (float32)."""
    n = weights.shape[0]
    if _kernel_applicable(tree, n, weights.device.type == "cuda"):
        if _IMPL == "coarse":
            out, _ = coarse_systematic_resample(tree, weights, r)
            return out, _uniform(weights)
        if _IMPL == "ends" or (_IMPL == "auto" and _auto_ends(tree)):
            packed, meta = pack_rows(tree)
            out, _ = systematic_resample_ends(packed, weights, r,
                                              block_slots=_ENDS_BLOCK)
            return unpack_rows(out, meta), _uniform(weights)
        leaves, treedef = tree_flatten(tree)
        first = leaves[0]
        if _IMPL == "v4" or (_IMPL == "auto"
                             and rp4.v4_applicable(first, n)):
            out, anc = rp4.systematic_resample_tiled(first, weights, r)
        elif _IMPL == "pallas":
            out, anc = rp1.systematic_resample(first, weights, r,
                                               block_slots=_KERNEL_BLOCK)
        else:
            out, anc = rp3.systematic_resample_pipelined(
                first, weights, r, block_slots=_KERNEL_BLOCK)
        rest = [sorted_row_gather(leaf, anc) for leaf in leaves[1:]]
        return (tree_unflatten(treedef, [out.to(first.dtype)] + rest),
                _uniform(weights))
    idx = systematic_resample_indices(weights, r)
    return tree_map(lambda a: sorted_row_gather(a, idx), tree), \
        _uniform(weights)


def systematic_resample(tree, weights: torch.Tensor,
                        generator: torch.Generator):
    """Resample any tree of ``(n, ...)`` tensors along axis 0 by
    ``weights (n,)``, with one float32 uniform drawn from ``generator``.
    Returns ``(resampled_tree, uniform_weights)``; the route is chosen as
    the module docstring says."""
    return systematic_resample_from_r(tree, weights,
                                      _draw_r(weights, generator))
