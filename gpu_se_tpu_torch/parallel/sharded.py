"""Multi-device filter steps over a :class:`~gpu_se_tpu_torch.parallel.mesh.Mesh`.

Counterpart of ``gpu_se_tpu/parallel/sharded.py``. Every rank holds a
contiguous slice of ``n_local`` particles (or Gaussians) of ``n_global =
n_local * W``; the collectives are ``parallel/_comm.py``'s.

Two paths, as in the reference:

* :func:`make_auto_sharded_step` and :func:`make_auto_sharded_gsukf_step`
  keep the reference's contract, the same step, bit for bit, as on one
  device, the simplest honest way: they all-gather the state, run the
  port's single-device step with the same generator state on every rank
  and keep this rank's slice. Every rank holds the whole population: the
  correctness anchor, not a scaling path (the reference's GSPMD has no
  torch counterpart here);
* :func:`make_shard_map_step`, :func:`make_shard_map_gsukf_step` and
  :func:`make_shard_map_tiled_step`: per-rank predict and update, then a
  distributed systematic resample with ``O(n_local)`` memory a rank,
  each rank drawing only its own slice of the noise (below).

:func:`point_estimate` and :func:`point_covariance` are the moments of
the whole population from each rank's slice, the reference's
``point_estimate`` and ``point_covariance`` on a sharded state: each
rank sums its rows in the single-device reduction's blocks, the block
sums are all-gathered, and every rank adds them in one order, so every
rank holds the same bits.

The resample starts from :func:`_segmented_ends`: the weight cumsum in
fixed 128-slot segments, whose ``(n_global / 128,)`` totals are the only
replicated array, so every float32 rounding is grouped alike at every
width whose shards hold whole segments, and the integer ``ends`` are
bitwise width-invariant. Everything after is exact integer logic, so
every route gives the same rows:

* ``"xla"``: a ring of ``ends`` blocks seeds each rank's ancestors, a
  ring of payload blocks gathers them (:func:`_ring_ancestors`,
  :func:`_ring_gather`); no kernel;
* ``"kernel"`` (``"kernel_interpret"`` maps to it): the blocks are
  broadcast in ascending global order into the port's ``ends_merge_round``
  (kernel A), with the reference's two data-dependent skips: read on the
  host when the step runs eagerly, IF nodes of the graph
  (``ops/graph_cond.if_then``) when it is captured, as the reference
  takes them with ``lax.cond`` inside its program;
* the survivor all-to-all: each rank compacts its survivors (``ends_k >
  ends_{k-1}``), sends each destination the one contiguous run whose
  slot intervals meet its slots, and merges what it receives once.
  ``"a2a"`` (ragged exchange) and ``"a2a_ring_v4"`` (ring exchange;
  ``"a2a_tiled_ring"`` maps to it) compact with ``compact`` (K2) and
  merge with ``expand`` (K1); ``"a2a_xla"`` (ragged) and ``"a2a_ring"``
  (ring) compact and merge in plain torch.

The reference's ``"a2a"`` and tiled pipeline exchange its 1024-lane
tiles; the port keeps its SoA ``(rows, n)`` layout and exchanges survivor
rows, which give the same rows after untiling. Its ragged all-to-all
reads the ``(W, W)`` sizes matrix to the host once a step
(``all_to_all_single`` takes Python ints); the ring exchange reads
nothing. On the CPU the wrappers of K1, K2 and A take their plain
versions, as everywhere in the port.

One dispatch a step. As the reference returns ``jax.jit`` of each
shard-map factory's step, each ``make_shard_map_*`` factory returns its
step as a :class:`~gpu_se_tpu_torch.graphs.Graphed` function (one CUDA
graph replay a call on the card; on the CPU it runs directly) wherever
the step reads nothing on the host and its collectives can be captured:
a mesh of one rank (every collective the identity), and every route but
the ragged exchange, whose ``all_to_all_single`` takes the sizes as
Python ints. A gloo group copies every buffer through the host, so its
steps run eagerly; an NCCL group of more than one rank also runs
eagerly until its captured collectives have been held to one rank's
step on cards. The factory decides this from the route and the mesh's
size and says so in ``step.graphed``; a capture that fails raises.

Two integers mark padding and are kept apart: :data:`_IBIG` (``2**30``,
above any global slot index) pads the exchanged survivor ends and firsts,
and ``compact``'s ``INT32_MAX`` pads its own output; ``n_global`` must
stay below ``_IBIG``.

Random numbers. The flat and GSUKF steps draw a key (two int64 words)
and then ``r`` from the state's generator, whose state is the same on
every rank, so every rank takes the same key and ``r`` with no host
read, and every generator advances alike. The noise is one
counter-based stream under that key (``ops/counter_draw``, Philox
through the ``counter_draw`` kernel, as the reference draws its noise
with partitionable threefry outside the ``shard_map``): its sample ``j``
depends only on the key and on ``j``, so each rank draws only its own
samples, ``O(n_local)`` memory and work a rank, and the step is
bit-equal across widths. Sample ``j`` is particle ``j`` for the flat
step, and ``p (2 nx + 1) + s`` (Gaussian ``p``, sigma point ``s``) for
the GSUKF, so that a rank's Gaussians are one contiguous range. The
single-device steps keep their torch streams, so the sharded step is
not the single-device step on the same generator: it is ``from_noise``
fed the global counter draw's slice. Their ``from_noise`` attribute
takes the noise and ``r`` instead, for the parity tests. The tiled step
draws each rank's noise from a stream of its own
(:func:`shard_tiled_pf_state` seeds it from the seed and the rank, as
the reference folds the rank into its key), so its noise depends on the
width, as the reference's does; ``r`` is rank 0's draw.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.filters import gs_ukf as gsf
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.filters.gs_ukf import GSUKFState
from gpu_se_tpu_torch.filters.particle import PFState
from gpu_se_tpu_torch.filters.particle_tiled import TiledPFState
from gpu_se_tpu_torch.ops import graph_cond
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4
from gpu_se_tpu_torch.ops import resample_pallas_block as rpb
from gpu_se_tpu_torch.ops.counter_draw import key_from
from gpu_se_tpu_torch.ops.reduce import _block, blocked_outer_sum, blocked_sum
from gpu_se_tpu_torch.ops.resample_coarse import blocked_cummax, blocked_cumsum
from gpu_se_tpu_torch.parallel import _comm
from gpu_se_tpu_torch.parallel.mesh import Mesh, particle_sharding
from gpu_se_tpu_torch.pytree import tree_flatten, tree_unflatten

_SEGMENT = 128           # slots of one segment of the distributed cumsum
_IBIG = 2**30            # pad of exchanged ends and firsts: > any slot
_KERNEL_BLOCK = 128      # block_slots of the kernel route's rounds
_MOMENT_BLOCK = 4096     # ops/reduce's block: the moments' partial sums


def _uniform(weights: torch.Tensor, n_global: int) -> torch.Tensor:
    return torch.full((weights.shape[0],), 1.0 / n_global,
                      dtype=weights.dtype, device=weights.device)


def _local(mesh: Mesh, x: torch.Tensor, n_local: int):
    """This rank's rows of a global ``x``."""
    return x.narrow(0, mesh.rank * n_local, n_local)


# ----------------------------------------------------------------------
# the width-invariant ends (sharded.py:101-144)
# ----------------------------------------------------------------------
def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of each row of ``x (m, seg)``. A scan along the last
    dim of two or more rows runs in a fixed order on the card (see
    ``ops/resample_coarse.blocked_cumsum``); one row is scanned beside a
    row of zeros."""
    if x.shape[0] > 1:
        return torch.cumsum(x, dim=1)
    return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), dim=1)[:1]


def _segmented_ends(weights: torch.Tensor, r, mesh: Mesh):
    """This rank's slice of the global monotonized ``ends`` and ``prev``,
    the largest ``ends`` entry of the ranks before it (``-1`` on rank 0),
    both int32.

    The cumsum runs in fixed 128-slot segments (one segment of
    ``n_local`` when that is not a multiple of 128): each rank scans its
    own, the segment totals are all-gathered and scanned
    (``blocked_cumsum``), and the slice of the normalized cumsum is
    ``(inner + offset) / total``: the same operands in the same order at
    every width. Then ``ends = floor(n_global * cs - r)``, converted and
    clamped as ``ops/resample_coarse.ends_from_weights`` does, a running
    max within the rank and across the ranks before it, and the run of
    entries tied with the global last raised to ``n_global - 1`` (a
    no-op for weights with a finite positive sum; otherwise it gives the
    reference's ancestors to the kernels, as on one device).
    """
    n_local = weights.shape[0]
    n_global = n_local * mesh.size
    if n_global >= _IBIG:
        raise ValueError(f"{n_global} particles: global slots must stay "
                         f"below the pad {_IBIG}")
    seg = _SEGMENT if n_local % _SEGMENT == 0 else n_local
    m = n_local // seg
    inner = _row_scan(weights.reshape(m, seg))
    totals = _comm.all_gather(mesh, inner[:, -1]).reshape(-1)
    co = blocked_cumsum(totals)
    off = torch.cat([co.new_zeros(1), co[:-1]])
    off_local = off[mesh.rank * m:(mesh.rank + 1) * m]
    cs = ((inner + off_local[:, None]) / co[-1]).reshape(n_local)
    ends = torch.floor(n_global * cs - r)
    ends = torch.clamp(torch.nan_to_num(ends, nan=0.0), -1, n_global - 1)
    ends = blocked_cummax(ends.to(torch.int32))
    lasts = _comm.all_gather(mesh, ends[-1:]).reshape(-1)
    prev = torch.max(torch.cat([lasts.new_full((1,), -1),
                                lasts[:mesh.rank]]))
    ends = torch.maximum(ends, prev)
    last = torch.max(lasts)
    ends = torch.where(ends == last, n_global - 1, ends)
    prev = torch.where(prev == last, n_global - 1, prev)
    return ends, prev


# ----------------------------------------------------------------------
# "xla": the rings (sharded.py:151-248)
# ----------------------------------------------------------------------
def _ring_ancestors(ends, prev, mesh: Mesh) -> torch.Tensor:
    """Global ancestor indices of this rank's slots, from a ring of the
    ``ends`` blocks.

    In round ``k`` this rank holds block ``q = (rank - k) mod W`` (with
    its owner's ``prev``): particle ``q n_local + j`` first feeds global
    slot ``ends[j - 1] + 1``; those that land in this rank's slots are
    scattered as seeds (max) and a running max fills the rest. The first
    slot's ancestor, whose seed may lie on another rank, is ``#{ends <
    slot0}``, counted over the rounds.
    """
    n_local = ends.shape[0]
    n_global = n_local * mesh.size
    slot0 = mesh.rank * n_local
    dev = ends.device
    ks = torch.arange(n_local, dtype=torch.int32, device=dev)
    seed = torch.zeros(n_local + 1, dtype=torch.int32, device=dev)
    cnt0 = torch.zeros((), dtype=torch.int64, device=dev)
    blk = torch.cat([prev.reshape(1), ends])      # the owner's prev, ends
    for rnd in range(mesh.size):
        q = (mesh.rank - rnd) % mesh.size
        fs, blk_ends = blk[:-1] + 1, blk[1:]
        tgt = fs - slot0
        tgt = torch.where((fs <= blk_ends) & (tgt >= 0) & (tgt < n_local),
                          tgt, n_local)
        seed.scatter_reduce_(0, tgt.long(), q * n_local + ks, "amax")
        cnt0 += torch.sum(blk_ends < slot0)
        if rnd < mesh.size - 1:
            blk = _comm.ring_shift(mesh, blk)
    seed = seed[:n_local]
    seed[0] = torch.maximum(seed[0], cnt0.to(torch.int32))
    return torch.clamp(blocked_cummax(seed), 0, n_global - 1)


def _ring_gather(tree, ancestors, mesh: Mesh):
    """The rows ``ancestors`` (global, sorted) of the sharded ``tree``,
    from a ring of the payload blocks: in each round the rows whose
    ancestors lie in the visiting block are copied from it."""
    n_local = ancestors.shape[0]
    leaves, treedef = tree_flatten(tree)
    blocks = [leaf.reshape(n_local, -1) for leaf in leaves]
    outs = [torch.zeros_like(b) for b in blocks]
    for rnd in range(mesh.size):
        lo = ((mesh.rank - rnd) % mesh.size) * n_local
        in_blk = ((ancestors >= lo) & (ancestors < lo + n_local))[:, None]
        li = torch.clamp(ancestors - lo, 0, n_local - 1).long()
        outs = [torch.where(in_blk, b.index_select(0, li), o)
                for b, o in zip(blocks, outs)]
        if rnd < mesh.size - 1:
            blocks = [_comm.ring_shift(mesh, b) for b in blocks]
    return tree_unflatten(treedef, [o.reshape(leaf.shape)
                                    for o, leaf in zip(outs, leaves)])


def _distributed_systematic_resample(tree, weights, r, mesh: Mesh):
    """Systematic resample of a tree of ``(n_local, ...)`` tensors over
    the ranks: :func:`_segmented_ends`, :func:`_ring_ancestors`,
    :func:`_ring_gather` (``sharded.py:953-980``). Returns ``(tree,
    uniform weights)``."""
    ends, prev = _segmented_ends(weights, r, mesh)
    anc = _ring_ancestors(ends, prev, mesh)
    return (_ring_gather(tree, anc, mesh),
            _uniform(weights, weights.shape[0] * mesh.size))


# ----------------------------------------------------------------------
# "kernel": ends_merge_round on the blocks in global order (:250-350)
# ----------------------------------------------------------------------
class _KernelCarry:
    """The kernel route's merge state for a graph: ``counts``, ``acc`` and
    ``finalized`` of :func:`~gpu_se_tpu_torch.ops.resample_pallas_block.
    block_resample_state` and the visiting block's ``ends`` and payload,
    at fixed addresses on the card, with the two skips' bodies captured
    once as kept graphs (``ops/graph_cond``'s IF items): ``below`` adds
    ``n_local`` to every count, ``merge`` runs ``ends_merge_round`` on
    the block and adds one to ``runs``, the card's count of its launches
    (``graphs.count_on_card``). Built outside any capture."""

    def __init__(self, n_local: int, nx: int, slot0: int, dev):
        self.counts, self.acc, self.fin = rpb.block_resample_state(
            n_local, nx, dev)
        self.ends = torch.zeros(n_local, dtype=torch.int32, device=dev)
        self.parts = torch.zeros((n_local, nx), dtype=torch.float32,
                                 device=dev)
        self.runs = torch.zeros((), dtype=torch.int64, device=dev)
        graph_cond.prepare(dev)

        def merge():
            rpb.block_resample_round(self.ends, self.parts, slot0,
                                     self.counts, self.acc, self.fin,
                                     block_slots=_KERNEL_BLOCK)
            self.runs.add_(1)

        self.below = _kept(lambda: self.counts.add_(n_local), dev)
        self.merge = _kept(merge, dev)
        graphs.count_on_card(self, rpb.ends_merge_round, 1, self.runs)


def _kept(fn, dev) -> torch.cuda.CUDAGraph:
    """``fn`` captured as a kept graph, the launches its capture counted
    taken back (it launched nothing)."""
    counts = [k.launches for k in graphs.KERNELS]
    graph = graphs.capture(fn, (), {}, [], dev, keep_graph=True)[0]
    for k, c in zip(graphs.KERNELS, counts):
        k.launches = c
    return graph


def _distributed_systematic_resample_kernel(tree, weights, r, mesh: Mesh,
                                            carries=None):
    """The same resample through the port's ``ends_merge_round`` (kernel
    A): any tree packs into one ``(n_local, <= 32)`` payload (the GSUKF
    bank: 30 columns). Round ``q`` broadcasts rank ``q``'s ``ends`` and
    payload (ends as one more int32 column, the payload's bits beside
    it) and advances this rank's merge over it, so the blocks arrive in
    ascending global order, which the merge needs. Two data-dependent
    skips: a block wholly below this rank's slots adds ``n_local`` to
    every count, and a rank whose slots are all final merges no more.

    Eagerly the skips are read on the host each round. A graphed step
    passes ``carries``, a dict of its :class:`_KernelCarry` by shape: on
    the card an eager call builds the carry, and a call under capture
    takes the skips as IF nodes over it, the same kernels on the same
    data, so the same bits."""
    packed, meta = rpb.pack_rows(tree)
    packed = packed.contiguous()
    n_local, nx = packed.shape
    slot0 = mesh.rank * n_local
    ends, _ = _segmented_ends(weights, r, mesh)
    dev = packed.device
    carry = None
    if carries is not None and dev.type == "cuda":
        key = (n_local, nx)
        if graphs.capturing(dev):
            carry = carries.get(key)
            if carry is None:
                raise RuntimeError(
                    "the kernel route's carry is built outside a capture: "
                    "run the step once before capturing it")
        elif key not in carries:
            # for the capture that follows this eager call
            carries[key] = _KernelCarry(n_local, nx, slot0, dev)
    if carry is None:
        counts, acc, fin = rpb.block_resample_state(n_local, nx, dev)
    else:
        counts, acc, fin = carry.counts, carry.acc, carry.fin
        for t in (counts, acc, fin):
            t.zero_()
    mine = (torch.cat([packed.view(torch.int32), ends[:, None]], dim=1)
            if mesh.size > 1 else None)
    for q in range(mesh.size):
        if mine is None:
            blk_ends, blk_parts = ends, packed
        else:
            blk = _comm.broadcast(mesh, mine, q)
            blk_ends = blk[:, -1].contiguous()
            blk_parts = blk[:, :-1].contiguous().view(torch.float32)
        below = blk_ends[-1] < slot0
        if carry is not None:
            go = ~below & ~torch.all(fin > 0.5)
            carry.ends.copy_(blk_ends)
            carry.parts.copy_(blk_parts)
            graph_cond.if_then(below, [carry.below])
            graph_cond.if_then(go, [carry.merge])
            continue
        full_below, all_done = torch.stack(
            [below, torch.all(fin > 0.5)]).tolist()
        if full_below:
            counts += n_local
        elif not all_done:
            rpb.block_resample_round(blk_ends, blk_parts, slot0, counts, acc,
                                     fin, block_slots=_KERNEL_BLOCK)
    # the carry's acc is rewritten by the next step: a graph hands out a
    # copy, laid out as the eager step's view of its own acc
    out = (acc if carry is None else acc.clone())[:, :nx]
    return (rpb.unpack_rows(out, meta),
            _uniform(weights, n_local * mesh.size))


# ----------------------------------------------------------------------
# the survivor all-to-all (:359-606)
# ----------------------------------------------------------------------
def _compact_survivors(packed, ends, prev):
    """``(rows, ends, firsts)`` of this rank's survivors (``ends_k >
    ends_{k-1}``, with ``ends_{-1} = prev``), dense at the front in
    order, in plain torch; rows of zeros and ``_IBIG`` ends and firsts
    beyond. Survivor ``k`` covers the global slots ``[first_k,
    ends_k]``."""
    n_local = ends.shape[0]
    prev_ends = torch.cat([prev.reshape(1), ends[:-1]])
    keep = ends > prev_ends
    pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    tgt = torch.where(keep, pos, n_local).long()

    def scatter(src, fill):
        out = src.new_full((n_local + 1,) + tuple(src.shape[1:]), fill)
        return out.index_copy_(0, tgt, src)[:n_local]

    return (scatter(packed, 0), scatter(ends, _IBIG),
            scatter(prev_ends + 1, _IBIG))


def _compact_survivors_v4(payload, ends, prev):
    """The same survivors through the port's ``compact`` (K2), whose keep
    rule starts its running max at -1: the ends go in shifted to ``ends -
    (prev + 1)`` (an order-preserving shift) and come out shifted back,
    ``compact``'s ``INT32_MAX`` pads turned into ``_IBIG``. ``payload`` is
    SoA ``(rows, n_local)`` float32; the rows come back SoA too. Firsts
    follow from consecutive survivors."""
    shift = prev + 1
    c_keys, c_payload, _, _ = rp4.compact(ends - shift, payload)
    real = c_keys != rp4.INT32_MAX
    # the pads' sums wrap and are masked
    surv_ends = torch.where(real, c_keys + shift, _IBIG)
    firsts = torch.cat([shift.reshape(1), surv_ends[:-1] + 1])
    return c_payload, surv_ends, torch.where(real, firsts, _IBIG)


def _send_windows(surv_ends, surv_first, n_local: int, n_shards: int):
    """``(in_off, sizes)``, ``(W,)`` int32: the run ``[lo, lo + size)`` of
    this rank's survivors whose slot intervals meet each destination's
    slots: ``lo = #{ends < start}``, ``lo + size = #{first < end}`` (both
    sorted, ``_IBIG`` pads)."""
    starts = torch.arange(n_shards, dtype=torch.int32,
                          device=surv_ends.device) * n_local
    lo = torch.searchsorted(surv_ends, starts, out_int32=True)
    hi = torch.searchsorted(surv_first, starts + n_local, out_int32=True)
    return lo, hi - lo


def _pad_received(recv: torch.Tensor, n_local: int) -> torch.Tensor:
    """``recv`` followed by pad rows up to ``n_local``: zero payload,
    ``_IBIG`` ends and firsts (the last two columns)."""
    out = recv.new_zeros((n_local,) + tuple(recv.shape[1:]))
    out[:, -2:] = _IBIG
    out[:recv.shape[0]] = recv
    return out


def _exchange_ragged(buf, in_off, sizes, mesh: Mesh):
    """The ragged all-to-all of the survivor runs (``sharded.py:398-409``):
    ``all_to_all_single`` of each destination's run, received in source
    order, which is global ``ends`` order. Reads the ``(W, W)`` sizes
    matrix and ``in_off`` to the host, the step's one such read."""
    n_local, w = buf.shape[0], mesh.size
    sizes_mat = _comm.all_gather(mesh, sizes)           # (W, W) [src, dst]
    host = torch.cat([sizes_mat.reshape(-1), in_off]).tolist()
    send_sizes = host[mesh.rank * w:(mesh.rank + 1) * w]
    recv_sizes = host[mesh.rank:w * w:w]
    lo = host[w * w:]
    if sum(recv_sizes) > n_local:
        raise AssertionError(f"{sum(recv_sizes)} survivors meet "
                             f"{n_local} slots")
    send = torch.cat([buf[lo[d]:lo[d] + send_sizes[d]] for d in range(w)])
    return _pad_received(_comm.all_to_all(mesh, send, send_sizes,
                                          recv_sizes), n_local)


def _exchange_ring(buf, sizes, mesh: Mesh):
    """The same receive buffer by a ring (``sharded.py:412-446``): the
    survivor blocks rotate, and each visiting block's run for this rank
    is copied to the receive offset the ragged exchange would use. No
    host read."""
    n_local = buf.shape[0]
    sizes_mat = _comm.all_gather(mesh, sizes)           # (W, W) [src, dst]
    offs = torch.cumsum(sizes_mat, dim=0) - sizes_mat   # exclusive by src
    my_sizes, my_offs = sizes_mat[:, mesh.rank], offs[:, mesh.rank]
    slot0 = torch.full((1,), mesh.rank * n_local, dtype=torch.int32,
                       device=buf.device)
    out = _pad_received(buf.new_zeros((0,) + tuple(buf.shape[1:])),
                        n_local + 1)
    i = torch.arange(n_local, device=buf.device)
    vis = buf
    for rnd in range(mesh.size):
        q = (mesh.rank - rnd) % mesh.size
        lo = torch.searchsorted(vis[:, -2].contiguous(), slot0)
        tgt = torch.where((i >= lo) & (i < lo + my_sizes[q]),
                          my_offs[q] + i - lo, n_local)
        out.index_copy_(0, tgt, vis)
        if rnd < mesh.size - 1:
            vis = _comm.ring_shift(mesh, vis)
    return out[:n_local]


EXCHANGES = ("ragged", "ring")


def _exchange(rows, surv_ends, surv_first, mesh: Mesh, exchange: str):
    """Send each destination its run of survivors; returns the received
    ``(rows (n_local, cols) float32, ends, firsts)``, sorted by global
    ends, with pads after. One int32 buffer carries the rows' bits, the
    ends and the firsts."""
    n_local = surv_ends.shape[0]
    in_off, sizes = _send_windows(surv_ends, surv_first, n_local, mesh.size)
    buf = torch.cat([rows.contiguous().view(torch.int32), surv_ends[:, None],
                     surv_first[:, None]], dim=1)
    recv = (_exchange_ragged(buf, in_off, sizes, mesh)
            if exchange == "ragged" else _exchange_ring(buf, sizes, mesh))
    return (recv[:, :-2].contiguous().view(torch.float32),
            recv[:, -2].contiguous(), recv[:, -1].contiguous())


def _merge_received_xla(rows, ends, firsts, slot0: int, n_local: int):
    """One merge in plain torch (``sharded.py:449-461``): received
    survivor ``i`` seeds local slot ``first_i - slot0`` (clipped to 0 for
    the one that starts on an earlier rank), a running max fills the
    rest, one row gather."""
    valid = ends < _IBIG
    j0 = torch.clamp(firsts - slot0, 0, n_local - 1)
    tgt = torch.where(valid, j0, n_local).long()
    seed = torch.full((n_local + 1,), -1, dtype=torch.int32,
                      device=rows.device)
    seed.scatter_reduce_(0, tgt, torch.arange(
        n_local, dtype=torch.int32, device=rows.device), "amax")
    p = torch.clamp(blocked_cummax(seed[:n_local]), 0, n_local - 1)
    return rows.index_select(0, p.long())


def _merge_received_v4(payload, ends, slot0: int, n_local: int):
    """The merge through the port's ``expand`` (K1), given the received
    SoA ``payload (rows, n_local)`` and global ``ends``: the ends are
    shifted to this rank's slots in int32 (the one survivor that reaches
    past them clipped to ``n_local``, pads to ``INT32_MAX``), so local
    slot ``i`` takes the first survivor with a key ``>= i``. Returns SoA
    ``(rows, n_local)``."""
    keys = torch.where(ends < _IBIG,
                       torch.clamp(ends - slot0, max=n_local), rp4.INT32_MAX)
    out, _ = rp4.expand(keys.to(torch.int32).contiguous(),
                        payload.contiguous())
    return out


def _a2a_compact_exchange_merge(x, ends, prev, mesh: Mesh,
                                exchange: str = "ragged"):
    """The kernel pipeline on the SoA ``x (rows, n_local)`` float32 with
    this rank's global ``ends`` and ``prev``: ``compact`` (K2), the
    exchange of survivor rows, ``expand`` (K1). Returns the resampled
    ``(rows, n_local)`` (``sharded.py:772-838``)."""
    rows_soa, surv_ends, surv_first = _compact_survivors_v4(x, ends, prev)
    recv_rows, recv_ends, _ = _exchange(rows_soa.T, surv_ends, surv_first,
                                        mesh, exchange)
    return _merge_received_v4(recv_rows.T, recv_ends,
                              mesh.rank * x.shape[1], x.shape[1])


def _distributed_systematic_resample_a2a(tree, weights, r, mesh: Mesh,
                                         exchange: str = "ragged",
                                         kernels: bool = False):
    """Compact, exchange the survivor runs, merge once
    (``sharded.py:841-950``); with ``kernels`` through K2 and K1, else in
    plain torch. ``exchange``: ``"ragged"`` or ``"ring"``. Returns
    ``(tree, uniform weights)``."""
    packed, meta = rpb.pack_rows(tree)
    n_local = packed.shape[0]
    slot0 = mesh.rank * n_local
    ends, prev = _segmented_ends(weights, r, mesh)
    if kernels:
        new = _a2a_compact_exchange_merge(packed.T.contiguous(), ends, prev,
                                          mesh, exchange).T
    else:
        rows, surv_ends, surv_first = _compact_survivors(packed, ends, prev)
        new = _merge_received_xla(
            *_exchange(rows, surv_ends, surv_first, mesh, exchange),
            slot0, n_local)
    return rpb.unpack_rows(new, meta), _uniform(weights, n_local * mesh.size)


# ----------------------------------------------------------------------
# the flat step (:983-1073)
# ----------------------------------------------------------------------
# resample_impl -> (protocol, exchange, kernels)
_FLAT_ROUTES = {
    "xla": ("ring", None, False),
    "kernel": ("kernel", None, True),
    "kernel_interpret": ("kernel", None, True),
    "a2a": ("a2a", "ragged", True),
    "a2a_tiled_ring": ("a2a", "ring", True),
    "a2a_ring_v4": ("a2a", "ring", True),
    "a2a_xla": ("a2a", "ragged", False),
    "a2a_ring": ("a2a", "ring", False),
}
_GSUKF_ROUTES = {name: _FLAT_ROUTES[name]
                 for name in ("xla", "kernel", "kernel_interpret")}
_GSUKF_ROUTES.update({"a2a": ("a2a", "ragged", False),
                      "a2a_ring": ("a2a", "ring", False)})


def _route(routes: dict, resample_impl: str):
    if resample_impl not in routes:
        raise ValueError(f"unknown resample_impl {resample_impl!r}; one of "
                         f"{sorted(routes)}")
    return routes[resample_impl]


def _resample(tree, weights, r, mesh: Mesh, route: tuple, carries=None):
    """Resample ``tree`` by ``weights`` and ``r`` through one route of
    :data:`_FLAT_ROUTES` or :data:`_GSUKF_ROUTES`; returns ``(tree,
    uniform weights)``. ``carries``: a graphed step's kernel-route
    carries."""
    protocol, exchange, kernels = route
    if protocol == "ring":
        return _distributed_systematic_resample(tree, weights, r, mesh)
    if protocol == "kernel":
        return _distributed_systematic_resample_kernel(tree, weights, r,
                                                       mesh, carries)
    return _distributed_systematic_resample_a2a(
        tree, weights, r, mesh, exchange=exchange, kernels=kernels)


def graphable(mesh: Mesh, exchange=None) -> bool:
    """Whether a step over ``mesh`` whose survivors go by ``exchange``
    (None: no exchange) is captured: not by the ragged exchange, whose
    sizes are read on the host, and on a mesh of one rank only (gloo
    copies through the host; NCCL's captured collectives are not yet
    held to one rank's step on cards)."""
    return exchange != "ragged" and mesh.size == 1


def _entry(step, from_noise, graphed: bool):
    """The factory's step: :class:`~gpu_se_tpu_torch.graphs.Graphed` of
    ``step`` where ``graphed``, else ``step``; with its ``from_noise``
    and its ``graphed`` flag."""
    if graphed:
        step = graphs.Graphed(step)
    step.from_noise = from_noise
    step.graphed = graphed
    return step


def shard_pf_state(state: PFState, mesh: Mesh) -> PFState:
    """This rank's slice of a global ``PFState`` on the mesh's device; the
    generator, which must lie on that device, is shared as it is."""
    return PFState(particle_sharding(mesh, state.particles),
                   particle_sharding(mesh, state.weights), state.generator)


def make_shard_map_step(mesh: Mesh, f, g, resample_impl: str = "xla"):
    """The sharded flat PF step ``step(state, u, z, dt, state_pdf,
    measurement_pdf) -> PFState`` on this rank's ``(n_local, nx)``
    particles: a key and then ``r`` from the state's generator (the same
    on every rank), this rank's particles' noise from the key's counter
    stream (:meth:`GaussianSum.draw_inputs_at` at ``rank * n_local``);
    predict and update per rank; the resample by ``resample_impl``'s
    route (module docstring). Every integer-``ends`` route gives the same
    rows, and the step is the same at every width. ``step.from_noise(
    particles, weights, u, z, dt, measurement_pdf, noise, r) ->
    (particles, weights)`` takes this rank's noise slice and ``r``
    instead. The step is one graph replay a call where ``step.graphed``
    (:func:`graphable`); ``from_noise`` runs eagerly."""
    route = _route(_FLAT_ROUTES, resample_impl)
    graphed = graphable(mesh, route[1])
    carries = {} if graphed else None

    def from_noise(particles, weights, u, z, dt, measurement_pdf, noise, r):
        particles = pf.predict_from_noise(particles, u, dt, f, noise)
        weights = pf.update(PFState(particles, weights, None), u, z, g,
                            measurement_pdf).weights
        return _resample(particles, weights, r, mesh, route, carries)

    def step(state: PFState, u, z, dt, state_pdf, measurement_pdf):
        n_local = state.n_particles
        gen, dev = state.generator, state.weights.device
        key = key_from(gen, dev)
        r = torch.rand((), generator=gen, dtype=torch.float32, device=dev)
        noise = state_pdf.draw_from(*state_pdf.draw_inputs_at(
            key, mesh.rank * n_local, n_local))
        particles, weights = from_noise(
            state.particles, state.weights, u, z, dt, measurement_pdf,
            noise, r)
        return PFState(particles, weights, gen)

    return _entry(step, from_noise, graphed)


def _gathered(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The global tensor from every rank's slice along dim 0."""
    return _comm.all_gather(mesh, t).reshape((-1,) + tuple(t.shape[1:]))


def make_auto_sharded_step(mesh: Mesh, f, g):
    """``step(state, u, z, dt, state_pdf, measurement_pdf) -> PFState``:
    the port's single-device ``filters/particle.step`` on the
    all-gathered population, with the same generator state on every
    rank, of which each rank keeps its slice; bit-equal to the
    single-device step. Every rank holds the whole population: the
    correctness anchor of the sharded steps, not a scaling path."""
    def step(state: PFState, u, z, dt, state_pdf, measurement_pdf):
        n_local = state.n_particles
        full = PFState(_gathered(mesh, state.particles),
                       _gathered(mesh, state.weights), state.generator)
        out = pf.step(full, u, z, dt, f, g, state_pdf, measurement_pdf)
        return PFState(_local(mesh, out.particles, n_local).contiguous(),
                       _local(mesh, out.weights, n_local).contiguous(),
                       state.generator)

    return step


# ----------------------------------------------------------------------
# the GSUKF (:1076-1186)
# ----------------------------------------------------------------------
def shard_gsukf_state(state: GSUKFState, mesh: Mesh) -> GSUKFState:
    """This rank's slice of the bank on the mesh's device; the generator
    is shared as it is."""
    return GSUKFState(particle_sharding(mesh, state.means),
                      particle_sharding(mesh, state.covariances),
                      particle_sharding(mesh, state.weights),
                      state.generator)


def make_auto_sharded_gsukf_step(mesh: Mesh, f, g):
    """The GSUKF counterpart of :func:`make_auto_sharded_step`: the port's
    ``gs_ukf.step`` on the all-gathered bank, this rank's slice kept;
    bit-equal to the single-device step, the whole bank on every rank."""
    def step(state: GSUKFState, u, z, dt, state_pdf, measurement_pdf):
        n_local = state.n_gaussians
        full = GSUKFState(_gathered(mesh, state.means),
                          _gathered(mesh, state.covariances),
                          _gathered(mesh, state.weights), state.generator)
        out = gsf.step(full, u, z, dt, f, g, state_pdf, measurement_pdf)
        return GSUKFState(
            *(_local(mesh, t, n_local).contiguous()
              for t in (out.means, out.covariances, out.weights)),
            state.generator)

    return step


def make_shard_map_gsukf_step(mesh: Mesh, f, g, resample_impl: str = "xla"):
    """The sharded GSUKF step ``step(state, u, z, dt, state_pdf,
    measurement_pdf) -> GSUKFState`` on this rank's slice of the bank: a
    key and then ``r`` from the state's generator (the same on every
    rank), this rank's sigma-point noise from the key's counter stream
    (:meth:`GaussianSum.draw_inputs_at_t`, samples ``p (2 nx + 1) + s``
    of this rank's Gaussians ``p``); per-rank ``predict_core`` and
    ``update_core``; the resample of ``(means, covariances)`` by
    ``"xla"`` (the rings), ``"kernel"`` (A on the 30-column bank) or
    ``"a2a"``/``"a2a_ring"`` (merged in plain torch, as the reference
    merges them in XLA). The step is the same at every width.
    ``step.from_noise(means, covariances, weights, u, z, dt,
    measurement_pdf, noise, r)`` takes this rank's noise, ``(2 nx + 1,
    nx, n_local)`` lanes-last, and ``r``, and returns ``((means,
    covariances), weights)``. Graphed as :func:`make_shard_map_step`'s
    step is."""
    route = _route(_GSUKF_ROUTES, resample_impl)
    graphed = graphable(mesh, route[1])
    carries = {} if graphed else None

    def from_noise(means, covariances, weights, u, z, dt, measurement_pdf,
                   noise, r):
        means, covs = gsf.predict_core(means, covariances, u, dt, noise, f,
                                       noise_is_lanes=True)
        means, covs, weights = gsf.update_core(means, covs, weights, u, z, g,
                                               measurement_pdf)
        return _resample((means, covs), weights, r, mesh, route, carries)

    def step(state: GSUKFState, u, z, dt, state_pdf, measurement_pdf):
        n_local, nx = state.means.shape
        s = 2 * nx + 1
        gen, dev = state.generator, state.weights.device
        key = key_from(gen, dev)
        r = torch.rand((), generator=gen, dtype=torch.float32, device=dev)
        noise = state_pdf.draw_t_from(*state_pdf.draw_inputs_at_t(
            key, mesh.rank * n_local * s, n_local * s))
        (means, covs), weights = from_noise(
            state.means, state.covariances, state.weights, u, z, dt,
            measurement_pdf, noise.reshape(nx, n_local, s).permute(2, 0, 1),
            r)
        return GSUKFState(means, covs, weights, gen)

    return _entry(step, from_noise, graphed)


# ----------------------------------------------------------------------
# the tiled step (:1189-1262)
# ----------------------------------------------------------------------
def _rank_seed(seed: int, rank: int) -> int:
    """A 63-bit seed for rank ``rank``'s stream of the run seeded by
    ``seed``."""
    state = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def shard_tiled_pf_state(state: TiledPFState, mesh: Mesh) -> TiledPFState:
    """This rank's particles, ``(nx, n_local)`` of the global ``(nx, n)``
    state, and its own noise stream on the mesh's device, seeded from
    the state generator's initial seed and the rank."""
    gen = torch.Generator(device=mesh.device).manual_seed(
        _rank_seed(state.generator.initial_seed(), mesh.rank))
    return TiledPFState(particle_sharding(mesh, state.x, dim=1), gen)


def make_shard_map_tiled_step(mesh: Mesh, f, g, exchange: str = "ragged"):
    """The sharded tiled PF step ``step(state, u, z, dt, state_pdf,
    measurement_pdf) -> TiledPFState`` on this rank's SoA ``(nx,
    n_local)`` particles, which stay in that layout across steps: noise
    from this rank's stream (:func:`shard_tiled_pf_state`), then ``r``,
    which every rank takes from rank 0; ``predict_update_local``;
    :func:`_segmented_ends`; ``compact`` (K2), the survivor exchange
    (``"ragged"`` or ``"ring"``), ``expand`` (K1), whose output is the
    next state. Given the same particles and weights the resample is
    bit-equal to every other route's; the noise depends on the width, as
    the reference's does. Over the ``"ring"`` exchange the step is one
    graph replay a call where the mesh allows (:func:`graphable`)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")

    def from_noise(x, u, z, dt, measurement_pdf, noise, r):
        xn, w = pft.predict_update_local(x, u, z, dt, f, g, measurement_pdf,
                                         noise)
        ends, prev = _segmented_ends(w, r, mesh)
        return _a2a_compact_exchange_merge(xn, ends, prev, mesh, exchange)

    def step(state: TiledPFState, u, z, dt, state_pdf, measurement_pdf):
        x, gen = state.x, state.generator
        noise = state_pdf.draw_t(gen, x.shape[1])
        r = _comm.broadcast(mesh, torch.rand(
            (), generator=gen, dtype=x.dtype, device=x.device), 0)
        return TiledPFState(
            from_noise(x, u, z, dt, measurement_pdf, noise, r), gen)

    return _entry(step, from_noise, graphable(mesh, exchange))


# ----------------------------------------------------------------------
# the moments of the whole population (the reference's point_estimate
# and point_covariance on a sharded state: a psum under jit)
# ----------------------------------------------------------------------
def _block_sums(x: torch.Tensor, b: int) -> torch.Tensor:
    """``(n / b, ...)``: the sums of ``x``'s consecutive ``b``-row
    blocks, by a pairwise tree of elementwise adds (each block
    zero-padded to a power of two): the same additions in the same order
    however many blocks there are, on any device. A reduction kernel's
    order on the card may change with the number of blocks, and with it
    the bits at another width."""
    n, rest = x.shape[0], tuple(x.shape[1:])
    s = x.reshape(n // b, b, -1)
    p = 1 << (b - 1).bit_length()
    if p != b:
        s = torch.cat([s, s.new_zeros((n // b, p - b, s.shape[2]))], dim=1)
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    return s.reshape((n // b,) + rest)


def _global_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over every rank's rows of ``x`` (this rank's ``(n_local,
    ...)``) in the blocks that ``ops/reduce.blocked_sum`` takes at the
    global row count. Where this rank's rows hold whole blocks, the
    block sums are all-gathered and every rank sums the ``(n_global /
    block, ...)`` partials in one order: the same bits on every rank and
    at every width. Otherwise each rank's own blocked sum is gathered
    and summed."""
    n_local = x.shape[0]
    b = _block(n_local * mesh.size, _MOMENT_BLOCK)
    part = (_block_sums(x, b) if b > 1 and n_local % b == 0
            else blocked_sum(x)[None])
    # row-major at every width: the sum's kernel, and with it the order
    # of its additions, follows the layout
    return torch.sum(_gathered(mesh, part.contiguous()), dim=0)


def _global_outer_sum(mesh: Mesh, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """``sum_i outer(a_i, b_i)`` over every rank's rows, by the blocks of
    ``ops/reduce.blocked_outer_sum`` at the global row count, as
    :func:`_global_sum` takes them."""
    n_local = a.shape[0]
    blk = _block(n_local * mesh.size, _MOMENT_BLOCK)
    if blk > 1 and n_local % blk == 0:
        part = torch.einsum("kbi,kbj->kij", a.reshape(-1, blk, a.shape[1]),
                            b.reshape(-1, blk, b.shape[1]))
    else:
        part = blocked_outer_sum(a, b)[None]
    return torch.sum(_gathered(mesh, part.contiguous()), dim=0)


def _weighted_mean(mesh: Mesh, weights: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i x_i / sum_i w_i`` over every rank's rows, the weights
    normalized by the global total first, as ``ops/reduce.weighted_mean``
    does."""
    w = weights / _global_sum(mesh, weights)
    return _global_sum(mesh, w.reshape((-1,) + (1,) * (x.dim() - 1)) * x)


def _tiled_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The uniform-weight mean of every rank's ``(nx, n_local)``
    particles in ``particle_tiled.point_estimate``'s 128-particle blocks:
    where this rank holds whole blocks, the block sums are gathered and
    summed in global order, bit-equal to the single-device estimate of
    the whole population; otherwise each rank's zero-padded blocks are
    summed and the ranks' sums added."""
    nx, n_local = x.shape
    pad = (-n_local) % pft.LANES
    if pad:
        x = torch.cat([x, x.new_zeros((nx, pad))], dim=1)
    part = torch.sum(x.reshape(nx, -1, pft.LANES), dim=2)
    if pad:
        part = torch.sum(part, dim=1, keepdim=True)
    blocks = _comm.all_gather(mesh, part).transpose(0, 1)
    return torch.sum(blocks.reshape(nx, -1), dim=1) / (n_local * mesh.size)


def point_estimate(state, mesh: Mesh) -> torch.Tensor:
    """The point estimate of the whole population from this rank's slice
    of a ``PFState`` or ``GSUKFState`` (the weighted mean, normalized) or
    of a ``TiledPFState`` (the mean): the same bits on every rank, and at
    every width whose shards hold whole blocks of the single-device
    reduction (4096 rows; 128 particles for the tiled state)."""
    if isinstance(state, TiledPFState):
        return _tiled_mean(mesh, state.x)
    if isinstance(state, GSUKFState):
        return _weighted_mean(mesh, state.weights, state.means)
    if isinstance(state, PFState):
        return _weighted_mean(mesh, state.weights, state.particles)
    raise TypeError(f"no point estimate of a {type(state).__name__}")


def point_covariance(state, mesh: Mesh) -> torch.Tensor:
    """The largest singular value of the whole population's covariance
    from this rank's slice: the weighted particle covariance of a
    ``PFState``, ``E[cov] + Var[means]`` of a ``GSUKFState``; the same
    bits on every rank."""
    if isinstance(state, GSUKFState):
        x, weights = state.means, state.weights
    elif isinstance(state, PFState):
        x, weights = state.particles, state.weights
    else:
        raise TypeError(f"no point covariance of a {type(state).__name__}")
    w = weights / _global_sum(mesh, weights)
    dist = x - _weighted_mean(mesh, weights, x)
    cov = _global_outer_sum(mesh, dist, dist * w[:, None])
    if isinstance(state, GSUKFState):
        cov = _global_sum(mesh, w[:, None, None] * state.covariances) + cov
    return torch.linalg.svdvals(cov)[0]
