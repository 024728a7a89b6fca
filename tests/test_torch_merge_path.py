"""The merge path of ``ends_merge_round`` and ``cumsum_merge``, and the
blocks of ``coarse_gather``, on the CPU.

* A numpy model that follows the control flow of
  ``gpu_se_tpu_torch/csrc/merge_path.cuh`` (each block's two diagonal
  splits by a warp's 32-ary search, its staged key segment, each
  thread's split in that segment and its serial walk), and of the clip
  of ``resample_block.cu``, gives ``searchsorted(keys, targets, "left")``
  for every slot of every block: the int32 ``ends`` against ``slot0 +
  s``, and the float32 normalized cumsum against ``(i + r) / n``, on the
  edge cases of ``gpu_se_tpu_torch/rig.py`` and the ring feeds' rounds.
  Change the kernels' logic and this model together; its threads a
  block and items a thread are ``rig.MERGE_THREADS``,
  ``rig.ENDS_MERGE_ITEMS`` and ``rig.CUMSUM_MERGE_ITEMS``, which a
  ``gpu`` test holds to the library's.
* A numpy model of ``gpu_se_tpu_torch/csrc/resample_coarse.cu``: blocks
  of ``rig.COARSE_CHUNKS`` chunks, their keys from the chunk boundaries
  ``o``, every stride-th key staged (at most ``rig.COARSE_STAGE``; every
  key when the range fits), the same walk, and each slot's gap between
  two samples searched in device memory, all threads of a batch of
  blocks at once; it gives
  ``searchsorted(ends, i, "left")`` for every slot of every ``rig`` case
  up to 2^24. Its constants are held to ``gst_coarse_chunks()`` and
  ``gst_coarse_stage()`` by a ``gpu`` test.
* The plain versions against the reference's Pallas kernels in
  interpret mode: ``ends_merge_round_plain`` through both round entries
  at ring geometries (``n_blk != n_local``, source blocks wholly below
  and wholly above the shard's slots, rounds over state that earlier
  rounds finalized in part), ``cumsum_merge_plain`` against the v3 entry
  at 1 and 8 rows.

Tolerance: integer logic and copies, so bit-equal.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.ops import resample_pallas3 as jrp3
from gpu_se_tpu.ops import resample_pallas_block as jrb
from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.ops import resample_coarse as trc
from gpu_se_tpu_torch.ops import resample_pallas3 as trp3
from gpu_se_tpu_torch.ops import resample_pallas_block as trb
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights as t_ends

THREADS = rig.MERGE_THREADS        # held to the library's on the card
A_ITEMS = rig.ENDS_MERGE_ITEMS     # items a thread: ends_merge_round
B_ITEMS = rig.CUMSUM_MERGE_ITEMS   # and cumsum_merge
D = THREADS * A_ITEMS              # ends_merge_round's items a block
PAIRS = sorted({(f, n) for f, n, _ in rig.ends_merge_cases(rig.CPU_EDGE_N)})
PAIR_IDS = [f"{f}-{n}" for f, n in PAIRS]
RINGS = [c for c in rig.RING_FEEDS if c[1] <= rig.CPU_EDGE_N]
RING_IDS = ["-".join(str(v) for v in c) for c in RINGS]
# block shapes the model met, summed over the tests of this module
SEEN = collections.Counter()


def _ends(family, n):
    exact = rig.edge_exact_ends(family, n)
    if exact is not None:
        return exact
    w, r = rig.edge_weights(family, n)
    return t_ends(torch.from_numpy(w), torch.tensor(r)).numpy()


def _cs(family, n):
    w, r = rig.edge_weights(family, n)
    return trp3.normalized_cumsum(torch.from_numpy(w), r).numpy(), r


def positions(n, r):
    """``(i + r) / n`` in float32 with IEEE rounding, the kernel's
    ``PositionTarget``."""
    return (np.arange(n, dtype=np.float32) + np.float32(r)) / np.float32(n)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def warp_lower_bound(keys, v):
    """``warp_stage.cuh`` ``warp_lower_bound``: ``#{keys < v}``."""
    lane = np.arange(32)
    lo, hi = 0, keys.shape[0]
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        p = lo + (lane + 1) * step - 1
        less = (p < hi) & (keys[np.minimum(p, hi - 1)] < v)
        cnt = int(less.sum())
        hi = min(hi, lo + (cnt + 1) * step - 1)
        lo = min(hi, lo + cnt * step)
    p = lo + lane
    less = (p < hi) & (keys[np.minimum(p, max(hi - 1, 0))] < v)
    return lo + int(less.sum())


def warp_merge_split(keys, targets, d):
    """``merge_path.cuh`` ``warp_merge_split``: ``(the keys among the
    first d merged items, rounds)``, 32 probes along the diagonal a
    round."""
    lane = np.arange(32)
    lo, hi, rounds = max(0, d - targets.shape[0]), min(d, keys.shape[0]), 1

    def before(p):
        out = np.zeros(32, dtype=bool)
        ok = p < hi
        out[ok] = keys[p[ok]] < targets[d - 1 - p[ok]]
        return out

    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        b = before(lo + (lane + 1) * step - 1)
        cnt = int(b.sum())
        assert b[:cnt].all() and not b[cnt:].any()     # a prefix
        hi = min(hi, lo + (cnt + 1) * step - 1)
        lo = min(hi, lo + cnt * step)
        rounds += 1
    b = before(lo + lane)
    assert b[:int(b.sum())].all()
    return lo + int(b.sum()), rounds


def merge_block(keys, targets, b, base, counts, items):
    """``merge_block`` for block ``b``, ``items`` a thread: fills
    ``counts[j0:j1]``."""
    block = THREADS * items
    total = keys.shape[0] + targets.shape[0]
    d0, d1 = b * block, min(b * block + block, total)
    i0, i1 = (warp_merge_split(keys, targets, d)[0] for d in (d0, d1))
    j0, nk = d0 - i0, i1 - i0
    ns = d1 - d0 - nk
    assert 0 <= nk <= block and 0 <= ns <= block   # the segment fits
    SEEN["no keys" if nk == 0 else "no slots" if ns == 0 else "mixed"] += 1
    sk, st = keys[i0:i1], targets[j0:j0 + ns]
    nb = nk + ns
    for t in range(THREADS):
        dt = min(t * items, nb)
        lo, hi = max(0, dt - ns), min(dt, nk)
        while lo < hi:
            mid = (lo + hi) >> 1
            if sk[mid] < st[dt - 1 - mid]:
                lo = mid + 1
            else:
                hi = mid
        ki, sj = lo, dt - lo
        for _ in range(dt, min(dt + items, nb)):
            if sj < ns and not (ki < nk and sk[ki] < st[sj]):
                assert counts[j0 + sj] == -1          # one writer a slot
                counts[j0 + sj] = base + i0 + ki
                sj += 1
            else:
                ki += 1


def merge_model(keys, targets, items, base=0):
    counts = np.full(targets.shape[0], -1, dtype=np.int64)
    block = THREADS * items
    for b in range(-(-(keys.shape[0] + targets.shape[0]) // block)):
        merge_block(keys, targets, b, base, counts, items)
    assert (counts >= 0).all()
    return counts


def ends_round_model(ends, slot0, n_local):
    """``ends_merge_round_kernel``'s counts: the clip, then the merge of
    ``ends[a_lo:a_hi]`` with the global slots, offset by ``a_lo``."""
    a_lo = warp_lower_bound(ends, slot0)
    a_hi = warp_lower_bound(ends, slot0 + n_local)
    targets = slot0 + np.arange(n_local, dtype=np.int64)
    if a_hi - a_lo + n_local == 0:
        return np.zeros(0, dtype=np.int64)
    return merge_model(ends[a_lo:a_hi], targets, A_ITEMS, base=a_lo)


# ----------------------------------------------------------------------
# the model against searchsorted
# ----------------------------------------------------------------------
@pytest.mark.parametrize("family, n", PAIRS, ids=PAIR_IDS)
def test_ends_merge_model_equals_searchsorted(family, n):
    ends = _ends(family, n)
    for slot0, n_local in ((0, n), (-3, n), (n // 3, n - n // 3),
                           (n + 7, n), (-n - 9, n)):
        want = np.searchsorted(ends, slot0 + np.arange(n_local), "left")
        np.testing.assert_array_equal(ends_round_model(ends, slot0, n_local),
                                      want, err_msg=f"slot0={slot0}")


@pytest.mark.parametrize("family, n", PAIRS, ids=PAIR_IDS)
def test_cumsum_merge_model_equals_searchsorted(family, n):
    cs, r = _cs(family, n)
    targets = positions(n, r)
    np.testing.assert_array_equal(merge_model(cs, targets, B_ITEMS),
                                  np.searchsorted(cs, targets, "left"))


@pytest.mark.parametrize("family, n", PAIRS, ids=PAIR_IDS)
def test_plain_positions_are_the_kernels(family, n):
    """The plain version's ``(arange + r) / n_t`` is the kernel's
    ``__fdiv_rn(float(i) + r, float(n))``, bit for bit: one formula on
    both sides, or the two part at ties."""
    _, r = rig.edge_weights(family, n)
    got = trp3._positions(n, torch.tensor(r)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  positions(n, r).view(np.int32))


@pytest.mark.parametrize("feed", RINGS, ids=RING_IDS)
def test_ring_rounds_model_equals_searchsorted(feed):
    """Every round of a ring feed: each shard (``slot0``) against each
    source block, ``n_blk != n_local``; the feeds of exact ``ends`` put
    blocks wholly below and wholly above a shard."""
    family, n, blocks, shards = feed
    ends = _ends(family, n)
    kinds = collections.Counter()
    src, dst = rig.ring_bounds(n, blocks), rig.ring_bounds(n, shards)
    for s0, s1 in zip(dst, dst[1:]):
        for b0, b1 in zip(src, src[1:]):
            blk = ends[b0:b1]
            kinds["below" if blk[-1] < s0 else "above" if blk[0] >= s1
                  else "across"] += 1
            want = np.searchsorted(blk, np.arange(s0, s1), "left")
            np.testing.assert_array_equal(
                ends_round_model(blk, s0, s1 - s0), want)
    if family == "all_survive":
        assert kinds["below"] and kinds["above"] and kinds["across"]


def test_ties_put_the_slot_first():
    """Keys equal to targets, repeated, in both types: the slot goes
    before an equal key, as ``searchsorted(..., "left")``."""
    n = 3 * THREADS * max(A_ITEMS, B_ITEMS) + 5    # 3 blocks of each
    ends = np.repeat(np.arange(0, n, 3, dtype=np.int32), 3)[:n]
    np.testing.assert_array_equal(
        ends_round_model(ends, 0, n),
        np.searchsorted(ends, np.arange(n), "left"))
    targets = positions(n, np.float32(0.5))
    cs = np.sort(np.concatenate([np.repeat(targets[::7], 2),
                                 targets[3::11]]))[:n].astype(np.float32)
    assert np.isin(cs, targets).sum() > n // 5
    np.testing.assert_array_equal(merge_model(cs, targets, B_ITEMS),
                                  np.searchsorted(cs, targets, "left"))


def test_blocks_of_only_slots_and_only_keys():
    """One survivor: its run of ``n - 1`` keys lies after every slot,
    so the merge has blocks of slots alone and blocks of keys alone."""
    SEEN.clear()
    n = 4 * D + 1
    ends = np.full(n, n - 1, dtype=np.int32)
    ends[:n // 3] = -1
    np.testing.assert_array_equal(ends_round_model(ends, 0, n),
                                  np.searchsorted(ends, np.arange(n), "left"))
    assert SEEN["no keys"] and SEEN["no slots"]


def test_a_block_takes_its_diagonal_in_four_warp_rounds_at_2_to_20():
    """Every block's split is one warp's search of at most 4 rounds over
    2^20 keys and 2^20 slots, not a thread's 20 dependent loads."""
    n = 2**20
    keys = np.sort(np.random.default_rng(0).integers(0, n, n)).astype(
        np.int32)
    targets = np.arange(n)
    merged = np.sort(np.concatenate([keys * 2 + 1, targets * 2]))
    for d in (0, 1, D, n, n + 12345, 2 * n - 1, 2 * n):
        split, rounds = warp_merge_split(keys, targets, d)
        assert split == np.count_nonzero(merged[:d] & 1)  # keys are odd
        assert rounds <= 4


# ----------------------------------------------------------------------
# the model of coarse_gather (csrc/resample_coarse.cu), all threads of a
# batch of blocks at once
# ----------------------------------------------------------------------
C_CHUNK = rig.COARSE_CHUNK
C_SLOTS = C_CHUNK * rig.COARSE_CHUNKS      # a block's slots
C_STAGE = rig.COARSE_STAGE                 # the keys a block stages
C_THREAD_SLOTS = C_SLOTS // THREADS        # the slots a thread refines
C_BATCH = 1024                             # blocks the model takes at once
C_PAIRS = sorted({(f, n) for f, n, _ in rig.coarse_cases()})
C_PAIR_IDS = [f"{f}-{n}" for f, n in C_PAIRS]
# the items a thread walked at most, over the tests of this module
C_ITEMS = collections.Counter()


def coarse_walk(ends, i0, stride, nq, j0, ns, counts):
    """The staged walk of a batch of blocks: the samples ``sk[q] =
    ends[i0 + q stride]``, ``q < nq`` (every key when ``stride`` is 1),
    merged with the slots ``[j0, j0 + ns)``, each thread's items found by
    its binary search of the block's diagonal, then walked. Sets
    ``counts[j0 + s]`` to the count of samples before the slot."""
    assert (nq <= C_STAGE).all()                     # the stage holds them
    t = np.arange(THREADS)[None, :]
    i0, stride, nq, j0, ns = (v[:, None] for v in (i0, stride, nq, j0, ns))
    last = ends.shape[0] - 1

    def sk(q):
        return ends[np.minimum(i0 + q * stride, last)]

    nb = nq + ns
    items = -(-nb // THREADS)
    dt = np.minimum(t * items, nb)
    end = np.minimum(dt + items, nb)
    lo, hi = np.maximum(0, dt - ns), np.minimum(dt, nq)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        less = sk(np.where(act, mid, 0)) < j0 + dt - 1 - mid
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    ki, sj = lo, dt - lo
    for step in range(int(items.max())):
        act = dt + step < end
        key_first = (ki < nq) & (sk(ki) < j0 + sj)
        slot = act & (sj < ns) & ~key_first
        pos = (j0 + sj)[slot]
        assert (counts[pos] == -1).all()                # one writer a slot
        assert np.unique(pos).shape == pos.shape
        counts[pos] = ki[slot]
        sj = sj + slot
        ki = ki + (act & ~slot)
    C_ITEMS["max"] = max(C_ITEMS["max"], int(items.max()))


def coarse_refine(ends, i0, nk, stride, j0, ns, counts):
    """``refine_counts`` for a batch of blocks: each thread's slots ``t +
    u THREADS`` searched in their gap between two samples (empty at
    stride 1), in device memory, all in step. Returns the rounds of loads
    of each thread."""
    s = (np.arange(THREADS)[:, None]
         + THREADS * np.arange(C_THREAD_SLOTS)[None, :])[None]
    i0, nk, stride, j0, ns = (v[:, None, None] for v in
                              (i0, nk, stride, j0, ns))
    ok = s < ns
    q = np.where(ok, counts[np.where(ok, j0 + s, 0)], 0)
    lo = np.where(q == 0, i0, i0 + (q - 1) * stride + 1)
    length = np.where(q == 0, 0, np.minimum(i0 + q * stride, i0 + nk) - lo)
    assert (length < stride).all()
    rounds = np.zeros(lo.shape[:2], dtype=np.int64)
    while (length > 0).any():
        act = length > 0
        rounds += act.any(axis=2)
        half = length >> 1
        mid = lo + half
        less = act & (ends[np.where(act, mid, 0)] < j0 + s)
        lo = np.where(less, mid + 1, lo)
        length = np.where(less, length - half - 1,
                          np.where(act, half, length))
    counts[(j0 + s)[ok]] = lo[ok]
    return rounds


def coarse_model(ends, o):
    """``coarse_gather_kernel``'s counts ``#{k : ends_k < i}`` of every
    slot (before the clamp to ``n - 1``), block by block as the kernel's
    grid takes them; the most rounds of loads a thread of a sampled block
    made; and the largest stride."""
    n = ends.shape[0]
    chunks = n // C_CHUNK
    o = o.astype(np.int64)
    counts = np.full(n, -1, dtype=np.int64)
    c0 = np.arange(0, chunks, rig.COARSE_CHUNKS)
    c1 = np.minimum(c0 + rig.COARSE_CHUNKS, chunks)
    i0, j0, ns = o[c0], c0 * C_CHUNK, (c1 - c0) * C_CHUNK
    nk = np.maximum(o[c1] - i0, 0)
    stride = np.maximum(1, -(-nk // C_STAGE))
    nq = -(-nk // stride)
    SEEN["coarse sampled"] += int((stride > 1).sum())
    SEEN["coarse no keys"] += int((nk == 0).sum())
    SEEN["coarse staged"] += int(((stride == 1) & (nk > 0)).sum())
    rounds = 0
    # each block's counts lie in [i0, i0 + nk]: its ancestors in the payload
    # columns the staged epilogue copies
    lo_of, hi_of = np.repeat(i0, ns), np.repeat(i0 + nk, ns)
    for b in range(0, c0.shape[0], C_BATCH):
        sl = slice(b, b + C_BATCH)
        coarse_walk(ends, i0[sl], stride[sl], nq[sl], j0[sl], ns[sl], counts)
        rounds = max(rounds, int(coarse_refine(
            ends, i0[sl], nk[sl], stride[sl], j0[sl], ns[sl], counts).max()))
    assert (counts >= 0).all()                          # every slot written
    assert ((lo_of <= counts) & (counts <= hi_of)).all()
    return counts, rounds, int(stride.max())


def _coarse_ends(family, n):
    ends = _ends(family, n)
    o = trc.chunk_boundaries(torch.from_numpy(ends), n).numpy()
    return ends, o


@pytest.mark.parametrize("family, n", C_PAIRS, ids=C_PAIR_IDS)
def test_coarse_model_equals_searchsorted(family, n):
    """Every ``rig`` case of ``coarse_gather``, 2^24 included: every slot
    of every block written once, equal to ``searchsorted(left)``; a
    thread walks at most ``(stage + slots) / threads`` items, and a thread
    of a sampled block makes at most ``log2(stride) + 1`` rounds of
    loads."""
    ends, o = _coarse_ends(family, n)
    counts, rounds, stride = coarse_model(ends, o)
    np.testing.assert_array_equal(
        counts, np.searchsorted(ends, np.arange(n, dtype=np.int32), "left"))
    assert C_ITEMS["max"] <= -(-(C_STAGE + C_SLOTS) // THREADS)
    assert rounds <= int(stride - 1).bit_length()


def test_coarse_one_survivor_samples_its_long_chunk():
    """One survivor at 2^20: the last chunk's window holds every key from
    the survivor on. Its block stages every stride-th key and makes no
    load in device memory past its samples, where a walk would read the
    whole range; the blocks before it hold no keys."""
    SEEN.clear()
    n = 2**20
    ends, o = _coarse_ends("one_survivor", n)
    assert o[-1] - o[-2] > C_STAGE
    counts, rounds, _ = coarse_model(ends, o)
    np.testing.assert_array_equal(
        counts, np.searchsorted(ends, np.arange(n), "left"))
    assert SEEN["coarse sampled"] == 1 and SEEN["coarse no keys"] > 0
    assert rounds == 0


@pytest.mark.parametrize("kind", ["all_in_last_chunk", "all_below_zero",
                                  "ties", "runs_across_sampled_blocks"])
def test_coarse_model_on_shaped_ends(kind):
    """Windows the rig's families do not make: every key in the last
    chunk (its window holds all n keys), every key below slot 0 (every
    window empty, counts n), keys equal to slots, and long runs of
    distinct keys that put sampled blocks, whose gaps hold keys both
    below and above a slot, beside staged ones."""
    SEEN.clear()
    n = -(-4 * C_STAGE // C_SLOTS) * C_SLOTS      # whole blocks
    if kind == "all_in_last_chunk":
        ends = np.full(n, n - 1, dtype=np.int32)
    elif kind == "all_below_zero":
        ends = np.full(n, -1, dtype=np.int32)
    elif kind == "ties":
        ends = np.repeat(np.arange(0, n, 3, dtype=np.int32), 3)[:n]
    else:
        # block 0: twice the stage of keys spread over its slots (stride
        # 3, gaps with keys on both sides of a slot); one run of equal
        # keys past the stage in block 2; the rest spread over all slots
        rng = np.random.default_rng(5)
        dense = rng.integers(0, C_SLOTS, 2 * C_STAGE + 1)
        run = np.full(C_STAGE + 1, 2 * C_SLOTS + 7)
        rest = rng.integers(0, n, n - dense.shape[0] - run.shape[0])
        ends = np.sort(np.concatenate([dense, run, rest])).astype(np.int32)
    assert ends.shape == (n,)
    o = trc.chunk_boundaries(torch.from_numpy(ends), n).numpy()
    counts, rounds, _ = coarse_model(ends, o)
    np.testing.assert_array_equal(
        counts, np.searchsorted(ends, np.arange(n), "left"))
    if kind == "all_in_last_chunk":
        assert SEEN["coarse sampled"] == 1
    if kind == "all_below_zero":
        assert SEEN["coarse no keys"] == n // C_SLOTS
    if kind == "runs_across_sampled_blocks":
        assert SEEN["coarse sampled"] >= 2 and SEEN["coarse staged"] >= 1
        assert rounds >= 1


# ----------------------------------------------------------------------
# the plain versions against the reference's kernels, interpret mode
# ----------------------------------------------------------------------
def _state_np(state):
    return [np.asarray(s) for s in state]


# (family, n, source block bounds, shard slots, entry): one survivor at
# entry 700 makes its block wholly above shard [0, 256) with every slot
# still open, so each slot takes that block's first row
RING_GEOMETRIES = [
    ("all_survive", 1024, (0, 100, 484, 600, 1024), (256, 512), "sync"),
    ("all_survive", 1024, (0, 100, 484, 600, 1024), (256, 512), "pipe"),
    ("one_survivor", 1024, (0, 300, 700, 1024), (0, 256), "sync"),
]


@pytest.mark.parametrize("family, n, bounds, shard, entry", RING_GEOMETRIES)
def test_ring_rounds_plain_equal_reference(family, n, bounds, shard, entry):
    ends = np.arange(n, dtype=np.int32)
    if family == "one_survivor":
        ends = np.where(ends < 700, -1, n - 1).astype(np.int32)
    parts = np.ascontiguousarray(rig.edge_payload(5, n).T)
    slot0, n_local = shard[0], shard[1] - shard[0]
    j_round, t_round, block_slots = {
        "sync": (jrb.pallas_block_resample_round,
                 trb.block_resample_round, 128),
        "pipe": (jrb.pallas_block_resample_round_pipelined,
                 trb.block_resample_round_pipelined, 256)}[entry]
    js = jrb.block_resample_state(n_local, 5)
    ts = trb.block_resample_state(n_local, 5, device="cpu")
    for b0, b1 in zip(bounds, bounds[1:]):
        js = j_round(jnp.asarray(ends[b0:b1]), jnp.asarray(parts[b0:b1]),
                     slot0, *js, block_slots, 256, interpret=True)
        ts = t_round(torch.from_numpy(ends[b0:b1]),
                     torch.from_numpy(parts[b0:b1]), slot0, *ts,
                     block_slots=block_slots)
        for g, w in zip(ts, _state_np(js)):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"block [{b0}, {b1})")
    assert float(ts[2].sum()) == n_local        # every slot finalized
    if family == "one_survivor":
        np.testing.assert_array_equal(ts[1][:, :5].numpy(),
                                      np.broadcast_to(parts[700], (256, 5)))


@pytest.mark.parametrize("rows", [1, 8])
def test_cumsum_merge_plain_equals_reference_v3(rows):
    n = 1024
    w, r = rig.edge_weights("heavy", n)
    parts = np.ascontiguousarray(rig.edge_payload(rows, n).T)
    cs = jnp.cumsum(jnp.asarray(w))
    cs = np.array(jax.lax.cummax(cs / cs[-1]))
    want_rows, want_anc = (np.asarray(a) for a in
                           jrp3.pallas_systematic_resample_pipelined(
                               jnp.asarray(parts), jnp.asarray(w),
                               jnp.asarray(r), interpret=True))
    out, anc = trp3.cumsum_merge_plain(
        torch.from_numpy(cs), torch.from_numpy(parts.T.copy()),
        torch.tensor(r))
    np.testing.assert_array_equal(anc.numpy(), want_anc)
    np.testing.assert_array_equal(out.numpy().T, want_rows)
