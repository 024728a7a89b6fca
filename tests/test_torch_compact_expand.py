"""``compact`` and ``expand`` on the edge cases they share with the card
tests and ``chip_smoke.py`` (``gpu_se_tpu_torch/rig.py``), on the CPU.

* the plain versions against numpy oracles (``flatnonzero``,
  ``searchsorted``) and, from n = 4096 on, ``resample_core`` against the
  reference's tiled Pallas entry in interpret mode, the port fed the
  ``ends`` of the reference's own ``ends_from_weights`` (the two
  libraries' cumsums may part at ties);
* the identities the CUDA kernels rest on, as numpy models that follow
  the kernels' control flow: the placement of the dead entries from the
  end, tile by tile; the survivor window of a chunk and the 0-or-1 step
  between neighbouring slots; the warp's 32-ary bracket; the galloping
  continuation for keys that repeat.

Tolerance: everything here is integer logic and copies, so bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.ops import resample_pallas4 as jrp4
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights as t_ends

CASES = rig.edge_cases(rig.CPU_EDGE_N)
IDS = [rig.edge_id(c) for c in CASES]
INT32_MAX = 2**31 - 1
COMPACT_TILE = rig.COMPACT_TILE    # held to the library's on the card
MAX_STAGE = rig.EXPAND_MAX_STAGE


def _ends(family, n):
    exact = rig.edge_exact_ends(family, n)
    if exact is not None:
        return exact
    w, r = rig.edge_weights(family, n)
    return t_ends(torch.from_numpy(w), torch.tensor(r)).numpy()


def _survivors(ends):
    return np.flatnonzero(np.diff(ends, prepend=np.int32(-1)) > 0)


def _compacted_keys(ends):
    kept = _survivors(ends)
    keys = np.full(ends.shape[0], INT32_MAX, dtype=np.int32)
    keys[:kept.shape[0]] = ends[kept]
    return keys


def _keys(kind, family, n):
    ends = _ends(family, n)
    return _compacted_keys(ends) if kind == "compacted" else ends


# ----------------------------------------------------------------------
# the plain versions against numpy, and the port against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [n for n in rig.EDGE_NS if n <= rig.CPU_EDGE_N])
def test_exact_ends_equal_ends_from_weights_at_small_n(n):
    """Where float32 is still exact, the ``ends`` written down for the
    all-survive case are those of the weights, in the port and in the
    reference."""
    w, r = rig.edge_weights("all_survive", n)
    exact = rig.edge_exact_ends("all_survive", n)
    np.testing.assert_array_equal(
        t_ends(torch.from_numpy(w), torch.tensor(r)).numpy(), exact)
    np.testing.assert_array_equal(
        np.asarray(j_ends(jnp.asarray(w), jnp.asarray(r))), exact)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compact_plain_equals_flatnonzero_oracle(case):
    family, n, rows = case
    ends = _ends(family, n)
    x = rig.edge_payload(rows, n)
    kept = _survivors(ends)
    m = kept.shape[0]
    assert m == {"all_survive": n, "one_survivor": 1}.get(family, m)
    assert 1 <= m <= n
    c_keys, c_payload, c_idx, count = trp4.compact(
        torch.from_numpy(ends), torch.from_numpy(x))
    assert count.dtype == torch.int32 and count.tolist() == [m]
    np.testing.assert_array_equal(c_keys.numpy()[:m], ends[kept])
    np.testing.assert_array_equal(c_idx.numpy()[:m], kept)
    np.testing.assert_array_equal(c_payload.numpy()[:, :m], x[:, kept])
    assert np.all(c_keys.numpy()[m:] == INT32_MAX)
    assert np.all(c_idx.numpy()[m:] == -1)
    assert not c_payload.numpy()[:, m:].any()
    assert not np.signbit(c_payload.numpy()[:, m:]).any()      # +0.0


@pytest.mark.parametrize("kind", ["compacted", "repeated"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_expand_plain_equals_searchsorted_oracle(case, kind):
    """On the compacted keys with their original indices and on the raw
    ``ends`` without (the direct route), at every chunk size."""
    family, n, rows = case
    ends = _ends(family, n)
    x = torch.from_numpy(rig.edge_payload(rows, n))
    if kind == "compacted":
        keys, payload, src, _ = trp4.compact(torch.from_numpy(ends), x)
    else:
        keys, payload, src = torch.from_numpy(ends), x, None
    j = np.minimum(np.searchsorted(keys.numpy(), np.arange(n), "left"),
                   n - 1)
    want_anc = j if src is None else src.numpy()[j]
    for block in rig.EXPAND_BLOCKS:
        out, anc = trp4.expand(keys, payload, src, block=block)
        assert anc.dtype == torch.int32
        np.testing.assert_array_equal(anc.numpy(), want_anc)
        np.testing.assert_array_equal(out.numpy(), payload.numpy()[:, j])
    if kind == "compacted":     # together: the resample by ends
        anc_direct = np.searchsorted(ends, np.arange(n), "left")
        np.testing.assert_array_equal(want_anc, anc_direct)


@pytest.mark.parametrize("family", rig.EDGE_FAMILIES)
@pytest.mark.parametrize("n", [n for n in rig.EDGE_NS
                               if 4096 <= n <= rig.CPU_EDGE_N]
                         + [8192, 12288])
def test_resample_core_equals_reference_tiled_entry(n, family):
    """The reference's tiled kernels in interpret mode against the port's
    ``resample_core`` on the reference's ``ends``; 8192 and 12288 span
    several of the reference's 4096-entry grid steps and of ``compact``'s
    tiles."""
    w, r = rig.edge_weights(family, n)
    parts = rig.edge_payload(5, n)
    want_rows, want_anc = jrp4.pallas_systematic_resample_tiled(
        jnp.asarray(parts.T), jnp.asarray(w), jnp.asarray(r), interpret=True)
    ends = np.array(j_ends(jnp.asarray(w), jnp.asarray(r)))
    out, anc = trp4.resample_core(torch.from_numpy(parts),
                                  torch.from_numpy(ends))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(want_anc))
    np.testing.assert_array_equal(out.numpy().T, np.asarray(want_rows))


# ----------------------------------------------------------------------
# compact: where the dead entries go
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dead_entries_counted_from_the_end_fill_the_tail(case):
    """Dead entry ``k`` at ``n - 1 - (k - rank_k)`` (``rank_k`` the
    survivors before it) is a bijection onto ``[count, n)``: the scatter
    needs no grand total."""
    family, n, _ = case
    ends = _ends(family, n)
    keep = np.diff(ends, prepend=np.int32(-1)) > 0
    rank = np.cumsum(keep) - keep
    dead = np.flatnonzero(~keep)
    pos = n - 1 - (dead - rank[dead])
    count = int(keep.sum())
    np.testing.assert_array_equal(np.sort(pos), np.arange(count, n))


@pytest.mark.parametrize("tile", [4, 1000, COMPACT_TILE])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_tiles_dead_entries_are_one_run_of_the_tail(case, tile):
    """What the kernel stores: tile ``t`` with ``excl`` survivors before
    it and ``c`` of its own puts survivor ``s`` at ``excl + s`` and fills
    ``[n - dead_before - dead, n - dead_before)``, ``dead_before = t *
    tile - excl``; over all tiles that is ``compact_plain``."""
    family, n, _ = case
    ends = _ends(family, n)
    keep = np.diff(ends, prepend=np.int32(-1)) > 0
    keys = np.full(n, -7, dtype=np.int64)
    idx = np.full(n, -7, dtype=np.int64)
    excl = 0
    for base in range(0, n, tile):
        k = base + np.flatnonzero(keep[base:base + tile])
        c = k.shape[0]
        keys[excl:excl + c] = ends[k]
        idx[excl:excl + c] = k
        dead = min(tile, n - base) - c
        lo = n - (base - excl) - dead
        assert np.all(keys[lo:lo + dead] == -7)         # written once
        keys[lo:lo + dead] = INT32_MAX
        idx[lo:lo + dead] = -1
        excl += c
    want = trp4.compact_plain(torch.from_numpy(ends),
                              torch.zeros((1, n)))
    np.testing.assert_array_equal(keys, want[0].numpy())
    np.testing.assert_array_equal(idx, want[2].numpy())
    assert excl == int(want[3])


# ----------------------------------------------------------------------
# expand: the window, the bracket and the steps, as the kernel takes them
# ----------------------------------------------------------------------
def warp_lower_bound(keys, v):
    """``csrc/resample_expand.cu`` ``warp_lower_bound``: 32 probes a
    round; returns ``(#{keys < v}, rounds)``."""
    lane = np.arange(32)
    lo, hi, rounds = 0, keys.shape[0], 0
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        p = lo + (lane + 1) * step - 1
        less = (p < hi) & (keys[np.minimum(p, hi - 1)] < v)
        cnt = int(less.sum())
        assert np.all(less[:cnt]) and not less[cnt:].any()
        hi = min(hi, lo + (cnt + 1) * step - 1)
        lo = min(hi, lo + cnt * step)
        rounds += 1
    p = lo + lane
    less = (p < hi) & (keys[np.minimum(p, max(hi - 1, 0))] < v)
    return lo + int(less.sum()), rounds + 1


def gallop(keys, start, v):
    """``gallop``: the first ``j >= start`` with ``keys[j] >= v``, or
    ``L``; returns it and the number of keys it read."""
    length, w, loads = keys.shape[0], 1, 0
    while start + w <= length:
        loads += 1
        if not keys[start + w - 1] < v:
            break
        start += w
        w <<= 1
    span = min(w - 1, length - start)
    loads += int(np.ceil(np.log2(span + 1)))
    return start + int(np.searchsorted(keys[start:start + span], v,
                                       "left")), loads


def expand_chunk(keys, c0, c1, block):
    """One block of ``expand_kernel``: the ancestors of slots ``[c0,
    c1)`` and how many slots left the 0-or-1 step."""
    length = keys.shape[0]
    lo, _ = warp_lower_bound(keys, c0)
    stage = min(block + 1, MAX_STAGE)
    ln = min(stage, length - lo)
    window = keys[lo:lo + ln]
    anc, searched = [], 0
    for i0 in range(c0, c1, 4):
        a = int(np.searchsorted(window, i0, "left"))
        j = lo + a
        if a == ln and j < length:
            j += int(np.searchsorted(keys[j:], i0, "left"))
        anc.append(j)
        for i in range(i0 + 1, min(i0 + 4, c1)):
            if j < length and keys[j] < i:
                j += 1
                if j < length and keys[j] < i:
                    j, _ = gallop(keys, j + 1, i)
                    searched += 1
            anc.append(j)
    return np.minimum(np.array(anc), length - 1), lo, searched


@pytest.mark.parametrize("kind", ["compacted", "repeated"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_warp_bracket_model_equals_searchsorted(case, kind):
    """The 32-ary bracket gives ``searchsorted(keys, c * block)`` for
    every chunk, in ``ceil(log32)`` rounds."""
    family, n, _ = case
    keys = _keys(kind, family, n)
    most = 1
    while 32**most < n:
        most += 1
    for block in rig.EXPAND_BLOCKS:
        starts = np.arange(0, n, block)
        if starts.shape[0] > 64:        # a spread of chunks, both ends in
            starts = starts[np.unique(np.linspace(
                0, starts.shape[0] - 1, 64).astype(int))]
        for c0 in starts:
            got, rounds = warp_lower_bound(keys, c0)
            assert got == np.searchsorted(keys, c0, "left")
            assert rounds <= most


def test_warp_bracket_model_takes_four_rounds_at_2_to_20():
    """Four rounds of 32 probes where one thread's binary search reads
    20 keys one after the other."""
    keys = np.arange(2**20, dtype=np.int32)
    seen = set()
    for v in (0, 1, 31, 32, 1023, 1024, 2**19 + 17, 2**20 - 1, 2**20):
        got, rounds = warp_lower_bound(keys, v)
        assert got == v and rounds <= 4
        seen.add(rounds)
    assert 4 in seen


@pytest.mark.parametrize("block", rig.EXPAND_BLOCKS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compacted_keys_step_by_at_most_one_inside_the_window(case, block):
    """Strictly increasing survivor keys: the ancestors of chunk ``c``
    lie in ``[lo_c, lo_c + block]`` and neighbouring slots' differ by 0
    or 1, so the kernel's step never has to search."""
    family, n, _ = case
    keys = _compacted_keys(_ends(family, n))
    anc = np.searchsorted(keys, np.arange(n), "left")
    assert np.all(np.isin(np.diff(anc), (0, 1)))
    for c0 in range(0, n, block):
        c1 = min(c0 + block, n)
        lo = np.searchsorted(keys, c0, "left")
        assert lo <= anc[c0] and anc[c1 - 1] <= lo + block
        if c0 // block < 8 or c1 == n:
            got, got_lo, searched = expand_chunk(keys, c0, c1, block)
            assert got_lo == lo and searched == 0
            np.testing.assert_array_equal(got, anc[c0:c1])


@pytest.mark.parametrize("block", rig.EXPAND_BLOCKS)
@pytest.mark.parametrize("n", [2049, 5001])
def test_repeated_keys_need_the_search_past_the_step(n, block):
    """The raw ``ends`` of heavy-tailed weights repeat: neighbouring
    ancestors jump by more than 1 and leave the window, and the kernel's
    continuation (a gallop in device memory) still finds them."""
    keys = _ends("heavy", n)
    anc = np.minimum(np.searchsorted(keys, np.arange(n), "left"), n - 1)
    assert np.diff(anc).max() > 1
    lo = np.searchsorted(keys, np.arange(0, n, block), "left")
    last = anc[np.minimum(np.arange(0, n, block) + block, n) - 1]
    if 3 <= block <= 1024:      # a block of one slot or of all cannot
        assert np.any(last > lo + block)
    total = 0
    for c0 in range(0, n, block):
        c1 = min(c0 + block, n)
        got, _, searched = expand_chunk(keys, c0, c1, block)
        np.testing.assert_array_equal(got, anc[c0:c1])
        total += searched
    assert total > 0 or block < 3


@pytest.mark.parametrize("seed", range(3))
def test_gallop_model_equals_searchsorted(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 400, 300)).astype(np.int32)
    for v in range(0, 402, 7):
        first = int(np.searchsorted(keys, v, "left"))
        for start in sorted({0, first // 2, max(first - 1, 0), first}):
            got, loads = gallop(keys, start, v)
            assert got == first
            assert loads <= 2 * np.ceil(np.log2(first - start + 2)) + 1
