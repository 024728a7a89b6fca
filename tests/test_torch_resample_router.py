"""The port's resample router and its merge entries against the JAX
reference.

The reference runs eagerly on the CPU, its Pallas kernels in interpret
mode. The port runs its plain versions, which the card tests
(``tests/test_torch_kernels.py``) hold the CUDA kernels to bit for bit.

* The integer-``ends`` block merge (``ops/resample_pallas_block``):
  given the reference's ``ends``, parts and carried state, the state
  after each round is bit-equal, for one round and for ascending feeds.
* The cumsum merge (``ops/resample_pallas3`` v3, ``ops/resample_pallas``
  v1): given the reference's normalized cumsum ``cs`` and ``r``, rows
  and ancestors are bit-equal.
* The coarse-window search (``ops/resample_coarse``): given the
  reference's ``ends`` and chunk boundaries, rows and ancestors are
  bit-equal to its kernel where the kernel's window holds every chunk,
  and to its entry (which falls back to the XLA path) where it does
  not.
* The router's gates decide as the reference's do over a grid of
  shapes and dtypes, with "the weights lie on a CUDA device" standing for
  "the backend is TPU".
* Every forced route on CPU tensors, given the reference's ``ends`` (or
  ``cs``) and ``r``, equals the reference's XLA route bit for bit; the
  merge routes compare floats, so they equal the reference's own merge
  kernels bit for bit and the XLA route up to a few tie rows; the tie
  rows are counted for five weight families.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.filters import resampling as jrs
from gpu_se_tpu.ops import resample_coarse as jrc
from gpu_se_tpu.ops import resample_pallas as jrp1
from gpu_se_tpu.ops import resample_pallas3 as jrp3
from gpu_se_tpu.ops import resample_pallas4 as jrp4
from gpu_se_tpu.ops import resample_pallas_block as jrb
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu_torch import pytree, rig
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops import resample_coarse as trc
from gpu_se_tpu_torch.ops import resample_pallas as trp1
from gpu_se_tpu_torch.ops import resample_pallas3 as trp3
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops import resample_pallas_block as trb

FAMILIES = ["near_uniform", "heavy"]
ALL_FAMILIES = FAMILIES + ["moderate", "uniform", "sparse", "spike"]
# rows of a 4096-slot merge route that may differ from the XLA route:
# the float compare cs_k < (i + r)/n and the integer one differ at ties
MERGE_TIE_ROWS = 8
# cross-route ancestors that may differ over all cases of
# test_cross_route_tie_count: 0 read, on the CPU, for both libraries
CROSS_ROUTE_TIES = 2


def _weights(n, family, rng):
    if family == "uniform":
        w = np.ones(n)
    elif family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    elif family == "heavy":   # lognormal with sigma 4, as the tiled PF's
        w = np.exp(4.0 * rng.standard_normal(n))
    elif family == "moderate":  # the reference's coarse-route test's
        w = np.exp(5.0 * np.tanh(rng.standard_normal(n)) ** 2)
    elif family == "sparse":    # nine in ten particles weightless
        w = np.where(rng.random(n) < 0.1,
                     np.exp(rng.standard_normal(n)), 0.0)
    else:                       # "spike": one particle holds nearly all
        w = np.ones(n)
        w[rng.integers(n)] = 1e7
    return w.astype(np.float32)


def _case(n, family, nx=5, seed=0):
    rng = np.random.default_rng([n, ALL_FAMILIES.index(family), nx, seed])
    parts = rng.standard_normal((n, nx)).astype(np.float32)
    return parts, _weights(n, family, rng), np.float32(rng.random())


def _jax_ends(w, r):
    return np.array(j_ends(jnp.asarray(w), jnp.asarray(r)))


def _jax_cs(w):
    """The reference merge kernels' prep (resample_pallas3.py:165-169)."""
    cs = jnp.cumsum(jnp.asarray(w))
    return np.array(jax.lax.cummax(cs / cs[-1]))


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _np(state):
    return [np.asarray(s) for s in state]


def _inject(monkeypatch, w, r):
    """Make every route of the port use the reference's ``ends`` and
    ``cs`` for these weights."""
    ends, cs = _t(_jax_ends(w, r)), _t(_jax_cs(w))
    for mod in (trs, trb, trp4, trc):
        monkeypatch.setattr(mod, "ends_from_weights", lambda *_: ends)
    monkeypatch.setattr(trp3, "normalized_cumsum", lambda *_: cs)


# ----------------------------------------------------------------------
# the integer-ends block merge
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n, family, nx", [(4096, "near_uniform", 5),
                                           (4096, "heavy", 30),
                                           (5120, "heavy", 5)])
@pytest.mark.parametrize("pipelined", [False, True])
def test_block_round_bit_equal_to_pallas(n, family, nx, pipelined):
    parts, w, r = _case(n, family, nx)
    ends = _jax_ends(w, r)
    if pipelined:
        want = jrb.pallas_block_resample_round_pipelined(
            jnp.asarray(ends), jnp.asarray(parts), 0,
            *jrb.block_resample_state(n, nx), interpret=True)
        got = trb.block_resample_round_pipelined(
            _t(ends), _t(parts), 0,
            *trb.block_resample_state(n, nx, device="cpu"))
    else:
        want = jrb.pallas_block_resample_round(
            jnp.asarray(ends), jnp.asarray(parts), 0,
            *jrb.block_resample_state(n, nx), interpret=True)
        got = trb.block_resample_round(
            _t(ends), _t(parts), 0,
            *trb.block_resample_state(n, nx, device="cpu"))
    for g, wt in zip(got, _np(want)):
        assert g.numpy().dtype == wt.dtype and g.shape == wt.shape
        np.testing.assert_array_equal(g.numpy(), wt)


@pytest.mark.parametrize("shards", [1, 4])
def test_block_rounds_four_block_feed(shards):
    """Four ascending source blocks through ``shards`` shards of output
    slots (``slot0`` offsets): the carried state is bit-equal to the
    reference kernels' after every block (both entries for one shard,
    the synchronous one for the second of four), and the shards together
    equal one round over the whole pool."""
    n, n_blocks = 2**12, 4
    n_blk, n_local = n // n_blocks, n // shards
    parts, w, r = _case(n, "heavy", seed=5)
    ends = _jax_ends(w, r)
    j_rounds = {"sync": jrb.pallas_block_resample_round,
                "pipe": jrb.pallas_block_resample_round_pipelined}
    t_rounds = {"sync": trb.block_resample_round,
                "pipe": trb.block_resample_round_pipelined}
    whole = trb.block_resample_round(
        _t(ends), _t(parts), 0, *trb.block_resample_state(n, 5, device="cpu"))
    # one kernel serves both entries: keep the interpret-mode runs few
    held = ({"sync": [0], "pipe": [0]} if shards == 1
            else {"sync": [1], "pipe": []})
    for name in j_rounds:
        for s in range(shards):
            slot0 = s * n_local
            js = jrb.block_resample_state(n_local, 5)
            ts = trb.block_resample_state(n_local, 5, device="cpu")
            for q in range(n_blocks):
                sl = slice(q * n_blk, (q + 1) * n_blk)
                ts = t_rounds[name](_t(ends[sl]), _t(parts[sl]), slot0, *ts,
                                    block_slots=128)
                if s not in held[name]:
                    continue
                js = j_rounds[name](jnp.asarray(ends[sl]),
                                    jnp.asarray(parts[sl]), slot0, *js,
                                    128, 256, interpret=True)
                for g, wt in zip(ts, _np(js)):
                    np.testing.assert_array_equal(g.numpy(), wt,
                                                  err_msg=f"{name} {s} {q}")
            rows = slice(slot0, slot0 + n_local)
            for g, wt in zip(ts, whole):
                assert torch.equal(g, wt[rows])


@pytest.mark.parametrize("pipelined", [False, True])
def test_ends_entry_bit_equal_to_pallas(monkeypatch, pipelined):
    n = 4096
    parts, w, r = _case(n, "heavy", 8)
    _inject(monkeypatch, w, r)
    want = jrb.pallas_systematic_resample_ends(
        jnp.asarray(parts), jnp.asarray(w), jnp.asarray(r), 256, 256,
        interpret=True, pipelined=pipelined)
    got = trb.systematic_resample_ends(_t(parts), _t(w), _t(r),
                                       pipelined=pipelined)
    for g, wt in zip(got, _np(want)):
        np.testing.assert_array_equal(g.numpy(), wt)


def test_block_round_state_contract():
    ends = torch.arange(256, dtype=torch.int32)
    parts = torch.zeros((256, 5))
    with pytest.raises(ValueError, match="block_slots"):
        trb.block_resample_round(
            ends, parts, 0, *trb.block_resample_state(200, 5, device="cpu"))
    with pytest.raises(ValueError, match="columns"):
        trb.block_resample_round(
            ends, parts, 0, *trb.block_resample_state(256, 9, device="cpu"))
    with pytest.raises(ValueError, match="32"):
        trb.block_resample_state(256, 33, device="cpu")
    state = trb.block_resample_state(256, 30, device="cpu")
    assert state[1].shape == (256, 32)


# ----------------------------------------------------------------------
# the cumsum merge (v3 and v1)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n, family, nx", [(4096, "near_uniform", 5),
                                           (4096, "heavy", 8),
                                           (5120, "heavy", 5)])
@pytest.mark.parametrize("entry", ["v3", "v1"])
def test_cumsum_merge_bit_equal_to_pallas(monkeypatch, n, family, nx, entry):
    parts, w, r = _case(n, family, nx)
    cs = _jax_cs(w)
    if entry == "v3":
        want = jrp3.pallas_systematic_resample_pipelined(
            jnp.asarray(parts), jnp.asarray(w), jnp.asarray(r), interpret=True)
        port_entry = trp3.systematic_resample_pipelined
    else:
        want = jrp1.pallas_systematic_resample(
            jnp.asarray(parts), jnp.asarray(w), jnp.asarray(r), interpret=True)
        port_entry = trp1.systematic_resample
    want_rows, want_anc = _np(want)
    out, anc = trp3.cumsum_merge(_t(cs), _t(parts.T), _t(r))
    np.testing.assert_array_equal(anc.numpy(), want_anc)
    np.testing.assert_array_equal(out.numpy().T, want_rows)
    _inject(monkeypatch, w, r)
    out, anc = port_entry(_t(parts), _t(w), _t(r))
    np.testing.assert_array_equal(anc.numpy(), want_anc)
    np.testing.assert_array_equal(out.numpy(), want_rows)


def test_merge_entries_keep_geometry_contract():
    n = 4096 + 256                      # a multiple of 128, not of 512
    parts, w, r = _case(n, "near_uniform")
    out, anc = trp3.systematic_resample_pipelined(_t(parts), _t(w), _t(r))
    assert out.shape == (n, 5) and anc.dtype == torch.int32
    with pytest.raises(ValueError, match="block_slots"):
        trp1.systematic_resample(_t(parts), _t(w), _t(r))
    wide = torch.zeros((4096, 9))
    with pytest.raises(ValueError, match="columns"):
        trp3.systematic_resample_pipelined(wide, torch.ones(4096), 0.5)


def test_normalized_cumsum_is_monotone_and_ends_at_one():
    _, w, r = _case(8192, "heavy")
    cs = trp3.normalized_cumsum(_t(w), _t(r))
    assert cs.dtype == torch.float32 and float(cs[-1]) == 1.0
    assert bool(torch.all(cs[1:] >= cs[:-1]))
    np.testing.assert_allclose(cs.numpy(), _jax_cs(w), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["uniform", "near_uniform", "heavy",
                                    "sparse", "spike"])
def test_cross_route_tie_count(family):
    """Ancestors of the merge routes (float ``cs_k < (i + r) / n``)
    against the ``ends`` routes (integer ``floor(n cs_k - r) < i``), each
    library with its own prep, five seeds at 4096 and at 2^20. The two
    compares may part at float ties; none was seen."""
    differ = {"port": 0, "reference": 0}
    for n in (4096, 2**20):
        for seed in range(5):
            rng = np.random.default_rng([n, seed])
            w = _weights(n, family, rng)
            r = np.float32(rng.random())
            tw, tr = _t(w), _t(r)
            merged = trp3.cumsum_merge_plain(
                trp3.normalized_cumsum(tw, tr), torch.zeros((1, n)), tr)[1]
            by_ends = trs.indices_from_ends(trs.ends_from_weights(tw, tr))
            differ["port"] += int(torch.count_nonzero(merged != by_ends))
            cs = jnp.asarray(_jax_cs(w))
            u = (jnp.arange(n, dtype=jnp.float32) + r) / jnp.float32(n)
            merged = jnp.minimum(jnp.searchsorted(cs, u, side="left"), n - 1)
            by_ends = jrc.indices_from_ends(j_ends(jnp.asarray(w),
                                                   jnp.asarray(r)))
            differ["reference"] += int(jnp.sum(merged != by_ends))
    assert max(differ.values()) <= CROSS_ROUTE_TIES, differ


# ----------------------------------------------------------------------
# the coarse-window search
# ----------------------------------------------------------------------
def _coarse_case(family, nx=5):
    n = 2**13
    parts, w, r = _case(n, family, nx)
    ends = _jax_ends(w, r)
    o = np.asarray(jrc.chunk_boundaries(jnp.asarray(ends), n, jrc.BLOCK))
    return n, parts, w, r, ends, o


@pytest.mark.parametrize("family", ["near_uniform", "moderate"])
def test_coarse_gather_bit_equal_to_pallas(family):
    """Where the reference kernel's four-block window holds every chunk,
    its rows and ancestors equal :func:`coarse_gather`'s, given the same
    ``ends`` and chunk boundaries."""
    n, parts, _, _, ends, o = _coarse_case(family)
    assert np.max(o[1:] - o[:-1]) <= (jrc.NWIN - 2) * jrc.BLOCK
    p8t = np.zeros((jrc.ROWS, n), np.float32)
    p8t[:5] = parts.T
    p8t[jrc.ENDS_ROW] = ends
    want_t, want_anc = jrc.coarse_kernel(jnp.asarray(p8t), jnp.asarray(o), n,
                                         interpret=True)
    out, anc = trc.coarse_gather(_t(ends), _t(o), _t(parts.T))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(want_anc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_t)[:5])


@pytest.mark.parametrize("family", ["moderate", "spike"])
def test_coarse_entry_bit_equal_to_reference(monkeypatch, family):
    """The entry on a two-leaf tree, given the reference's ``ends``: equal
    to the reference's entry, which takes its kernel on ``moderate``
    weights and its XLA fallback on ``spike``, whose chunks overflow the
    window; the port has no window to overflow."""
    n, parts, w, r, ends, o = _coarse_case(family)
    wide = (np.max(o[1:] - o[:-1]) > (jrc.NWIN - 2) * jrc.BLOCK)
    assert wide == (family == "spike")
    tree = (parts, parts[:, :1] * 2)
    want, want_anc = jrc.coarse_systematic_resample(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w),
        jnp.asarray(r), interpret=True)
    _inject(monkeypatch, w, r)
    got, anc = trc.coarse_systematic_resample(
        tuple(_t(a) for a in tree), _t(w), _t(r))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(want_anc))
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))


def test_chunk_boundaries_match_reference():
    for family in ("heavy", "spike", "uniform"):
        n, _, _, _, ends, o = _coarse_case(family)
        got = trc.chunk_boundaries(_t(ends), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), o, err_msg=family)


def test_coarse_contract():
    ends = torch.arange(4096, dtype=torch.int32)
    o = trc.chunk_boundaries(ends, 4096)
    with pytest.raises(ValueError, match="multiple"):
        trc.coarse_gather(ends[:4000], o, torch.zeros((5, 4000)))
    with pytest.raises(ValueError, match="multiple"):
        trc.coarse_gather(ends, o[:-1], torch.zeros((5, 4096)))
    with pytest.raises(TypeError):
        trc.coarse_gather(ends.long(), o, torch.zeros((5, 4096)))


# ----------------------------------------------------------------------
# the router's gates
# ----------------------------------------------------------------------
J_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
            "i32": jnp.int32, "f64": jnp.float64}
T_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
            "f16": torch.float16, "i32": torch.int32, "f64": torch.float64}


def _leaf_pair(shape, dtype):
    """A shape-only stand-in for each side: no memory at 2^20 rows."""
    return (jax.ShapeDtypeStruct(shape, J_DTYPES[dtype]),
            torch.zeros((), dtype=T_DTYPES[dtype]).expand(shape))


def _trees(n, width, dtype):
    """(name, jax tree, torch tree) of shape stand-ins."""
    out = []
    j, t = _leaf_pair((n, width), dtype)
    out.append(("single", j, t))
    a, b = _leaf_pair((n, 5), "f32"), _leaf_pair((n, width), dtype)
    out.append(("pair", (a[0], b[0]), (a[1], b[1])))
    out.append(("dict", {"b": a[0], "a": b[0]}, {"b": a[1], "a": b[1]}))
    c = _leaf_pair((n, 5, 5), dtype)
    out.append(("bank", (b[0], c[0]), (b[1], c[1])))
    d = _leaf_pair((n,), dtype)
    out.append(("with_1d_leaf", [b[0], d[0]], [b[1], d[1]]))
    return out


@pytest.mark.parametrize("n", [2**11, 4096, 5000, 5120, 2**20])
def test_route_table_matches_reference(monkeypatch, n):
    """Every gate decides as the reference's: ``_kernel_applicable``
    under each route (auto with the reference's backend taken as TPU for
    CUDA tensors, as CPU for CPU tensors), ``_auto_ends``,
    ``v4_applicable`` of the first leaf and ``packable_cols``."""
    routes = ["auto", "ends", "v4", "v3", "pallas", "coarse", "xla"]
    checked = 0
    for width in (5, 6, 8, 9, 30, 33):
        for dtype in J_DTYPES:
            for name, jt, tt in _trees(n, width, dtype):
                where = (name, width, dtype)
                assert trs._auto_ends(tt) == jrs._auto_ends(jt), where
                assert trb.packable_cols(tt) == jrb.packable_cols(jt), where
                assert trs._pack_dtypes_ok(tt) == jrs._pack_dtypes_ok(jt)
                jfirst = jax.tree_util.tree_leaves(jt)[0]
                tfirst = pytree.tree_flatten(tt)[0][0]
                assert tuple(tfirst.shape) == jfirst.shape, where
                assert trp4.v4_applicable(tfirst, n) == \
                    jrp4.v4_applicable(jfirst, n), where
                for backend, on_cuda in (("tpu", True), ("cpu", False)):
                    monkeypatch.setattr(jax, "default_backend",
                                        lambda b=backend: b)
                    for route in routes:
                        with jrs.impl(route), trs.impl(route):
                            want = jrs._kernel_applicable(jt, n)
                            got = trs._kernel_applicable(tt, n, on_cuda)
                        assert got == want, where + (route, backend)
                        checked += 1
    assert checked == 6 * 5 * 5 * 2 * len(routes)


@pytest.mark.parametrize("n", [2**11, 4096, 5000, 2**20])
def test_bank_gate_matches_reference(n):
    for nx in (2, 5, 6):
        for dtype in J_DTYPES:
            m = _leaf_pair((n, nx), dtype)
            c = _leaf_pair((n, nx, nx), "f32")
            assert trp4.bank_applicable(m[1], c[1], n) == \
                jrp4.bank_applicable(m[0], c[0], n), (nx, dtype)
            assert trp4.bank_rows(nx) == jrp4.bank_rows(nx)


def test_f32_exact_dtypes_match_reference():
    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16), (torch.float64, jnp.float64),
             (torch.int8, jnp.int8), (torch.int16, jnp.int16),
             (torch.uint8, jnp.uint8), (torch.uint16, jnp.uint16),
             (torch.int32, jnp.int32), (torch.int64, jnp.int64),
             (torch.bool, jnp.bool_)]
    for t, j in pairs:
        assert trs.f32_exact_dtype(t) == jrs.f32_exact_dtype(j), t


# ----------------------------------------------------------------------
# forced routes end to end on CPU tensors
# ----------------------------------------------------------------------
def _route_tree(route, n, rng):
    """A numpy tree the route takes, as the router sees it."""
    f32 = np.float32
    if route in ("ends", "bank"):
        means = rng.standard_normal((n, 5)).astype(f32)
        a = rng.standard_normal((n, 5, 5)).astype(f32)
        return (means, a + np.swapaxes(a, 1, 2))     # exactly symmetric
    if route == "v4":
        return (rng.standard_normal((n, 5)).astype(f32),
                np.arange(n, dtype=np.int32))
    if route == "v3":
        return (rng.standard_normal((n, 8)).astype(f32),
                rng.integers(0, 9, (n, 2)).astype(np.int32))
    if route == "pallas":
        bf = rng.standard_normal((n, 6)).astype(jnp.bfloat16)
        return [bf, rng.standard_normal((n, 3)).astype(np.float16)]
    if route == "coarse":
        return {"x": rng.standard_normal((n, 5)).astype(f32),
                "e": rng.standard_normal((n, 1)).astype(np.float16)}
    return {"x": rng.standard_normal((n, 5)).astype(f32),
            "y": rng.integers(-9, 9, (n, 3, 2)).astype(np.int32)}


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _leaves_np(tree):
    """Leaves as numpy, bfloat16 widened to float32 (exactly)."""
    out = []
    for a in jax.tree_util.tree_leaves(tree):
        if isinstance(a, torch.Tensor):
            out.append((a.float() if a.dtype == torch.bfloat16 else a).numpy())
        else:
            out.append(np.asarray(a, np.float32 if a.dtype == jnp.bfloat16
                                  else a.dtype))
    return out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("route", ["ends", "v4", "v3", "pallas", "bank",
                                   "coarse", "xla"])
def test_forced_route_on_cpu_matches_reference(monkeypatch, route, family):
    n = 2**13 if route == "coarse" else 4096      # the coarse gate's least
    rng = np.random.default_rng([7, FAMILIES.index(family)])
    tree = _route_tree(route, n, rng)
    w = _weights(n, family, rng)
    key = jax.random.PRNGKey(11)
    r = np.float32(jax.random.uniform(key, ()))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    with jrs.impl("xla"):
        if route == "bank":
            want, want_w = jrs.systematic_resample_bank(*jtree, jnp.asarray(w),
                                                        key)
        else:
            want, want_w = jrs.systematic_resample(jtree, jnp.asarray(w), key)
    if route in ("v3", "pallas"):
        with jrs.impl("v3_interpret" if route == "v3" else "interpret"):
            merged, _ = jrs.systematic_resample(jtree, jnp.asarray(w), key)
    ttree = jax.tree_util.tree_map(_to_torch, tree)
    _inject(monkeypatch, w, r)
    before = (trb.ends_merge_round.launches, trp3.cumsum_merge.launches,
              trp4.compact.launches, trp4.expand.launches,
              trc.coarse_gather.launches)
    with trs.impl(route):
        if route == "bank":
            got, got_w = trs.systematic_resample_bank_from_r(
                *ttree, _t(w), _t(r))
        else:
            got, got_w = trs.systematic_resample_from_r(ttree, _t(w), _t(r))
    assert (trb.ends_merge_round.launches, trp3.cumsum_merge.launches,
            trp4.compact.launches, trp4.expand.launches,
            trc.coarse_gather.launches) == before
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    got_l, want_l = _leaves_np(got), _leaves_np(want)
    assert type(got) is type(ttree)
    if route in ("v3", "pallas"):
        for g, m in zip(got_l, _leaves_np(merged)):
            np.testing.assert_array_equal(g, m)
        differ = np.any((got_l[0] != want_l[0]).reshape(n, -1), axis=1)
        assert np.count_nonzero(differ) <= MERGE_TIE_ROWS
        return
    for g, wt in zip(got_l, want_l):
        assert g.dtype == wt.dtype and g.shape == wt.shape
        np.testing.assert_array_equal(g, wt)


def test_auto_on_cpu_takes_the_plain_route():
    n = 4096
    parts, w, r = _case(n, "heavy", 8)
    means = torch.from_numpy(parts[:, :5].copy())
    covs = means[:, :, None] * means[:, None, :]
    for tree in (_t(parts), (means, covs)):
        got, _ = trs.systematic_resample_from_r(tree, _t(w), _t(r))
        with trs.impl("xla"):
            want, _ = trs.systematic_resample_from_r(tree, _t(w), _t(r))
        for g, wt in zip(pytree.tree_flatten(got)[0],
                         pytree.tree_flatten(want)[0]):
            assert torch.equal(g, wt)
    assert _build._lib is None


def test_generator_entries_draw_one_uniform():
    n = 4096
    parts, w, _ = _case(n, "near_uniform")
    gen = torch.Generator().manual_seed(3)
    r = torch.rand((), generator=torch.Generator().manual_seed(3))
    got, got_w = trs.systematic_resample(_t(parts), _t(w), gen)
    want, _ = trs.systematic_resample_from_r(_t(parts), _t(w), r)
    assert torch.equal(got, want)
    assert torch.equal(got_w, torch.full((n,), 1.0 / n))


def test_coarse_route_raises_and_unknown_route_is_refused():
    """The coarse entry refuses a payload past its six columns, which the
    router's gate keeps on the plain route (a bank under ``impl("coarse")``
    too, as the reference's); an unknown route name is refused."""
    n = 8192
    wide, w, r = _case(n, "near_uniform", nx=7)
    with pytest.raises(ValueError, match="columns"):
        trc.coarse_systematic_resample(_t(wide), _t(w), _t(r))
    with trs.impl("xla"):
        want, _ = trs.systematic_resample_from_r(_t(wide), _t(w), _t(r))
        bank = (_t(wide[:, :5]), torch.zeros((n, 5, 5)))
        want_bank, _ = trs.systematic_resample_bank_from_r(*bank, _t(w),
                                                           _t(r))
    with trs.impl("coarse"):
        got, _ = trs.systematic_resample_from_r(_t(wide), _t(w), _t(r))
        got_bank, _ = trs.systematic_resample_bank_from_r(*bank, _t(w),
                                                          _t(r))
    assert torch.equal(got, want)
    assert all(torch.equal(g, wt) for g, wt in zip(got_bank, want_bank))
    with pytest.raises(ValueError, match="route"):
        trs.impl("v3_interpret")
    assert trs._IMPL == "auto"


# ----------------------------------------------------------------------
# trees and packing
# ----------------------------------------------------------------------
Pair = collections.namedtuple("Pair", "mean cov")


def test_tree_leaf_order_matches_jax():
    """Dict leaves come by sorted key, as in ``jax.tree_util``."""
    def tree(leaf):
        return {"z": leaf(0), "a": [leaf(1), (leaf(2), leaf(3))],
                "m": Pair(leaf(4), {"y": leaf(5), "b": leaf(6)})}

    want = [int(a) for a in jax.tree_util.tree_leaves(
        tree(lambda i: np.array(i)))]
    leaves, treedef = pytree.tree_flatten(tree(lambda i: torch.tensor(i)))
    assert [int(a) for a in leaves] == want
    rebuilt = pytree.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt["m"], Pair)
    assert isinstance(rebuilt["a"], list)
    assert isinstance(rebuilt["a"][1], tuple)
    assert [int(a) for a in pytree.tree_flatten(rebuilt)[0]] == want
    doubled = pytree.tree_map(lambda a: 2 * a, tree(lambda i: torch.tensor(i)))
    assert int(doubled["m"].cov["b"]) == 12
    with pytest.raises(TypeError):
        pytree.tree_flatten({"a": np.zeros(3)})


def test_pack_rows_round_trip_and_reference_layout():
    rng = np.random.default_rng(2)
    n = 64
    tree = {"m": rng.standard_normal((n, 5)).astype(np.float32),
            "c": rng.standard_normal((n, 5, 5)).astype(np.float16)}
    jpacked, _ = jrb.pack_rows(jax.tree_util.tree_map(jnp.asarray, tree))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    packed, meta = trb.pack_rows(ttree)
    assert packed.dtype == torch.float32 and packed.shape == (n, 30)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    back = trb.unpack_rows(packed, meta)
    for k in tree:
        assert back[k].dtype == ttree[k].dtype
        assert torch.equal(back[k], ttree[k])


# ----------------------------------------------------------------------
# the copy semantics (the port's; the reference kernels differ here)
# ----------------------------------------------------------------------
def test_merges_copy_signed_zero_and_non_finite_rows_exactly():
    """Both merges and the coarse search copy the ancestor's row: ``-0.0`` keeps its sign and an
    ``inf`` reaches only the slots whose ancestor holds it. (The
    reference's one-hot matrix-unit gathers add, which turns ``-0.0`` to
    ``+0.0`` and spreads ``0 * inf = nan`` over a window.)"""
    n = 4096
    parts, w, r = _case(n, "near_uniform")
    parts[:, 0] = -0.0
    parts[100, 1] = np.inf
    parts[200, 2] = np.nan
    ends = _t(_jax_ends(w, r))
    anc = trs.indices_from_ends(ends).numpy()
    want = parts[anc]
    counts, acc, _ = trb.block_resample_round(
        ends, _t(parts), 0, *trb.block_resample_state(n, 5, device="cpu"))
    out, anc_m = trp3.cumsum_merge(_t(_jax_cs(w)), _t(parts.T), _t(r))
    out_c, anc_c = trc.coarse_gather(ends, trc.chunk_boundaries(ends, n),
                                     _t(parts.T))
    for got, a in ((acc[:, :5].numpy(), counts[:, 0].numpy()),
                   (out.numpy().T, anc_m.numpy()),
                   (out_c.numpy().T, anc_c.numpy())):
        np.testing.assert_array_equal(got, parts[a])
        assert np.all(np.signbit(got[:, 0]))
        assert np.count_nonzero(np.isinf(got)) == np.count_nonzero(a == 100)
        assert np.count_nonzero(np.isnan(got)) == np.count_nonzero(a == 200)
    np.testing.assert_array_equal(acc[:, :5].numpy(), want)


# ----------------------------------------------------------------------
# weights without a finite positive sum
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", rig.NO_SUM_KINDS)
@pytest.mark.parametrize("route", ["auto", "xla", "ends", "v4", "coarse",
                                   "bank", "v3", "pallas"])
def test_weights_without_a_finite_sum_follow_the_reference(kind, route):
    """A NaN normalized cumsum: every slot takes the ancestor the
    reference's XLA route gives (the first entry of the last run of
    ``ends``), on every route: the cumsum merges take it through their
    keys (``-inf`` before it, ``+inf`` from it)."""
    n = 4096
    parts, _, r = _case(n, "near_uniform")
    w = rig.no_sum_weights(kind, n)
    want = parts[np.asarray(jrs.systematic_resample_indices(
        jnp.asarray(w), jnp.asarray(r)))]
    ends = trc.ends_from_weights(_t(w), _t(r))
    assert int(ends[-1]) == n - 1
    with trs.impl(route):
        if route == "bank":
            a = parts[:, :3]
            covs = _t(a[:, :, None] * a[:, None, :])
            (got, _), _ = trs.systematic_resample_bank_from_r(
                _t(parts[:, :3]), covs, _t(w), _t(r))
            want = want[:, :3]
        else:
            got, _ = trs.systematic_resample_from_r(_t(parts), _t(w), _t(r))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", rig.NO_SUM_KINDS)
def test_merge_routes_without_a_finite_sum_follow_the_reference_v1(kind):
    """The port's ``pallas`` and ``v3`` routes on such weights give the
    rows and ancestors of the reference's v1 Pallas merge
    (``impl("interpret")``), which are its XLA route's."""
    n = 4096
    parts, _, r = _case(n, "near_uniform")
    w = rig.no_sum_weights(kind, n)
    want, want_anc = jrp1.pallas_systematic_resample(
        jnp.asarray(parts), jnp.asarray(w), jnp.asarray(r), interpret=True)
    for entry in (trp1.systematic_resample, trp3.systematic_resample_pipelined):
        got, anc = entry(_t(parts), _t(w), _t(r))
        np.testing.assert_array_equal(anc.numpy(), np.asarray(want_anc))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
