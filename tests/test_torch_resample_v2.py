"""The port's v2 fused resample against the reference's Pallas kernels
(interpret mode, on the CPU), and ``expand``'s plain version against
the reference's ``indices_from_ends``.

The v2 entry computes ``ends`` the port's way (row-blocked cumsum), the
reference by a 1-d cumsum, so the two may part at float ties. On
integer-valued weights every cumsum is exact and ``ends`` agree; given
the same ``ends`` (injected), the outputs must be bit-equal: both sides
copy survivor rows. Each interpret-mode call of the reference costs a
few seconds, so the cases are few.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.ops import resample_pallas2 as jrp2
from gpu_se_tpu.ops.resample_coarse import indices_from_ends as j_indices
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.ops import resample_pallas2 as trp2
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights as t_ends

FAMILIES = ["uniform", "near_uniform", "heavy", "integer"]


def _weights(n, family, rng):
    if family == "uniform":
        w = np.ones(n)
    elif family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    elif family == "heavy":     # lognormal with sigma 4
        w = np.exp(4.0 * rng.standard_normal(n))
    else:                       # integers, many zeros: exact cumsums
        w = np.floor(np.exp(2.0 * rng.standard_normal(n)))
    return w.astype(np.float32)


def _case(n, family, nx=5, seed=0):
    rng = np.random.default_rng([n, FAMILIES.index(family), seed])
    parts = rng.standard_normal((n, nx)).astype(np.float32)
    return parts, _weights(n, family, rng), np.float32(rng.random())


def _ref_ends(w, r):
    """The reference entry's ``ends`` (``resample_pallas2.py:260-266``)."""
    cum = jnp.cumsum(jnp.asarray(w))
    cum = cum / cum[-1]
    n = w.shape[0]
    ends = jnp.clip(jax.lax.cummax(jnp.floor(n * cum - r)), -1.0, n - 1.0)
    return np.asarray(ends).astype(np.int32)


def _ref_v2(parts, w, r, window, block):
    return np.asarray(jrp2.fused_systematic_resample_v2(
        jnp.asarray(parts), jnp.asarray(w), jnp.asarray(r), window=window,
        block=block, interpret=True))


@pytest.mark.parametrize("n, window, block", [(4096, 1024, 1024),
                                              (8192, 2048, 1024),
                                              (8192, 512, 4096)])
def test_v2_equals_reference_on_integer_weights(n, window, block):
    parts, w, r = _case(n, "integer")
    want = _ref_v2(parts, w, r, window, block)
    np.testing.assert_array_equal(
        t_ends(torch.from_numpy(w), torch.tensor(r)).numpy(),
        _ref_ends(w, r))
    got = trp2.fused_systematic_resample_v2(
        torch.from_numpy(parts), torch.from_numpy(w), torch.tensor(r),
        window=window, block=block)
    assert got.shape == (n, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's own XLA formulation: particles[indices]
    idx = trs.systematic_resample_indices(torch.from_numpy(w),
                                          torch.tensor(r)).numpy()
    np.testing.assert_array_equal(want, parts[idx])


def test_v2_equals_reference_given_its_ends(monkeypatch):
    """Real-valued heavy-tailed weights, the reference's ``ends``
    injected: bit-equal rows, and ancestors equal to the plain route's."""
    n = 4096
    parts, w, r = _case(n, "heavy", nx=3)
    ends = torch.from_numpy(_ref_ends(w, r))
    monkeypatch.setattr(trp2, "ends_from_weights", lambda *_: ends)
    want = _ref_v2(parts, w, r, 1024, 1024)
    got, anc = trp2.resample_v2_core(torch.from_numpy(parts),
                                     torch.from_numpy(w), torch.tensor(r))
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(anc.numpy(),
                                  trs.indices_from_ends(ends).numpy())


def test_compact_equals_reference_compact_prefix():
    """TPU kernel 8 (``_compact_kernel``) is served by the port's
    ``compact``: the survivors' ``C = ends + 1``, state rows and count
    equal the reference kernel's packed prefix (past the count the
    reference leaves garbage, which it masks itself)."""
    n, nx, window = 4096, 5, 1024
    parts, w, r = _case(n, "heavy", nx=nx, seed=1)
    ends = _ref_ends(w, r)
    c_incl = ends.astype(np.float32) + 1.0
    flags = (c_incl > np.concatenate([[0.0], c_incl[:-1]])).astype(np.float32)
    vals8 = np.concatenate([parts.T, c_incl[None], flags[None],
                            np.zeros((1, n), np.float32)])
    n_pad = n + 4 * window
    stream = np.asarray(jrp2._compact(jnp.asarray(vals8), n_pad, window,
                                      interpret=True))
    c_keys, c_payload, c_idx, count = trp4.compact(
        torch.from_numpy(ends), torch.from_numpy(parts.T.copy()))
    m = int(count.item())
    assert m == int(flags.sum())
    np.testing.assert_array_equal(c_keys[:m].numpy() + 1.0, stream[5, :m])
    np.testing.assert_array_equal(c_payload[:, :m].numpy(), stream[:nx, :m])
    np.testing.assert_array_equal(stream[6, :m], np.ones(m, np.float32))
    np.testing.assert_array_equal(parts[c_idx[:m].numpy()].T, stream[:nx, :m])


def test_geometry_checks_reject_what_the_reference_rejects():
    parts, w, r = _case(4096, "near_uniform", nx=6)
    for p, kw in ((parts, {}), (parts[:, :5], {"window": 1000})):
        with pytest.raises(AssertionError):
            _ref_v2(p, w, r, kw.get("window", 1024), 1024)
        with pytest.raises(ValueError):
            trp2.fused_systematic_resample_v2(
                torch.from_numpy(np.ascontiguousarray(p)),
                torch.from_numpy(w), torch.tensor(r), **kw)
    with pytest.raises(ValueError, match="block"):
        trp2.fused_systematic_resample_v2(
            torch.from_numpy(parts[:, :5].copy()), torch.from_numpy(w),
            torch.tensor(r), block=1000)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4096, 5001])
def test_expand_plain_equals_reference_indices(n, family):
    """``expand`` on CPU tensors (its plain version) against the
    reference's ``indices_from_ends`` and an index gather, on the
    compacted input and on the uncompacted ``ends`` (keys that repeat),
    at several chunk sizes: bit-equal."""
    parts, w, r = _case(n, family, seed=2)
    ends = t_ends(torch.from_numpy(w), torch.tensor(r))
    c_keys, c_payload, c_idx, _ = trp4.compact(
        ends, torch.from_numpy(parts.T.copy()))
    before = trp2.expand.launches
    for keys, payload, src in ((c_keys, c_payload, c_idx),
                               (ends, torch.from_numpy(parts.T.copy()),
                                None)):
        j = np.minimum(np.asarray(j_indices(jnp.asarray(keys.numpy()))),
                       n - 1)
        want = (torch.from_numpy(payload.numpy()[:, j]),
                torch.from_numpy((j if src is None else src.numpy()[j])
                                 .astype(np.int32)))
        args = (keys, payload, src)
        for block in (1, 512, 1024, 4096, 8192):
            for got in (trp2.expand_plain(*args, block=block),
                        trp2.expand(*args, block=block)):
                assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    assert trp2.expand.launches == before


def test_expand_contract():
    keys = torch.arange(8, dtype=torch.int32)
    payload = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="block"):
        trp2.expand(keys, payload, block=0)
    with pytest.raises(ValueError):
        trp2.expand(keys, torch.zeros((2, 7)))
    with pytest.raises(TypeError):
        trp2.expand(keys.long(), payload)
    out, anc = trp2.expand(keys, payload)
    assert out.shape == (2, 8) and anc.dtype == torch.int32


def test_v2_keeps_dtype_and_ancestors():
    """A float64 payload comes back float64 (through the float32
    stream, as the reference's), and the ancestors are the plain
    route's."""
    parts, w, r = _case(4096, "heavy", nx=2, seed=3)
    x = torch.from_numpy(parts.astype(np.float64))
    got, anc = trp2.resample_v2_core(x, torch.from_numpy(w),
                                     torch.tensor(r), block=512)
    assert got.dtype == torch.float64
    idx = trs.systematic_resample_indices(torch.from_numpy(w),
                                          torch.tensor(r))
    assert torch.equal(anc, idx)
    assert torch.equal(got, x.float().double()[idx.long()])
