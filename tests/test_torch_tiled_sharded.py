"""The port's sharded tiled PF step against the JAX reference's, on the
CPU; mirrors ``tests/test_tiled_sharded.py``.

The port keeps its SoA ``(nx, n_local)`` state and exchanges survivor
rows where the reference exchanges 1024-lane tiles; the results compare
after untiling. It runs over gloo in spawned groups of W = 2 and 4
ranks (``tests/_torch_parallel_workers.tiled_suite``, one group a width)
and at W = 1 in this process, on n = 16384 particles (``n_local`` = 4096
at W = 4) of degenerate weights (the compaction regime). Tolerances:

* the tiled resample, given the same weights: bit-equal with both
  exchanges to the port's ring route and across widths; given the
  reference's ``ends``, bit-equal to the reference's tiled pipeline
  (interpreted, W = 4) and ring; with its own ``ends``, the rows apart
  from the reference's are at most ``STEP_TIE_ROWS`` per 4096 (cumsum
  ties);
* chained steps: finite, the two exchanges bit-equal, and the point
  estimate within 4 standard deviations of the mean of ``SEEDS``
  single-device tiled runs from the same start (the noise streams differ
  by construction, one a rank; a near-zero state's estimate varies by
  ~0.08 between realizations at this effective sample size, more than
  the reference test's fixed bound of 0.06 allows two realizations).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpu_se_tpu.filters import particle_tiled as jpft
from gpu_se_tpu.parallel import make_mesh as ref_mesh
from gpu_se_tpu.parallel import sharded as jS
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.filters import particle_tiled as tpft
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.parallel.launch import run_group

from tests import _torch_parallel_workers as workers
from tests.test_tiled_sharded import X_SS, _rig

AX = "particles"
N = 4 * 4096
WIDTHS = (1, 2, 4)
STEP_TIE_ROWS = 8
STEPS = 3
SEEDS = 8
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
U = np.array([0.06, 0.2], np.float32)


def _ref_tiled_rows(nd, parts, w, r):
    """The reference's tiled pipeline (segmented ends, v4 compaction,
    ring exchange, v4 merge, interpreted) on a width-``nd`` mesh, as
    ``tests/test_tiled_sharded.py`` drives it; untiled rows."""
    @jax.jit
    @functools.partial(
        shard_map, mesh=ref_mesh(nd),
        in_specs=(P(AX, None), P(AX), P()), out_specs=P(AX, None),
        check_vma=False)
    def dist(tiled, w_local, r):
        n_local = tiled.shape[0] * 128
        ends, prev = jS._segmented_ends(w_local, r, AX)
        ends_loc = (ends - (prev + 1)).astype(jnp.float32)
        x = jnp.stack([tiled[:, k * 128:(k + 1) * 128] for k in range(5)])
        body = jpft.build_body(x, ends_loc.reshape(-1, 128), 5,
                               with_index=False)
        return jS._a2a_compact_exchange_merge(
            body, prev, n_local, 5, AX, exchange="ring", interpret=True,
            return_tiled=True)

    st = jpft.tile(jnp.asarray(parts), jax.random.PRNGKey(0))
    out = dist(st.tiled, jnp.asarray(w), jnp.float32(r))
    return np.asarray(jpft.untile(jpft.TiledPFState(tiled=out, key=st.key),
                                  5))


def _ref_ends(w, r):
    fn = jax.jit(shard_map(
        lambda w, r: jS._segmented_ends(w, r, AX)[0], mesh=ref_mesh(1),
        in_specs=(P(AX), P()), out_specs=P(AX), check_vma=False))
    return np.asarray(fn(jnp.asarray(w), jnp.float32(r)))


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(3)
    parts = rng.standard_normal((N, 5)).astype(np.float32)
    w = np.exp(rng.standard_normal(N)).astype(np.float32)
    w[: N - N // 16] = 1e-12
    r = np.float32(0.43)
    x0, state_pdf, meas_pdf = _rig()
    z = np.asarray(tbio.static_outputs(torch.from_numpy(X_SS),
                                       torch.from_numpy(U.astype(float))),
                   np.float32)
    tiled = np.asarray(jpft.tile(jnp.asarray(parts),
                                 jax.random.PRNGKey(0)).tiled)
    d = dict(tiled=tiled, w=w, r=r, ref_ends=_ref_ends(w, r), u=U, z=z,
             dt=np.float32(0.1), seed=5, n=N, steps=STEPS,
             **{k: tuple(np.asarray(getattr(gs, f)) for f in FIELDS)
                for k, gs in (("x0", x0), ("state_pdf", state_pdf),
                              ("meas", meas_pdf))})
    ref = _ref_tiled_rows(4, parts, w, r)
    port = {1: workers.tiled_suite(d)}
    for nd in WIDTHS[1:]:
        outs = run_group(workers.tiled_suite, nd, d, timeout_s=240)
        port[nd] = {k: np.concatenate([o[k] for o in outs],
                                      axis=1 if k.startswith("chain") or
                                      k in ("ragged", "ring")
                                      or k.endswith("_ref_ends") else 0)
                    for k in outs[0]}
    return d, ref, port


@pytest.mark.parametrize("nd", WIDTHS)
def test_tiled_resample_bit_equal_given_the_same_weights(runs, nd):
    _, ref, port = runs
    got = port[nd]
    for exchange in ("ragged", "ring"):
        np.testing.assert_array_equal(got[exchange].T, got["xla"])
        np.testing.assert_array_equal(got[exchange], port[1][exchange])
        np.testing.assert_array_equal(got[exchange + "_ref_ends"].T, ref)
    apart = np.count_nonzero(np.any(got["ragged"].T != ref, axis=1))
    assert apart <= STEP_TIE_ROWS * N // 4096, apart


@pytest.mark.parametrize("nd", WIDTHS)
def test_tiled_sharded_chain_finite_and_consistent(runs, nd):
    d, _, port = runs
    got = port[nd]
    assert got["chain_ragged"].shape == (5, N)
    assert np.isfinite(got["chain_ragged"]).all()
    np.testing.assert_array_equal(got["chain_ragged"], got["chain_ring"])
    est = got["chain_ragged"].astype(np.float64).mean(axis=1)

    # single-device tiled runs from the same start: other noise
    # realizations of the same distribution
    x0, state_pdf, meas = (convert.gaussian_sum_from_numpy(*d[k],
                                                           device="cpu")
                           for k in ("x0", "state_pdf", "meas"))
    u, z, dt = (torch.from_numpy(np.asarray(d[k])) for k in ("u", "z", "dt"))
    ests = []
    for seed in range(SEEDS):
        st = tpft.init(torch.Generator().manual_seed(d["seed"]), N, x0)
        st.generator.manual_seed(100 + seed)
        for _ in range(STEPS):
            st = tpft.step(st, u, z, dt, tbio.homeostatic_des,
                           tbio.static_outputs, state_pdf, meas)
        ests.append(tpft.point_estimate(st).numpy())
    mean, std = np.mean(ests, axis=0), np.std(ests, axis=0)
    assert np.all(np.abs(est - mean) <= 4 * std), (est, mean, std)
