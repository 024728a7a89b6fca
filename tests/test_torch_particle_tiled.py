"""The port's tiled particle-filter step against the JAX reference.

The reference runs eagerly on the CPU with its Pallas kernels in
interpret mode (a jitted reference may fuse the model's float32 ops
differently). Noise and ``r`` are the reference's own, injected through
``step_from_noise``. Tolerances:

* predicted particles: bit-equal (same float32 ops in the same order);
* weights: ``rtol=1e-5`` (``exp`` differs by ulps between libraries);
* one step's output: the rows whose ancestor moved with an ``ends``
  entry on a cumsum tie may differ (at most ``STEP_TIE_ROWS`` of 4096;
  0-4 seen), every other row is bit-equal; given the reference's
  ``ends`` the whole output is bit-equal;
* ``point_estimate``: ``rtol=2e-5`` (float32 sums in another order).

n is a power of two: the step's skipped multiply by the uniform
incoming weights is exact only then.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.filters import particle_tiled as jpft
from gpu_se_tpu.filters.resampling import sorted_row_gather as j_gather
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu.ops.resample_coarse import indices_from_ends as j_indices
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.distributions import GaussianSum as TGS
from gpu_se_tpu_torch.filters import particle_tiled as tpft
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights as t_ends

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_parity_step.npz")
NX = 5
STEP_TIE_ROWS = 8
REGIMES = ["heavy", "near_uniform"]
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
F_J = functools.partial(jbio.homeostatic_des, xp=jnp)
G_J = functools.partial(jbio.static_outputs, xp=jnp)


def _load_fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_parity_fixture",
        os.path.join(REPO, "scripts", "make_torch_parity_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FIX = _load_fixture_script()


def _rig():
    return tuple(JGS.create(*args) for args in FIX.bench_rig())


def _to_torch(jgs):
    return convert.gaussian_sum_from_numpy(
        *(np.asarray(getattr(jgs, f)) for f in FIELDS), device="cpu")


@pytest.fixture(scope="module")
def regenerated():
    """The fixture's arrays computed afresh by the reference (two eager
    interpret-mode steps at n = 4096)."""
    return FIX.build()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fixture_file_is_current(regenerated):
    committed = np.load(FIXTURE)
    assert sorted(committed.files) == sorted(regenerated)
    for name, want in regenerated.items():
        got = committed[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert os.path.getsize(FIXTURE) < 2**20


@pytest.mark.parametrize("regime", REGIMES)
def test_step_from_noise_matches_reference_step(regenerated, regime):
    """Against ``particle_tiled.step(interpret=True)``: heavy-tailed
    weights take the reference's compacted kernel route, near-uniform
    ones its direct route."""
    d = regenerated
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in FIELDS), device="cpu")
    args = (_t(d["x_in"]), _t(d["u"]), _t(d[f"{regime}_z"]), _t(d["dt"]),
            tbio.homeostatic_des, tbio.static_outputs, meas)
    want = d[f"{regime}_x_out"]
    xn, w = tpft.predict_update_local(*args, _t(d["noise"]))
    np.testing.assert_allclose(w.numpy(), d[f"{regime}_w"], rtol=1e-5, atol=0)
    out, _ = trp4.resample_core(xn, _t(d[f"{regime}_ends"]))
    np.testing.assert_array_equal(out.numpy(), want)
    got = tpft.step_from_noise(*args, _t(d["noise"]), _t(d["r"])).numpy()
    differ = np.any(got != want, axis=0)
    assert np.count_nonzero(differ) <= STEP_TIE_ROWS
    # a differing row is one whose ancestor moved, not a changed value
    ends = t_ends(w, _t(d["r"]))
    moved = (trp4.expand_plain(ends, xn)[1].numpy()
             != np.asarray(j_indices(jnp.asarray(d[f"{regime}_ends"]))))
    np.testing.assert_array_equal(differ, moved)


def test_predict_update_local_matches_reference():
    """At n = 8192 against the reference's own ``predict_update_local``,
    fed the noise it draws from the step's key split."""
    x0, state_pdf, meas_pdf = _rig()
    n = 8192
    state = jpft.init(jax.random.PRNGKey(4), n, x0)
    _, kn, _ = jax.random.split(state.key, 3)
    u = jnp.array([0.06, 0.2], jnp.float32)
    z = jnp.asarray(jbio.static_outputs(FIX.X_SS, np.asarray(u), xp=np),
                    jnp.float32)
    xn_j, w_j = jpft.predict_update_local(
        state.tiled, u, z, jnp.float32(0.1), F_J, G_J, state_pdf, meas_pdf,
        NX, kn)
    noise = state_pdf.draw_t(kn, n)
    tstate = convert.tiled_state_from_numpy(
        np.asarray(state.tiled), NX, torch.Generator())
    xn, w = tpft.predict_update_local(
        tstate.x, _t(u), _t(z), torch.tensor(np.float32(0.1)),
        tbio.homeostatic_des, tbio.static_outputs, _to_torch(meas_pdf),
        _t(noise))
    np.testing.assert_array_equal(xn.numpy(),
                                  np.asarray(xn_j).reshape(NX, n))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j).reshape(n),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("z_offset", [0.0, 0.3])
def test_three_chained_steps(z_offset):
    """Three chained steps against the reference's XLA formulation of the
    same step (``tests/test_particle_tiled.py`` pins the kernel step to
    it bit for bit), fed the reference's noise and ``r``. Chained on its
    own output with the reference's ``ends`` injected, the port stays
    bit-equal; with its own ``ends``, each step differs only in tie rows.
    (Left free-running, ties compound: 92 and 302 of 4096 rows differed
    after three steps, since resampling duplicates a moved row.)"""
    x0, state_pdf, meas_pdf = _rig()
    n = 4096
    u = jnp.array([0.06, 0.2], jnp.float32)
    z = jnp.asarray(jbio.static_outputs(FIX.X_SS, np.asarray(u), xp=np)
                    + z_offset, jnp.float32)
    dt = jnp.float32(0.1)
    key = jax.random.PRNGKey(11)
    x_j = x0.draw_t(jax.random.PRNGKey(4), n)
    x_t = _t(x_j)
    meas = _to_torch(meas_pdf)
    model = (_t(u), _t(z), _t(dt), tbio.homeostatic_des, tbio.static_outputs,
             meas)
    for _ in range(3):
        key, kn, kr = jax.random.split(key, 3)
        noise = state_pdf.draw_t(kn, n)
        r = jax.random.uniform(kr, (), dtype=jnp.float32)
        own = tpft.step_from_noise(x_t, *model, _t(noise), _t(r)).numpy()
        xn = x_j + F_J(x_j, u, dt) + noise
        w = meas_pdf.pdf_t(z.reshape(-1, 1) - G_J(xn, u))
        ends = j_ends(w, r)
        x_j = j_gather(xn.T, j_indices(ends)).T
        xn_t, _ = tpft.predict_update_local(x_t, *model, _t(noise))
        x_t, _ = trp4.resample_core(xn_t, _t(ends))
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        rows = np.count_nonzero(np.any(own != np.asarray(x_j), axis=0))
        assert rows <= STEP_TIE_ROWS


def test_tile_untile_round_trip_with_reference():
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((8192, NX)).astype(np.float32)
    tiled = np.asarray(jpft.tile(jnp.asarray(parts), jax.random.PRNGKey(0)).tiled)
    x = tpft.untile_from_jax(tiled, NX)
    np.testing.assert_array_equal(x.numpy(), parts.T)
    np.testing.assert_array_equal(tpft.tile_to_jax(x), tiled)
    back = jpft.untile(jpft.TiledPFState(tiled=jnp.asarray(
        tpft.tile_to_jax(x)), key=jax.random.PRNGKey(0)), NX)
    np.testing.assert_array_equal(np.asarray(back), parts)
    with pytest.raises(ValueError):
        tpft.tile_to_jax(x[:, :1000])


def test_point_estimate_matches_reference():
    rng = np.random.default_rng(2)
    parts = rng.standard_normal((8192, NX)).astype(np.float32)
    jstate = jpft.tile(jnp.asarray(parts), jax.random.PRNGKey(0))
    want = np.asarray(jpft.point_estimate(jstate, NX))
    tstate = convert.tiled_state_from_numpy(
        np.asarray(jstate.tiled), NX, torch.Generator())
    got = tpft.point_estimate(tstate).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert np.array_equal(tpft.dims(tstate).numpy(), parts.T)
    odd = tpft.TiledPFState(x=torch.from_numpy(parts[:5000].T.copy()),
                            generator=torch.Generator())
    np.testing.assert_allclose(tpft.point_estimate(odd).numpy(),
                               parts[:5000].mean(axis=0), rtol=2e-5,
                               atol=2e-6)


def test_statistical_agreement_with_reference_step(regenerated):
    """The port's own step (its own noise stream) from the fixture's
    particles against the reference step's output: particle means agree
    to sampling error, with the bound of ``tests/test_particle_tiled.py``.
    Near-uniform weights (~3,600 distinct ancestors of 4096); under the
    heavy-tailed ones a few hundred survive and two independent steps'
    means spread past that bound."""
    d = regenerated
    x0, state_pdf, meas_pdf = _rig()
    state = tpft.TiledPFState(x=_t(d["x_in"]),
                              generator=torch.Generator().manual_seed(200))
    state = tpft.step(state, _t(d["u"]), _t(d["near_uniform_z"]), _t(d["dt"]),
                      tbio.homeostatic_des, tbio.static_outputs,
                      _to_torch(state_pdf), _to_torch(meas_pdf))
    assert state.x.shape == (NX, 4096) and state.n_particles == 4096
    got = tpft.point_estimate(state).numpy()
    ref = d["near_uniform_x_out"].mean(axis=1)
    scale = np.maximum(np.abs(ref), 0.05)
    assert np.all(np.abs(got - ref) / scale < 0.2)


def test_init_and_step_are_reproducible_from_a_seed():
    x0, state_pdf, meas_pdf = (TGS.create(*a, device="cpu")
                               for a in FIX.bench_rig())
    u = torch.tensor([0.06, 0.2])
    z = tbio.static_outputs(torch.from_numpy(FIX.X_SS)).to(torch.float32)
    runs = []
    for _ in range(2):
        st = tpft.init(torch.Generator().manual_seed(3), 4096, x0)
        for _ in range(2):
            st = tpft.step(st, u, z, 0.1, tbio.homeostatic_des,
                           tbio.static_outputs, state_pdf, meas_pdf)
        runs.append(st.x)
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[0]).all()
