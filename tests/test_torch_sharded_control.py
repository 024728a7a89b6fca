"""The port's global moments, sharded control step and entry points
against the JAX reference's, on the CPU.

The port runs over gloo in spawned groups of W = 2 and 4 ranks
(``tests/_torch_parallel_workers.control_suite``, one group a width) and
at W = 1 in this process; the reference on the virtual CPU mesh of
``tests/conftest.py`` at the same W, its estimates taken by its own
``point_estimate`` and ``point_covariance`` on ``NamedSharding`` states
under ``jit`` (a psum). Tolerances:

* the global estimate and covariance are bit-equal on every rank, and
  where the shards hold whole blocks of the single-device reduction
  (``N`` = 16384 rows: 4096-row blocks, 128-particle tiled blocks) the
  estimate is bit-equal across W = 1, 2, 4; the tiled estimate is
  bit-equal to the port's single-device ``point_estimate``, the flat and
  GSUKF estimates lie within ``PORT_RTOL`` and ``PORT_ATOL`` of it
  (their block sums run along a contiguous axis, the single-device sums
  along the rows), the
  covariances within ``PORT_COV_RTOL``; where they do not hold whole
  blocks (``N_ODD`` = 48 rows), within the same tolerances;
* against the reference's estimates on ``NamedSharding`` states within
  ``REF_RTOL`` (1e-5 relative), the covariances within ``REF_COV_RTOL``;
* the control step's ``from_noise`` at W = 1 and 2, 16 and 128
  particles a rank, on the dry run's toy MPC, fed the noise and ``r`` of
  the reference's key schedule, against the reference's control step
  rebuilt here from its pieces (sharded PF step, ``point_estimate``,
  selection, ``make_device_step``): particles within the flat
  tolerances (``rtol=2e-5, atol=1e-6``), the estimate within 1e-5
  relative, ``u`` within 1e-4 and ``y_pred`` within 1e-3 (those of
  ``tests/test_torch_sharding.py``'s scenario solvers), the status
  equal, and ``u`` bit-equal on every rank;
* for each filter, the control step's ``from_noise`` fed the noise and
  ``r`` its ``step`` draws equals the step bit for bit (W = 1);
* ``entry(device="cpu")`` equals the port's tiled step bit for bit, and
  ``dryrun_multichip(2, device="cpu")`` runs and prints its line.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.control import MPC as RefMPC
from gpu_se_tpu.control import mpc as ref_mpc_mod
from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.filters import gs_ukf as jgs
from gpu_se_tpu.filters import particle as jpf
from gpu_se_tpu.filters import particle_tiled as jpft
from gpu_se_tpu.models import LinearModel as RefLinearModel
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.parallel import make_mesh as ref_mesh
from gpu_se_tpu.parallel import make_shard_map_step as ref_step
from gpu_se_tpu.parallel import sharded as jS
from gpu_se_tpu_torch import entry
from gpu_se_tpu_torch.filters import gs_ukf as tgs
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.filters import particle_tiled as tpft
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import counter_draw as tcd
from gpu_se_tpu_torch.parallel import make_mesh
from gpu_se_tpu_torch.parallel.control import make_sharded_control_step
from gpu_se_tpu_torch.parallel.launch import run_group

from tests import _torch_parallel_workers as workers

N = 16384
N_ODD = 48
WIDTHS = (1, 2, 4)
SPAWNED = (2, 4)
CONTROL_WIDTHS = (1, 2)
CONTROL_N = (16, 128)
PORT_RTOL = 1e-6
PORT_ATOL = 1e-7     # float32's eps at the particles' unit spread
PORT_COV_RTOL = 1e-5
REF_RTOL = 1e-5
REF_COV_RTOL = 1e-4
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
X_SS = entry.X_SS
DT = np.float32(0.1)


def _moment_cases():
    """Flat, GSUKF and tiled populations of ``N`` and ``N_ODD`` rows:
    particles about the steady state, lognormal weights, SPD
    covariances; float32 from a seed."""
    rng = np.random.default_rng(7)
    cases = {}
    for n in (N, N_ODD):
        x = (X_SS + rng.standard_normal((n, 5))).astype(np.float32)
        w = np.exp(2.0 * rng.standard_normal(n)).astype(np.float32)
        half = rng.standard_normal((n, 5, 5)).astype(np.float32)
        covs = (half @ half.transpose(0, 2, 1) / 5).astype(np.float32)
        cases[f"pf {n}"] = dict(kind="pf", x=x, w=w)
        cases[f"gsukf {n}"] = dict(kind="gsukf", x=x, w=w, covs=covs)
        cases[f"tiled {n}"] = dict(kind="tiled", x=x)
    return cases


def _ref_moments(nd, case):
    """The reference's ``point_estimate`` and ``point_covariance`` on the
    case's state placed by its ``shard_*_state`` on a width-``nd``
    mesh, under ``jit``."""
    mesh, key = ref_mesh(nd), jax.random.PRNGKey(0)
    x, kind = jnp.asarray(case["x"]), case["kind"]
    if kind == "tiled":
        if len(x) % 128:
            return None, None       # the reference tiles whole 128-lane rows
        st = jS.shard_tiled_pf_state(jpft.tile(x, key), mesh)
        return np.asarray(jax.jit(lambda s: jpft.point_estimate(s, 5))(st)), None
    if kind == "pf":
        st = jS.shard_pf_state(jpf.PFState(x, jnp.asarray(case["w"]), key),
                               mesh)
        mod = jpf
    else:
        st = jS.shard_gsukf_state(jgs.GSUKFState(
            x, jnp.asarray(case["covs"]), jnp.asarray(case["w"]), key), mesh)
        mod = jgs
    return (np.asarray(jax.jit(mod.point_estimate)(st)),
            np.asarray(jax.jit(mod.point_covariance)(st)))


def _port_single(case):
    """The port's single-device estimate and covariance of the case."""
    x = torch.from_numpy(case["x"])
    if case["kind"] == "tiled":
        return tpft.point_estimate(tpft.TiledPFState(x.T.contiguous(),
                                                     None)).numpy(), None
    w = torch.from_numpy(case["w"])
    if case["kind"] == "pf":
        st, mod = tpf.PFState(x, w, None), tpf
    else:
        st, mod = tgs.GSUKFState(x, torch.from_numpy(case["covs"]), w,
                                 None), tgs
    return (mod.point_estimate(st).numpy(),
            mod.point_covariance(st).numpy())


# ----------------------------------------------------------------------
# the reference's control step, rebuilt from its pieces
# ----------------------------------------------------------------------
def _ref_dists():
    x0 = JGS.create(np.stack([X_SS, X_SS]),
                    np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
                    np.array([0.75, 0.25]))
    state_pdf = JGS.create(
        np.zeros((2, 5)),
        np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                  np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
        np.array([0.75, 0.25]))
    meas_pdf = JGS.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]))
    return x0, state_pdf, meas_pdf


def _ref_control_mpc():
    lin = RefLinearModel(
        A=np.array([[0.7, 0.0], [0.1, 0.9]]),
        B=np.array([[25.0, 0.1], [0.2, 8.0]]),
        C=np.eye(2) * np.array([180.0, 116.0]), D=np.zeros((2, 2)), dt=1.0,
        x_bar=X_SS[[0, 2]], u_bar=np.array([0.04, 0.1]), f_bar=np.zeros(2),
        y_bar=X_SS[[0, 2]] * np.array([180.0, 116.0]))
    K = RefMPC(P=20, M=8, Q=np.diag([0.1, 1.0]), R=np.diag([1.0, 1.0]),
               lin_model=lin, ysp=np.array([1.0, -1.0]),
               u_bounds=[np.array([0, np.inf]) - 0.04,
                         np.array([0, np.inf]) - 0.1])
    return lin, K


def _ref_control(nd, n, um1, z):
    """The reference's sharded control step on ``n`` particles over a
    width-``nd`` mesh, with the noise and ``r`` its key schedule draws."""
    x0, state_pdf, meas_pdf = _ref_dists()
    lin, K = _ref_control_mpc()
    consts, mpc_step = ref_mpc_mod.make_device_step(K)
    mesh = ref_mesh(nd)
    f, g = jbio.Bioreactor.homeostatic_DEs, jbio.Bioreactor.static_outputs
    pf_step = ref_step(mesh, f, g)
    state = jpf.init(jax.random.PRNGKey(n + nd), n, x0)
    _, k_noise, k_r = jax.random.split(state.key, 3)
    noise = np.asarray(state_pdf.draw(k_noise, (n,)))
    r = np.float32(jax.random.uniform(k_r, ()))
    n_d, m = (K.M + 1) * K.Ni, int(K.qp.m)

    @jax.jit
    def control_step(state, um1, z, bias, warm_v, warm_y):
        state = pf_step(state, um1, z, jnp.float32(DT), state_pdf, meas_pdf)
        x_hat = jpf.point_estimate(state)
        x_dev = x_hat[jnp.array([0, 2])] - jnp.asarray(lin.x_bar, x_hat.dtype)
        u_dev = um1 - jnp.asarray(lin.u_bar, x_hat.dtype)
        ctrl, y_pred, sol = mpc_step(consts, x_dev, u_dev, bias, warm_v,
                                     warm_y)
        return (state, ctrl + jnp.asarray(lin.u_bar, x_hat.dtype), y_pred,
                sol, x_hat)

    out = control_step(jS.shard_pf_state(state, mesh), jnp.asarray(um1),
                       jnp.asarray(z), jnp.zeros(2), jnp.zeros(n_d),
                       jnp.zeros(m))
    st, u, y_pred, sol, x_hat = out
    case = dict(x=np.asarray(state.particles), w=np.asarray(state.weights),
                noise=noise, r=r)
    want = dict(particles=np.asarray(st.particles), est=np.asarray(x_hat),
                u=np.asarray(u), y_pred=np.asarray(y_pred),
                status=int(sol.status))
    return case, want


@pytest.fixture(scope="module")
def runs():
    """The reference's moments and control steps, and the port's, by
    width."""
    cases = _moment_cases()
    ref = {"moments": {nd: {name: _ref_moments(nd, c)
                            for name, c in cases.items()} for nd in WIDTHS},
           "control": {}}
    x0, state_pdf, meas_pdf = _ref_dists()
    um1 = np.array(entry.U, np.float32)
    z = tbio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).numpy()
    control = {"cases": {}, "um1": um1, "z": z, "dt": float(DT),
               "meas": tuple(np.asarray(getattr(meas_pdf, k))
                             for k in FIELDS),
               "mpc": entry.toy_control("cpu")[1]}
    for nd in CONTROL_WIDTHS:
        for n_rank in CONTROL_N:
            case, want = _ref_control(nd, n_rank * nd, um1, z)
            control["cases"][(nd, n_rank)] = case
            ref["control"][(nd, n_rank)] = want
    d = {"moments": cases, "control": control}
    port = {1: [workers.control_suite(d)]}
    for nd in SPAWNED:
        port[nd] = run_group(workers.control_suite, nd, d, timeout_s=240)
    return cases, ref, port


def _same_on_every_rank(outs, get):
    first = get(outs[0])
    for o in outs[1:]:
        for a, b in zip(get(o), first):
            if a is not None:
                np.testing.assert_array_equal(a.view(np.int32),
                                              b.view(np.int32))
    return first


@pytest.mark.parametrize("nd", WIDTHS)
def test_global_moments_same_bits_on_every_rank_and_width(runs, nd):
    cases, _, port = runs
    for name in cases:
        est, _ = _same_on_every_rank(port[nd],
                                     lambda o: o["moments"][name])
        if name.endswith(f" {N}"):
            want = port[1][0]["moments"][name][0]
            np.testing.assert_array_equal(est.view(np.int32),
                                          want.view(np.int32), err_msg=name)


@pytest.mark.parametrize("nd", WIDTHS)
def test_global_moments_near_single_device(runs, nd):
    cases, _, port = runs
    for name, case in cases.items():
        est, cov = port[nd][0]["moments"][name]
        want_est, want_cov = _port_single(case)
        if case["kind"] == "tiled" and name.endswith(f" {N}"):
            np.testing.assert_array_equal(est, want_est, err_msg=name)
        np.testing.assert_allclose(est, want_est, rtol=PORT_RTOL,
                                   atol=PORT_ATOL, err_msg=name)
        if cov is not None:
            np.testing.assert_allclose(cov, want_cov, rtol=PORT_COV_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("nd", WIDTHS)
def test_global_moments_vs_reference_sharded(runs, nd):
    cases, ref, port = runs
    for name, case in cases.items():
        est, cov = port[nd][0]["moments"][name]
        want_est, want_cov = ref["moments"][nd][name]
        if want_est is None:
            continue
        np.testing.assert_allclose(est, want_est, rtol=REF_RTOL,
                                   err_msg=name)
        if cov is not None:
            np.testing.assert_allclose(cov, want_cov, rtol=REF_COV_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("nd", CONTROL_WIDTHS)
@pytest.mark.parametrize("n_rank", CONTROL_N)
def test_control_step_vs_reference(runs, nd, n_rank):
    _, ref, port = runs
    outs = [o["control"][(nd, n_rank)] for o in port[nd]]
    _same_on_every_rank(outs, lambda o: (o["est"], o["u"], o["y_pred"]))
    assert len({o["status"] for o in outs}) == 1
    got = outs[0]
    want = ref["control"][(nd, n_rank)]
    particles = np.concatenate([o["particles"] for o in outs])
    np.testing.assert_allclose(particles, want["particles"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["est"], want["est"], rtol=1e-5)
    np.testing.assert_allclose(got["u"], want["u"], atol=1e-4)
    np.testing.assert_allclose(got["y_pred"], want["y_pred"], atol=1e-3)
    assert got["status"] == want["status"]


def _own_draws(filter, state, state_pdf):
    """The noise and ``r`` that the sharded step of ``filter`` draws
    from ``state``'s generator at W = 1 (the generator is advanced)."""
    gen = state.generator
    if filter == "tiled":
        noise = state_pdf.draw_t(gen, state.x.shape[1])
        return noise, torch.rand((), generator=gen)
    key = tcd.key_from(gen, "cpu")
    r = torch.rand((), generator=gen)
    if filter == "pf":
        return state_pdf.draw_from(*state_pdf.draw_inputs_at(
            key, 0, state.n_particles)), r
    n, nx = state.means.shape
    s = 2 * nx + 1
    noise = state_pdf.draw_t_from(*state_pdf.draw_inputs_at_t(key, 0, n * s))
    return noise.reshape(nx, n, s).permute(2, 0, 1), r


@pytest.mark.parametrize("filter", ("pf", "gsukf", "tiled"))
def test_control_from_noise_is_the_step_fed_its_own_draws(filter):
    """For each filter, ``step.from_noise`` fed the noise and ``r`` that
    ``step`` draws gives the same state, control, prediction and status,
    bit for bit (W = 1, the dry run's toy MPC)."""
    lin, mpc = entry.toy_control("cpu")
    x0, state_pdf, meas_pdf = entry.toy_dists("cpu")
    um1, z = entry._inputs("cpu")
    mesh = make_mesh(device="cpu")
    step = make_sharded_control_step(mesh, mpc, lin, tbio.homeostatic_des,
                                     tbio.static_outputs, dt=entry.DT,
                                     filter=filter)
    init = {"pf": lambda g: tpf.init(g, 256, x0),
            "gsukf": lambda g: tgs.init(g, 64, x0, state_pdf),
            "tiled": lambda g: tpft.init(g, 256, x0)}[filter]
    warm = (torch.zeros(2), torch.zeros((mpc.M + 1) * mpc.Ni),
            torch.zeros(mpc.qp.m))
    got = step(init(torch.Generator().manual_seed(3)), um1, z, *warm,
               state_pdf, meas_pdf)
    state = init(torch.Generator().manual_seed(3))
    noise, r = _own_draws(filter, state, state_pdf)
    want = step.from_noise(state, um1, z, *warm, meas_pdf, noise, r)
    fields = {"pf": ("particles", "weights"),
              "gsukf": ("means", "covariances", "weights"),
              "tiled": ("x",)}[filter]
    for f in fields:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[3].status) == int(want[3].status)
    assert torch.isfinite(got[1]).all()


def test_entry_is_the_tiled_step():
    fn, (state, u, z) = entry.entry(device="cpu")
    assert state.x.shape == (5, entry.ENTRY_N)
    x0, state_pdf, meas_pdf = entry.toy_dists("cpu")
    want = tpft.step(
        tpft.init(torch.Generator().manual_seed(0), entry.ENTRY_N, x0), u,
        z, torch.tensor(entry.DT), tbio.homeostatic_des, tbio.static_outputs,
        state_pdf, meas_pdf)
    got = fn(state, u, z)
    assert torch.equal(got.x, want.x)
    assert torch.isfinite(got.x).all()


def test_entry_distributions_are_the_reference_ones():
    """``toy_dists`` builds the reference entry point's mixtures: every
    field equal to the reference's within float32 rounding of the same
    float64 setup."""
    for port, ref in zip(entry.toy_dists("cpu"), _ref_dists()):
        for k in FIELDS:
            np.testing.assert_allclose(getattr(port, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_dryrun_multichip_runs_on_two_cpu_ranks(capsys):
    entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): ok")
    assert "qp_status=" in line and line.endswith("devices=2")
