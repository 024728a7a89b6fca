"""The port's CUDA-graph helper (``gpu_se_tpu_torch/graphs.py``) and the
graphed methods of its filter shells, on the CPU.

A CUDA graph exists only on the card. Here the helper's card side
(``graphs.on_card``, ``warm_up``, ``capture``) is replaced by a stand-in
whose graph keeps the captured outputs, as a CUDA graph keeps its
tensors' addresses, and rewrites them in place at each replay by running
the function again on the static inputs; its capture draws nothing from
the generators, as a CUDA graph's capture does not advance them. So the
helper's own logic runs as on the card: keys, static buffers, inputs
copied in, outputs handed out, constants and generators held, launch
counts moved from the capture to the replays.

Sizes: 2^12 particles, 2^8 Gaussians, nx = 5. The JAX shells' jitted
methods run under ``jax.disable_jit()``: jitted, XLA fuses the model's
float32 ops and moves the weights by ~1e-5 itself. Tolerances, the
parity tests' own, given the reference's noise, ``r`` and ``ends``:
weights ``rtol=1e-5``, the resampled step bit-equal,
``point_estimate`` ``rtol=1e-6``, ``point_covariance`` ``rtol=1e-4``;
everything the port computes twice, graphed and eager, is bit-equal.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.filters import gs_ukf as jg
from gpu_se_tpu.filters import particle as jpf
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu_torch import convert, graphs, rig
from gpu_se_tpu_torch import sim as tsim
from gpu_se_tpu_torch.distributions import GaussianSum as TGS
from gpu_se_tpu_torch.filters import gs_ukf as tg
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.filters import particle_tiled as tpt
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops import resample_pallas_block as trb
from gpu_se_tpu_torch.sim import loop as tloop

CPU = "cpu"
N_PF = 2**12
N_GS = 2**8
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
X_SS = rig.X_SS
F_T, G_T = tbio.homeostatic_des, tbio.static_outputs
U = np.array([0.06, 0.2], np.float32)
DT = np.float32(0.1)
METHODS = ("predict", "update", "resample", "step", "moments")


# ----------------------------------------------------------------------
# the stand-in for the card's side (tests/_torch_graph_stand_in.py)
# ----------------------------------------------------------------------
from tests._torch_graph_stand_in import (  # noqa: E402,F401
    StandInGraph,
    _tensors,
    stand_in,
    stand_in_capture,
)


# ----------------------------------------------------------------------
# the helper
# ----------------------------------------------------------------------
def _affine(x, y, scale):
    return x * scale + y


def test_cpu_tensors_run_directly():
    g = graphs.Graphed(_affine)
    x = torch.arange(4.0)
    assert torch.equal(g(x, x, 2.0), x * 3)
    assert g.entries == {} and g.captures == 0


def test_disabled_runs_eagerly(stand_in):
    g = graphs.Graphed(_affine)
    with graphs.disabled():
        g(torch.ones(3), torch.ones(3), 2.0)
    assert g.captures == 0
    g(torch.ones(3), torch.ones(3), 2.0)
    assert g.captures == 1


def test_disabled_names_the_graphs_it_stops(stand_in):
    a, b = graphs.Graphed(_affine), graphs.Graphed(_affine)
    x = torch.ones(2)
    with graphs.disabled(a):
        a(x, x, 1.0)
        b(x, x, 1.0)
        with graphs.disabled():
            b(x, x, 2.0)
    assert (a.captures, b.captures) == (0, 1)
    a(x, x, 1.0)
    assert a.captures == 1


def test_capture_then_replay_copies_inputs(stand_in):
    g = graphs.Graphed(_affine)
    x, y = torch.arange(4.0), torch.ones(4)
    assert torch.equal(g(x, y, 2.0), x * 2 + 1)
    entry = next(iter(g.entries.values()))
    for k in range(3):
        x2 = torch.full((4,), float(k))
        assert torch.equal(g(x2, y, 2.0), x2 * 2 + 1)
    assert (g.captures, g.replays) == (1, 3)
    # the static buffers are the graph's own, not the caller's
    assert all(s is not t for s, t in zip(entry.static, (x, y)))


def test_keyword_arguments_in_any_order(stand_in):
    """Keyword tensors (the QP's chunks pass them) reach the static
    buffers of their own names, in whatever order a caller gives them."""
    g = graphs.Graphed(_affine)
    x, y = torch.arange(3.0), torch.ones(3)
    g(y=y, x=x, scale=2.0)
    got = g(y=torch.full((3,), 5.0), scale=2.0, x=x)
    assert torch.equal(got, x * 2 + 5)
    assert g.replays == 1


@pytest.mark.parametrize("change", ["shape", "dtype", "strides",
                                    "alignment", "value"])
def test_a_new_key_captures_anew(stand_in, change):
    g = graphs.Graphed(_affine)
    x = torch.arange(6.0).reshape(2, 3)
    g(x, x, 2.0)
    g(x, x, 2.0)
    other = {"shape": (x.reshape(3, 2), x.reshape(3, 2), 2.0),
             "dtype": (x.double(), x.double(), 2.0),
             "strides": (x.T.contiguous().T, x, 2.0),
             "alignment": (torch.arange(7.0)[1:].reshape(2, 3), x, 2.0),
             "value": (x, x, 3.0)}[change]
    got = g(*other)
    assert torch.equal(got, _affine(*other))
    assert g.captures == 2 and len(g.entries) == 2
    g(*other)
    assert g.replays == 2


def test_the_route_keys_a_graph(stand_in):
    g = graphs.Graphed(_affine, key=trs.route)
    x = torch.ones(3)
    g(x, x, 1.0)
    with trs.impl("xla"):
        g(x, x, 1.0)
        g(x, x, 1.0)
    g(x, x, 1.0)
    assert g.captures == 2 and g.replays == 2
    assert {k[1] for k in g.entries} == {"auto", "xla"}


def _scaled(x, dist):
    return x * dist.weights.sum() + dist.means[0, 0]


def _dist(scale):
    return TGS.create(np.zeros((1, 2)), np.eye(2)[None] * scale, [scale],
                      device=CPU)


def test_a_constant_is_read_at_its_address(stand_in):
    """A frozen dataclass is baked in: the same object computes with its
    current values; another object of the same shapes replaces the
    entry (its graph freed) and is computed with."""
    g = graphs.Graphed(_scaled)
    x, d1 = torch.ones(3), _dist(2.0)
    g(x, d1)
    assert torch.equal(g(x, d1), x * 2)
    d1.weights.mul_(3.0)                     # in place: read at replay
    assert torch.equal(g(x, d1), x * 6)
    d2 = _dist(5.0)
    assert torch.equal(g(x, d2), x * 5)
    assert g.captures == 2 and len(g.entries) == 1
    assert next(iter(g.entries.values())).consts == [d2]


def _draw(x, gen):
    return x + torch.rand(x.shape, generator=gen)


def test_generators_draw_as_eager(stand_in):
    g = graphs.Graphed(_draw)
    gen_g, gen_e = torch.Generator().manual_seed(4), \
        torch.Generator().manual_seed(4)
    x = torch.zeros(5)
    for _ in range(3):
        assert torch.equal(g(x, gen_g), _draw(x, gen_e))
    saved = gen_e.get_state()
    want = _draw(x, gen_e)
    gen_g.set_state(saved)                   # honoured at the next replay
    assert torch.equal(g(x, gen_g), want)
    other = torch.Generator().manual_seed(4)
    g(x, other)                              # another generator: captured
    assert g.captures == 2 and len(g.entries) == 1


def _passthrough(x, y):
    return x, y * 2


def test_outputs_are_the_callers_to_keep(stand_in):
    g = graphs.Graphed(_passthrough)
    x, y = torch.ones(3), torch.ones(3)
    g(x, y)
    a_x, a_y = g(x, y)
    held = a_y.clone()
    assert a_x is x                          # an input handed back as is
    for k in range(3):
        g(x, torch.full((3,), float(k)))
    assert torch.equal(a_y, held)


def test_buffers_and_outputs_keep_their_layout(stand_in):
    """A strided view in (the ends route's unpacked rows) is copied into
    a buffer of its strides and alignment; an output handed out keeps
    the layout eager dispatch gives it."""
    g = graphs.Graphed(lambda t: (t * 2, t[:, 1:]))
    packed = torch.arange(40.0).reshape(5, 8)
    view = packed[:, 3:8]
    g(view)
    entry = next(iter(g.entries.values()))
    assert entry.static[0].stride() == view.stride()
    assert graphs._alignment(entry.static[0]) == graphs._alignment(view)
    got = g(view)
    want = (view * 2, view[:, 1:])
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.stride() == b.stride()
        assert graphs._alignment(a) == graphs._alignment(b)


def test_copy_out_false_hands_out_the_graphs_tensors(stand_in):
    g = graphs.Graphed(_passthrough, copy_out=False)
    x = torch.ones(3)
    g(x, x)
    first = g(x, x)[1]
    second = g(x, 3 * x)[1]
    assert first is second and torch.equal(first, 6 * x)


def test_launch_counts_move_to_the_replays(stand_in, monkeypatch):
    def kernel(x):
        kernel.launches += 1
        return x + 1

    kernel.launches = 0
    monkeypatch.setattr(graphs, "KERNELS", (kernel,))
    g = graphs.Graphed(lambda x: kernel(kernel(x)))
    x = torch.zeros(2)
    g(x)                       # the warm-up launches; the capture is taken back
    assert kernel.launches == 2
    for _ in range(3):
        g(x)
    assert kernel.launches == 2 + 3 * 2
    assert next(iter(g.entries.values())).launches == {kernel: 2}


# ----------------------------------------------------------------------
# the shells' graphed methods
# ----------------------------------------------------------------------
def _harness_rig():
    """``sim/harness.get_noise``'s mixtures and x0 at the steady state."""
    state_pdf, meas_pdf = tsim.get_noise(device=CPU)
    sd, md = state_pdf.dist, meas_pdf.dist
    x0 = TGS.create(sd.means.numpy() + X_SS, sd.covariances.double().numpy(),
                    sd.weights.numpy(), device=CPU)
    return x0, sd, md


def _bench_rig():
    return tuple(TGS.create(*a, device=CPU) for a in rig.bench_rig())


def _shell(kind, stabilized=False, seed=0):
    if kind == "pf":
        x0, sd, md = _harness_rig()
        return tpf.ParticleFilter(F_T, G_T, N_PF, x0, sd, md, seed=seed,
                                  device=CPU, stabilized=stabilized)
    x0, sd, md = _bench_rig()
    return tg.GaussianSumUnscentedKalmanFilter(
        F_T, G_T, N_GS, x0, sd, md, seed=seed, device=CPU,
        stabilized=stabilized)


def _z():
    return (np.asarray(jbio.static_outputs(X_SS, U, xp=np))
            + np.array([5.0, -20.0])).astype(np.float32)


def _call(filt, method):
    if method == "predict":
        filt.predict(U, DT)
    elif method == "update":
        filt.update(U, _z())
    elif method == "resample":
        filt.resample()
    elif method == "step":
        filt.step(U, _z(), DT)
    else:
        return filt.moments()
    return filt.state


def _core(kind):
    return tpf if kind == "pf" else tg


def _functional(kind, filt, state, method):
    core = _core(kind)
    u, z, dt = (torch.as_tensor(v) for v in (U, _z(), DT))
    if method == "predict":
        return core.predict(state, u, dt, F_T, filt.state_pdf)
    if method == "update":
        upd = core.update_stabilized if filt.stabilized else core.update
        return upd(state, u, z, G_T, filt.measurement_pdf)
    if method == "resample":
        return core.resample(state)
    if method == "step":
        return core.step(state, u, z, dt, F_T, G_T, filt.state_pdf,
                         filt.measurement_pdf, filt.stabilized)
    return core.point_estimate(state), core.point_covariance(state)


def _same(got, want):
    a, b = _tensors(got), _tensors(want)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _fork(state):
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, generator=gen)


@pytest.mark.parametrize("graphed", [False, True], ids=["direct", "graphed"])
@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_shell_methods_equal_the_functional_forms(request, kind, graphed):
    """Each of the five methods, called three times in turn (a capture
    and two replays through the stand-in), equals its functional form
    from the same state and generator state, bit for bit."""
    if graphed:
        request.getfixturevalue("stand_in")
    filt = _shell(kind)
    for _ in range(3):
        for method in METHODS:
            before = _fork(filt.state)
            got = _call(filt, method)
            want = _functional(kind, filt, before, method)
            _same(got, want)
            if method != "moments":
                assert torch.equal(filt.state.generator.get_state(),
                                   before.generator.get_state())
    if graphed:
        assert all(filt.graphs[m].replays >= 1 for m in METHODS)
    else:
        assert all(filt.graphs[m].captures == 0 for m in METHODS)


@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_shell_route_and_stabilized_capture_anew(stand_in, kind):
    filt = _shell(kind)
    step = filt.graphs["step"]
    for _ in range(2):
        filt.step(U, _z(), DT)
    assert step.captures == 1
    with trs.impl("xla"):
        filt.step(U, _z(), DT)
    assert step.captures == 2
    filt.stabilized = True
    before = _fork(filt.state)
    filt.step(U, _z(), DT)
    assert step.captures == 3
    _same(filt.state, _functional(kind, filt, before, "step"))


@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_shell_honours_new_dists_and_states(stand_in, kind):
    """A dist assigned anew and a state assigned from outside (a
    checkpoint's, with a generator of its own) are computed with, as the
    eager shell computes."""
    filt, eager = _shell(kind), _shell(kind)
    for _ in range(2):
        filt.step(U, _z(), DT)
        with graphs.disabled():
            eager.step(U, _z(), DT)
    _, _, md = _harness_rig() if kind == "pf" else _bench_rig()
    wide = TGS.create(md.means.numpy(), 4 * md.covariances.double().numpy(),
                      md.weights.numpy(), device=CPU)
    for f in (filt, eager):
        f.measurement_pdf = wide
    filt.step(U, _z(), DT)
    with graphs.disabled():
        eager.step(U, _z(), DT)
    _same(filt.state, eager.state)
    assert filt.graphs["step"].captures == 2
    for f in (filt, eager):
        st = f.state
        f.state = dataclasses.replace(
            st, generator=torch.Generator().manual_seed(9),
            **{k.name: getattr(st, k.name) + 0.0
               for k in dataclasses.fields(st) if k.name != "generator"})
    filt.step(U, _z(), DT)
    with graphs.disabled():
        eager.step(U, _z(), DT)
    _same(filt.state, eager.state)
    _same(filt.moments(), eager.moments())


@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_shell_hands_out_tensors_that_keep_their_values(stand_in, kind):
    filt = _shell(kind)
    for _ in range(2):
        filt.step(U, _z(), DT)
    est, cov = filt.moments()
    held = _tensors(filt.state) + [est, cov]
    snaps = [t.clone() for t in held]
    for _ in range(3):
        filt.step(U, _z(), DT)
        filt.moments()
    assert all(torch.equal(t, s) for t, s in zip(held, snaps))
    assert filt.graphs["step"].replays >= 3


def test_tiled_graphed_step_equals_step(stand_in):
    x0, sd, md = _bench_rig()
    u, z = torch.as_tensor(U), torch.as_tensor(_z())
    st_g = tpt.init(torch.Generator().manual_seed(2), N_PF, x0)
    st_e = _fork(st_g)
    step_g = tpt.graphed_step()
    for _ in range(4):
        st_g = step_g(st_g, u, z, 0.1, F_T, G_T, sd, md)
        st_e = tpt.step(st_e, u, z, 0.1, F_T, G_T, sd, md)
        _same(st_g, st_e)
        assert torch.equal(st_g.generator.get_state(),
                           st_e.generator.get_state())
    assert (step_g.captures, step_g.replays) == (1, 3)
    sfn = tpt.graphed_step_from_noise()
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        noise, r = sd.draw_t(gen, N_PF), torch.rand((), generator=gen)
        args = (st_g.x, u, z, 0.1, F_T, G_T, md, noise, r)
        assert torch.equal(sfn(*args), tpt.step_from_noise(*args))
    assert sfn.replays == 2


# ----------------------------------------------------------------------
# against the JAX shells' jitted steps, given the reference's draws
# ----------------------------------------------------------------------
def _to_torch(jgs):
    return convert.gaussian_sum_from_numpy(
        *(np.asarray(getattr(jgs, f)) for f in FIELDS), device=CPU)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _inject(monkeypatch, noise, r, ends, lanes: bool):
    """The port's draws and ``ends`` replaced by the reference's."""
    noise_t = _t(noise)
    monkeypatch.setattr(TGS, "draw_t" if lanes else "draw",
                        lambda self, gen, shape: noise_t)
    monkeypatch.setattr(trs, "_draw_r", lambda w, gen: _t(r))
    ends_t = _t(ends)
    for mod in (trs, trb, trp4):
        monkeypatch.setattr(mod, "ends_from_weights", lambda *_: ends_t)


def _check_moments(got, want_est, want_cov):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_est),
                               rtol=1e-6, atol=0)
    assert float(got[1]) == pytest.approx(float(want_cov), rel=1e-4)


def test_pf_shell_step_through_the_helper_vs_jax_shell(stand_in,
                                                       monkeypatch):
    """``ParticleFilter.step`` through the helper (a capture, then a
    replay from the same start) against the reference shell's ``step``,
    given its noise, ``r`` and ``ends``."""
    x0_t, sd_t, md_t = _harness_rig()
    x0, sd, md = (JGS.create(*(np.asarray(getattr(d, f), np.float64)
                               for f in FIELDS[:3]))
                  for d in (x0_t, sd_t, md_t))
    ref = jpf.ParticleFilter(jbio.Bioreactor.homeostatic_DEs,
                             jbio.Bioreactor.static_outputs, N_PF, x0, sd,
                             md, seed=3)
    start = ref.state
    k1, sub1 = jax.random.split(start.key)
    _, sub2 = jax.random.split(k1)
    noise = jax.jit(lambda k: sd.draw(k, (N_PF,)))(sub1)
    r = np.float32(jax.random.uniform(sub2, ()))
    with jax.disable_jit():
        ref.predict(U, DT)
        ref.update(U, _z())
        w_upd = np.asarray(ref.weights)
        ref.state = start
        ref.step(U, _z(), DT)
        want_est, want_cov = ref.moments()
    ends = np.asarray(j_ends(jnp.asarray(w_upd), jnp.asarray(r)))
    want_x = np.asarray(ref.particles)

    filt = tpf.ParticleFilter(F_T, G_T, N_PF, x0_t, _to_torch(sd),
                              _to_torch(md), device=CPU)
    first = tpf.PFState(_t(start.particles), _t(start.weights),
                        torch.Generator())
    _inject(monkeypatch, noise, r, ends, lanes=False)
    filt.state = first
    filt.predict(U, DT)
    filt.update(U, _z())
    np.testing.assert_allclose(filt.weights.numpy(), w_upd, rtol=1e-5,
                               atol=0)
    for _ in range(2):                       # the capture, then a replay
        filt.state = first
        filt.step(U, _z(), DT)
        np.testing.assert_array_equal(filt.particles.numpy(), want_x)
        _check_moments(filt.moments(), want_est, want_cov)
    assert filt.graphs["step"].replays == 1


def test_gsukf_shell_step_through_the_helper_vs_jax_shell(stand_in,
                                                          monkeypatch):
    """The GSUKF shell's ``step`` through the helper against the
    reference shell's ``step``, given its sigma-point noise, ``r`` and
    ``ends``."""
    x0_a, sp_a, mp_a = rig.bench_rig()
    x0, sd, md = (JGS.create(*a) for a in (x0_a, sp_a, mp_a))
    f_j = functools.partial(jbio.homeostatic_des, xp=jnp)
    g_j = functools.partial(jbio.static_outputs, xp=jnp)
    ref = jg.GaussianSumUnscentedKalmanFilter(f_j, g_j, N_GS, x0, sd, md,
                                              seed=1)
    start = ref.state
    k1, sub1 = jax.random.split(start.key)
    _, sub2 = jax.random.split(k1)
    nx = x0_a[0].shape[-1]
    noise_t = jax.jit(lambda k: sd.draw_t(k, N_GS * (2 * nx + 1)))(sub1)
    r = np.float32(jax.random.uniform(sub2, ()))
    with jax.disable_jit():
        ref.predict(U, DT)
        ref.update(U, _z())
        w_upd = np.asarray(ref.weights)
        ref.state = start
        ref.step(U, _z(), DT)
        want = (np.asarray(ref.means), np.asarray(ref.covariances))
        want_est, want_cov = ref.moments()
    ends = np.asarray(j_ends(jnp.asarray(w_upd), jnp.asarray(r)))

    filt = tg.GaussianSumUnscentedKalmanFilter(
        F_T, G_T, N_GS, _to_torch(x0), _to_torch(sd), _to_torch(md),
        device=CPU)
    first = tg.GSUKFState(_t(start.means), _t(start.covariances),
                          _t(start.weights), torch.Generator())
    _inject(monkeypatch, noise_t, r, ends, lanes=True)
    filt.state = first
    filt.predict(U, DT)
    filt.update(U, _z())
    np.testing.assert_allclose(filt.weights.numpy(), w_upd, rtol=1e-5,
                               atol=0)
    for _ in range(2):
        filt.state = first
        filt.step(U, _z(), DT)
        np.testing.assert_array_equal(filt.means.numpy(), want[0])
        np.testing.assert_array_equal(filt.covariances.numpy(), want[1])
        _check_moments(filt.moments(), want_est, want_cov)
    assert filt.graphs["step"].replays == 1


# ----------------------------------------------------------------------
# the closed loop on the device
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pf", [True, False], ids=["pf", "gsukf"])
def test_scan_loop_records_unchanged_by_graphs(request, pf):
    """``make_scan_loop``'s records on the CPU, run directly, equal the
    same loop's with its filter work through the helper (stand-in
    graphs), bit for bit; the graphs are captured at the first run and
    replayed at the second."""
    bioreactor, lin_model, K, est = tsim.get_parts(
        dt_control=1, N_particles=N_PF if pf else 16, pf=pf, device=CPU)
    state_pdf, meas_pdf = tsim.get_noise(device=CPU)
    kw = {} if pf else {"filter_core": tg}
    x0 = np.asarray(bioreactor.X)

    def records():
        run, _ = tloop.make_scan_loop(K, lin_model, state_pdf.dist,
                                      meas_pdf.dist, end_time=4.0,
                                      dt_control=1.0, dt_predict=0.5, **kw)
        return [run(est.state, x0, torch.Generator().manual_seed(5))
                for _ in range(2)]

    direct = records()
    request.getfixturevalue("stand_in")
    graphed = records()
    for a, b in zip(direct + direct, graphed + graphed[::-1]):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


# ----------------------------------------------------------------------
# the pacf series' readings beside each rep
# ----------------------------------------------------------------------
def test_pacf_sensors_without_a_card():
    """Without a card every sensor reads None and the CPU series carries
    no sensor fields; ``correlation`` is Pearson's r, None for a
    constant or missing series."""
    from gpu_se_tpu_torch.results import pacf_series as ps

    sensors = ps.CardSensors()
    assert sensors.read() == dict.fromkeys(ps.CardSensors.FIELDS)
    sensors.close()
    out = ps.pacf_series(256, 2, 12, gpu=False)
    assert out["idle_gap_s"] == 0.0 and "sensor_series" not in out
    a = np.arange(12.0)
    assert ps.correlation(a, 2 * a + 1) == pytest.approx(1.0)
    assert ps.correlation(a, -a) == pytest.approx(-1.0)
    assert ps.correlation(a, np.ones(12)) is None
    assert ps.correlation(a, [None] * 12) is None


# ----------------------------------------------------------------------
# counts kept on the device, and the fork of a state
# ----------------------------------------------------------------------
def test_counts_on_the_device_settle_and_go_with_their_owner():
    """A registered count adds ``launches`` a run to its wrapper and is
    zeroed at each settle; once its owner is gone it is read no more."""
    import gc

    class Owner:
        pass

    wrapper = types.SimpleNamespace(launches=0)
    owner, count = Owner(), torch.zeros((), dtype=torch.int64)
    graphs.count_on_card(owner, wrapper, 2, count)
    count.add_(3)
    graphs.settle_counts()
    assert wrapper.launches == 6 and count.item() == 0
    graphs.settle_counts()
    assert wrapper.launches == 6
    del owner
    gc.collect()
    count.add_(1)
    graphs.settle_counts()
    assert wrapper.launches == 6 and count.item() == 1


@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_fork_clones_the_state_and_its_generator(kind):
    x0, state_pdf, _ = (TGS.create(*a, device="cpu")
                        for a in rig.bench_rig())
    gen = torch.Generator().manual_seed(4)
    state = (tpf.init(gen, 64, x0) if kind == "pf"
             else tg.init(gen, 16, x0, state_pdf))
    copy = graphs.fork(state)
    assert copy.generator is not state.generator
    assert torch.equal(copy.generator.get_state(),
                       state.generator.get_state())
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(copy, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.stride() == b.stride()
            assert a.data_ptr() != b.data_ptr()
    assert torch.equal(torch.rand(3, generator=copy.generator),
                       torch.rand(3, generator=state.generator))
