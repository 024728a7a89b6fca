"""The benchmark's reference against the port at tiny sizes on the CPU:
the plant, the mixtures' densities, the UKF update and the MPC agree
with the port's float64 results, the reference GSUKF's closed-loop
filter steps through its stages, and short runs of each cell's traffic
on the CPU compare as sound (the particle filter's loop as it read
before the check took its reference filter from the estimator)."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from port_bench import manifest, run
from port_bench.reference import mpc as ref_mpc
from port_bench.reference import loop_check, plant, ukf
from port_bench.reference import pf as ref_pf
from port_bench.reference.mixture import Mixture
from port_bench.session import Session

CFG = manifest.read_json(manifest.PKG / "configs" / "pf_2p20.json")


def _states(n, seed=0):
    g = np.random.default_rng(seed)
    x = np.array(CFG["plant"]["x_guess"])[None] + g.normal(
        0, [0.2, 1.0, 0.5, 0.05, 1.0], (n, 5))
    x[:, 3] = np.abs(x[:, 3])
    return torch.as_tensor(x)


def test_plant_matches_the_port_model():
    from gpu_se_tpu_torch.models import bioreactor

    x = _states(64)
    u = torch.tensor([0.05, 0.15], dtype=torch.float64)
    port = bioreactor.homeostatic_des(x.T, u, 0.1).T
    ref = torch.stack(plant.deltas([x[:, j] for j in range(5)],
                                   [0.05, 0.15], 0.1, plant.torch_ops()), 1)
    torch.testing.assert_close(ref, port, rtol=1e-12, atol=1e-14)
    port_e = bioreactor.euler_step(x.T, u, 0.1).T
    ref_e = torch.stack(plant.euler([x[:, j] for j in range(5)],
                                    [0.05, 0.15], 0.1, plant.torch_ops()), 1)
    torch.testing.assert_close(ref_e, port_e, rtol=1e-12, atol=1e-14)


def test_steady_state_matches_the_port_rig():
    from gpu_se_tpu_torch.models import Bioreactor

    pl = CFG["plant"]
    port = Bioreactor.find_SS(np.array(pl["u_start"]),
                              np.array(pl["x_guess"]))
    np.testing.assert_allclose(plant.steady_state(pl["u_start"],
                                                  pl["x_guess"]), port,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("which", ["state_noise", "measurement_noise"])
def test_mixture_density_matches_the_port(which):
    from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum

    spec = CFG[which]
    mix = Mixture.from_config(spec)
    port = GaussianSum.create(spec["means"], spec["covariances"],
                              spec["weights"], device="cpu",
                              dtype=torch.float64)
    x = torch.as_tensor(mix.draw(np.random.default_rng(1), 256))
    torch.testing.assert_close(mix.torch_pdf(x), port.pdf(x), rtol=1e-10,
                               atol=0)
    big = torch.as_tensor(mix.draw(np.random.default_rng(2), 200_000))
    torch.testing.assert_close(big.var(0), torch.as_tensor(
        mix.covariance().diagonal().copy()), rtol=0.05, atol=0)


def test_ukf_update_matches_the_port():
    from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
    from gpu_se_tpu_torch.filters import gs_ukf
    from gpu_se_tpu_torch.models import bioreactor

    n = 32
    means = _states(n, 3)
    a = torch.as_tensor(np.random.default_rng(4).normal(0, 0.01, (n, 5, 5)))
    covs = a @ a.transpose(1, 2) + 1e-4 * torch.eye(5, dtype=torch.float64)
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    spec = CFG["measurement_noise"]
    mpdf = GaussianSum.create(spec["means"], spec["covariances"],
                              spec["weights"], device="cpu",
                              dtype=torch.float64)
    u = torch.tensor([0.05, 0.15], dtype=torch.float64)
    z = torch.tensor([281.0, 612.0], dtype=torch.float64)
    pm, pc, pw = gs_ukf.update_core(means, covs, w, u, z,
                                    bioreactor.static_outputs, mpdf)
    rm, rc, rw = ukf.update(means, covs, w, [0.05, 0.15], [281.0, 612.0],
                            Mixture.from_config(spec))
    torch.testing.assert_close(rm, pm, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(rc, pc, rtol=1e-7, atol=1e-12)
    torch.testing.assert_close(rw, pw, rtol=1e-7, atol=0)


def test_the_reference_gsukf_run_steps_through_its_stages():
    n, dt = 256, 0.1
    sm = Mixture.from_config(CFG["state_noise"])
    mm = Mixture.from_config(CFG["measurement_noise"])
    x0 = sm.shifted(plant.steady_state(CFG["plant"]["u_start"],
                                       CFG["plant"]["x_guess"]))
    us = [[0.06, 0.2], [0.05, 0.15], [0.05, 0.15], [0.04, 0.1]]
    zs = [[260.0, 1000.0], [261.0, 998.0], [259.5, 1003.0], [262.0, 995.0]]
    predict, control = [True, True, False, True], [True, False, True, True]
    est, sd = ukf.filter_run(x0, sm, mm, n, us, zs, dt,
                             torch.Generator().manual_seed(5), "cpu",
                             predict=predict, control=control)
    gen = torch.Generator().manual_seed(5)
    means = x0.torch_draw(gen, n, "cpu")
    covs = torch.as_tensor(sm.covs[0]).expand(n, 5, 5).clone()
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    for t in range(len(zs)):
        if predict[t]:
            means, covs = ukf.predict_drawn(means, covs, us[t], dt, sm, gen)
        if control[t]:
            means, covs, w = ukf.update(means, covs, w, us[t], zs[t], mm)
            idx = ref_pf.systematic_indices(w / w.sum(), gen)
            # systematic: in order, each row copied n w_i times, give or
            # take one
            assert bool((idx[1:] >= idx[:-1]).all())
            copies = torch.bincount(idx, minlength=n).double()
            assert float((copies - n * w / w.sum()).abs().max()) < 1.0
            means, covs = means[idx], covs[idx]
            w = torch.full((n,), 1.0 / n, dtype=torch.float64)
        wn = w / w.sum()
        torch.testing.assert_close(est[t], wn @ means, rtol=0, atol=0)
        total = wn @ (means - wn @ means).pow(2) + wn @ torch.stack(
            [covs[:, j, j] for j in range(5)], dim=1)
        torch.testing.assert_close(sd[t], total.sqrt(), rtol=1e-14, atol=0)
    low, _ = ukf.filter_run(x0, sm, mm, n, us, zs, dt,
                            torch.Generator().manual_seed(5), "cpu",
                            predict=predict, control=control, reduced=True)
    assert torch.equal(ref_pf.round_bf16(low), low)       # bfloat16
    assert not torch.equal(low, est)


def test_reference_mpc_matches_the_port_mpc():
    from gpu_se_tpu_torch.sim import harness

    cfg = json.loads(json.dumps(CFG))
    cfg["mpc"]["dt_control"] = 10.0
    b, lin, K, _ = harness.get_parts(dt_control=10.0, N_particles=16,
                                     device="cpu")
    ref = ref_mpc.ReferenceMPC(cfg)
    assert (ref.P, ref.M) == (K.P, K.M)
    np.testing.assert_allclose(ref.y_bar, lin.y_bar, rtol=1e-9)
    x = b.X.copy()
    x[0] += 0.05
    x[2] -= 0.3
    u_prev = np.array([0.06, 0.2])
    u = K.step(lin.xn2d(x), lin.un2d(u_prev), lin.yn2d(b.outputs(u_prev)))
    ctrl, y_pred = ref.solve(x[[0, 2]] - ref.x_bar, u_prev - ref.u_bar,
                             np.zeros(2))
    np.testing.assert_allclose(ctrl, u, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y_pred, K.y_predicted, rtol=1e-5, atol=1e-5)
    far = ref.solve(np.array([0.0, 40.0]), u_prev - ref.u_bar, np.zeros(2))
    assert np.all(far[0] + ref.u_bar >= -1e-12)      # the bound holds


@pytest.mark.parametrize("a, b", [(0.0, float("nan")),
                                  (float("nan"), 1.0)])
def test_a_nan_reading_is_never_dropped(a, b):
    assert loop_check.worse(a, b) != loop_check.worse(a, b)
    assert loop_check.worse(1.0, 2.0) == 2.0 == loop_check.worse(2.0, 1.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -3.0], dtype=torch.float32)
    got = ref_pf.round_tf32(x).tolist()
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10, -3.0]
    np.testing.assert_array_equal(ref_mpc.tf32(x.numpy()), np.array(got))


@contextlib.contextmanager
def one_thread():
    """One torch thread and one BLAS thread: the CPU's sums in one
    order, whatever the environment sets."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    try:
        with threadpool_limits(1):
            torch.set_num_threads(1)
            yield
    finally:
        torch.set_num_threads(n)


def _cpu_run(cell, sizes, traffic=None, control="none", fault="none",
             seconds=0.5):
    c = manifest.cell(cell)
    sizes = dict(sizes)
    if "mpc" in sizes:
        sizes["mpc"] = {**c.config["mpc"], **sizes["mpc"]}
    s = Session(cell=c, seed=2 ** 31 + 11, seconds=seconds, trace=False,
                device=torch.device("cpu"), process_start=time.time(),
                sizes=sizes, traffic_sizes=traffic or {}, control=control,
                fault=fault)
    return run.execute(s)


STREAM_SIZES = {"n_log2": 10}
LOOP_SIZES = {"n_log2": 10, "mpc": {"dt_control": 0.5}}
LOOP_TRAFFIC = {"pool": [0, 1], "end_time": 10.0}

# what a sound run at these sizes reads, with room (the CPU's numbers;
# the limits of the cells are set from the card's, at the cells' sizes)
SOUND_CPU = {
    "pf_2p20_stream": {"noise_moment_gap": 0.5, "weight_gap": 2e-3,
                       "rows_not_inherited": 0, "offspring_gap": 2,
                       "estimate_gap": 0.05},
    "gsukf_2p18_stream": {"noise_moment_gap": 0.5, "mean_gap": 0.05,
                          "cov_gap": 1e-4, "weight_gap": 2e-3,
                          "rows_not_inherited": 0, "offspring_gap": 2,
                          "estimate_gap": 0.05},
    "pf_2p20_loop": {"plant_gap": 1e-6, "measurement_gap": 1e-6,
                     "control_gap": 1e-4, "fallback_misses": 0,
                     "estimate_rms_gap": 5.0,
                     "estimate_rms_gap_unmeasured": 20.0},
    "gsukf_2p18_loop": {"plant_gap": 1e-6, "measurement_gap": 1e-6,
                        "control_gap": 1e-4, "fallback_misses": 0,
                        "estimate_rms_gap": 0.1,
                        "estimate_rms_gap_unmeasured": 0.5,
                        "survivor_share_gap": 0.01},
}


def sizes_of(cell):
    if cell.endswith("_loop"):
        return LOOP_SIZES, LOOP_TRAFFIC
    return STREAM_SIZES, None


@pytest.mark.parametrize("cell", sorted(SOUND_CPU))
def test_a_short_cpu_run_compares_as_sound(cell):
    sizes, traffic = sizes_of(cell)
    res = _cpu_run(cell, sizes, traffic)
    assert res["attempted"] > 0
    if not cell.endswith("_loop"):           # a QP may stall: the fallback
        assert res["failed"] == 0
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert set(got) == set(SOUND_CPU[cell])
    for name, bound in SOUND_CPU[cell].items():
        assert got[name] <= bound, (name, got[name])


# what the check of pf_2p20_loop read at the sizes above, one thread
# each, before it took its reference filter from the estimator's module
# (``estimators/pf.loop_filter``): the same filter on the same draws
PF_LOOP_BEFORE = {
    "none": {"plant_gap": 1.0926900604707565e-07,
             "measurement_gap": 1.101289636673667e-07,
             "control_gap": 1.648440957069397e-05, "fallback_misses": 0,
             "estimate_rms_gap": 1.330457206666289,
             "estimate_rms_gap_unmeasured": 6.819134851732844},
    "twin": {"plant_gap": 1.0926900604707565e-07,
             "measurement_gap": 1.101289636673667e-07,
             "control_gap": 1.648440957069397e-05, "fallback_misses": 0,
             "estimate_rms_gap": 1.0942954536075367,
             "estimate_rms_gap_unmeasured": 7.692038749418541},
    "reduced": {"plant_gap": 0.003839224442333467,
                "measurement_gap": 0.003737078655607981,
                "control_gap": 0.003506523599186573, "fallback_misses": 0,
                "estimate_rms_gap": 1.38137542657493,
                "estimate_rms_gap_unmeasured": 34.864063719373306},
}


@pytest.mark.parametrize("control", sorted(PF_LOOP_BEFORE))
def test_the_pf_loop_check_reads_as_before(control):
    with one_thread():
        res = _cpu_run("pf_2p20_loop", LOOP_SIZES, LOOP_TRAFFIC,
                       control=control)
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert got == PF_LOOP_BEFORE[control]


@pytest.mark.parametrize("cell", ["pf_2p20_stream", "gsukf_2p18_stream"])
def test_a_nan_weight_fails_the_stream_check(cell, monkeypatch):
    est = manifest.module("estimators", manifest.cell(cell).config[
        "estimator"])
    check = est.check

    def with_nan(snaps, *args):
        w = snaps[0]["updated"]["weights"].clone()
        w[0] = float("nan")
        snaps[0]["updated"] = {**snaps[0]["updated"], "weights": w}
        return check(snaps, *args)

    monkeypatch.setattr(est, "check", with_nan)
    res = _cpu_run(cell, STREAM_SIZES)
    gap = res["compared"]["weight_gap"]["value"]
    assert gap != gap
    assert res["correct"] is False


def test_a_replay_that_departs_from_the_window_reads_nan(monkeypatch):
    """The GSUKF loop's bank is read from a replay of each checked
    episode; a replay whose records differ from the window's by a bit
    (here a predict that moves the bank by its call count) reads NaN."""
    from gpu_se_tpu_torch.filters import gs_ukf

    predict, calls = gs_ukf.predict, [0]

    def drifting(state, *args, **kwargs):
        calls[0] += 1
        new = predict(state, *args, **kwargs)
        return dataclasses.replace(new, means=new.means * (
            1 + 1e-6 * (calls[0] % 7)))

    monkeypatch.setattr(gs_ukf, "predict", drifting)
    res = _cpu_run("gsukf_2p18_loop", LOOP_SIZES, LOOP_TRAFFIC)
    gap = res["compared"]["survivor_share_gap"]["value"]
    assert gap != gap
    assert res["correct"] is False


def test_the_reference_gsukf_counts_the_gaussians_each_resample_keeps():
    n = 64
    sm = Mixture.from_config(CFG["state_noise"])
    mm = Mixture.from_config(CFG["measurement_noise"])
    x0 = sm.shifted(plant.steady_state(CFG["plant"]["u_start"],
                                       CFG["plant"]["x_guess"]))
    us, zs = [[0.06, 0.2]] * 3, [[260.0, 1000.0]] * 3
    kept = []
    ukf.filter_run(x0, sm, mm, n, us, zs, 0.1,
                   torch.Generator().manual_seed(5), "cpu",
                   predict=[True] * 3, control=[True, False, True],
                   survivors=kept)
    # the measurement is linear in the state and the local update has no
    # measurement noise, so every Gaussian's updated mean meets the
    # measurement, the weights stay uniform and each Gaussian is kept
    assert kept == [1.0, 1.0]


def test_the_bank_reading_counts_distinct_gaussians():
    from port_bench.estimators import gsukf

    means = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    state = type("S", (), {"means": means[[0, 0, 2, 3]]})
    assert float(gsukf.bank_survivors(state)) == 0.75
