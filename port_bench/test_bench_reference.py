"""The benchmark's reference against the port at tiny sizes on the CPU:
the plant, the mixtures' densities, the UKF update and the MPC agree
with the port's float64 results, and short runs of each cell's traffic
on the CPU compare as sound."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from port_bench import manifest, run
from port_bench.reference import mpc as ref_mpc
from port_bench.reference import plant, ukf
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


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -3.0], dtype=torch.float32)
    got = ref_pf.round_tf32(x).tolist()
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10, -3.0]
    np.testing.assert_array_equal(ref_mpc.tf32(x.numpy()), np.array(got))


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
