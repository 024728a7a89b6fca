"""The Gaussian-sum UKF (``filters.gs_ukf``) as a configuration builds
it, what a snapshot of its state holds, how the reference judges one
step, the reference filter that the closed loop's check runs beside the
program's, and what the check reads of the program's bank in the loop
(``bank_survivors``)."""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import pf as ref_pf
from port_bench.reference import systematic, ukf
from port_bench.reference.loop_check import worse


def build(cfg: dict, seed: int, device, x_plant):
    """The shell at ``2 ** n_log2`` Gaussians, initialised as the port's
    closed-loop rig does."""
    from gpu_se_tpu_torch.distributions import MultivariateGaussianSum
    from gpu_se_tpu_torch.filters import GaussianSumUnscentedKalmanFilter
    from gpu_se_tpu_torch.models import Bioreactor

    sn, mn = cfg["state_noise"], cfg["measurement_noise"]
    x0 = MultivariateGaussianSum(
        means=np.asarray(sn["means"]) + np.asarray(x_plant)[None],
        covariances=sn["covariances"], weights=sn["weights"], device=device)
    return GaussianSumUnscentedKalmanFilter(
        f=Bioreactor.homeostatic_DEs, g=Bioreactor.static_outputs,
        N_particles=2 ** cfg["n_log2"], x0=x0,
        state_pdf=MultivariateGaussianSum(**sn, device=device),
        measurement_pdf=MultivariateGaussianSum(**mn, device=device),
        seed=seed, device=device)


def snapshot(shell) -> dict:
    st = shell.state
    return {"means": st.means, "covariances": st.covariances,
            "weights": st.weights}


def check(snaps: list, mixtures: dict, control: str = "none",
          seed: int = 0) -> dict:
    """The numbers compared for the sampled steps, each the largest over
    them; ``control="reduced"`` as in ``estimators/pf.py``."""
    reduced = control == "reduced"
    bf = ref_pf.round_bf16
    out = {"noise_moment_gap": 0.0, "mean_gap": 0.0, "cov_gap": 0.0,
           "weight_gap": 0.0, "rows_not_inherited": 0,
           "offspring_gap": 0, "estimate_gap": 0.0}
    for k, s in enumerate(snaps):
        b, p, u, r = (s["before"], s["predicted"], s["updated"],
                      s["resampled"])
        gen = torch.Generator(device=p["means"].device).manual_seed(seed + k)
        m2, c2, w2 = ukf.update(p["means"], p["covariances"], p["weights"],
                                s["u"], s["z"], mixtures["measurement"])
        if reduced:
            m1, c1 = ukf.predict_drawn(b["means"], b["covariances"], s["u"],
                                       s["dt"], mixtures["state"], gen)
            m1, c1 = bf(m1), bf(c1)
            m2_out, c2_out = bf(m2), bf(c2)
            zt = torch.as_tensor(np.asarray(s["z"]), dtype=torch.float32,
                                 device=m2.device)
            y2 = torch.stack([m2_out[:, 0] * 180.0, m2_out[:, 2] * 116.0], 1)
            w2_out = p["weights"].double() * mixtures["measurement"].torch_pdf(
                ref_pf.round_tf32(zt - y2.float()), tf32=True).double()
            idx = systematic.ancestors(u["means"], ref_pf.control_resample(
                u["means"], w2, gen))[0]
            r_means, r_covs = u["means"][idx], u["covariances"][idx]
            r_w = torch.ones_like(w2)
            est_out = bf(r_means.double().mean(0))
        else:
            m1, c1 = p["means"], p["covariances"]
            m2_out, c2_out, w2_out = u["means"], u["covariances"], \
                u["weights"]
            r_means, r_covs, r_w = r["means"], r["covariances"], r["weights"]
            est_out = s["estimate"]
        out["noise_moment_gap"] = worse(out["noise_moment_gap"],
                                        ukf.predict_noise_gaps(
            b["means"], b["covariances"], m1, c1, s["u"], s["dt"],
            mixtures["state"]))
        sd = p["covariances"].double().diagonal(dim1=1, dim2=2) \
            .clamp_min(0).sqrt() + 1e-30
        out["mean_gap"] = worse(out["mean_gap"],
                                ukf.relative_gap(m2_out, m2, sd))
        out["cov_gap"] = worse(out["cov_gap"], ukf.relative_gap(
            c2_out, c2, sd[:, :, None] * sd[:, None, :]))
        out["weight_gap"] = worse(out["weight_gap"],
                                  ref_pf.weight_gap(w2_out, w2))
        anc, missing = systematic.ancestors(u["means"], r_means)
        ok = anc >= 0
        same = (r_covs[ok] == u["covariances"][anc[ok]])
        missing += int((~same.reshape(same.shape[0], -1).all(dim=1)).sum())
        out["rows_not_inherited"] += missing
        out["offspring_gap"] = worse(out["offspring_gap"],
                                     systematic.offspring_gap(w2, anc))
        out["estimate_gap"] = worse(out["estimate_gap"], ref_pf.estimate_gap(
            est_out, r_means, r_w,
            within=r_covs.double().diagonal(dim1=1, dim2=2)))
    return out


# the float64 reference filter that the closed loop's check runs beside
# the program's, over the episode's own inputs and measurements
# (``reference/loop_check.py``)
loop_filter = ukf.filter_run


def bank_survivors(state) -> torch.Tensor:
    """The share of the bank's Gaussians that are distinct, bit for bit,
    in the program's state after a control event's resample: the share
    of the Gaussians before it that the weights kept. A 0-d tensor on
    the state's device (no read to the host)."""
    keys = torch.sort(systematic.row_keys(state.means)).values
    n = keys.shape[0]
    return (1 + (keys[1:] != keys[:-1]).sum()).double() / n
