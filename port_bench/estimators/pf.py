"""The flat particle filter (``filters.particle.ParticleFilter``) as a
configuration builds it, what a snapshot of its state holds, how the
reference judges one step, and the reference filter that the closed
loop's check runs beside the program's."""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import pf as ref_pf
from port_bench.reference.loop_check import worse


def build(cfg: dict, seed: int, device, x_plant):
    """The shell at ``2 ** n_log2`` particles, initialised as the port's
    closed-loop rig does: the state noise moved to the plant's state."""
    from gpu_se_tpu_torch.distributions import MultivariateGaussianSum
    from gpu_se_tpu_torch.filters import ParticleFilter
    from gpu_se_tpu_torch.models import Bioreactor

    sn, mn = cfg["state_noise"], cfg["measurement_noise"]
    x0 = MultivariateGaussianSum(
        means=np.asarray(sn["means"]) + np.asarray(x_plant)[None],
        covariances=sn["covariances"], weights=sn["weights"], device=device)
    return ParticleFilter(
        f=Bioreactor.homeostatic_DEs, g=Bioreactor.static_outputs,
        N_particles=2 ** cfg["n_log2"], x0=x0,
        state_pdf=MultivariateGaussianSum(**sn, device=device),
        measurement_pdf=MultivariateGaussianSum(**mn, device=device),
        seed=seed, device=device)


def snapshot(shell) -> dict:
    """References to the state's tensors (the shell hands out fresh
    tensors at every call, so holding them copies nothing)."""
    st = shell.state
    return {"particles": st.particles, "weights": st.weights}


def check(snaps: list, mixtures: dict, control: str = "none",
          seed: int = 0) -> dict:
    """The numbers compared for the sampled steps, each the largest over
    them. ``snaps`` holds, per step, its host inputs, the state before
    the step and after each stage, and the point estimate. With
    ``control="reduced"`` each stage's output is the control's: the
    reference put in the program's place, its products from TF32
    operands and its other float32 work rounded to bfloat16."""
    reduced = control == "reduced"
    out = {"noise_moment_gap": 0.0, "weight_gap": 0.0,
           "rows_not_inherited": 0, "offspring_gap": 0,
           "estimate_gap": 0.0}
    noise = []
    for k, s in enumerate(snaps):
        x0 = s["before"]["particles"]
        x1 = s["predicted"]["particles"]
        w0 = s["predicted"]["weights"].double()
        gen = torch.Generator(device=x1.device).manual_seed(seed + k)
        mean1 = ref_pf.predicted_mean(x0, s["u"], s["dt"])
        w_ref = w0 * ref_pf.likelihood(x1, s["z"], mixtures["measurement"])
        if reduced:
            x1_out = ref_pf.round_bf16(mean1 + mixtures["state"].torch_draw(
                gen, x1.shape[0], x1.device))
            w1_out = w0 * ref_pf.likelihood(x1, s["z"],
                                            mixtures["measurement"],
                                            tf32=True)
            x2_out = ref_pf.control_resample(x1, w_ref, gen)
            w2_out = torch.ones_like(w0)
            est_out = ref_pf.round_bf16(x2_out.double().mean(0))
        else:
            x1_out = x1.double()
            w1_out = s["updated"]["weights"]
            x2_out = s["resampled"]["particles"]
            w2_out = s["resampled"]["weights"]
            est_out = s["estimate"]
        noise.append(x1_out - mean1)
        out["weight_gap"] = worse(out["weight_gap"],
                                  ref_pf.weight_gap(w1_out, w_ref))
        missing, mismatch = ref_pf.resample_gaps(x1, w_ref, x2_out)
        out["rows_not_inherited"] += missing
        out["offspring_gap"] = worse(out["offspring_gap"], mismatch)
        out["estimate_gap"] = worse(out["estimate_gap"], ref_pf.estimate_gap(
            est_out, x2_out, w2_out))
    if noise:
        out["noise_moment_gap"] = ref_pf.moment_gap(torch.cat(noise),
                                                    mixtures["state"])
    return out


# the float64 reference filter that the closed loop's check runs beside
# the program's, over the episode's own inputs and measurements
# (``reference/loop_check.py``)
loop_filter = ref_pf.filter_run
