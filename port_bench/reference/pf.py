"""The particle filter's stages in float64, for the comparison.

The program's noise comes from its own stream, so the reference follows
it stage by stage from the program's state: the predict's deterministic
part is recomputed, and what is left over (the implied noise) is held to
the configuration's mixture by its moments; the update's weights, the
resample's rows and ancestors and the point estimate are recomputed
from the stage's input. ``filter_run`` is a whole filter of the
reference's own (its own noise), for the closed loop, whose filter state
the program does not hand out.
"""
from __future__ import annotations

import torch

from port_bench.reference import plant, systematic

F64 = torch.float64


def _rows(x):
    return [x[:, j] for j in range(x.shape[1])]


def predicted_mean(x: torch.Tensor, u, dt) -> torch.Tensor:
    """``x + f(x, u) dt`` for every row, float64."""
    x = x.to(F64)
    d = plant.deltas(_rows(x), [float(u[0]), float(u[1])], float(dt),
                     plant.torch_ops())
    return x + torch.stack(d, dim=1)


def moment_gap(noise: torch.Tensor, mix) -> float:
    """The largest relative miss of the implied noise's second and
    fourth central moments against the mixture's, over the
    coordinates."""
    mean = torch.as_tensor(mix.mean(), dtype=F64, device=noise.device)
    var = torch.as_tensor(mix.covariance().diagonal().copy(), dtype=F64,
                          device=noise.device)
    m4 = torch.as_tensor(mix.fourth_moments(), dtype=F64, device=noise.device)
    c = noise - mean
    gaps = torch.cat([(c.pow(2).mean(0) / var - 1).abs(),
                      (c.pow(4).mean(0) / m4 - 1).abs()])
    return float(gaps.max())


def likelihood(x: torch.Tensor, z, mix, tf32: bool = False) -> torch.Tensor:
    """``p(z - g(x))`` for every row, float64; with ``tf32`` the control's
    float32 density, its quadratic form's operands rounded to TF32."""
    if tf32:
        x = x.to(torch.float32)
        y = torch.stack(plant.measure(_rows(x)), dim=1)
        zt = torch.as_tensor([float(z[0]), float(z[1])], dtype=torch.float32,
                             device=x.device)
        return mix.torch_pdf(round_tf32(zt - y), tf32=True).to(F64)
    x = x.to(F64)
    y = torch.stack(plant.measure(_rows(x)), dim=1)
    zt = torch.as_tensor([float(z[0]), float(z[1])], dtype=F64,
                         device=x.device)
    return mix.torch_pdf(zt - y)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10-bit mantissa (nearest, ties
    to even), as a TF32 product reads its operands."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & -8192).view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back to float64: the control of a
    float32 stage with no matrix product."""
    return t.to(torch.bfloat16).to(F64)


def control_resample(x: torch.Tensor, w: torch.Tensor, generator):
    """Systematic resampling with the cumulative sum in bfloat16: the
    control's output rows."""
    n = w.shape[0]
    cs = round_bf16(torch.cumsum(round_bf16(w / w.sum()), 0))
    r = torch.rand((), dtype=F64, generator=generator, device=w.device)
    pos = (torch.arange(n, dtype=F64, device=w.device) + r) / n
    return x[torch.searchsorted(cs / cs[-1], pos).clamp_max(n - 1)]


# weights under this share of the largest are not compared one by one
WEIGHT_FLOOR = 1e-4


def weight_gap(w_prog: torch.Tensor, w_ref: torch.Tensor) -> float:
    """The largest relative gap of a weight, over the weights of at
    least :data:`WEIGHT_FLOOR` of the largest."""
    w_ref = w_ref.to(F64)
    keep = w_ref >= WEIGHT_FLOOR * w_ref.max()
    return float(((w_prog.to(F64)[keep] / w_ref[keep]) - 1).abs().max())


def estimate_gap(est_prog: torch.Tensor, x: torch.Tensor,
                 w: torch.Tensor, within=None) -> float:
    """The gap of the program's point estimate from the float64 weighted
    mean of ``x``, over the estimate's spread (the weighted spread of
    ``x``, plus the weighted mean of ``within (n, nx)``, the variance
    each row stands for), the largest over the coordinates."""
    x, w = x.to(F64), w.to(F64)
    w = w / w.sum()
    mean = w @ x
    var = w @ (x - mean).pow(2)
    if within is not None:
        var = var + w @ within.to(F64)
    sd = var.sqrt()
    return float(((est_prog.to(F64) - mean).abs() / (sd + 1e-12)).max())


def resample_gaps(x_before, w_ref, x_after):
    """``(rows not inherited, offspring gap)``."""
    anc, missing = systematic.ancestors(x_before, x_after)
    return missing, systematic.offspring_gap(w_ref, anc)


def systematic_indices(wn: torch.Tensor, generator) -> torch.Tensor:
    """The rows systematic resampling of the normalized float64 weights
    ``wn`` copies, at a uniform ``r`` drawn from ``generator``."""
    n = wn.shape[0]
    cs = torch.cumsum(wn, 0)
    r = torch.rand((), dtype=F64, generator=generator, device=wn.device)
    pos = (torch.arange(n, dtype=F64, device=wn.device) + r) / n
    return torch.searchsorted(cs / cs[-1], pos).clamp_max(n - 1)


def filter_run(x0_mix, state_mix, meas_mix, n, us, zs, dt, generator,
               device, predict, control, reduced: bool = False):
    """A float64 particle filter of ``n`` particles over the inputs
    ``us[t]`` and measurements ``zs[t]``, in the closed loop's order: at
    each step a predict where ``predict[t]``, an update and a resample
    where ``control[t]``, then the estimate. Returns the estimate and
    the weighted spread of the particles it was taken from, ``(T, nx)``
    each. With ``reduced`` it is the control's filter on the same draws:
    its particles rounded to bfloat16 after each predict, its density's
    products from TF32 operands and its estimate rounded to bfloat16."""
    def rnd(a):
        return round_bf16(a) if reduced else a

    x = rnd(x0_mix.torch_draw(generator, n, device))
    w = torch.full((n,), 1.0 / n, dtype=F64, device=device)
    ests, sds = [], []
    for t in range(len(zs)):
        if predict[t]:
            x = rnd(predicted_mean(x, us[t], dt) + state_mix.torch_draw(
                generator, n, device))
        if control[t]:
            w = w * likelihood(x, zs[t], meas_mix, tf32=reduced)
        wn = w / w.sum()
        mean = wn @ x
        ests.append(mean)
        sds.append((wn @ (x - mean).pow(2)).sqrt())
        if control[t]:
            x = x[systematic_indices(wn, generator)]
            w = torch.full((n,), 1.0 / n, dtype=F64, device=device)
    return rnd(torch.stack(ests)), torch.stack(sds)
