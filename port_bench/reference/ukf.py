"""The Gaussian-sum UKF's stages in float64, for the comparison.

Each Gaussian's sigma points are its mean and the mean plus and minus
each column of the lower Cholesky factor of its covariance (where the
factor fails, that of the covariance plus ``1e-10 I``), weighted
``w_0 = 1 / (1 + 5 nx / 4)`` and ``w_i = 1 / (2 nx + 8 / 5)``. The
predict moves every sigma point by the model and adds a draw of the
state noise to each before recombining; the program's draws are its own,
so the reference recomputes the deterministic part and holds the rest to
the mixture by moments: the means' implied noise has the variance
``sum_s w_s^2`` times the mixture's, and the covariances exceed the
noiseless recombination by ``(1 - sum_s w_s^2)`` times it on average.
The update (the local UKF updates, then ``w_i *= p(z - g(m_i))``) is
recomputed whole from the program's predicted bank. ``filter_run`` is a
whole filter of the reference's own (its own noise), for the closed
loop, whose bank the program does not hand out.
"""
from __future__ import annotations

import torch

from port_bench.reference import pf as ref_pf
from port_bench.reference import plant

F64 = torch.float64
JITTER = 1e-10


def sigma_weights(nx: int, device) -> torch.Tensor:
    w0 = 1.0 / (1.0 + 5.0 / 4.0 * nx)
    wi = 1.0 / (2 * nx + 8.0 / 5.0)
    return torch.tensor([w0] + [wi] * (2 * nx), dtype=F64, device=device)


def factor(covs: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors, jittered where the plain one fails."""
    covs = covs.to(F64)
    low, info = torch.linalg.cholesky_ex(covs)
    bad = info != 0
    if bool(bad.any()):
        eye = torch.eye(covs.shape[-1], dtype=F64, device=covs.device)
        low2, _ = torch.linalg.cholesky_ex(covs[bad] + JITTER * eye)
        low = low.clone()
        low[bad] = low2
    return low


def sigma_points(means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """``(N, 2 nx + 1, nx)``."""
    m = means.to(F64)[:, None, :]
    cols = factor(covs).transpose(-1, -2)            # row i: column i
    return torch.cat([m, m + cols, m - cols], dim=1)


def _apply(fn, sig):
    n, s, nx = sig.shape
    flat = sig.reshape(n * s, nx)
    out = torch.stack(fn([flat[:, j] for j in range(nx)]), dim=1)
    return out.reshape(n, s, -1)


def predict_noise_gaps(m0, c0, m1, c1, u, dt, mix) -> float:
    """The largest relative miss of the predict's implied noise against
    the mixture: the variance of the means' and the mean excess of the
    covariances' diagonals."""
    nx = m0.shape[1]
    w = sigma_weights(nx, m0.device)
    sig = sigma_points(m0, c0)
    uu = [float(u[0]), float(u[1])]
    moved = sig + _apply(lambda r: plant.deltas(r, uu, float(dt),
                                                plant.torch_ops()), sig)
    m_det = torch.einsum("s,nsi->ni", w, moved)
    d = moved - m_det[:, None, :]
    c_det = torch.einsum("s,nsi,nsj->nij", w, d, d)
    w2 = float((w ** 2).sum())
    var = torch.as_tensor(mix.covariance().diagonal().copy(), dtype=F64,
                          device=m0.device)
    mean_noise = m1.to(F64) - m_det
    var_gap = (mean_noise.var(dim=0) / (w2 * var) - 1).abs()
    excess = (c1.to(F64) - c_det).diagonal(dim1=1, dim2=2).mean(0)
    cov_gap = (excess / ((1 - w2) * var) - 1).abs()
    return float(torch.cat([var_gap, cov_gap]).max())


def predict_drawn(m0, c0, u, dt, mix, generator):
    """The predict in float64 with the reference's own draws of the
    state noise, one a sigma point: the control's predict before its
    rounding."""
    nx = m0.shape[1]
    w = sigma_weights(nx, m0.device)
    sig = sigma_points(m0, c0)
    uu = [float(u[0]), float(u[1])]
    moved = sig + _apply(lambda r: plant.deltas(r, uu, float(dt),
                                                plant.torch_ops()), sig)
    n, s = moved.shape[:2]
    moved = moved + mix.torch_draw(generator, n * s, m0.device).reshape(
        n, s, nx)
    mean = torch.einsum("s,nsi->ni", w, moved)
    d = moved - mean[:, None, :]
    return mean, torch.einsum("s,nsi,nsj->nij", w, d, d)


def update(m1, c1, w1, u, z, mix, tf32: bool = False):
    """The local UKF updates and the weight update, float64; with
    ``tf32`` the weights' density is the control's (``pf.likelihood``)."""
    nx = m1.shape[1]
    w = sigma_weights(nx, m1.device)
    means = m1.to(F64)
    sig = sigma_points(m1, c1)
    eta = _apply(lambda r: plant.measure(r), sig)            # (N, s, 2)
    eta_mean = torch.einsum("s,nsi->ni", w, eta)
    de = eta - eta_mean[:, None, :]
    dx = sig - means[:, None, :]
    p_yy = torch.einsum("s,nsi,nsj->nij", w, de, de)
    p_xy = torch.einsum("s,nsi,nsj->nij", w, dx, de)
    gain = p_xy @ torch.linalg.inv(p_yy)
    zt = torch.as_tensor([float(z[0]), float(z[1])], dtype=F64,
                         device=m1.device)
    m2 = means + (gain @ (zt - eta_mean)[:, :, None])[:, :, 0]
    kpk = gain @ p_yy @ gain.transpose(1, 2)
    c2 = c1.to(F64) - 0.5 * (kpk + kpk.transpose(1, 2))
    if tf32:
        return m2, c2, w1.to(F64) * ref_pf.likelihood(m2, z, mix, tf32=True)
    y2 = torch.stack(plant.measure([m2[:, j] for j in range(nx)]), dim=1)
    w2 = w1.to(F64) * mix.torch_pdf(zt - y2)
    return m2, c2, w2


def filter_run(x0_mix, state_mix, meas_mix, n, us, zs, dt, generator,
               device, predict, control, reduced: bool = False,
               survivors: list | None = None):
    """A float64 Gaussian-sum UKF of ``n`` Gaussians over the inputs
    ``us[t]`` and measurements ``zs[t]``, in the closed loop's order, as
    ``filters.gs_ukf`` is driven there: the means drawn from ``x0_mix``,
    every covariance the first state-noise component's, uniform weights;
    at each step a predict (:func:`predict_drawn`) where ``predict[t]``;
    where ``control[t]`` an update (:func:`update`), then a systematic
    resample of the bank with uniform weights after it; then the
    estimate, the weighted mean of the means. Returns the estimates and
    the bank's spread, the square root of its total variance in each
    state (the weighted mean of the covariances' diagonals plus the
    weighted variance of the means), ``(T, nx)`` each. With
    ``reduced`` it is the control's filter on the same draws: its means
    and covariances rounded to bfloat16 after each predict (each
    covariance by its lower Cholesky factor: rounded whole, some turn
    indefinite, their factors NaN, and the bank's estimate with them),
    its density's products from TF32 operands and its estimate rounded
    to bfloat16. A list ``survivors`` gets, at each control event, the
    share of the bank's Gaussians that the resample kept."""
    def rnd(a):
        return ref_pf.round_bf16(a) if reduced else a

    nx = state_mix.dim
    means = x0_mix.torch_draw(generator, n, device)
    covs = torch.as_tensor(state_mix.covs[0], dtype=F64, device=device) \
        .expand(n, nx, nx).clone()
    w = torch.full((n,), 1.0 / n, dtype=F64, device=device)
    ests, sds = [], []
    for t in range(len(zs)):
        if predict[t]:
            means, covs = predict_drawn(means, covs, us[t], dt, state_mix,
                                        generator)
            if reduced:
                low = ref_pf.round_bf16(factor(covs))
                means, covs = rnd(means), low @ low.transpose(1, 2)
        if control[t]:
            means, covs, w = update(means, covs, w, us[t], zs[t], meas_mix,
                                    tf32=reduced)
            idx = ref_pf.systematic_indices(w / w.sum(), generator)
            means, covs = means[idx], covs[idx]
            if survivors is not None:
                survivors.append(torch.unique(idx).numel() / n)
            w = torch.full((n,), 1.0 / n, dtype=F64, device=device)
        wn = w / w.sum()
        mean = wn @ means
        ests.append(mean)
        sds.append((wn @ (means - mean).pow(2)
                    + wn @ covs.diagonal(dim1=1, dim2=2)).sqrt())
    return rnd(torch.stack(ests)), torch.stack(sds)


def relative_gap(prog: torch.Tensor, ref: torch.Tensor, scale) -> float:
    """The largest ``|prog - ref| / scale``."""
    return float(((prog.to(F64) - ref).abs() / scale).max())
