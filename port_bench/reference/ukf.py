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
recomputed whole from the program's predicted bank.
"""
from __future__ import annotations

import torch

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


def update(m1, c1, w1, u, z, mix):
    """The local UKF updates and the weight update, float64."""
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
    y2 = torch.stack(plant.measure([m2[:, j] for j in range(nx)]), dim=1)
    w2 = w1.to(F64) * mix.torch_pdf(zt - y2)
    return m2, c2, w2


def relative_gap(prog: torch.Tensor, ref: torch.Tensor, scale) -> float:
    """The largest ``|prog - ref| / scale``."""
    return float(((prog.to(F64) - ref).abs() / scale).max())
