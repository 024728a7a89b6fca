"""Gaussian-sum unscented Kalman filter: a bank of UKFs with importance
weights.

Counterpart of ``gpu_se_tpu/filters/gs_ukf.py``: a functional core over
an explicit :class:`GSUKFState` and the
:class:`GaussianSumUnscentedKalmanFilter` shell. The public layout is the
reference's, means ``(N, nx)`` and covariances ``(N, nx, nx)``; inside
:func:`predict_core` and :func:`update_core` the work runs lanes-last
(``(nx, N)``, ``(nx, nx, N)``) in the reference's op order, so every
elementwise op runs over the whole bank. Cholesky failure is handled
branchlessly: a factor with a NaN is redone with ``1e-10 * I`` added.

The process and measurement functions follow the port's model
convention (``models/bioreactor.py``): ``f(x, u, dt)`` and ``g(x, u)``
take the state dims on the leading axis and broadcast over the rest. The
reference ``vmap``s a per-vector ``f``/``g`` over the sigma and bank
axes; here each is called once on the stacked sigma points ``(nx, s *
N)``.

Random numbers come from the state's ``torch.Generator``: :func:`predict`
draws the sigma-point noise ``state_pdf.draw_t(generator, N * s)``,
reshaped ``(nx, s, N)`` and read as ``(s, nx, N)`` (the reference's
mapping of its stream), :func:`resample` one float32 uniform ``r``.
:func:`predict_core` and :func:`step_from_noise` take them as arguments,
for the tests that inject the reference's.

:func:`resample` goes through the router's Gaussian-bank entry, which on
a CUDA device takes the compact + expand kernels over the means
and the upper triangle of each covariance: :func:`update_core` keeps the
covariances exactly symmetric for it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from gpu_se_tpu_torch import graphs, trace
from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.filters import resampling
from gpu_se_tpu_torch.filters.particle import _as_dist
from gpu_se_tpu_torch.filters.resampling import (
    systematic_resample_bank,
    systematic_resample_bank_from_r,
)
from gpu_se_tpu_torch.ops.mixture_pdf import mixture_pdf
from gpu_se_tpu_torch.ops.reduce import (
    blocked_outer_sum,
    blocked_sum,
    weighted_mean,
)
from gpu_se_tpu_torch.ops.smallmat import (
    cholesky_small,
    cholesky_small_lanes,
    inv_small_jittered_lanes,
)

JITTER = 1e-10


@dataclass
class GSUKFState:
    """means ``(N, nx)``, covariances ``(N, nx, nx)``, weights ``(N,)``,
    and the ``torch.Generator`` that :func:`predict` and :func:`resample`
    draw from (on the bank's device; they advance it in place)."""

    means: torch.Tensor
    covariances: torch.Tensor
    weights: torch.Tensor
    generator: torch.Generator

    @property
    def n_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def n_dim(self) -> int:
        return self.means.shape[1]


def sigma_weights(nx: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(2 nx + 1,)`` sigma weights: ``w_mu + 2 nx w_sigma = 1`` and
    ``w_mu / w_sigma = 1.6``."""
    # two fills, no copy from the host: a CUDA graph captures them
    w_mu = torch.full((1,), 1.0 / (1.0 + 5.0 / 4.0 * nx), dtype=dtype,
                      device=device)
    w = torch.full((2 * nx,), 1.0 / (2 * nx + 8.0 / 5.0), dtype=dtype,
                   device=device)
    return torch.cat([w_mu, w])


def _batched_cholesky_jittered(covs: torch.Tensor,
                               jitter: float = JITTER) -> torch.Tensor:
    """Batched Cholesky of ``(..., nx, nx)``; where a factor has a NaN,
    the factor of ``covs + jitter * I`` instead."""
    nx = covs.shape[-1]
    eye = torch.eye(nx, dtype=covs.dtype, device=covs.device)
    l0 = cholesky_small(covs)
    bad = torch.isnan(l0).any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
    l1 = cholesky_small(covs + jitter * eye)
    return torch.where(bad, l1, l0)


def _cholesky_lanes_jittered(covs_t: torch.Tensor) -> torch.Tensor:
    """Lanes-last :func:`_batched_cholesky_jittered` of ``(nx, nx, ...)``."""
    nx = covs_t.shape[0]
    eye = torch.eye(nx, dtype=covs_t.dtype, device=covs_t.device).reshape(
        (nx, nx) + (1,) * (covs_t.dim() - 2))
    l0 = cholesky_small_lanes(covs_t)
    bad = torch.isnan(l0).any(dim=0, keepdim=True).any(dim=1, keepdim=True)
    l1 = cholesky_small_lanes(covs_t + JITTER * eye)
    return torch.where(bad, l1, l0)


def get_sigma_points(state: GSUKFState) -> torch.Tensor:
    """``(N, 2 nx + 1, nx)`` sigma points: the mean, then the mean plus
    and minus each column of the jittered Cholesky factor."""
    stds_t = _batched_cholesky_jittered(state.covariances).transpose(-1, -2)
    mean = state.means[:, None, :]
    return torch.cat([mean, mean + stds_t, mean - stds_t], dim=1)


# ----------------------------------------------------------------------
def init(generator: torch.Generator, n_gaussians: int, x0: GaussianSum,
         state_pdf: GaussianSum, dtype=torch.float32) -> GSUKFState:
    """Means drawn from ``x0``, every covariance the first state-noise
    component's, uniform weights; on ``x0``'s device."""
    means = x0.draw(generator, (n_gaussians,)).to(dtype)
    cov0 = state_pdf.covariances[0].to(dtype=dtype, device=means.device)
    covs = cov0.expand((n_gaussians,) + tuple(cov0.shape)).clone()
    weights = torch.full((n_gaussians,), 1.0 / n_gaussians, dtype=dtype,
                         device=means.device)
    return GSUKFState(means, covs, weights, generator)


def _sigma_stack(means_t: torch.Tensor, l_t: torch.Tensor) -> torch.Tensor:
    """``(2 nx + 1, nx, N)``: the means, then the means plus and minus
    each column of the factor ``l_t (nx, nx, N)``."""
    nx = means_t.shape[0]
    return torch.stack(
        [means_t]
        + [means_t + l_t[:, i] for i in range(nx)]
        + [means_t - l_t[:, i] for i in range(nx)])


def _sigma_points_lanes(means_t: torch.Tensor,
                        covs_t: torch.Tensor) -> torch.Tensor:
    """Sigma points lanes-last: ``means_t (nx, N)``, ``covs_t (nx, nx,
    N)`` -> ``(2 nx + 1, nx, N)``; :func:`get_sigma_points`' construction
    and op order."""
    return _sigma_stack(means_t, _cholesky_lanes_jittered(covs_t))


def _on_stack(fn: Callable, sig: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` of every sigma point of ``sig (s, nx, N)`` in one call on
    the stacked ``(nx, s * N)``; returns ``(s, ny, N)``."""
    s, nx, n = sig.shape
    out = fn(sig.transpose(0, 1).reshape(nx, s * n), *args)
    return out.reshape(out.shape[0], s, n).transpose(0, 1)


def predict_core(means, covariances, u, dt, noise, f: Callable,
                 noise_is_lanes: bool = False):
    """Unscented prediction given the sigma-point noise: ``noise (N, 2 nx
    + 1, nx)``, or ``(2 nx + 1, nx, N)`` if ``noise_is_lanes``. The noise
    is added to the moved sigma points before they are recombined (the
    reference's deliberate covariance inflation). Returns ``(means (N,
    nx), covariances (N, nx, nx))``; the covariances are exactly
    symmetric."""
    nx = means.shape[1]
    w_sigma = sigma_weights(nx, means.dtype, means.device)
    means_t = means.T
    covs_t = covariances.permute(1, 2, 0).contiguous()      # (nx, nx, N)
    sig = _sigma_points_lanes(means_t, covs_t)              # (s, nx, N)
    deltas = _on_stack(f, sig, u, dt)
    noise_t = noise if noise_is_lanes else noise.permute(1, 2, 0)
    sig = sig + deltas + noise_t
    # every sum over the sigma points accumulates in order, one point at
    # a time, as the reference's reduction does: a CUDA reduction adds in
    # another order
    new_means_t = None
    for si in range(sig.shape[0]):
        t = w_sigma[si] * sig[si]
        new_means_t = t if new_means_t is None else new_means_t + t
    cent = sig - new_means_t[None]
    covs_new_t = None
    for si in range(cent.shape[0]):
        term = w_sigma[si] * (cent[si][:, None, :] * cent[si][None, :, :])
        covs_new_t = term if covs_new_t is None else covs_new_t + term
    return new_means_t.T, covs_new_t.permute(2, 0, 1)


def predict(state: GSUKFState, u, dt, f: Callable,
            state_pdf: GaussianSum) -> GSUKFState:
    """Unscented prediction with noise drawn from ``state_pdf``."""
    n, nx = state.means.shape
    s = 2 * nx + 1
    noise_t = state_pdf.draw_t(state.generator, n * s).reshape(nx, s, n)
    means, covs = predict_core(state.means, state.covariances, u, dt,
                               noise_t.transpose(0, 1), f,
                               noise_is_lanes=True)
    return dataclasses.replace(state, means=means, covariances=covs)


def update_core(means, covariances, weights, u, z, g: Callable,
                measurement_pdf: GaussianSum, return_eta: bool = False):
    """Each Gaussian's local UKF measurement update, then the global
    weight update ``w_i *= p(z - g(mean_i))``. Returns ``(means,
    covariances, weights)``, or ``(means, covariances, eta)`` with the
    residuals ``eta (N, ny)`` if ``return_eta``.

    ``P_yy`` is built from the sigma spread alone (the reference's
    semantics: the measurement noise enters through the weights only);
    the gain solve is :func:`~gpu_se_tpu_torch.ops.smallmat.
    inv_small_jittered_lanes`. ``K P_yy K^T`` is symmetrized, so the
    covariances stay exactly symmetric.
    """
    nx = means.shape[1]
    w_sigma = sigma_weights(nx, means.dtype, means.device)
    means_t = means.T
    covs_t = covariances.permute(1, 2, 0).contiguous()      # (nx, nx, N)
    # the centered sigma points are exactly the factor's columns
    # (0, +l_i, -l_i)
    l_t = _cholesky_lanes_jittered(covs_t)

    def centered(si):
        return l_t[:, si - 1] if si <= nx else -l_t[:, si - 1 - nx]

    etas = _on_stack(g, _sigma_stack(means_t, l_t), u)      # (s, ny, N)
    eta_means_t = None                                      # (ny, N)
    for si in range(etas.shape[0]):
        t = w_sigma[si] * etas[si]
        eta_means_t = t if eta_means_t is None else eta_means_t + t

    p_xy_t = None                                           # (nx, ny, N)
    p_yy_t = None                                           # (ny, ny, N)
    for si in range(etas.shape[0]):
        eta_c = etas[si] - eta_means_t
        w_eta = w_sigma[si] * eta_c
        tyy = eta_c[:, None, :] * w_eta[None, :, :]
        p_yy_t = tyy if p_yy_t is None else p_yy_t + tyy
        if si == 0:
            continue                                        # centered: 0
        txy = centered(si)[:, None, :] * w_eta[None, :, :]
        p_xy_t = txy if p_xy_t is None else p_xy_t + txy
    inv_t = inv_small_jittered_lanes(p_yy_t)                # (ny, ny, N)
    gains_t = torch.sum(p_xy_t[:, :, None, :] * inv_t[None], dim=1)

    es_t = z[:, None] - eta_means_t                         # (ny, N)
    new_means_t = means_t + torch.sum(gains_t * es_t[None], dim=1)
    kp_t = torch.sum(gains_t[:, :, None, :] * p_yy_t[None], dim=1)
    kpk_t = torch.sum(kp_t[:, None, :, :] * gains_t[None, :, :, :], dim=2)
    # kpk[i, j] and kpk[j, i] sum the same terms in another order
    kpk_t = 0.5 * (kpk_t + kpk_t.transpose(0, 1))
    covs_new_t = covs_t - kpk_t

    eta = (z[:, None] - g(new_means_t, u)).T                # (N, ny)
    new_means, new_covs = new_means_t.T, covs_new_t.permute(2, 0, 1)
    if return_eta:
        return new_means, new_covs, eta
    return new_means, new_covs, measurement_pdf.pdf(eta, scale=weights)


def update(state: GSUKFState, u, z, g: Callable,
           measurement_pdf: GaussianSum) -> GSUKFState:
    """Local UKF updates and the linear weight update."""
    means, covs, weights = update_core(state.means, state.covariances,
                                       state.weights, u, z, g,
                                       measurement_pdf)
    return dataclasses.replace(state, means=means, covariances=covs,
                               weights=weights)


def update_stabilized(state: GSUKFState, u, z, g: Callable,
                      measurement_pdf: GaussianSum) -> GSUKFState:
    """Local UKF updates and the log-space weight update, ``w_i ∝
    exp(log max(w_i, 1e-38) + logpdf_i - max)``; the weights come back
    normalized."""
    means, covs, eta = update_core(state.means, state.covariances,
                                   state.weights, u, z, g, measurement_pdf,
                                   return_eta=True)
    logw = (torch.log(torch.clamp_min(state.weights, 1e-38))
            + measurement_pdf.logpdf(eta))
    w = torch.exp(logw - torch.max(logw))
    return dataclasses.replace(state, means=means, covariances=covs,
                               weights=w / torch.sum(w))


def resample(state: GSUKFState) -> GSUKFState:
    """Systematic resample of the bank through the router's bank entry;
    uniform weights after."""
    (means, covs), weights = systematic_resample_bank(
        state.means, state.covariances, state.weights, state.generator)
    return GSUKFState(means, covs, weights, state.generator)


def step(state: GSUKFState, u, z, dt, f: Callable, g: Callable,
         state_pdf: GaussianSum, measurement_pdf: GaussianSum,
         stabilized: bool = False) -> GSUKFState:
    """Predict, update (log-space if ``stabilized``) and resample."""
    state = predict(state, u, dt, f, state_pdf)
    upd = update_stabilized if stabilized else update
    return resample(upd(state, u, z, g, measurement_pdf))


def step_from_noise(means, covariances, weights, u, z, dt, f: Callable,
                    g: Callable, measurement_pdf: GaussianSum, noise, r,
                    noise_is_lanes: bool = False):
    """The deterministic step: :func:`step` (linear weight update) with
    the given sigma-point ``noise`` (as :func:`predict_core` takes it) and
    float32 uniform ``r``. Returns ``((means, covariances), weights)``."""
    means, covs = predict_core(means, covariances, u, dt, noise, f,
                               noise_is_lanes)
    means, covs, weights = update_core(means, covs, weights, u, z, g,
                                       measurement_pdf)
    return systematic_resample_bank_from_r(means, covs, weights, r)


def point_estimate(state: GSUKFState) -> torch.Tensor:
    """Weighted mean of the bank, by blocked sums."""
    return weighted_mean(state.weights, state.means)


def covariance_matrix(state: GSUKFState) -> torch.Tensor:
    """The total covariance ``E[cov] + Var[means]``, ``(nx, nx)``."""
    w = state.weights / blocked_sum(state.weights)
    cov_cov = blocked_sum(w[:, None, None] * state.covariances)
    dist = state.means - weighted_mean(state.weights, state.means)
    cov_mean = blocked_outer_sum(dist, dist * w[:, None])
    return cov_cov + cov_mean


def point_covariance(state: GSUKFState) -> torch.Tensor:
    """Largest singular value of the total covariance, ``E[cov] +
    Var[means]``."""
    return torch.linalg.svdvals(covariance_matrix(state))[0]


def _update(state: GSUKFState, u, z, g: Callable,
            measurement_pdf: GaussianSum, stabilized: bool) -> GSUKFState:
    upd = update_stabilized if stabilized else update
    return upd(state, u, z, g, measurement_pdf)


def _moment_parts(means, covariances, weights):
    """The point estimate and the total covariance matrix (the moments up
    to the singular values, as ``filters/particle._moment_parts``)."""
    state = GSUKFState(means, covariances, weights, None)
    return point_estimate(state), covariance_matrix(state)


# ----------------------------------------------------------------------
class GaussianSumUnscentedKalmanFilter:
    """Stateful shell with the reference's API.

    The state, the distributions and every call's ``u``, ``z`` and ``dt``
    live on ``device``: the card unless the caller passes
    ``device="cpu"``. Assigning :attr:`state` clears the :meth:`moments`
    cache.

    ``predict``, ``update``, ``resample`` (the bank's compact + expand),
    ``step`` and ``moments`` each run on the card as the replay of a CUDA
    graph of their own (:attr:`graphs`), as the
    ``particle.ParticleFilter`` shell's do, and each method is a span of
    the recorder as theirs are.
    """

    def __init__(self, f, g, N_particles, x0, state_pdf, measurement_pdf,
                 seed: int = 0, device="cuda", stabilized: bool = False):
        self.device = torch.device(device)
        self.f, self.g = f, g
        self.N_particles = int(N_particles)
        self.state_pdf = _as_dist(state_pdf).to(self.device)
        self.measurement_pdf = _as_dist(measurement_pdf).to(self.device)
        self.stabilized = stabilized
        self._moments_cache = None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init(generator, self.N_particles,
                          _as_dist(x0).to(self.device), self.state_pdf)
        route = resampling.route
        self.graphs = {
            "predict": graphs.Graphed(predict),
            "update": graphs.Graphed(_update),
            "resample": graphs.Graphed(resample, key=route),
            "step": graphs.Graphed(step, key=route),
            "moments": graphs.Graphed(_moment_parts),
        }

    @property
    def state(self) -> GSUKFState:
        return self._state

    @state.setter
    def state(self, state: GSUKFState) -> None:
        self._state = state
        self._moments_cache = None

    def _t(self, v) -> torch.Tensor:
        # a host value goes to the card without waiting for it
        return graphs.as_input(v, self.device)

    # -- reference API --------------------------------------------------
    def predict(self, u, dt):
        with trace.span("shell.predict"):
            self.state = self.graphs["predict"](
                self.state, self._t(u), self._t(dt), self.f, self.state_pdf)

    def update(self, u, z):
        with trace.span("shell.update") as span:
            launched = mixture_pdf.launches
            self.state = self.graphs["update"](
                self.state, self._t(u), self._t(z), self.g,
                self.measurement_pdf, self.stabilized)
            trace.annotate(span, (("mixture_pdf",
                                   mixture_pdf.launches - launched),))

    def resample(self):
        with trace.span("shell.resample"):
            self.state = self.graphs["resample"](self.state)

    def step(self, u, z, dt):
        """Predict, update and resample in one call (one replay)."""
        with trace.span("shell.step"):
            self.state = self.graphs["step"](
                self.state, self._t(u), self._t(z), self._t(dt), self.f,
                self.g, self.state_pdf, self.measurement_pdf, self.stabilized)

    def point_estimate(self):
        with trace.span("shell.point_estimate", self.device):
            return point_estimate(self.state)

    def point_covariance(self):
        with trace.span("shell.point_covariance", self.device):
            return point_covariance(self.state)

    def moments(self):
        """``(point_estimate, point_covariance)``, cached until the state
        changes."""
        if self._moments_cache is None:
            st = self.state
            with trace.span("shell.moments", self.device):
                est, cov = self.graphs["moments"](st.means, st.covariances,
                                                  st.weights)
                self._moments_cache = (est, torch.linalg.svdvals(cov)[0])
        return self._moments_cache

    @property
    def means(self) -> torch.Tensor:
        return self.state.means

    @property
    def covariances(self) -> torch.Tensor:
        return self.state.covariances

    @property
    def weights(self) -> torch.Tensor:
        return self.state.weights
