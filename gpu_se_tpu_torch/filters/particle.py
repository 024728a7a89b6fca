"""Sampling-importance-resampling particle filter on an ``(n, nx)`` state.

Counterpart of ``gpu_se_tpu/filters/particle.py``: one functional core
over an explicit :class:`PFState`, and the :class:`ParticleFilter` shell
with the reference's six methods plus ``step`` and ``moments``. The
resample goes through the router of ``filters/resampling.py``, which on
a CUDA device takes the hand-written kernels.

The process and measurement functions follow the port's model
convention: ``f(x, u, dt)`` and ``g(x, u)`` take the state dims on the
leading axis and broadcast over the rest (``models/bioreactor.py``), so
they are applied to ``particles.T`` (``(nx, n)``) and their results
transposed back; the public layout stays ``(n, nx)``, as the
reference's and the harness's.

Random numbers come from the state's ``torch.Generator``: the noise
draw, then the resample's uniform ``r``. :func:`predict_from_noise` and
:func:`step_from_noise` take them as arguments, for the tests that
inject the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from gpu_se_tpu_torch import graphs, trace
from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.filters import resampling
from gpu_se_tpu_torch.filters.resampling import (
    systematic_resample,
    systematic_resample_from_r,
)
from gpu_se_tpu_torch.ops.mixture_pdf import mixture_pdf
from gpu_se_tpu_torch.ops.reduce import (
    blocked_outer_sum,
    blocked_sum,
    weighted_mean,
)


@dataclass
class PFState:
    """Particle-filter state.

    Attributes
    ----------
    particles : (n, nx) tensor
    weights : (n,) tensor
    generator : torch.Generator
        The stream :func:`predict` and :func:`resample` draw from, on the
        particles' device; they advance it in place.
    """

    particles: torch.Tensor
    weights: torch.Tensor
    generator: torch.Generator

    @property
    def n_particles(self) -> int:
        return self.particles.shape[0]


def init(generator: torch.Generator, n_particles: int, x0: GaussianSum,
         dtype=torch.float32) -> PFState:
    """``n_particles`` draws from ``x0`` and uniform weights."""
    particles = x0.draw(generator, (n_particles,)).to(dtype)
    weights = torch.full((n_particles,), 1.0 / n_particles, dtype=dtype,
                         device=particles.device)
    return PFState(particles, weights, generator)


def predict_from_noise(particles: torch.Tensor, u, dt, f: Callable,
                       noise: torch.Tensor) -> torch.Tensor:
    """``x_i + f(x_i, u, dt) + noise_i`` for every particle."""
    return particles + f(particles.T, u, dt).T + noise


def predict(state: PFState, u, dt, f: Callable,
            state_pdf: GaussianSum) -> PFState:
    """Move every particle by the model and a draw of ``state_pdf`` (the
    draw a ``predict.draw`` span of the recorder)."""
    with trace.site_span("predict.draw", state.particles.device):
        noise = state_pdf.draw(state.generator, (state.n_particles,))
    return dataclasses.replace(
        state, particles=predict_from_noise(state.particles, u, dt, f, noise))


def _residuals(particles, u, z, g):
    return z - g(particles.T, u).T


def update(state: PFState, u, z, g: Callable,
           measurement_pdf: GaussianSum) -> PFState:
    """``w_i *= p(z - g(x_i, u))``: the prior weights are the density's
    ``scale``, so the multiply is its last rounding."""
    return dataclasses.replace(state, weights=measurement_pdf.pdf(
        _residuals(state.particles, u, z, g), scale=state.weights))


def update_stabilized(state: PFState, u, z, g: Callable,
                      measurement_pdf: GaussianSum) -> PFState:
    """Log-space update, ``w_i ∝ exp(log w_i + logpdf_i - max)``; the
    weights come back normalized."""
    logw = (torch.log(torch.clamp_min(state.weights, 1e-38))
            + measurement_pdf.logpdf(_residuals(state.particles, u, z, g)))
    w = torch.exp(logw - torch.max(logw))
    return dataclasses.replace(state, weights=w / torch.sum(w))


def resample(state: PFState) -> PFState:
    """Systematic resample through the router; uniform weights after."""
    particles, weights = systematic_resample(state.particles, state.weights,
                                             state.generator)
    return PFState(particles, weights, state.generator)


def step(state: PFState, u, z, dt, f: Callable, g: Callable,
         state_pdf: GaussianSum, measurement_pdf: GaussianSum,
         stabilized: bool = False) -> PFState:
    """Predict, update (log-space if ``stabilized``) and resample."""
    state = predict(state, u, dt, f, state_pdf)
    upd = update_stabilized if stabilized else update
    return resample(upd(state, u, z, g, measurement_pdf))


def step_from_noise(particles: torch.Tensor, weights: torch.Tensor, u, z, dt,
                    f: Callable, g: Callable, measurement_pdf: GaussianSum,
                    noise: torch.Tensor, r, stabilized: bool = False):
    """The deterministic step: :func:`step` with the given ``noise (n,
    nx)`` and uniform ``r``. Returns ``(particles, weights)``."""
    state = PFState(predict_from_noise(particles, u, dt, f, noise), weights,
                    None)
    upd = update_stabilized if stabilized else update
    state = upd(state, u, z, g, measurement_pdf)
    return systematic_resample_from_r(state.particles, state.weights, r)


def point_estimate(state: PFState) -> torch.Tensor:
    """Weighted particle mean, normalized, by blocked sums."""
    return weighted_mean(state.weights, state.particles)


def covariance_matrix(state: PFState) -> torch.Tensor:
    """The weighted particle covariance ``(nx, nx)``, by blocked sums."""
    w = state.weights / blocked_sum(state.weights)
    dist = state.particles - weighted_mean(state.weights, state.particles)
    return blocked_outer_sum(dist, dist * w[:, None])


def point_covariance(state: PFState) -> torch.Tensor:
    """Largest singular value of the weighted particle covariance."""
    return torch.linalg.svdvals(covariance_matrix(state))[0]


def _update(state: PFState, u, z, g: Callable, measurement_pdf: GaussianSum,
            stabilized: bool) -> PFState:
    upd = update_stabilized if stabilized else update
    return upd(state, u, z, g, measurement_pdf)


def _moment_parts(particles, weights):
    """The point estimate and the covariance matrix: the moments up to
    the singular values, which cuSOLVER finds only with a read of its
    status back to the host."""
    state = PFState(particles, weights, None)
    return point_estimate(state), covariance_matrix(state)


# ----------------------------------------------------------------------
class ParticleFilter:
    """Stateful shell with the reference's API.

    The state, the distributions and every call's ``u``, ``z`` and ``dt``
    live on ``device`` (default: ``x0``'s). Assigning :attr:`state`
    clears the :meth:`moments` cache.

    As the reference jits ``predict``, ``update``, ``resample``, ``step``
    and ``moments``, each runs on the card as the replay of its own CUDA
    graph (:attr:`graphs`, ``gpu_se_tpu_torch.graphs``), captured anew for
    another shape, resample route, ``stabilized`` flag, generator or
    assigned distribution; ``moments`` takes the covariance's largest
    singular value after its replay. The tensors it hands out keep their
    values after later calls. On the CPU each runs directly.

    Each method is a ``shell.<method>`` span of the recorder
    (``gpu_se_tpu_torch.trace``); the graphed ones hold their inputs'
    staging and the graphed call (a device span of its own), and the
    eager ones (the point estimate, covariance and moments) are device
    spans too. The staging's few-byte copies stay outside the device
    spans: two stamps more a call would cost the card more than the
    copies take.
    """

    def __init__(self, f, g, N_particles, x0, state_pdf, measurement_pdf,
                 seed: int = 0, device=None, stabilized: bool = False):
        x0 = _as_dist(x0)
        self.device = torch.device(device if device is not None
                                   else x0.means.device)
        self.f, self.g = f, g
        self.N_particles = int(N_particles)
        self.state_pdf = _as_dist(state_pdf).to(self.device)
        self.measurement_pdf = _as_dist(measurement_pdf).to(self.device)
        self.stabilized = stabilized
        self._moments_cache = None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init(generator, self.N_particles, x0.to(self.device))
        route = resampling.route
        self.graphs = {
            "predict": graphs.Graphed(predict),
            "update": graphs.Graphed(_update),
            "resample": graphs.Graphed(resample, key=route),
            "step": graphs.Graphed(step, key=route),
            "moments": graphs.Graphed(_moment_parts),
        }

    @property
    def state(self) -> PFState:
        return self._state

    @state.setter
    def state(self, state: PFState) -> None:
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
            with trace.span("shell.moments", self.device):
                est, cov = self.graphs["moments"](self.state.particles,
                                                  self.state.weights)
                self._moments_cache = (est, torch.linalg.svdvals(cov)[0])
        return self._moments_cache

    @property
    def particles(self) -> torch.Tensor:
        return self.state.particles

    @property
    def weights(self) -> torch.Tensor:
        return self.state.weights


def _as_dist(d) -> GaussianSum:
    """A :class:`GaussianSum`, or the ``.dist`` of a stateful shell."""
    if isinstance(d, GaussianSum):
        return d
    return d.dist
