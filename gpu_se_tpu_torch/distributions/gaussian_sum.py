"""Gaussian-sum (mixture of multivariate Gaussians) distributions.

Counterpart of ``gpu_se_tpu/distributions/gaussian_sum.py``: the same
host float64 precompute of the Cholesky factors, inverse covariances
and normalization constants, cast to float32 on the target device; the
row-major ``pdf`` / ``logpdf`` / ``draw`` of the flat particle filter and
the GSUKF (the densities through ``ops/mixture_pdf``: one hand-written
kernel on the card) and the lanes-last ``pdf_t`` / ``draw_t`` of the
tiled one; and the stateful
:class:`MultivariateGaussianSum` shell, and its replay-deterministic
:class:`DeterministicGaussianSum`.

Random numbers come from an explicit ``torch.Generator``: Philox on a
CUDA generator, the Mersenne twister on a CPU one. Neither reproduces
the reference's threefry stream, so element-level tests inject the
reference's normals and components through :meth:`GaussianSum.draw_from`
and :meth:`GaussianSum.draw_t_from`, and the port's own draws are checked at the distribution level.
:meth:`GaussianSum.draw_inputs_at` and :meth:`GaussianSum.draw_inputs_at_t`
take their normals and uniforms from the counter-based stream of
``ops/counter_draw`` instead, any slice of it, for the sharded steps.

The ``chol @ eps`` products are float32 matrix products: callers on a
CUDA device keep ``torch.backends.cuda.matmul.allow_tf32`` off, or the
noise keeps only TF32's ~3 decimal digits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from gpu_se_tpu_torch.ops import counter_draw, mixture_pdf


@dataclass(frozen=True)
class GaussianSum:
    """Mixture of ``Nd`` multivariate Gaussians over ``R^Nx``.

    Attributes
    ----------
    means : (Nd, Nx)
    covariances : (Nd, Nx, Nx)
    weights : (Nd,)
        Mixture weights, used as given by :meth:`pdf_t` and normalized
        by the draws.
    chol : (Nd, Nx, Nx)
        Lower Cholesky factors of the covariances.
    inv_cov : (Nd, Nx, Nx)
        Inverse covariances.
    log_const : (Nd,)
        ``-Nx/2 log(2 pi) - 1/2 log det(cov)`` per component.
    """

    means: torch.Tensor
    covariances: torch.Tensor
    weights: torch.Tensor
    chol: torch.Tensor
    inv_cov: torch.Tensor
    log_const: torch.Tensor

    @classmethod
    def create(cls, means, covariances, weights, device="cuda",
               dtype=torch.float32) -> "GaussianSum":
        """Build a mixture, precomputing its factors in float64 on the
        host and casting them to ``dtype`` on ``device``: the card unless
        the caller passes ``device="cpu"``. Without CUDA the default
        raises, as torch does."""
        means64 = np.atleast_2d(np.asarray(means, dtype=np.float64))
        covs64 = np.asarray(covariances, dtype=np.float64)
        if covs64.ndim == 2:
            covs64 = covs64[None]
        w64 = np.atleast_1d(np.asarray(weights, dtype=np.float64))
        nx = means64.shape[1]
        chol = np.linalg.cholesky(covs64)
        inv_cov = np.linalg.inv(covs64)
        _, logdet = np.linalg.slogdet(covs64)
        log_const = -0.5 * nx * math.log(2.0 * math.pi) - 0.5 * logdet

        def dev(a):
            # the float64 -> float32 cast rounds to nearest, as the
            # reference's does, so both hold the same float32 factors
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(dev(means64), dev(covs64), dev(w64), dev(chol),
                   dev(inv_cov), dev(log_const))

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def n_dim(self) -> int:
        return self.means.shape[1]

    # ------------------------------------------------------------------
    def pdf(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        """Mixture pdf at a batch of points ``x (..., Nx)``; returns
        ``(...)``, times ``scale (...)`` where given (a filter's prior
        weights). One launch of ``ops/mixture_pdf``'s kernel for a CUDA
        ``x``, its plain version for a CPU one: :meth:`pdf_t`'s order
        over rows."""
        return mixture_pdf.mixture_pdf(x, self.means, self.inv_cov,
                                       self.log_const, self.weights,
                                       scale=scale)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log mixture pdf at ``x (..., Nx)`` by log-sum-exp over the
        components, so a far point underflows to a finite log rather
        than to ``log 0``; returns ``(...)``. The kernel's ``log`` mode
        for a CUDA ``x``, as :meth:`pdf`."""
        return mixture_pdf.mixture_pdf(x, self.means, self.inv_cov,
                                       self.log_const, self.weights,
                                       log=True)

    def pdf_t(self, x: torch.Tensor) -> torch.Tensor:
        """Lanes-last mixture pdf: ``x`` is ``(Nx, ...)``; returns ``(...)``.

        The quadratic form is unrolled over the components and state
        dims in the reference's order (``(e @ inv_cov) . e`` row-major),
        one elementwise op at a time, so no step is fused or reassociated:
        ``ops/mixture_pdf``'s plain version over lanes, whose order the
        kernel behind :meth:`pdf` keeps.
        """
        return mixture_pdf.mixture_pdf_plain(
            x.movedim(0, -1), self.means, self.inv_cov, self.log_const,
            self.weights)

    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator, shape=(1,)) -> torch.Tensor:
        """Draw ``(*shape, Nx)`` samples from ``generator``'s stream:
        :meth:`draw_inputs`, then :meth:`draw_from`."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        size = math.prod(shape)
        return self.draw_from(*self.draw_inputs(generator, size)).reshape(
            shape + (self.n_dim,))

    def draw_inputs(self, generator: torch.Generator, size: int):
        """``(eps (size, Nx) standard normals, comp (size,) int64
        component indices)`` for :meth:`draw_from`, from ``generator``'s
        stream on the mixture's device."""
        probs = (self.weights / self.weights.sum()).to(torch.float64)
        comp = torch.multinomial(probs, size, replacement=True,
                                 generator=generator)
        eps = torch.randn((size, self.n_dim), dtype=self.means.dtype,
                          generator=generator, device=self.means.device)
        return eps, comp

    def _component_of(self, u: torch.Tensor) -> torch.Tensor:
        """The component of each uniform ``u``, int64: ``u >= w0 / (w0 +
        w1)`` for two components (as :meth:`draw_t_from` picks), the
        count of float64 cumulative weights ``<= u`` otherwise."""
        if self.n_components == 2:
            p0 = self.weights[0] / (self.weights[0] + self.weights[1])
            return (u >= p0).to(torch.int64)
        w = self.weights.to(torch.float64)
        cum = torch.cumsum(w, 0) / w.sum()
        comp = torch.searchsorted(cum, u.to(torch.float64), right=True)
        return comp.clamp_max_(self.n_components - 1)

    def draw_inputs_at(self, key: torch.Tensor, start: int, count: int):
        """:meth:`draw_inputs` of the samples ``[start, start + count)`` of
        the counter-based stream keyed by ``key``
        (``ops/counter_draw``): ``(eps (count, Nx), comp (count,))`` for
        :meth:`draw_from`. Sample ``j`` depends only on ``key`` and ``j``,
        so slices concatenate to the whole draw."""
        eps, u = counter_draw.counter_draw(key, start, count, self.n_dim)
        return eps.to(self.means.dtype), self._component_of(u)

    def draw_inputs_at_t(self, key: torch.Tensor, start: int, count: int):
        """The lanes-last twin of :meth:`draw_inputs_at`: ``(eps (Nx,
        count), pick (count,))`` for :meth:`draw_t_from`, ``pick`` the
        uniforms for two components, the component indices otherwise."""
        eps, u = counter_draw.counter_draw(key, start, count, self.n_dim,
                                           lanes_last=True)
        pick = u if self.n_components == 2 else self._component_of(u)
        return eps.to(self.means.dtype), pick

    def draw_from(self, eps: torch.Tensor, comp: torch.Tensor) -> torch.Tensor:
        """The deterministic core of :meth:`draw`: sample ``k`` is
        ``means[comp_k] + chol[comp_k] @ eps_k``, every component's affine
        computed and the sample's selected by a one-hot, in the
        reference's order."""
        onehot = (comp[:, None] == torch.arange(
            self.n_components, device=comp.device)).to(eps.dtype)  # (n, Nd)
        scaled = torch.einsum("nj,dij->ndi", eps, self.chol)       # (n, Nd, Nx)
        return onehot @ self.means + torch.sum(onehot[:, :, None] * scaled,
                                               dim=1)

    def draw_t(self, generator: torch.Generator, size: int) -> torch.Tensor:
        """Lanes-last draw ``(Nx, size)`` from ``generator``'s stream.

        Draws the standard normals first, then one uniform per sample for
        a two-component mixture or one categorical component per sample
        otherwise, on ``generator``'s device.
        """
        kw = dict(generator=generator, device=self.means.device)
        eps = torch.randn((self.n_dim, size), dtype=self.means.dtype, **kw)
        if self.n_components == 2:
            pick = torch.rand((size,), dtype=self.means.dtype, **kw)
        else:
            probs = (self.weights / self.weights.sum()).to(torch.float64)
            pick = torch.multinomial(probs, size, replacement=True,
                                     generator=generator)
        return self.draw_t_from(eps, pick)

    def draw_t_from(self, eps: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
        """The deterministic core of :meth:`draw_t`.

        ``eps`` is ``(Nx, size)`` standard normals. ``pick`` is ``(size,)``:
        uniforms in ``[0, 1)`` for a two-component mixture (component 0
        where ``u < w0 / (w0 + w1)``), component indices otherwise.
        """
        if self.n_components == 2:
            p0 = self.weights[0] / (self.weights[0] + self.weights[1])
            a = self.means[0][:, None] + self.chol[0] @ eps
            b = self.means[1][:, None] + self.chol[1] @ eps
            return torch.where((pick < p0)[None, :], a, b)
        scaled = torch.stack([
            self.chol[d] @ eps for d in range(self.n_components)
        ])                                                   # (Nd, Nx, size)
        onehot = (pick[None, :] == torch.arange(
            self.n_components, device=pick.device)[:, None]
        ).to(eps.dtype)                                      # (Nd, size)
        mean_term = self.means.T @ onehot                    # (Nx, size)
        noise = torch.sum(onehot[:, None, :] * scaled, dim=0)
        return mean_term + noise

    # ------------------------------------------------------------------
    def mean(self) -> torch.Tensor:
        """Mixture mean (weights normalized)."""
        w = self.weights / torch.sum(self.weights)
        return w @ self.means

    def covariance(self) -> torch.Tensor:
        """Mixture covariance (law of total covariance)."""
        w = self.weights / torch.sum(self.weights)
        d = self.means - w @ self.means
        return (torch.einsum("d,dij->ij", w, self.covariances)
                + torch.einsum("d,di,dj->ij", w, d, d))

    def to(self, device) -> "GaussianSum":
        """The same mixture with every field on ``device``."""
        return GaussianSum(*(getattr(self, f.name).to(device)
                             for f in fields(self)))


class MultivariateGaussianSum:
    """Stateful shell with the reference's constructor and method surface.

    ``library=`` is accepted and ignored. Each :meth:`draw` advances a
    ``torch.Generator`` on ``device`` (the card unless the caller passes
    ``device="cpu"``) seeded from ``seed`` (the reference splits a PRNG
    key); the two streams differ.
    """

    def __init__(self, means, covariances, weights, library=None,
                 seed: int = 0, device="cuda"):
        del library
        self.dist = GaussianSum.create(means, covariances, weights,
                                       device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.means = self.dist.means
        self.covariances = self.dist.covariances
        self.weights = self.dist.weights

    @property
    def _Nd(self) -> int:
        return self.dist.n_components

    @property
    def _Nx(self) -> int:
        return self.dist.n_dim

    def pdf(self, x):
        return self.dist.pdf(x)

    def logpdf(self, x):
        return self.dist.logpdf(x)

    def draw(self, shape=(1,)):
        return self.dist.draw(self.generator, shape)


class DeterministicGaussianSum(MultivariateGaussianSum):
    """Replay-deterministic variant for CPU-versus-card parity runs.

    All instances share one lazily extended stream of float32 values, and
    ``draw(shape)`` returns the *first* ``prod(shape) * Nx`` of them,
    squeezed, on the instance's device: two instances (one driving a CPU
    filter, one a card filter) see identical noise. The reference's
    semantics; its stream is threefry from ``PRNGKey(1234)``, this one
    a CPU ``torch.Generator`` seeded 1234, whose draws extend it in
    :meth:`GaussianSum.draw` samples of the instance that first needs
    more values. The streams differ: a test that copies the reference's
    ``_values`` into this class gets the reference's draws.
    """

    _values = np.array([], dtype=np.float32)
    # created at the first draw, so importing the package draws nothing
    _stream = None
    SEED = 1234

    @classmethod
    def reset(cls):
        cls._values = np.array([], dtype=np.float32)
        cls._stream = None

    def draw(self, shape=(1,)):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        size = math.prod(shape) * self._Nx
        cls = DeterministicGaussianSum
        if cls._values.size < size:
            if cls._stream is None:
                cls._stream = torch.Generator().manual_seed(cls.SEED)
            need = size - cls._values.size
            n_draw = -(-need // self._Nx)
            drawn = self.dist.to("cpu").draw(cls._stream, (n_draw,))
            cls._values = np.hstack(
                [cls._values, drawn.numpy().ravel()[:need]])
        out = cls._values[:size].reshape(shape + (self._Nx,))
        return torch.from_numpy(np.squeeze(out)).to(self.means.device)
