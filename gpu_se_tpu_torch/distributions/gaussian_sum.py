"""Gaussian-sum (mixture of multivariate Gaussians) distributions.

Counterpart of ``gpu_se_tpu/distributions/gaussian_sum.py``: the same
host float64 precompute of the Cholesky factors, inverse covariances
and normalization constants, cast to float32 on the target device, and
the same lanes-last ``pdf_t`` / ``draw_t`` used by the tiled particle
filter.

Random numbers come from an explicit ``torch.Generator``: Philox on a
CUDA generator, the Mersenne twister on a CPU one. Neither reproduces
the reference's threefry stream, so element-level tests inject the
reference's normals and uniforms through :meth:`GaussianSum.draw_t_from`
and the port's own draws are checked at the distribution level.

The ``chol @ eps`` products are float32 matrix products: callers on a
CUDA device keep ``torch.backends.cuda.matmul.allow_tf32`` off, or the
noise keeps only TF32's ~3 decimal digits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


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
    def create(cls, means, covariances, weights, device="cpu",
               dtype=torch.float32) -> "GaussianSum":
        """Build a mixture, precomputing its factors in float64 on the
        host and casting them to ``dtype`` on ``device``."""
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
    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Mixture pdf at a batch of points ``x (..., Nx)``; returns
        ``(...)``."""
        x = torch.atleast_2d(x)
        es = x[..., None, :] - self.means                    # (..., Nd, Nx)
        quad = torch.einsum("...di,dij,...dj->...d", es, self.inv_cov, es)
        comp = torch.exp(self.log_const - 0.5 * quad)
        return torch.sum(self.weights * comp, dim=-1)

    def pdf_t(self, x: torch.Tensor) -> torch.Tensor:
        """Lanes-last mixture pdf: ``x`` is ``(Nx, ...)``; returns ``(...)``.

        The quadratic form is unrolled over the components and state
        dims in the reference's order (``(e @ inv_cov) . e`` row-major),
        one elementwise op at a time, so no step is fused or reassociated.
        """
        total = None
        for d in range(self.n_components):
            es = [x[i] - self.means[d, i] for i in range(self.n_dim)]
            quad = None
            for i in range(self.n_dim):
                acc = None
                for j in range(self.n_dim):
                    term = self.inv_cov[d, j, i] * es[j]
                    acc = term if acc is None else acc + term
                t = es[i] * acc
                quad = t if quad is None else quad + t
            comp = self.weights[d] * torch.exp(self.log_const[d] - 0.5 * quad)
            total = comp if total is None else total + comp
        return total

    # ------------------------------------------------------------------
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
