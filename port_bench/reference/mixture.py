"""Gaussian mixtures of the benchmark's own, in float64.

The configuration file states each mixture (means, covariances,
weights); the traffic draws the plant's noise from it with numpy, the
reference evaluates its density with torch, and the comparisons read its
moments. Nothing here is taken from the program.
"""
from __future__ import annotations

import math

import numpy as np


class Mixture:
    def __init__(self, means, covariances, weights):
        self.means = np.atleast_2d(np.asarray(means, dtype=float))
        self.covs = np.asarray(covariances, dtype=float)
        w = np.asarray(weights, dtype=float)
        self.weights = w / w.sum()
        self.dim = self.means.shape[1]
        self.chol = np.linalg.cholesky(self.covs)
        self.inv = np.linalg.inv(self.covs)
        _, logdet = np.linalg.slogdet(self.covs)
        self.log_const = -0.5 * self.dim * math.log(2 * math.pi) - 0.5 * logdet

    @classmethod
    def from_config(cls, spec: dict) -> "Mixture":
        return cls(spec["means"], spec["covariances"], spec["weights"])

    def shifted(self, offset) -> "Mixture":
        """The same mixture with ``offset`` added to every mean."""
        return Mixture(self.means + np.asarray(offset, dtype=float)[None],
                       self.covs, self.weights)

    def mean(self) -> np.ndarray:
        return self.weights @ self.means

    def covariance(self) -> np.ndarray:
        d = self.means - self.mean()
        return (np.einsum("k,kij->ij", self.weights, self.covs)
                + np.einsum("k,ki,kj->ij", self.weights, d, d))

    def fourth_moments(self) -> np.ndarray:
        """``E[(x_j - mean_j)^4]`` for each coordinate."""
        d = self.means - self.mean()
        var = np.einsum("kjj->kj", self.covs)
        return self.weights @ (d ** 4 + 6 * d ** 2 * var + 3 * var ** 2)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``(n, dim)`` draws."""
        comp = rng.choice(len(self.weights), size=n, p=self.weights)
        eps = rng.standard_normal((n, self.dim))
        return self.means[comp] + np.einsum("nij,nj->ni", self.chol[comp], eps)

    def torch_pdf(self, x, tf32: bool = False):
        """The density at ``x (n, dim)``, in ``x``'s dtype; with ``tf32``
        (float32 ``x``) the quadratic form's operands are rounded to TF32,
        as the control computes it."""
        import torch

        from port_bench.reference.pf import round_tf32

        kw = dict(dtype=x.dtype, device=x.device)
        means = torch.as_tensor(self.means, **kw)
        inv = torch.as_tensor(self.inv, **kw)
        total = torch.zeros(x.shape[0], **kw)
        for k in range(len(self.weights)):
            e = x - means[k]
            if tf32:
                e, inv_k = round_tf32(e), round_tf32(inv[k])
                quad = ((e @ inv_k) * e).sum(dim=1)
            else:
                quad = ((e @ inv[k]) * e).sum(dim=1)
            total = total + self.weights[k] * torch.exp(self.log_const[k]
                                                         - 0.5 * quad)
        return total

    def torch_draw(self, generator, n: int, device):
        """``(n, dim)`` float64 draws from a torch generator on
        ``device``: the reference filter's own noise."""
        import torch

        kw = dict(dtype=torch.float64, device=device)
        comp = torch.multinomial(torch.as_tensor(self.weights, **kw), n,
                                 replacement=True, generator=generator)
        eps = torch.randn((n, self.dim), generator=generator, **kw)
        chol = torch.as_tensor(self.chol, **kw)[comp]
        means = torch.as_tensor(self.means, **kw)[comp]
        return means + torch.einsum("nij,nj->ni", chol, eps)
