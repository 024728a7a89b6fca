"""Gaussian-mixture distributions on torch tensors."""
from gpu_se_tpu_torch.distributions.gaussian_sum import (
    DeterministicGaussianSum,
    GaussianSum,
    MultivariateGaussianSum,
)

__all__ = ["DeterministicGaussianSum", "GaussianSum",
           "MultivariateGaussianSum"]
