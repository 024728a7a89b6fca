"""Particle filters, the Gaussian-sum UKF and systematic resampling."""
from gpu_se_tpu_torch.filters import gs_ukf, particle, resampling
from gpu_se_tpu_torch.filters.gs_ukf import (
    GaussianSumUnscentedKalmanFilter,
    GSUKFState,
)
from gpu_se_tpu_torch.filters.particle import ParticleFilter, PFState
from gpu_se_tpu_torch.filters.resampling import (
    systematic_resample,
    systematic_resample_indices,
)

# the reference's serial and parallel class names; one implementation
# serves both
ParallelParticleFilter = ParticleFilter
ParallelGaussianSumUnscentedKalmanFilter = GaussianSumUnscentedKalmanFilter

__all__ = [
    "particle",
    "gs_ukf",
    "resampling",
    "ParticleFilter",
    "ParallelParticleFilter",
    "PFState",
    "GaussianSumUnscentedKalmanFilter",
    "ParallelGaussianSumUnscentedKalmanFilter",
    "GSUKFState",
    "systematic_resample",
    "systematic_resample_indices",
]
