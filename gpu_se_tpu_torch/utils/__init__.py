"""Instrumentation: run sequences, the pacf gate, energy per run, the
result jar and state checkpoints."""
from gpu_se_tpu_torch.utils.cache import PickleJar, global_cache_settings
from gpu_se_tpu_torch.utils.checkpoint import StateCheckpointer
from gpu_se_tpu_torch.utils.power import (
    PowerMeasurement,
    accelerator_probe_available,
)
from gpu_se_tpu_torch.utils.run_sequences import RunSequences
from gpu_se_tpu_torch.utils.stats import acf, max_abs_pacf, pacf

__all__ = [
    "PickleJar",
    "StateCheckpointer",
    "global_cache_settings",
    "RunSequences",
    "PowerMeasurement",
    "accelerator_probe_available",
    "acf",
    "pacf",
    "max_abs_pacf",
]
