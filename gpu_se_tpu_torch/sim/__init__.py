"""The closed-loop harness and the on-device loop."""
from gpu_se_tpu_torch.sim.harness import (
    Simulation,
    get_noise,
    get_parts,
    get_random_io,
    performance,
)

__all__ = ["Simulation", "get_parts", "get_noise", "get_random_io", "performance"]
