"""Process models on stacked ``(nx, ...)`` tensors.

The bioreactor's regime functions are here. The reference's
``NonlinearModel`` base, its ``Bioreactor`` shell, the CSTR, the linear
model and the tanks come with the control slice (``ROADMAP.md`` item 9).
"""
from gpu_se_tpu_torch.models.bioreactor import (
    all_outputs,
    euler_step,
    high_n_des,
    homeostatic_des,
    static_outputs,
)

__all__ = [
    "homeostatic_des",
    "high_n_des",
    "static_outputs",
    "all_outputs",
    "euler_step",
]
