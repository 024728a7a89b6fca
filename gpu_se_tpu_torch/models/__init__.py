"""Process models: the bioreactor's regime functions on stacked
``(nx, ...)`` tensors, the ``NonlinearModel`` base with its host shells
(bioreactor, CSTR, tanks) and the linear model with its linearizer."""
from gpu_se_tpu_torch.models.base import NonlinearModel
from gpu_se_tpu_torch.models.bioreactor import (
    Bioreactor,
    all_outputs,
    euler_step,
    high_n_des,
    homeostatic_des,
    static_outputs,
)
from gpu_se_tpu_torch.models.cstr import (
    CSTRModel,
    analytic_jacobians,
    cstr_des,
    cstr_outputs,
)
from gpu_se_tpu_torch.models.linear import LinearModel, create_linear_model
from gpu_se_tpu_torch.models.tanks import DiagTank, LinkedTanks, TankModel

__all__ = [
    "NonlinearModel",
    "Bioreactor",
    "homeostatic_des",
    "high_n_des",
    "static_outputs",
    "all_outputs",
    "euler_step",
    "CSTRModel",
    "cstr_des",
    "cstr_outputs",
    "analytic_jacobians",
    "LinearModel",
    "create_linear_model",
    "TankModel",
    "DiagTank",
    "LinkedTanks",
]
