"""The dense ADMM QP, the condensed MPC and the scenario MPC."""
from gpu_se_tpu_torch.control.mpc import MPC, build_prediction_matrices
from gpu_se_tpu_torch.control.qp import (
    DUAL_INFEASIBLE,
    MAX_ITER_REACHED,
    PRIMAL_INFEASIBLE,
    SOLVED,
    DenseQP,
    QPSettings,
    QPSolution,
)
from gpu_se_tpu_torch.control.scenario_mpc import ScenarioMPC, consensus_consts

__all__ = [
    "MPC",
    "ScenarioMPC",
    "consensus_consts",
    "build_prediction_matrices",
    "DenseQP",
    "QPSettings",
    "QPSolution",
    "SOLVED",
    "MAX_ITER_REACHED",
    "PRIMAL_INFEASIBLE",
    "DUAL_INFEASIBLE",
]
