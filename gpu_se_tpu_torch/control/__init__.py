"""The dense ADMM QP and the condensed MPC.

The reference's ``ScenarioMPC`` and ``consensus_consts``
(``control/scenario_mpc.py``) are not ported yet: they come with the
scenario-MPC slice.
"""
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

__all__ = [
    "MPC",
    "build_prediction_matrices",
    "DenseQP",
    "QPSettings",
    "QPSolution",
    "SOLVED",
    "MAX_ITER_REACHED",
    "PRIMAL_INFEASIBLE",
    "DUAL_INFEASIBLE",
]
