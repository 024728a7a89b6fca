"""The scenario axis of the MPC on one device (``scenario``).

The reference's mesh, distributed start-up and sharded filter steps come
with the multi-device slice (``ROADMAP.md``, Queue 1 item 15).
"""
from gpu_se_tpu_torch.parallel.scenario import (
    make_consensus_scenario_step,
    make_scenario_solver,
)

__all__ = ["make_scenario_solver", "make_consensus_scenario_step"]
