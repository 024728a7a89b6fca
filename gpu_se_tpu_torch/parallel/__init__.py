"""The multi-device layer over ``torch.distributed``: the mesh over the
particle axis (``mesh``), the multi-process start-up (``distributed``),
the sharded filter steps (``sharded``) and the scenario axis of the MPC
(``scenario``). ``launch`` runs a function in a spawned process group.
"""
from gpu_se_tpu_torch.parallel.mesh import (
    PARTICLE_AXIS,
    make_mesh,
    particle_sharding,
    replicated,
)
from gpu_se_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
)
from gpu_se_tpu_torch.parallel.scenario import (
    make_consensus_scenario_step,
    make_scenario_solver,
)
from gpu_se_tpu_torch.parallel.sharded import (
    make_auto_sharded_gsukf_step,
    make_auto_sharded_step,
    make_shard_map_gsukf_step,
    make_shard_map_step,
    make_shard_map_tiled_step,
    shard_gsukf_state,
    shard_pf_state,
    shard_tiled_pf_state,
)

__all__ = [
    "PARTICLE_AXIS",
    "make_mesh",
    "particle_sharding",
    "replicated",
    "make_auto_sharded_step",
    "make_shard_map_step",
    "make_shard_map_tiled_step",
    "make_shard_map_gsukf_step",
    "shard_tiled_pf_state",
    "shard_pf_state",
    "shard_gsukf_state",
    "make_auto_sharded_gsukf_step",
    "make_scenario_solver",
    "make_consensus_scenario_step",
    "initialize_distributed",
    "global_mesh",
]
