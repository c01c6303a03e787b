"""Parallelism layer: the ('data', 'model') mesh, its sharding rules (DP,
Megatron TP, FSDP storage sharding, expert parallelism), ring context
parallelism, the GPipe pipeline over a ('data', 'stage') mesh and the
process group set-up, on ``torch.distributed`` (the JAX package's
``parallel/``)."""
from .distributed import (
    LocalRanks, init_local_group, initialize_distributed, process_local_batch_slice,
    spawn_ranks,
)
from .mesh import (
    DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, P, ShardedModel, batch_sharding, make_mesh,
    make_pp_mesh, opt_state_shardings, param_shardings, param_spec, replicated,
    shard_params,
)
from .pipeline_parallel import pipeline_apply, place_stage_params, stack_stage_params
from .ring_attention import ring_attention, ring_attention_local

__all__ = [
    'DATA_AXIS', 'MODEL_AXIS', 'STAGE_AXIS', 'Mesh', 'P', 'ShardedModel', 'batch_sharding',
    'make_mesh', 'make_pp_mesh', 'opt_state_shardings', 'param_shardings', 'param_spec',
    'replicated', 'shard_params', 'pipeline_apply', 'place_stage_params',
    'stack_stage_params', 'ring_attention', 'ring_attention_local',
    'LocalRanks', 'init_local_group', 'initialize_distributed', 'process_local_batch_slice',
    'spawn_ranks',
]
