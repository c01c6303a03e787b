"""Parallelism layer: the ('data', 'model') mesh, its sharding rules (DP,
Megatron TP, FSDP storage sharding, expert parallelism) and the process
group set-up, on ``torch.distributed`` (the JAX package's ``parallel/``).
Ring context parallelism and the GPipe pipeline are not ported yet."""
from .distributed import (
    LocalRanks, init_local_group, initialize_distributed, process_local_batch_slice,
    spawn_ranks,
)
from .mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, P, ShardedModel, batch_sharding, make_mesh,
    opt_state_shardings, param_shardings, param_spec, replicated, shard_params,
)

__all__ = [
    'DATA_AXIS', 'MODEL_AXIS', 'Mesh', 'P', 'ShardedModel', 'batch_sharding', 'make_mesh',
    'opt_state_shardings', 'param_shardings', 'param_spec', 'replicated', 'shard_params',
    'LocalRanks', 'init_local_group', 'initialize_distributed', 'process_local_batch_slice',
    'spawn_ranks',
]
