"""Parallelism of the port: the sharding rules and collectives on
``torch.distributed`` meshes, the data- and tensor-parallel train step,
and DVFS plan transfer across DP/TP meshes and chip models."""
from .collectives import moe_all_to_all, moe_all_to_all_sharded
from .plan_transfer import (transfer_train_bundle, transfer_serve_plan,
                            compare_transfer, TransferRow)
from .sharding import (batch_specs, cache_specs, gather_state, param_specs,
                       shard_state, state_shardings)
from .train_step import ShardedStep, init_sharded_state

__all__ = ["transfer_train_bundle", "transfer_serve_plan",
           "compare_transfer", "TransferRow", "param_specs", "batch_specs",
           "cache_specs", "state_shardings", "shard_state", "gather_state",
           "moe_all_to_all", "moe_all_to_all_sharded", "ShardedStep",
           "init_sharded_state"]
