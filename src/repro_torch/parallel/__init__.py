"""Parallelism of the port: DVFS plan transfer across DP/TP meshes and
chip models.  The sharding rules and collectives come with the port's
``torch.distributed`` meshes (ROADMAP item 11)."""
from .plan_transfer import (transfer_train_bundle, transfer_serve_plan,
                            compare_transfer, TransferRow)

__all__ = ["transfer_train_bundle", "transfer_serve_plan",
           "compare_transfer", "TransferRow"]
