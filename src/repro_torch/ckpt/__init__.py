from .checkpoint import CheckpointManager
from .elastic import reshard_restore

__all__ = ["CheckpointManager", "reshard_restore"]
