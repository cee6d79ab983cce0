"""Atomic, sharded checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (latest_step, load, prune_old,
                                               restore, save)

__all__ = ["latest_step", "load", "prune_old", "restore", "save"]
