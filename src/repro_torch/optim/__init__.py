"""AdamW with its schedule and clip, and int8 error-feedback gradient
compression, as functions on trees of tensors (the reference's ``optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, global_norm, init,
                                     schedule, update)
from repro_torch.optim import compression

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "schedule",
           "update", "compression"]
