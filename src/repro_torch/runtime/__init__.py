"""The fault-tolerant training step loop (the reference's ``runtime``)."""
from repro_torch.runtime.loop import FaultConfig, LoopStats, WorkerFailure, run

__all__ = ["FaultConfig", "LoopStats", "WorkerFailure", "run"]
