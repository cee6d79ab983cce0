"""Serving front-ends over the port's index."""
from repro_torch.serving.service import (PendingQuery, ServiceStats,
                                         ShardedLSHService)

__all__ = ["PendingQuery", "ServiceStats", "ShardedLSHService"]
