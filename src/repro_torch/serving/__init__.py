"""Serving front-ends over the port's index: the micro-batching service,
and the retrieval service that embeds with the model zoo."""
from repro_torch.serving.retrieval import RetrievalService, embed_texts
from repro_torch.serving.service import (PendingQuery, ServiceStats,
                                         ShardedLSHService)

__all__ = ["PendingQuery", "RetrievalService", "ServiceStats",
           "ShardedLSHService", "embed_texts"]
