"""Serving front-ends over the port's index: the micro-batching service,
the pipelined async service, and the retrieval service that embeds with
the model zoo."""
from repro_torch.serving.pipeline import QueryPipeline
from repro_torch.serving.retrieval import RetrievalService, embed_texts
from repro_torch.serving.service import (PendingQuery, ServiceStats,
                                         ShardedLSHService)
from repro_torch.serving.workers import (AdmissionFull, AsyncLSHService,
                                         AsyncQuery, AsyncWrite)

__all__ = ["RetrievalService", "embed_texts", "ShardedLSHService",
           "ServiceStats", "PendingQuery", "QueryPipeline",
           "AsyncLSHService", "AsyncQuery", "AsyncWrite",
           "AdmissionFull"]
