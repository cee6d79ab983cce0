"""Retrieval serving path: LM embeddings + the paper's distributed LSH.

The paper's workload with the model zoo as the feature extractor:
  index build: embed documents -> DistributedLSHIndex.build (one routed
               row per doc and table);
  streaming:   embed new documents -> ShardedLSHService.insert (or the
               pipelined AsyncLSHService);
  query:       embed queries -> ShardedLSHService micro-batch -> entropy
               offsets -> Layered-LSH route -> per-shard bucket search
               -> (c,r)-NN results.

Embeddings are mean-pooled final hidden states, l2-normalised (the
paper's unit-norm setting).  The S shards are a leading tensor axis on
one device, so ``build`` takes ``n_shards`` and ``device`` where the
reference takes a mesh.  ``recover_or_build`` is the durable entry
point: a warm restart from a snapshot directory (restore + WAL replay),
or a cold build that writes the boot snapshot and attaches the WAL.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, hidden_states
from repro_torch.serving.service import ShardedLSHService
from repro_torch.serving.workers import AsyncLSHService, AsyncWrite


# documents embedded per forward: the reference embeds a whole corpus in
# one call, which at gemma-7b's width would hold tens of GB of MLP
# activations; 64 documents of 128 tokens fill the card's products
EMBED_BATCH = 64


@torch.no_grad()
def embed_texts(model: Transformer, tokens) -> torch.Tensor:
    """Mean-pooled last hidden state, unit norm, float32: tokens (B, S)
    -> (B, d) on the model's device, embedded EMBED_BATCH rows at a
    time."""
    dev = model.embed_table.device
    tokens = torch.as_tensor(tokens, device=dev)
    out = []
    for i in range(0, tokens.shape[0], EMBED_BATCH):
        x = hidden_states(model, tokens[i:i + EMBED_BATCH])
        out.append(x.mean(dim=1).float())
    pooled = torch.cat(out) if out else torch.empty(
        (0, model.cfg.d_model), device=dev)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp_min(norm, 1e-9)


@dataclasses.dataclass
class RetrievalService:
    """End-to-end embed -> route -> search service on one device."""
    cfg: ModelConfig
    lsh: LSHConfig
    model: Transformer
    index: DistributedLSHIndex
    service: "ShardedLSHService | AsyncLSHService"

    @classmethod
    def build(cls, cfg: ModelConfig, model: Transformer, doc_tokens, *,
              n_shards: int = 8, device=None, r: float = 0.25,
              c: float = 2.0, k: int = 10, L: int = 16, W: float = 1.0,
              scheme: Scheme = Scheme.LAYERED, seed: int = 0,
              bucket_size: int = 64, max_latency_ms: float = 25.0,
              k_neighbors: int = 1, n_tables: int = 1,
              pipelined: bool = False, slack: float = 4.0):
        """Embed ``doc_tokens`` and build the index over them.  ``device``
        is the index's (``cuda`` unless given); the model stays where it
        is.  ``slack`` is the index's capacity headroom over an even
        share of the shards (``DistributedLSHIndex``'s); at ``n_shards``
        no skew of the embeddings can overflow a shard.

        pipelined=True serves through ``AsyncLSHService`` (the pipelined
        query path + an engine thread, bitwise-identical answers); the
        default stays the synchronous micro-batcher."""
        docs = embed_texts(model, doc_tokens)
        lsh = LSHConfig(d=int(docs.shape[1]), k=k, W=W, r=r, c=c, L=L,
                        n_shards=n_shards, scheme=scheme, seed=seed,
                        n_tables=n_tables)
        index = DistributedLSHIndex(lsh, device=device, slack=slack,
                                    k_neighbors=k_neighbors)
        index.build(docs)
        front = AsyncLSHService if pipelined else ShardedLSHService
        service = front(index, bucket_size=bucket_size,
                        max_latency_ms=max_latency_ms,
                        k_neighbors=k_neighbors)
        return cls(cfg=cfg, lsh=lsh, model=model, index=index,
                   service=service)

    @classmethod
    def recover_or_build(cls, cfg: ModelConfig, model: Transformer,
                         doc_tokens, *, snapshot_dir: "str | None" = None,
                         n_shards: int = 8, device=None,
                         bucket_size: int = 64,
                         max_latency_ms: float = 25.0,
                         k_neighbors: int = 1, pipelined: bool = False,
                         **build_kwargs):
        """The durable entry point of ``launch/serve.py``.

        With a ``snapshot_dir`` holding a snapshot: warm-restart (restore
        at ``n_shards`` + WAL-tail replay through a WAL-attached service)
        and skip the embed and build entirely.  Otherwise build fresh
        from ``doc_tokens`` and, when a ``snapshot_dir`` is given, attach
        a WriteAheadLog and write the boot snapshot so the service is
        recoverable from its first streamed write.  Returns ``(service,
        RecoverResult | None)`` -- None on a cold build.
        """
        from repro_torch import persist
        if snapshot_dir and persist.has_snapshot(snapshot_dir):
            rr = persist.recover(
                snapshot_dir, device=device, n_shards=n_shards,
                slack=build_kwargs.get("slack", 4.0),
                service=dict(bucket_size=bucket_size,
                             max_latency_ms=max_latency_ms,
                             k_neighbors=k_neighbors))
            # a warm restart keeps the SNAPSHOT's LSHConfig (stored rows
            # were hashed under it); surface any build kwarg the caller
            # changed since, instead of silently serving the old config
            drift = {
                kw: (v, getattr(rr.index.cfg, kw))
                for kw, v in build_kwargs.items()
                if hasattr(rr.index.cfg, kw)
                and getattr(rr.index.cfg, kw) != v}
            if drift:
                import warnings
                changed = {k: f"{want} (snapshot: {have})"
                           for k, (want, have) in drift.items()}
                warnings.warn(
                    f"warm restart from {snapshot_dir} keeps the "
                    f"snapshot's LSH config; ignoring changed flags "
                    f"{changed} -- rebuild without --snapshot-dir (or a "
                    f"fresh dir) to apply them", stacklevel=2)
            service = rr.service
            if pipelined:
                # replay ran through the recovered synchronous service;
                # serve through the pipelined front-end from here on,
                # carrying its stats (replay counts) and WAL
                service = AsyncLSHService(
                    rr.index, bucket_size=bucket_size,
                    max_latency_ms=max_latency_ms,
                    k_neighbors=k_neighbors, wal=rr.wal,
                    stats=rr.service.stats)
            svc = cls(cfg=cfg, lsh=rr.index.cfg, model=model,
                      index=rr.index, service=service)
            return svc, rr
        svc = cls.build(cfg, model, doc_tokens, n_shards=n_shards,
                        device=device, bucket_size=bucket_size,
                        max_latency_ms=max_latency_ms,
                        k_neighbors=k_neighbors, pipelined=pipelined,
                        **build_kwargs)
        if snapshot_dir:
            svc.service.wal = persist.WriteAheadLog(
                persist.wal_path(snapshot_dir))
            persist.snapshot(svc.index, snapshot_dir, wal=svc.service.wal)
        return svc, None

    def insert_docs(self, doc_tokens) -> np.ndarray:
        """Embed and stream new documents into the index; returns gids."""
        if doc_tokens.shape[0] == 0:
            return np.empty((0,), np.int64)
        docs = embed_texts(self.model, doc_tokens)
        res = self.service.insert(docs)
        if isinstance(res, AsyncWrite):
            res = res.result()       # pipelined front-end returns a future
        if res.drops:
            # dropped rows are not the trailing ones, so the gid->doc
            # attribution below would silently lie -- refuse instead
            raise RuntimeError(
                f"insert overflow: {res.drops} of {docs.shape[0]} docs "
                f"dropped (store capacity {res.capacity}/shard)")
        return np.arange(res.gid_start, res.gid_start + res.n_inserted)

    def query(self, query_tokens) -> tuple[np.ndarray, np.ndarray, list]:
        """Embed a batch of queries and answer through the micro-batcher.

        Returns (b, K) top-K gid and distance arrays (K = the service's
        k_neighbors; column 0 is the best candidate) plus the handles.
        """
        q = embed_texts(self.model, query_tokens)
        handles = self.service.submit_batch(q.cpu().numpy())
        self.service.drain()
        gids = np.stack([h.gids for h in handles])
        dists = np.stack([h.dists for h in handles])
        return gids, dists, handles

    def close(self) -> None:
        """Drain and stop a pipelined service (no-op for the sync one)."""
        if isinstance(self.service, AsyncLSHService):
            self.service.close()
