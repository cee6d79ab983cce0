"""Deterministic, resumable, sharded token pipeline for LM training (the
reference's ``data/pipeline.py``).

The iterator state is a tiny ``PipelineState`` (seed + step) saved in
every checkpoint, so a restart resumes the exact batch sequence; each
data-parallel shard derives its stream from (seed, shard_id).  Batch t is
``jax.random.categorical`` under ``fold_in(fold_in(PRNGKey(seed),
shard_id), t)`` over a zipfian unigram: the argmax over the vocab of the
logits plus Gumbel noise, drawn with the port's jax-compatible threefry
(``core/prng.py``), so the tokens are the reference's bit for bit.  The
draws are made on the pipeline's device, one batch row at a time (a
batch is batch x (seq + 1) x vocab draws).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.index import resolve_device


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class TokenPipeline:
    """Synthetic LM token stream (zipfian unigram) on ``device`` (``cuda``
    unless given).

    Produces (tokens, labels) int64 tensors of shape (batch, seq).
    Deterministic in (seed, step, shard): batch b at step t is identical
    across restarts, and equal to the reference's.
    """

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, n_shards: int = 1, shard_id: int = 0,
                 device=None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.device = resolve_device(device)
        self.state = PipelineState(seed=seed, step=0)
        # zipfian unigram distribution over the vocab
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._logits = torch.from_numpy(
            np.log(p / p.sum()).astype(np.float32)).to(self.device)

    def _batch_at(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        key = prng.PRNGKey(self.state.seed).to(self.device)
        key = prng.fold_in(prng.fold_in(key, self.shard_id), step)
        cols = self.seq_len + 1
        shape = (self.batch, cols, self.vocab_size)
        row = cols * self.vocab_size
        toks = torch.empty((self.batch, cols), dtype=torch.int64,
                           device=self.device)
        for r in range(self.batch):
            g = prng.gumbel(key, shape, start=r * row, count=row)
            # argmax takes the first of equal maxima, as jnp.argmax does
            toks[r] = torch.argmax(g.view(cols, self.vocab_size)
                                   + self._logits, dim=-1)
        return toks[:, :-1], toks[:, 1:]

    def __next__(self):
        out = self._batch_at(self.state.step)
        self.state.step += 1
        return out

    def __iter__(self):
        return self

    def restore(self, state: PipelineState):
        self.state = state
