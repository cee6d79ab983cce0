"""Typed call surface for the bucket-search kernels.

A ``QueryBatch`` bundles the received query rows, a ``StoreView`` the
stored rows plus the optional CSR layout.  Every tensor may carry leading
batch dimensions -- the index passes all S shards at once, as a leading
shard axis, and one kernel launch covers them all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed pairwise tree: (x0 + x1) + (x2 + x3) ...,
    level by level, zero-padded to an even length at each level.  Every
    add is one rounded elementwise op, so the result depends on nothing
    but the values along ``dim`` -- not on the tensor's shape, how a
    library reduction would split it, or the device.  The same point
    rounds alike when it is inserted and when the store is rebuilt, and
    dispatch and receive side hash an offset alike."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded as IEEE has it, on every device: taken
    in float64 and rounded once (exact for a square root, 53 >= 2 x 24 + 2
    bits).  torch's float32 ``sqrt`` on the card is an ulp off the CPU's
    for some inputs."""
    return torch.sqrt(x.double()).float()


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared norms over the last axis (``tree_sum`` of the squares)."""
    x = x.to(torch.float32)
    return tree_sum(x * x, -1)


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """Received query rows, ready for the bucket scan.

    buckets holds the packed (hi, lo) words of each of the L probed
    offset buckets as their int32 bit patterns, flattened to 2*L words
    per row.
    """

    q: torch.Tensor        # (..., R, d) float32 query rows
    qsq: torch.Tensor      # (..., R) float32 squared norms
    buckets: torch.Tensor  # (..., R, 2*L) int32 packed probe buckets
    probe: torch.Tensor    # (..., R, L) int32 0/1 -- probe this bucket?
    table: torch.Tensor    # (..., R) int32 table id each row probes

    @classmethod
    def build(cls, q, buckets, probe, table=None) -> "QueryBatch":
        """Computes qsq; table defaults to 0."""
        if table is None:
            table = torch.zeros(q.shape[:-1], dtype=torch.int32,
                                device=q.device)
        return cls(q=q, qsq=sq_norms(q),
                   buckets=buckets, probe=probe, table=table)


@dataclasses.dataclass(frozen=True)
class StoreView:
    """Stored rows as the kernels see them.

    Rows ``[0, n_sorted)`` are sorted by (table, packed hi, packed lo) as
    uint32, with per-row CSR spans: ``bucket_start[i]``/``bucket_end[i]``
    delimit row i's own bucket.  Rows ``[n_sorted, N)`` are the unsorted
    insert tail.  ``n_sorted == 0`` marks a fully unsorted store.
    """

    points: torch.Tensor   # (..., N, d) float32 stored points
    psq: torch.Tensor      # (..., N) float32 squared norms
    buckets: torch.Tensor  # (..., N, 2) int32 packed H bucket per row
    gid: torch.Tensor      # (..., N) int32 global ids (IMAX = empty)
    valid: torch.Tensor    # (..., N) int32 0/1 liveness
    table: torch.Tensor    # (..., N) int32 table id per row
    bucket_start: Optional[torch.Tensor] = None  # (..., N) int32 span start
    bucket_end: Optional[torch.Tensor] = None    # (..., N) int32 span end
    n_sorted: int = 0      # rows [0, n_sorted) are bucket-sorted

    @classmethod
    def build(cls, points, buckets, gid, valid, table=None,
              bucket_start=None, bucket_end=None,
              n_sorted: int = 0) -> "StoreView":
        """Computes psq; table defaults to 0."""
        if table is None:
            table = torch.zeros(points.shape[:-1], dtype=torch.int32,
                                device=points.device)
        return cls(points=points,
                   psq=sq_norms(points),
                   buckets=buckets, gid=gid, valid=valid, table=table,
                   bucket_start=bucket_start, bucket_end=bucket_end,
                   n_sorted=n_sorted)
