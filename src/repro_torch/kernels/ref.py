"""Plain PyTorch versions of the bucket-search kernels.

Each function computes exactly what its CUDA kernel computes, with
ordinary tensor operations: the CPU tests run them, and on the card they
are the yardstick each kernel is held against.  The full scan walks the
point axis in chunks and the gather walks span offsets, each carrying a
running top-K, so both also run at the full store size on the card (the
unchunked (R, L, N) match tensor would need gigabytes per shard).

Top-K selection is exact in (dist^2, gid) lex order: a non-negative
float32 orders like its bit pattern, so ``bits(d2) << 32 | gid`` is one
int64 key whose order is the lex order, and ``topk`` on it is exact,
ties included.  Every tensor may carry leading batch (shard) dimensions.
"""
from __future__ import annotations

import math

import torch

F32_MAX = float(torch.finfo(torch.float32).max)
IMAX = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


def lex_key(d2: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(dist^2 >= 0, gid >= 0) -> int64 keys ordered like (dist^2, gid)."""
    hi = d2.contiguous().view(torch.int32).to(torch.int64)
    return (hi << 32) | gid.to(torch.int64)


def lex_unkey(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return d2, (key & _M32).to(torch.int32)


def sentinel_key(device) -> torch.Tensor:
    return lex_key(torch.tensor(F32_MAX, device=device),
                   torch.tensor(IMAX, device=device))


def merge_lex_topk(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of each row, ascending (sentinel-padded)."""
    if keys.shape[-1] < k:
        pad = sentinel_key(keys.device).expand(
            keys.shape[:-1] + (k - keys.shape[-1],))
        keys = torch.cat([keys, pad], dim=-1)
    return torch.topk(keys, k, dim=-1, largest=False, sorted=True).values


def pair_dots(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Dot of every row of q (..., R, d) with every point of p (..., N, d)
    -> (..., R, N), summed in ascending order over d, one rounded multiply
    and one rounded add per term.  ``row_dots`` gives the same value for
    the same pair, so the two plain versions agree bit for bit, on the
    CPU and on the card; a library matmul would pick its own order."""
    acc = q[..., :, None, 0] * p[..., None, :, 0]
    for k in range(1, q.shape[-1]):
        acc = acc + q[..., :, None, k] * p[..., None, :, k]
    return acc


def row_dots(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Dot of each row of q (..., E, d) with the same row of p, in the
    order of ``pair_dots``."""
    acc = q[..., 0] * p[..., 0]
    for k in range(1, q.shape[-1]):
        acc = acc + q[..., k] * p[..., k]
    return acc


def _chunk(n_rows: int, n_points: int) -> int:
    """Point chunk keeping each (rows, chunk) temporary near 2**25."""
    return max(128, min(n_points, (1 << 25) // max(n_rows, 1)))


def bucket_search_ref(*, query, store, cr2: float, L: int, K: int = 1):
    """Masked top-K full scan (plain version of ``bucket_search_cuda``).

    A (row, point) pair is a hit when the point's packed bucket equals
    one of the row's probed buckets, the point is valid and of the row's
    table, and dist^2 = |q|^2 + |p|^2 - 2 q.p (clamped at 0) <= cr2.
    Returns (topd (..., R, K) f32, topg (..., R, K) int32, cnt (..., R)
    int32): the K best hits in (dist^2, gid) lex order, padded with
    (F32_MAX, IMAX), and the number of hits.
    """
    q, p = query.q, store.points
    R, N = q.shape[-2], p.shape[-2]
    batch = q.shape[:-2]
    qb = query.buckets.reshape(batch + (R, L, 2))
    on = query.probe > 0
    best = sentinel_key(q.device).expand(batch + (R, K)).clone()
    cnt = torch.zeros(batch + (R,), dtype=torch.int32, device=q.device)
    step = _chunk(R * math.prod(batch), N)
    for c0 in range(0, N, step):
        c1 = min(N, c0 + step)
        pc = p[..., c0:c1, :]
        d2 = (query.qsq.unsqueeze(-1) + store.psq[..., None, c0:c1]
              - 2.0 * pair_dots(q, pc))
        d2 = torch.clamp_min(d2, 0.0)
        pb = store.buckets[..., c0:c1, :]
        match = torch.zeros(d2.shape, dtype=torch.bool, device=q.device)
        for l in range(L):
            match |= ((qb[..., l, 0, None] == pb[..., None, :, 0])
                      & (qb[..., l, 1, None] == pb[..., None, :, 1])
                      & on[..., l, None])
        match &= store.valid[..., None, c0:c1] > 0
        match &= query.table.unsqueeze(-1) == store.table[..., None, c0:c1]
        hit = match & (d2 <= cr2)
        cnt += hit.sum(dim=-1, dtype=torch.int32)
        keys = torch.where(hit, lex_key(d2, store.gid[..., None, c0:c1]),
                           sentinel_key(q.device))
        best = merge_lex_topk(torch.cat([best, keys], dim=-1), K)
    topd, topg = lex_unkey(best)
    return topd, topg, cnt


def bucket_gather_ref(q, qsq, start, end, p, psq, gid, pvalid,
                      cr2: float, *, K: int):
    """CSR gather (plain version of ``bucket_gather_cuda``).

    Expanded row e (one (query row, probe) pair) hits the points of the
    sorted region whose row index lies in its span [start[e], end[e]),
    that are valid and within dist^2 <= cr2.  q (..., E, d); p (..., N, d).
    Returns (topd, topg, cnt) as ``bucket_search_ref``.
    """
    E, d = q.shape[-2], q.shape[-1]
    batch = q.shape[:-2]
    best = sentinel_key(q.device).expand(batch + (E, K)).clone()
    cnt = torch.zeros(batch + (E,), dtype=torch.int32, device=q.device)
    span = (end - start).to(torch.int64)
    longest = int(span.max()) if span.numel() else 0
    for o in range(longest):
        inside = o < span
        c = torch.where(inside, start.to(torch.int64) + o, 0)
        pc = torch.gather(p, -2, c.unsqueeze(-1).expand(batch + (E, d)))
        take = lambda a: torch.gather(a, -1, c)
        d2 = qsq + take(psq) - 2.0 * row_dots(q, pc)
        d2 = torch.clamp_min(d2, 0.0)
        hit = inside & (take(pvalid) > 0) & (d2 <= cr2)
        cnt += hit.to(torch.int32)
        keys = torch.where(hit, lex_key(d2, take(gid)),
                           sentinel_key(q.device))
        best = merge_lex_topk(torch.cat([best, keys.unsqueeze(-1)], dim=-1),
                              K)
    topd, topg = lex_unkey(best)
    return topd, topg, cnt
