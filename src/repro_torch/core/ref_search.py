"""Brute-force reference search: exact NN / top-K ground truth for tests
and recall@K measurement.

Squared distances are |q|^2 + |p|^2 - 2 q.p (clamped at 0) with the
product q.p from one ``torch.matmul`` per chunk of points, always in
IEEE float32 (``ieee_float32``: TF32 off for the call, whatever the
process set).  Top-K order is (dist, id) lex order, taken exactly on
``kernels/ref.py``'s int64 lex keys, so ties break on the lower id as in
the reference.  Inputs may be numpy arrays or tensors; ``device=None``
is the card (``resolve_device``), answers come back as numpy arrays (distances rooted there, as the
reference roots them).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.index import resolve_device
from repro_torch.kernels.ref import lex_key, lex_unkey, merge_lex_topk

IMAX = np.iinfo(np.int32).max


@contextlib.contextmanager
def ieee_float32():
    """float32 products in IEEE float32 inside the block: no TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def as_f32(x, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x, dtype=np.float32)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=torch.float32)


def sq_dists(queries: torch.Tensor, q_sq: torch.Tensor,
             chunk: torch.Tensor) -> torch.Tensor:
    """(m, B) squared distances of queries (m, d) with norms q_sq (m,)
    to the points of chunk (B, d), clamped at 0."""
    with ieee_float32():
        prod = queries @ chunk.T
    d2 = q_sq[:, None] + torch.sum(chunk ** 2, dim=-1)[None, :] - 2.0 * prod
    return torch.clamp_min(d2, 0.0)


def pad_key(device, pad_d: float = float("inf")) -> torch.Tensor:
    """The lex key of the padding pair (pad_d, IMAX)."""
    return lex_key(torch.tensor(pad_d, device=device),
                   torch.tensor(IMAX, device=device))


def topk_sort(d: torch.Tensor, g: torch.Tensor, k: int,
              pad_d: float = float("inf")
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, c) masked (dist, id) pairs -> the k best per row in (dist, id)
    lex order, padded with (pad_d, IMAX) when c < k.  Distances are
    non-negative (or +inf) and ids non-negative, the domain of every
    top-K path: there the int64 lex key orders exactly like the pair."""
    keys = lex_key(d.to(torch.float32), g)
    if keys.shape[1] < k:
        pad = pad_key(d.device, pad_d).expand(keys.shape[0],
                                              k - keys.shape[1])
        keys = torch.cat([keys, pad], dim=1)
    return lex_unkey(merge_lex_topk(keys, k))


def topk_merge_host(best, arg, cand_d, cand_g
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Merge a running (m, k) top-K with (m, c) new candidates, in (dist,
    id) lex order (the chunked scan's accumulator step); numpy out."""
    k = best.shape[1]
    d = torch.cat([torch.tensor(np.asarray(best, np.float32)),
                   torch.tensor(np.asarray(cand_d, np.float32))], dim=1)
    g = torch.cat([torch.tensor(np.asarray(arg, np.int32)),
                   torch.tensor(np.asarray(cand_g, np.int32))], dim=1)
    sd, sg = topk_sort(d, g, k)
    return sd.numpy(), sg.numpy()


def nearest_neighbor(data, queries, chunk: int = 8192, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Exact NN: (dist, idx) arrays of shape (m,); the first of tied
    points wins."""
    dev = resolve_device(device)
    q = as_f32(queries, dev)
    q_sq = torch.sum(q ** 2, dim=-1)
    best = torch.full((q.shape[0],), float("inf"), device=dev)
    arg = torch.zeros((q.shape[0],), dtype=torch.int64, device=dev)
    n = data.shape[0]
    for s in range(0, n, chunk):
        d2 = sq_dists(q, q_sq, as_f32(data[s:min(n, s + chunk)], dev))
        a = torch.argmin(d2, dim=1)
        m2 = torch.gather(d2, 1, a[:, None])[:, 0]
        upd = m2 < best
        best = torch.where(upd, m2, best)
        arg = torch.where(upd, a + s, arg)
    return np.sqrt(best.cpu().numpy()), arg.cpu().numpy()


def nearest_neighbors(data, queries, k: int, chunk: int = 8192,
                      device=None) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-K NN in (dist, idx) lex order: (m, k) float32 dist and
    int32 idx arrays (inf / IMAX padded when the dataset has fewer than k
    points) -- the recall@K ground truth."""
    dev = resolve_device(device)
    q = as_f32(queries, dev)
    q_sq = torch.sum(q ** 2, dim=-1)
    best = pad_key(dev).expand(q.shape[0], k)
    n = data.shape[0]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = sq_dists(q, q_sq, as_f32(data[s:e], dev))
        gid = torch.arange(s, e, dtype=torch.int32, device=dev)
        best = merge_lex_topk(
            torch.cat([best, lex_key(d2, gid.expand_as(d2))], dim=1), k)
    d2, gid = lex_unkey(best)
    return np.sqrt(d2.cpu().numpy()), gid.cpu().numpy()
