"""Training-data near-duplicate detection using the paper's LSH layout --
the classic dedup pipeline as a data pre-pass.

Every example embedding is both a data point and a query; an example is
a duplicate if a *different* example of its bucket lies within radius r.
The buckets are the index's own first layer (``sample_params``,
``hash_h`` through the hash kernel on the card, ``pack_buckets``); the
grouping and the exact distances within a bucket run on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.core.hashing import hash_h, pack_buckets, sample_params
from repro_torch.core.index import resolve_device
from repro_torch.core.ref_search import as_f32


def dedup_embeddings(emb, r: float, k: int = 12, W: float = 0.5,
                     seed: int = 0, chunk: int = 2048,
                     device=None) -> np.ndarray:
    """Returns a boolean keep-mask (first occurrence of each near-dup
    cluster is kept).  ``emb`` (n, d) is a numpy array or a tensor."""
    dev = resolve_device(device)
    x = as_f32(emb, dev)
    emb = emb.cpu().numpy() if torch.is_tensor(emb) else np.asarray(emb)
    n, d = emb.shape
    cfg = LSHConfig(d=d, k=k, W=W, r=r, c=2.0, L=1, n_shards=1,
                    scheme=Scheme.LAYERED, seed=seed)
    params = sample_params(prng.PRNGKey(seed), cfg).to(dev)
    # the int32 bit patterns of the reference's uint32 words
    packed = pack_buckets(params, hash_h(params, x, W)).cpu().numpy()
    packed = packed.view(np.uint32)
    # group by bucket; within a bucket do exact pairwise distance
    order = np.lexsort((packed[:, 1], packed[:, 0]))
    keep = np.ones((n,), bool)
    r2 = r * r
    s = 0
    ps = packed[order]
    while s < n:
        e = s
        while e < n and (ps[e] == ps[s]).all():
            e += 1
        if e - s > 1:
            idx = order[s:e]
            pts = emb[idx]
            d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
            for i in range(len(idx)):
                if not keep[idx[i]]:
                    continue
                dup = (d2[i] <= r2)
                dup[: i + 1] = False
                keep[idx[dup]] = False
        s = e
    return keep
