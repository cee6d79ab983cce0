"""Synthetic stand-ins for the paper's three evaluation datasets (§4.1).

  Random -- points ~ N^d(0, 1) (i.e. coordinate sigma = 1/sqrt(d)); each
    query = random data point + N^d(0, r) perturbation.  "Planted": w.h.p.
    the perturbed source is the only point within cr.  Paper: d=100, 1M
    points, 100K queries, r=0.3, c=2.
  Wiki   -- TF-IDF vectors; we synthesise power-law sparse docs projected
    to a dense feature space and l2-normalised.  Paper: r=0.1, c=2.
  Image  -- 64-d color histograms, unit norm.  Paper: r=0.08, c=2.

Every generator is deterministic in (seed, n, d).  ``planted_random``
draws through the jax-compatible PRNG (``core/prng.py``), on the card
unless the caller names a device, and gives the reference's draws
(normals within 2 ulp, the planted ids bitwise); the other two are numpy
``default_rng`` code, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.index import resolve_device


def planted_random(n: int, m: int, d: int = 100, r: float = 0.3,
                   seed: int = 0, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (data (n,d), queries (m,d), planted_idx (m,)) tensors on
    ``device``."""
    dev = resolve_device(device)
    kd, kp, ki = prng.split(prng.PRNGKey(seed).to(dev), 3)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    data = prng.normal(kd, (n, d)) * f32(1.0 / np.sqrt(d))
    idx = prng.randint(ki, (m,), 0, n)
    noise = prng.normal(kp, (m, d)) * f32(r / np.sqrt(d))
    queries = data[idx] + noise
    return data, queries, idx


def tfidf_like(n: int, m: int, d: int = 256, nnz: int = 32,
               seed: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Power-law sparse docs -> dense unit-norm vectors (Wiki stand-in).

    Term frequencies are zipfian (term 0 most common), and IDF weighting
    DOWN-weights the common terms (idf ~ log of inverse document
    frequency, i.e. increasing in rank) -- so documents differentiate on
    their rare terms, like real TF-IDF corpora.
    """
    rng = np.random.default_rng(seed)
    idf = np.log1p(np.arange(1, d + 1)).astype(np.float32)
    docs = np.zeros((n + m, d), np.float32)
    terms = rng.zipf(1.3, size=(n + m, nnz)).clip(1, d) - 1
    tf = rng.exponential(1.0, size=(n + m, nnz)).astype(np.float32)
    for j in range(nnz):
        docs[np.arange(n + m), terms[:, j]] += tf[:, j] * idf[terms[:, j]]
    docs /= np.maximum(np.linalg.norm(docs, axis=1, keepdims=True), 1e-9)
    return docs[:n], docs[n:]


def image_histograms(n: int, m: int, d: int = 64,
                     seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Dirichlet-ish color histograms, unit l2 norm (Tiny-Image stand-in).

    Queries are mild perturbations of data points (near-duplicate search),
    matching the measured 0.08 avg query-NN distance in the paper.
    """
    rng = np.random.default_rng(seed)
    conc = rng.gamma(0.5, 1.0, size=(n, d)).astype(np.float32) + 1e-6
    data = conc / np.linalg.norm(conc, axis=1, keepdims=True)
    src = rng.integers(0, n, size=m)
    noise = rng.normal(0.0, 0.08 / np.sqrt(d), size=(m, d)).astype(np.float32)
    q = data[src] + noise
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    return data, q
