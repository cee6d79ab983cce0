"""Configuration for distributed LSH (paper: Bahmani, Goel, Shinde 2012).

A copy of the reference package's plain-Python config (the port imports
nothing of it).

All parameters follow the paper's notation:
  d  -- data dimensionality
  k  -- number of concatenated first-layer hashes  (H = (h_1..h_k))
  W  -- first-layer bin width                      (h(v) = floor((a.v+b)/W))
  r  -- near-neighbour radius   (paper scales so r = 1/c)
  c  -- approximation ratio     ((c,r)-NN problem)
  L  -- number of entropy-LSH query offsets
  D  -- second-layer bin width  (G(v) = floor((alpha.v+beta)/D));
        Corollary 12 chooses D = Theta(sqrt(k))
  T  -- number of independent hash tables (``n_tables``); the classic
        multi-table union recall lever.  Each table samples its own
        (A, b, alpha, beta) from a split key; the fused index hosts all
        T tables behind ONE collective per phase.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class Scheme(str, enum.Enum):
    """Bucket -> machine placement schemes.

    SIMPLE  -- uniform hash of the H-bucket (the paper's baseline, Fig 3.1)
    LAYERED -- the paper's contribution: G(H(.)) with Gaussian G (Fig 3.2)
    SUM     -- Haghani et al. (EDBT'09): sum of bucket coordinates
    CAUCHY  -- Haghani et al.: 1-stable (Cauchy) projection of the bucket
    """

    SIMPLE = "simple"
    LAYERED = "layered"
    SUM = "sum"
    CAUCHY = "cauchy"


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    d: int
    k: int
    W: float
    r: float
    c: float
    L: int
    n_shards: int
    scheme: Scheme = Scheme.LAYERED
    D: Optional[float] = None  # default Theta(sqrt(k)) per Corollary 12
    seed: int = 0
    # Number of independent hash tables fused into one index.  Table 0
    # uses the same parameter/offset derivation as a single-table config
    # (T=1 reproduces single-table results bit-for-bit); tables are a
    # nested prefix sequence, so raising T only adds candidates.
    n_tables: int = 1
    # Probe generation: "entropy" = Panigrahy sphere offsets (the paper's
    # default); "mplsh" = Multi-Probe query-directed probing (Lv et al.;
    # the paper uses it as the first layer for Wiki, section 4.2). For
    # mplsh, L counts probes beyond the home bucket.
    probes: str = "entropy"
    # Static routing capacities for the TPU all_to_all implementation.
    # ``None`` -> derived from the theoretical bounds (Theorem 8).
    query_capacity: Optional[int] = None
    data_capacity: Optional[int] = None

    def __post_init__(self):
        if self.D is None:
            object.__setattr__(self, "D", math.sqrt(self.k))
        if self.c <= 1:
            raise ValueError("approximation ratio c must be > 1")
        if self.L < 1 or self.k < 1 or self.n_shards < 1:
            raise ValueError("L, k, n_shards must be >= 1")
        if self.n_tables < 1:
            raise ValueError("n_tables must be >= 1")

    # ------------------------------------------------------------------
    # Theoretical quantities from the paper, used for capacity sizing and
    # property tests.
    # ------------------------------------------------------------------
    def fq_bound(self) -> float:
        """Theorem 8 w.h.p. bound on distinct (Key,Value) pairs per query:

            f_q <= 2 (1 + 4/(cW)) k / D + 1
        """
        return 2.0 * (1.0 + 4.0 / (self.c * self.W)) * self.k / self.D + 1.0

    def pairs_per_query(self) -> float:
        """Expected routed rows per query under each scheme, summed over
        the T fused tables (each table ships its own distinct Keys).

        SIMPLE ships one row per *distinct H bucket* which is at most L;
        LAYERED ships f_q = O(k/D) rows (Theorem 8).  SUM/CAUCHY behave
        like LAYERED for capacity purposes (they also coalesce nearby
        buckets) but carry no w.h.p. guarantee -- we provision them at the
        SIMPLE level to be safe.
        """
        if self.scheme == Scheme.LAYERED:
            return self.n_tables * min(float(self.L), self.fq_bound())
        return self.n_tables * float(self.L)


def p_collision(z: float) -> float:
    """P(z) = erf(z) - (1 - e^{-z^2}) / (sqrt(pi) z)   (paper eq. 3.8).

    Pr[G(u) = G(v)] = P(D / (sqrt(2) * ||u-v||))  (Lemma 10).
    """
    if z <= 0:
        return 0.0
    return math.erf(z) - (1.0 - math.exp(-z * z)) / (math.sqrt(math.pi) * z)


def collision_probability(distance: float, D: float) -> float:
    """Lemma 10 collision probability for the second-layer LSH G."""
    if distance == 0:
        return 1.0
    return p_collision(D / (math.sqrt(2.0) * distance))
