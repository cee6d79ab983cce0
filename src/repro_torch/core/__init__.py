"""Core distributed LSH (the paper's contribution), on torch.

  config       -- LSHConfig, Scheme, the paper's theoretical bounds
  prng         -- jax-compatible threefry2x32 (keys, split, fold_in, draws)
  hashing      -- p-stable first layer H, second layer G (+ Sum/Cauchy)
  offsets      -- Entropy-LSH sphere-surface query offsets
  store_layout -- host-side CSR bucket layout of the sorted region
  index        -- the sharded index, S shards as a leading tensor axis
"""
from repro_torch.core.config import (LSHConfig, Scheme,
                                     collision_probability, p_collision)
from repro_torch.core.index import DistributedLSHIndex, QueryResult

__all__ = ["LSHConfig", "Scheme", "collision_probability", "p_collision",
           "DistributedLSHIndex", "QueryResult"]
