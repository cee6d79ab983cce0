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
from repro_torch.core.hashing import (HashParams, StackedHashParams, g_of,
                                      gamma, hash_h, pack_buckets,
                                      sample_params, sample_stacked_params,
                                      shard_key, shard_of, table_key)
from repro_torch.core.offsets import (query_offsets, query_offsets_by_table,
                                      stacked_base_keys)
from repro_torch.core.index import (DispatchedBatch, DistributedLSHIndex,
                                    QueryResult, ScannedBatch,
                                    first_occurrence_mask)

__all__ = [
    "LSHConfig", "Scheme", "collision_probability", "p_collision",
    "HashParams", "StackedHashParams", "gamma", "g_of", "hash_h",
    "pack_buckets", "sample_params", "sample_stacked_params", "table_key",
    "shard_key", "shard_of",
    "query_offsets", "query_offsets_by_table", "stacked_base_keys",
    "DistributedLSHIndex", "first_occurrence_mask", "QueryResult",
    "DispatchedBatch", "ScannedBatch",
]
