"""Core distributed LSH (the paper's contribution), on torch.

  config       -- LSHConfig, Scheme, the paper's theoretical bounds
  prng         -- jax-compatible threefry2x32 (keys, split, fold_in, draws)
  hashing      -- p-stable first layer H, second layer G (+ Sum/Cauchy)
  offsets      -- Entropy-LSH sphere-surface query offsets
  multiprobe   -- Multi-Probe LSH query-directed probes
  accounting   -- TrafficReport: shuffle rows/bytes and load balance
  simulate     -- analytic traffic / load-balance / recall accounting
  ref_search   -- brute-force oracle
  store_layout -- host-side CSR bucket layout of the sorted region
  index        -- the sharded index, S shards as a leading tensor axis
"""
from repro_torch.core.config import (LSHConfig, Scheme,
                                     collision_probability, p_collision)
from repro_torch.core.hashing import (HashParams, StackedHashParams, g_of,
                                      gamma, gh, hash_h, pack_buckets,
                                      sample_params, sample_stacked_params,
                                      sample_table_params, shard_key,
                                      shard_of, table_key)
from repro_torch.core.offsets import (batch_query_offsets, query_offsets,
                                      query_offsets_by_table,
                                      stacked_base_keys, table_base_key)
from repro_torch.core.accounting import (COLLECTIVES_PER_INSERT,
                                         COLLECTIVES_PER_QUERY,
                                         TrafficReport)
from repro_torch.core.index import (DispatchedBatch, DistributedLSHIndex,
                                    QueryResult, ScannedBatch,
                                    first_occurrence_mask)
from repro_torch.core.simulate import (StreamReport, lsh_topk_reference,
                                       recall_at_k, simulate,
                                       simulate_stream)
from repro_torch.core.ref_search import nearest_neighbor, nearest_neighbors

__all__ = [
    "LSHConfig", "Scheme", "collision_probability", "p_collision",
    "HashParams", "StackedHashParams", "gamma", "gh", "g_of", "hash_h",
    "pack_buckets", "sample_params", "sample_stacked_params",
    "sample_table_params", "table_key", "shard_key", "shard_of",
    "batch_query_offsets", "query_offsets", "query_offsets_by_table",
    "stacked_base_keys", "table_base_key",
    "TrafficReport", "COLLECTIVES_PER_INSERT", "COLLECTIVES_PER_QUERY",
    "simulate", "StreamReport", "simulate_stream",
    "lsh_topk_reference", "recall_at_k",
    "nearest_neighbor", "nearest_neighbors",
    "DistributedLSHIndex", "first_occurrence_mask", "QueryResult",
    "DispatchedBatch", "ScannedBatch",
]
