"""Network-traffic and load-balance accounting.

The paper's two figures of merit (section 1.1):
  * total network traffic  -- MapReduce shuffle size / number of DHT calls;
    here: routed (Key, Value) rows and their wire bytes,
  * maximum per-machine load -- "curse of the last reducer";
    here: max rows received by any shard.

The index's exchange is a fixed-capacity all-to-all, so we track BOTH the
live rows (the paper's metric, what an elastic fabric would ship) and the
capacity bytes (what the static dense collective ships).  Plain numpy: a
report of the port reads as one of the reference, field for field.

Multi-table fusion (``LSHConfig.n_tables`` = T > 1) adds a third axis:
rows split per table (the naive "T independent indexes" implementation
would ship the same rows through T separate collectives), while the
fused index issues a CONSTANT number of collectives per phase --
``COLLECTIVES_PER_INSERT`` and ``COLLECTIVES_PER_QUERY`` below,
independent of T (asserted by a compiled-trace test).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Cross-shard collectives issued by one fused step, independent of the
# table count T (the naive multi-table implementation pays T x these):
#   insert: 1 fused all_to_all  ([x | packed | gid | table] payload)
#   query:  1 fused dispatch all_to_all + 1 routed return all_to_all
#           (the return collective replaced all_gather + psum)
COLLECTIVES_PER_INSERT = 1
COLLECTIVES_PER_QUERY = 2


@dataclasses.dataclass
class TrafficReport:
    scheme: str
    n_shards: int
    # ---- query-phase shuffle (the paper's headline metric) ----
    query_rows: int            # total live (Key, Value) pairs for all queries
    query_bytes: int           # query_rows * row_bytes
    fq_mean: float             # mean distinct Keys per query  (Definition 7,
    #                            summed over the T fused tables)
    fq_max: int                # max over queries
    fq_bound: float            # Theorem 8 w.h.p. bound (for LAYERED,
    #                            PER TABLE -- multiply by n_tables for the
    #                            fused per-query bound)
    # ---- index build shuffle (n_tables rows per data point) ----
    data_rows: int
    data_bytes: int
    # ---- load balance (Table 1) ----
    data_load_avg: float       # avg data rows per shard
    data_load_max: int         # max data rows on any shard
    query_load_avg: float
    query_load_max: int
    # ---- static-collective view (the dense exchange) ----
    capacity_rows: Optional[int] = None   # rows the dense all_to_all ships
    capacity_bytes: Optional[int] = None
    overflow_drops: int = 0               # rows beyond capacity (must be 0)
    # ---- quality ----
    recall: Optional[float] = None
    results_emitted: Optional[int] = None
    recall_at_k: Optional[float] = None   # |LSH topK ∩ exact topK| / K
    k_neighbors: Optional[int] = None     # the K recall_at_k was run at
    # ---- multi-table fusion ----
    n_tables: int = 1
    query_rows_by_table: Optional[tuple] = None   # (T,) live rows per table
    data_rows_by_table: Optional[tuple] = None    # (T,) stored rows per table
    collectives_insert: int = COLLECTIVES_PER_INSERT   # per fused step,
    collectives_query: int = COLLECTIVES_PER_QUERY     # independent of T

    def summary(self) -> str:
        lines = [
            f"scheme={self.scheme} shards={self.n_shards}"
            + (f" tables={self.n_tables}" if self.n_tables > 1 else ""),
            f"  query shuffle: rows={self.query_rows} bytes={self.query_bytes}"
            f" f_q mean={self.fq_mean:.2f} max={self.fq_max}"
            f" (thm8 bound {self.fq_bound:.2f}/table)",
            f"  data  shuffle: rows={self.data_rows} bytes={self.data_bytes}",
            f"  load balance: data avg={self.data_load_avg:.1f}"
            f" max={self.data_load_max}"
            f" | query avg={self.query_load_avg:.1f} max={self.query_load_max}",
        ]
        if self.n_tables > 1 and self.query_rows_by_table is not None:
            per_t = ",".join(str(r) for r in self.query_rows_by_table)
            lines.append(
                f"  per-table query rows: [{per_t}] fused into"
                f" {self.collectives_query} collectives/step"
                f" (naive: {self.n_tables * self.collectives_query})")
        if self.capacity_bytes is not None:
            lines.append(
                f"  static a2a: rows={self.capacity_rows}"
                f" bytes={self.capacity_bytes} drops={self.overflow_drops}")
        if self.recall is not None:
            lines.append(f"  recall={self.recall:.3f}"
                         f" emitted={self.results_emitted}")
        if self.recall_at_k is not None:
            lines.append(f"  recall@{self.k_neighbors}={self.recall_at_k:.3f}")
        return "\n".join(lines)


def load_stats(loads: np.ndarray) -> tuple[float, int]:
    return float(np.mean(loads)), int(np.max(loads))


def query_row_bytes(d: int, n_tables: int = 1) -> int:
    """Logical bytes of one routed query row: the d-dim float32 point +
    an int32 global id, plus an int32 table tag when multiple tables are
    fused.  NOTE this is the paper's (Key, Value)-pair accounting, kept
    comparable with the paper figures and prior baselines: the fused
    implementation physically ships the table column even at n_tables=1
    (one constant int32 the logical metric deliberately ignores; the
    static-collective ``capacity_bytes`` view is where implementation
    padding belongs)."""
    return 4 * (d + 1) + (4 if n_tables > 1 else 0)


def data_row_bytes(d: int, n_tables: int = 1) -> int:
    """Logical bytes of one routed data row <H(p), p>: point + packed
    bucket (2x uint32) + id, plus an int32 table tag when multiple
    tables are fused (same single-table convention as
    ``query_row_bytes``)."""
    return 4 * d + 8 + 4 + (4 if n_tables > 1 else 0)
