"""Host-side CSR bucket layout for the sorted store region.

One place owns the sort order and the CSR construction so that every
path that materialises a sorted store -- ``load_rows`` (and through it
snapshots, elastic restore, and ``compact()``) plus the benchmarks and
tests -- agrees exactly with what ``kernels.ops.csr_probe_spans``
binary-searches over:

  lex order   (table asc, packed hi asc, packed lo asc), hi/lo compared
              as uint32 (the packed words are universal-hash outputs;
              the routing Key plays no part in the order)
  CSR spans   per ROW, not per bucket: ``bucket_start[i]``/``bucket_end``
              [i] delimit the row range of row i's own bucket, so a
              probe that binary-searches to any row of its bucket reads
              the span straight off that row
  sentinels   unused slots inside the sorted region carry table = IMAX,
              packed = 0xFFFFFFFF -- they sort after every real row (no
              real table id reaches IMAX), keeping the search valid at
              full region width on every shard

All numpy, all host-side: this runs in ``load_rows`` next to the
routing pass, never on the device.
"""
from __future__ import annotations

import numpy as np

IMAX = np.iinfo(np.int32).max
SENTINEL_PACKED = np.uint32(0xFFFFFFFF)


def sort_order(table: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """Permutation sorting rows by (table, packed hi, packed lo).

    ``packed`` is (n, 2) uint32; the sort is stable so equal-bucket rows
    keep their relative (insertion) order.
    """
    hi = packed[:, 0].astype(np.uint32)
    lo = packed[:, 1].astype(np.uint32)
    return np.lexsort((lo, hi, table))


def bucket_spans(table: np.ndarray, packed: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row CSR spans of an ALREADY sorted (table, packed) column pair.

    Returns (bucket_start, bucket_end) int32 arrays of the same length:
    rows sharing one (table, hi, lo) triple all carry that run's
    [first, one-past-last) range.
    """
    n = len(table)
    if n == 0:
        z = np.zeros(0, np.int32)
        return z, z
    hi = packed[:, 0].astype(np.uint32)
    lo = packed[:, 1].astype(np.uint32)
    new_run = np.ones(n, bool)
    new_run[1:] = ((table[1:] != table[:-1]) | (hi[1:] != hi[:-1])
                   | (lo[1:] != lo[:-1]))
    run_id = np.cumsum(new_run) - 1                    # (n,) 0..n_runs-1
    run_start = np.flatnonzero(new_run)                # (n_runs,)
    run_end = np.append(run_start[1:], n)
    return (run_start[run_id].astype(np.int32),
            run_end[run_id].astype(np.int32))


def is_bucket_sorted(table: np.ndarray, packed: np.ndarray) -> bool:
    """True when the rows already follow the CSR lex order."""
    if len(table) < 2:
        return True
    hi = packed[:, 0].astype(np.uint32)
    lo = packed[:, 1].astype(np.uint32)
    # compare adjacent rows lexicographically, table major
    t0, t1 = table[:-1], table[1:]
    h0, h1 = hi[:-1], hi[1:]
    l0, l1 = lo[:-1], lo[1:]
    ok = (t0 < t1) | ((t0 == t1) & ((h0 < h1) | ((h0 == h1) & (l0 <= l1))))
    return bool(np.all(ok))


def bucket_stats(bucket_start: np.ndarray, bucket_end: np.ndarray,
                 n_rows: int) -> tuple[int, float]:
    """(max, mean) bucket occupancy over the first ``n_rows`` REAL rows
    (callers pass the count of non-sentinel rows): the index's layout
    health numbers."""
    if n_rows == 0:
        return 0, 0.0
    sizes = (bucket_end[:n_rows] - bucket_start[:n_rows]).astype(np.int64)
    return int(sizes.max()), float(sizes.mean())
