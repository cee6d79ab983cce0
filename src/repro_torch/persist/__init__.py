"""Durability control plane for the port's streaming LSH index.

  snapshot -- atomic, compacted-by-construction full-state snapshot
  restore  -- rebuild a live index from a snapshot, elastically onto any
              shard count (rows re-route as Key mod S', no re-hashing)
  recover  -- restore + idempotent WAL-tail replay (crash convergence)
  WriteAheadLog -- framed, CRC-checked append-before-apply batch log

Snapshots and logs are the JAX reference's files: either side restores
and replays the other's.
"""
from repro_torch.persist.snapshot import (RecoverResult, SnapshotWriter,
                                          has_snapshot, recover, restore,
                                          snapshot, wal_path)
from repro_torch.persist.wal import (OP_DELETE, OP_INSERT, WalRecord,
                                     WriteAheadLog, iter_records)

__all__ = ["snapshot", "restore", "recover", "RecoverResult",
           "has_snapshot", "wal_path", "SnapshotWriter", "WriteAheadLog",
           "WalRecord", "iter_records", "OP_INSERT", "OP_DELETE"]
