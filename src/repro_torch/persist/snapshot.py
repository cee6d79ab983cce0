"""Durable snapshots + recovery for the port's streaming distributed index.

Built on the atomic checkpoint layout (``repro_torch.checkpoint``:
manifest + round-robin shard files + ``LATEST`` pointer, committed by a
single rename) through ``checkpoint.load``, because a snapshot's row
count is data-dependent (no fixed template tree).  The files are the JAX
reference's: a snapshot either side wrote restores on the other.

What a snapshot holds -- LIVE rows only, so every snapshot is compacted
by construction (tombstones never reach disk):

  * the flat live-row store: x, packed H buckets (uint32), gid, table id
    and the shard-count-independent routing Key per row, in CSR lex
    order with each row's bucket span (schema 2);
  * the canonical stacked hash parameters of all T tables (the packing
    words as uint32) and the stacked per-table offset base keys + the
    root base key (uint32 pairs, jax's key layout);
  * the ``LSHConfig``, the ``_next_gid`` allocator, K, the store's
    per-shard capacity and the merge counter (in the manifest's
    ``extra``), so post-restore streaming inserts never reuse a gid.

Elastic restore: hash params and the routing Key are independent of the
shard count, so ``restore(dir, n_shards=S')`` re-routes every row as
``Key mod S'`` WITHOUT re-hashing and agrees bit for bit with a fresh
S'-shard index holding the same live rows (tested).

Recovery: ``recover`` = restore the latest snapshot + replay the WAL
tail in order.  Replay is idempotent -- an insert batch whose gids are
already live is skipped (per gid), so a crash anywhere between WAL
append, index apply, snapshot commit and WAL truncate converges to the
uninterrupted store.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import store_layout
from repro_torch.core.config import LSHConfig, Scheme
from repro_torch.core.hashing import StackedHashParams
from repro_torch.core.index import DistributedLSHIndex
from repro_torch.persist.wal import OP_INSERT, WriteAheadLog

# schema 2: rows are persisted in CSR lex (table, packed hi, packed lo)
# order with their bucket offsets (rows_bucket_start/rows_bucket_end) and
# a "layout" manifest entry; schema-1 snapshots (slot order, no offsets)
# restore identically -- load_rows re-sorts and re-derives the CSR either
# way
_SCHEMA = 2
_PARAM_FIELDS = ("A", "b", "alpha", "beta", "alpha_cauchy", "pack_mult",
                 "pack_add")
# the packing words hold uint32 values (int64 in the port's tensors); the
# rest of the parameters are float32
_UINT32_FIELDS = ("pack_mult", "pack_add")


def wal_path(snap_dir: str) -> str:
    """The WAL file that rides alongside a snapshot directory."""
    return os.path.join(snap_dir, "wal.log")


def has_snapshot(snap_dir: str) -> bool:
    return checkpoint.latest_step(snap_dir) is not None


def _config_to_dict(cfg: LSHConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["scheme"] = cfg.scheme.value
    return d


def _config_from_dict(d: dict) -> LSHConfig:
    d = dict(d)
    d["scheme"] = Scheme(d["scheme"])
    return LSHConfig(**d)


def _leaf(by_path: dict, name: str) -> np.ndarray:
    """Find a flat-dict leaf by its key, in either key-path string form
    ("['name']", or a bare "name")."""
    for p, v in by_path.items():
        if p == name or f"'{name}'" in p:
            return v
    raise KeyError(f"snapshot missing leaf {name!r} (have {list(by_path)})")


def _u32(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of uint32 values -> the uint32 array on disk."""
    return t.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Snapshot
# ---------------------------------------------------------------------------

def _fetch_state(index: DistributedLSHIndex) -> dict:
    """Fetch everything a snapshot needs as host numpy copies.

    This is the only part of a snapshot that must run at a consistent
    point in the op stream (between index writes) and the only part that
    touches the index's tensors: the returned dict is self-contained, so
    the file write can happen later on another thread while the index
    keeps mutating.
    """
    sp = index.stacked_params
    return {
        "rows": index.host_live_rows(),
        "params": {f: (_u32(getattr(sp, f)) if f in _UINT32_FIELDS
                       else getattr(sp, f).cpu().numpy().astype(np.float32))
                   for f in _PARAM_FIELDS},
        "k_stacked": _u32(index.stacked_keys),
        "k_base": _u32(index.base_key),
        "config": _config_to_dict(index.cfg),
        "next_gid": int(index._next_gid),
        "k_neighbors": int(index.k_neighbors),
        "store_capacity": int(index.store.capacity) if index.store else 0,
        "merges": int(index._merges),
    }


def _write_state(state: dict, snap_dir: str, *,
                 wal: Optional[WriteAheadLog] = None,
                 wal_upto: Optional[int] = None,
                 step: Optional[int] = None, nshards: int = 4,
                 keep: Optional[int] = 3) -> str:
    """Write a fetched state dict to disk (pure file work, no index
    access -- safe on a background thread).  ``wal_upto`` limits the
    post-commit WAL truncate to the records the fetch covered; None
    means a full reset (the synchronous path)."""
    # rows go to disk in CSR lex order with their bucket offsets, so a
    # snapshot IS a sorted store image
    rows = state["rows"]
    order = store_layout.sort_order(rows["table"], rows["packed"])
    rows = {k: v[order] for k, v in rows.items()}
    bs, be = store_layout.bucket_spans(rows["table"], rows["packed"])
    tree = {f"rows_{k}": v for k, v in rows.items()}
    tree["rows_bucket_start"] = bs
    tree["rows_bucket_end"] = be
    tree.update({f"p_{f}": v for f, v in state["params"].items()})
    tree["k_stacked"] = state["k_stacked"]
    tree["k_base"] = state["k_base"]
    extra = {
        "schema": _SCHEMA,
        "kind": "lsh-index-snapshot",
        "config": state["config"],
        "next_gid": state["next_gid"],
        "n_live_rows": int(rows["gid"].shape[0]),
        "k_neighbors": state["k_neighbors"],
        # the live store's per-shard reservation: restore defaults to it
        # (scaled across shard counts) so WAL replay after a crash can't
        # hit append-region overflow the original stream did not
        "store_capacity": state["store_capacity"],
        "layout": {"sorted": True, "merges": state["merges"]},
    }
    if step is None:
        step = (checkpoint.latest_step(snap_dir) or 0) + 1
    path = checkpoint.save(snap_dir, step, tree, extra=extra,
                           nshards=nshards)
    if wal is not None:
        wal.truncate(upto_seq=wal_upto)
    if keep is not None:
        checkpoint.prune_old(snap_dir, keep=keep)
    return path


def snapshot(index: DistributedLSHIndex, snap_dir: str, *,
             wal: Optional[WriteAheadLog] = None,
             step: Optional[int] = None, nshards: int = 4,
             keep: Optional[int] = 3) -> str:
    """Write a durable, compacted snapshot of the live index state.

    If a ``wal`` is given it is truncated AFTER the snapshot commits
    (rename + LATEST pointer), so a crash between the two leaves a WAL
    tail whose replay is idempotent, never a hole.  The newest ``keep``
    step directories are retained and older ones removed (``keep=None``
    disables pruning).  Returns the step directory path.
    """
    return _write_state(_fetch_state(index), snap_dir, wal=wal,
                        step=step, nshards=nshards, keep=keep)


class SnapshotWriter:
    """Background snapshot writer: non-blocking durability for serving.

    ``submit`` fetches the index state on the CALLER's thread (the
    consistent point in the op stream, and the one thread that may touch
    the index's tensors; the fetched arrays are host copies) and hands
    the file write -- shard files, manifest rename, WAL truncate, pruning
    -- to a daemon thread.  At most one write is in flight: a submit that
    arrives while one is running is skipped (returns None, counted)
    unless ``wait=True``, which joins the previous write first.  The WAL
    truncate is bounded to the records the fetch covered
    (``truncate(upto_seq=...)``), so appends landing during the write
    survive for the next recovery.

    ``join`` (call it on shutdown) waits for the in-flight write and
    re-raises any error the writer thread hit.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.written = 0
        self.skipped = 0

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, index: DistributedLSHIndex, snap_dir: str, *,
               wal: Optional[WriteAheadLog] = None, wait: bool = False,
               nshards: int = 4, keep: Optional[int] = 3
               ) -> Optional[str]:
        """Start a background snapshot; returns the target step path, or
        None if skipped because one is already in flight."""
        if self.in_flight:
            if not wait:
                self.skipped += 1
                return None
            self._thread.join()
        if self._thread is not None:
            self._thread.join()          # reap the finished writer
            self._thread = None
        if self._error is not None:      # surface the previous failure
            err, self._error = self._error, None
            raise err
        state = _fetch_state(index)
        # the records the fetch covers: appends after this point must
        # survive the post-commit truncate
        wal_upto = wal.n_records if wal is not None else None
        step = (checkpoint.latest_step(snap_dir) or 0) + 1
        path = os.path.join(snap_dir, f"step_{step}")

        def work():
            try:
                _write_state(state, snap_dir, wal=wal, wal_upto=wal_upto,
                             step=step, nshards=nshards, keep=keep)
            except BaseException as exc:   # noqa: BLE001 -- re-raised
                self._error = exc          # on join()/next submit()
        self._thread = threading.Thread(target=work, daemon=True,
                                        name="lsh-snapshot-writer")
        self._thread.start()
        self.written += 1
        return path

    def join(self) -> None:
        """Wait for the in-flight write; re-raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    close = join


# ---------------------------------------------------------------------------
# Restore (optionally elastic: n_shards != the saved shard count)
# ---------------------------------------------------------------------------

def _stacked_params_from_leaves(by_path: dict, device) -> StackedHashParams:
    """The saved parameters (uint32 packing words) as the port's tensors."""
    out = {}
    for f in _PARAM_FIELDS:
        a = np.asarray(_leaf(by_path, f"p_{f}"))
        a = (a.astype(np.uint32).astype(np.int64) if f in _UINT32_FIELDS
             else a.astype(np.float32))
        out[f] = torch.as_tensor(a, device=device)
    return StackedHashParams(**out)


def _key_tensor(a, device) -> torch.Tensor:
    """A saved uint32 key (pair or stack of pairs) -> the port's int64."""
    a = np.asarray(a).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(a, device=device)


def restore(snap_dir: str, *, device=None, n_shards: Optional[int] = None,
            step: Optional[int] = None, k_neighbors: Optional[int] = None,
            slack: float = 4.0, capacity: Optional[int] = None,
            ) -> DistributedLSHIndex:
    """Rebuild a live index from the latest (or given) snapshot.

    ``device`` is the index's (``cuda`` unless given).  ``n_shards``
    defaults to the saved shard count; when it differs, the stored rows
    are re-routed host-side as ``Key mod n_shards`` -- no re-hashing, and
    exact agreement with a fresh index of that shard count.
    ``capacity`` pre-reserves per-shard rows; it defaults to the saved
    reservation scaled by the shard counts (the total is kept).
    """
    by_path, step, extra = checkpoint.load(snap_dir, step=step)
    if extra.get("kind") != "lsh-index-snapshot":
        raise ValueError(f"{snap_dir} step_{step} is not an index snapshot")
    cfg = _config_from_dict(extra["config"])
    S_saved = cfg.n_shards
    S = n_shards if n_shards is not None else S_saved
    if S != cfg.n_shards:
        cfg = dataclasses.replace(cfg, n_shards=S)
    if k_neighbors is None:
        k_neighbors = int(extra.get("k_neighbors", 1))
    if capacity is None and extra.get("store_capacity"):
        capacity = int(math.ceil(
            int(extra["store_capacity"]) * S_saved / S))

    index = DistributedLSHIndex(cfg, device=device, slack=slack,
                                k_neighbors=k_neighbors)
    # install the SAVED parameters before the rows (the setters refuse a
    # populated index); they equal the freshly sampled ones for an
    # untouched seed, but survive custom parameter assignments
    index.stacked_params = _stacked_params_from_leaves(by_path,
                                                       index.device)
    index.stacked_keys = _key_tensor(_leaf(by_path, "k_stacked"),
                                     index.device)
    index.base_key = _key_tensor(_leaf(by_path, "k_base"), index.device)

    rows = {k: np.asarray(_leaf(by_path, f"rows_{k}"))
            for k in ("x", "packed", "gid", "table", "key")}
    index.load_rows(rows, capacity=capacity)
    index._next_gid = int(extra["next_gid"])
    index._merges = int(extra.get("layout", {}).get("merges", 0))
    return index


# ---------------------------------------------------------------------------
# Recover: restore + idempotent WAL replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoverResult:
    index: DistributedLSHIndex
    service: Optional[object]     # ShardedLSHService when requested
    wal: WriteAheadLog            # open handle, ready for further appends
    step: int                     # snapshot step restored
    replayed_inserts: int         # insert batches applied from the tail
    replayed_deletes: int         # delete batches applied from the tail
    replayed_points: int          # points inserted by replay
    skipped_points: int           # points skipped as already live
    #                               (idempotence: crash between snapshot
    #                               commit and WAL truncate)


def recover(snap_dir: str, *, device=None, n_shards: Optional[int] = None,
            k_neighbors: Optional[int] = None, slack: float = 4.0,
            capacity: Optional[int] = None,
            service: Optional[dict] = None) -> RecoverResult:
    """Restore the latest snapshot, then replay the WAL tail in order.

    Converges to the uninterrupted store from a crash at ANY point: an
    appended-but-unapplied batch is replayed; an applied-and-snapshotted
    batch whose truncate was lost is skipped per gid (inserts) or a
    no-op (deletes); replay preserves log order, so insert/delete
    interleavings resolve exactly as they originally did.

    ``service``: optional kwargs dict -- when given, a
    ``ShardedLSHService`` is built around the restored index with the
    WAL attached, and the tail is replayed THROUGH it (so ServiceStats
    counts the replayed writes); the service is returned ready to serve.
    """
    index = restore(snap_dir, device=device, n_shards=n_shards,
                    k_neighbors=k_neighbors, slack=slack,
                    capacity=capacity)
    step = checkpoint.latest_step(snap_dir)
    wal = WriteAheadLog(wal_path(snap_dir))

    svc = None
    if service is not None:
        from repro_torch.serving.service import ShardedLSHService
        svc = ShardedLSHService(index, wal=wal, **service)

    def apply_insert(points, gids):
        if svc is not None:
            svc.insert(points, gids=gids)
        else:
            index.insert(points, gids=gids)

    def apply_delete(gids):
        if svc is not None:
            svc.delete(gids)
        else:
            index.delete(gids)

    # live-gid set for idempotent replay: only gid and valid come back
    # from the device (not the store that restore just pushed)
    st = index.store
    live = set(st.gid[st.valid].unique().cpu().tolist())
    n_ins = n_del = n_pts = n_skip = 0
    if svc is not None:
        svc._replaying = True
    try:
        for rec in wal.records():
            if rec.op == OP_INSERT:
                fresh = np.array([int(g) not in live for g in rec.gids],
                                 bool)
                if fresh.any():
                    apply_insert(rec.points[fresh], rec.gids[fresh])
                    n_pts += int(fresh.sum())
                n_skip += int((~fresh).sum())
                n_ins += 1
                live.update(int(g) for g in rec.gids)
                if len(rec.gids):
                    # even a fully-skipped batch must advance the
                    # allocator past its gids (no reuse after restart)
                    index._next_gid = max(index._next_gid,
                                          int(rec.gids.max()) + 1)
            else:
                apply_delete(rec.gids)
                n_del += 1
                live.difference_update(int(g) for g in rec.gids)
    finally:
        if svc is not None:
            svc._replaying = False
    if index._drops:
        # replay overflowed a capacity the original stream did not:
        # returning would hand back an index that lost rows while
        # claiming to have converged -- fail loudly instead
        raise RuntimeError(
            f"WAL replay dropped {index._drops} rows (append-region "
            f"overflow on the restored store, capacity "
            f"{index.store.capacity}/shard); re-run recover() with an "
            f"explicit capacity= matching the pre-crash reservation")
    return RecoverResult(index=index, service=svc, wal=wal, step=step,
                         replayed_inserts=n_ins, replayed_deletes=n_del,
                         replayed_points=n_pts, skipped_points=n_skip)
