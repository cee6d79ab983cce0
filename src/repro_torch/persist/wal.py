"""Write-ahead log for the streaming LSH index.

One append-only binary file of framed records.  Each record is an
insert/delete BATCH (the index applies a batch as one step, so batch
framing is exactly the crash-consistency unit):

    header:  magic u32 | op u8 | n u32 | d u32 | seq u64 | crc u32
    payload: gids (n x int64) [+ points (n x d x float32) for inserts]

(The JAX reference's format, byte for byte: the same appends give the
same file on either side, and each side replays the other's.)

``crc`` is the CRC-32 of the header prefix plus the payload, so a torn
tail (the process died mid-``write``) is detected and dropped on replay
instead of corrupting recovery -- everything BEFORE the torn record is
still replayed.  The durability contract is therefore:

  * ``append_*`` returned -> the batch survives a crash (it will be
    replayed by ``persist.recover``);
  * crash mid-append -> the batch is dropped cleanly (it was never
    applied either, since appends happen BEFORE the index apply).

``truncate()`` atomically resets the log to empty (tmp file + rename);
``persist.snapshot`` calls it AFTER the snapshot commit, so a crash
between the two just leaves a tail whose replay is idempotent.
``truncate(upto_seq=...)`` drops only the records a snapshot covered,
preserving (with their original seq numbers) records appended while a
BACKGROUND snapshot was writing.

Group commit: ``WriteAheadLog(group_commit_n=..., group_commit_ms=...)``
batches fsyncs across appends -- ``append_*`` still returns only after
the frame reached the OS (process-crash durable, append-before-apply
unchanged), and the file is fsynced (power-fail durable) no later than
every ``group_commit_n`` appends or ``group_commit_ms`` milliseconds,
whichever comes first, plus on ``sync_now``/``truncate``/``close``.
``sync=True`` remains fsync-per-append.  All mutators take an internal
lock, so a serving engine thread and a background snapshot writer can
share one log.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

import numpy as np

_MAGIC = 0x57414C31          # "WAL1"
_HEADER = struct.Struct("<IBIIQ")   # magic, op, n, d, seq
_CRC = struct.Struct("<I")

OP_INSERT = 1
OP_DELETE = 2


@dataclasses.dataclass
class WalRecord:
    op: int                   # OP_INSERT or OP_DELETE
    seq: int                  # monotonically increasing per log
    gids: np.ndarray          # (n,) int64
    points: Optional[np.ndarray]   # (n, d) float32 for inserts, else None


def _frame(op: int, seq: int, gids: np.ndarray,
           points: Optional[np.ndarray]) -> bytes:
    gids = np.ascontiguousarray(gids, np.int64)
    n = int(gids.shape[0])
    d = 0
    payload = gids.tobytes()
    if op == OP_INSERT:
        points = np.ascontiguousarray(points, np.float32)
        if points.shape[0] != n:
            raise ValueError(f"gids ({n}) / points ({points.shape[0]}) "
                             f"length mismatch")
        d = int(points.shape[1])
        payload += points.tobytes()
    head = _HEADER.pack(_MAGIC, op, n, d, seq)
    crc = zlib.crc32(payload, zlib.crc32(head))
    return head + _CRC.pack(crc) + payload


class WriteAheadLog:
    """Append-only framed batch log (see module docstring for format)."""

    def __init__(self, path: str, sync: bool = False,
                 group_commit_n: Optional[int] = None,
                 group_commit_ms: Optional[float] = None,
                 clock=time.monotonic):
        """sync=True fsyncs after every append (true power-fail
        durability); the default flushes to the OS only, which survives
        process crashes -- the regime the tests exercise.

        group_commit_n / group_commit_ms bound how many appends / how
        much time may pass between fsyncs (either alone works; together
        the first bound hit triggers the sync).  clock is the monotonic
        time source for the ms window (injectable for tests).
        """
        if group_commit_n is not None and group_commit_n < 1:
            raise ValueError(f"group_commit_n={group_commit_n} must be >= 1")
        if group_commit_ms is not None and group_commit_ms < 0:
            raise ValueError(
                f"group_commit_ms={group_commit_ms} must be >= 0")
        self.path = path
        self.sync = sync
        self.group_commit_n = group_commit_n
        self.group_commit_ms = group_commit_ms
        self._clock = clock
        self._lock = threading.RLock()
        self._unsynced = 0
        self._last_sync = clock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # continue the sequence after the last intact record, and CLIP any
        # torn tail first: appending after garbage bytes would strand the
        # new records behind the frame replay stops at
        end, self._seq = _intact_prefix(path)
        if os.path.exists(path) and os.path.getsize(path) > end:
            with open(path, "r+b") as f:
                f.truncate(end)
        self._f = open(path, "ab")

    def append_insert(self, gids, points) -> int:
        return self._append(OP_INSERT, gids, np.asarray(points, np.float32))

    def append_delete(self, gids) -> int:
        return self._append(OP_DELETE, gids, None)

    def _append(self, op: int, gids, points) -> int:
        with self._lock:
            seq = self._seq
            self._f.write(_frame(op, seq, np.asarray(gids, np.int64),
                                 points))
            self._f.flush()
            self._unsynced += 1
            if self.sync or self._group_window_hit():
                self._fsync_locked()
            self._seq += 1
            return seq

    def _group_window_hit(self) -> bool:
        n, ms = self.group_commit_n, self.group_commit_ms
        if n is None and ms is None:
            return False
        if n is not None and self._unsynced >= n:
            return True
        return (ms is not None
                and (self._clock() - self._last_sync) * 1e3 >= ms)

    def _fsync_locked(self) -> None:
        os.fsync(self._f.fileno())
        self._unsynced = 0
        self._last_sync = self._clock()

    def sync_now(self) -> None:
        """Force pending appends to disk (closes the group window)."""
        with self._lock:
            if self._unsynced:
                self._f.flush()
                self._fsync_locked()

    def truncate(self, upto_seq: Optional[int] = None) -> None:
        """Atomically drop records the snapshot covered (post-commit).

        With no argument: full reset to an empty log, sequence restarts
        at 0.  With ``upto_seq``: drop only records with seq < upto_seq
        and keep the rest VERBATIM (original seq numbers) -- the form a
        background snapshot uses, since appends may have landed while it
        was writing and those must survive for the next recovery.
        """
        with self._lock:
            self._f.flush()
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                if upto_seq is not None:
                    for rec in iter_records(self.path):
                        if rec.seq >= upto_seq:
                            f.write(_frame(rec.op, rec.seq, rec.gids,
                                           rec.points))
                f.flush()
                if self.sync or self.group_commit_n is not None \
                        or self.group_commit_ms is not None:
                    os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            if upto_seq is None:
                self._seq = 0
            self._unsynced = 0
            self._last_sync = self._clock()

    def records(self) -> Iterator[WalRecord]:
        """Replay every intact record (the torn tail, if any, is dropped)."""
        with self._lock:
            self._f.flush()
        return iter_records(self.path)

    @property
    def n_records(self) -> int:
        return self._seq

    def close(self) -> None:
        with self._lock:
            if not self._f.closed and self._unsynced \
                    and (self.group_commit_n is not None
                         or self.group_commit_ms is not None):
                # an open group window must not lose its durability
                # promise at shutdown
                self._f.flush()
                self._fsync_locked()
            self._f.close()


def _intact_prefix(path: str) -> tuple[int, int]:
    """(byte length of the intact record prefix, next sequence number)."""
    end, seq = 0, 0
    if not os.path.exists(path):
        return end, seq
    with open(path, "rb") as f:
        for rec in _read_records(f):
            end, seq = f.tell(), rec.seq + 1
    return end, seq


def iter_records(path: str) -> Iterator[WalRecord]:
    """Yield intact records from a WAL file; stop at the first torn or
    corrupt frame (crash-consistency: a partial trailing write must not
    abort recovery of everything before it)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        yield from _read_records(f)


def _read_records(f) -> Iterator[WalRecord]:
    while True:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            return                       # clean EOF or torn header
        magic, op, n, d, seq = _HEADER.unpack(head)
        if magic != _MAGIC or op not in (OP_INSERT, OP_DELETE):
            return                       # corrupt frame: stop replay
        crc_bytes = f.read(_CRC.size)
        if len(crc_bytes) < _CRC.size:
            return
        (crc,) = _CRC.unpack(crc_bytes)
        nbytes = 8 * n + (4 * n * d if op == OP_INSERT else 0)
        payload = f.read(nbytes)
        if len(payload) < nbytes:
            return                       # torn payload
        if zlib.crc32(payload, zlib.crc32(head)) != crc:
            return                       # bit rot / torn overwrite
        gids = np.frombuffer(payload[:8 * n], np.int64)
        points = None
        if op == OP_INSERT:
            points = np.frombuffer(payload[8 * n:], np.float32)
            points = points.reshape(n, d)
        yield WalRecord(op=op, seq=seq, gids=gids, points=points)
