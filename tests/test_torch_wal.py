"""The port's WriteAheadLog: the reference's unit cases, and its files.

Pure host-side file-format tests (no index, no subprocess) -- the
crash-consistency semantics the recovery path builds on, as
``tests/test_wal.py`` holds the reference to them:

  * append -> replay round-trips batches bit-for-bit, in order;
  * a torn trailing write (partial frame) is dropped on replay and
    CLIPPED on reopen, so post-crash appends stay reachable;
  * CRC failures stop replay at the corrupt frame;
  * truncate atomically resets the log and the sequence numbers;
  * group commit fsyncs no later than every N appends / M ms (whichever
    first), plus on sync_now/truncate/close, while append stays
    flush-to-OS (process-crash durable) in between;
  * truncate(upto_seq=...) keeps later records VERBATIM with their
    original seqs (the background-snapshot form).
"""
import os

import numpy as np
import pytest

from repro_torch.persist import (OP_DELETE, OP_INSERT, WriteAheadLog,
                                 iter_records)


@pytest.fixture
def fsync_count(monkeypatch):
    """Count os.fsync calls (the group-commit durability points)."""
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd),
                                                 real(fd))[1])
    return calls


@pytest.fixture
def wal_file(tmp_path):
    return str(tmp_path / "wal.log")


def test_append_replay_roundtrip(wal_file):
    w = WriteAheadLog(wal_file)
    pts = np.arange(12, dtype=np.float32).reshape(3, 4)
    gids = np.array([5, 6, 7], np.int64)
    assert w.append_insert(gids, pts) == 0
    assert w.append_delete(np.array([6], np.int64)) == 1
    assert w.append_insert(gids + 10, pts * 2.0) == 2
    w.close()

    recs = list(iter_records(wal_file))
    assert [r.op for r in recs] == [OP_INSERT, OP_DELETE, OP_INSERT]
    assert [r.seq for r in recs] == [0, 1, 2]
    np.testing.assert_array_equal(recs[0].gids, gids)
    np.testing.assert_array_equal(recs[0].points, pts)
    assert recs[1].points is None
    np.testing.assert_array_equal(recs[1].gids, [6])
    np.testing.assert_array_equal(recs[2].points, pts * 2.0)


def test_reopen_continues_sequence(wal_file):
    w = WriteAheadLog(wal_file)
    w.append_insert([1], np.zeros((1, 2), np.float32))
    w.close()
    w2 = WriteAheadLog(wal_file)
    assert w2.n_records == 1
    assert w2.append_delete([1]) == 1
    w2.close()
    assert [r.seq for r in iter_records(wal_file)] == [0, 1]


def test_torn_tail_dropped_and_clipped(wal_file):
    w = WriteAheadLog(wal_file)
    w.append_insert([1, 2], np.ones((2, 3), np.float32))
    w.append_insert([3, 4], np.ones((2, 3), np.float32))
    w.close()
    size = os.path.getsize(wal_file)
    with open(wal_file, "r+b") as f:
        f.truncate(size - 5)                     # torn mid-payload
    assert [r.seq for r in iter_records(wal_file)] == [0]

    # reopen clips the torn bytes, so a post-crash append is replayable
    w2 = WriteAheadLog(wal_file)
    assert w2.n_records == 1
    w2.append_delete([2])
    w2.close()
    recs = list(iter_records(wal_file))
    assert [(r.op, r.seq) for r in recs] == [(OP_INSERT, 0), (OP_DELETE, 1)]


def test_crc_corruption_stops_replay(wal_file):
    w = WriteAheadLog(wal_file)
    w.append_insert([1], np.ones((1, 2), np.float32))
    first_len = os.path.getsize(wal_file)
    w.append_insert([2], np.ones((1, 2), np.float32))
    w.close()
    with open(wal_file, "r+b") as f:
        f.seek(first_len + 25)                   # inside record 2's bytes
        f.write(b"\xff")
    assert [r.seq for r in iter_records(wal_file)] == [0]


def test_truncate_resets(wal_file):
    w = WriteAheadLog(wal_file)
    w.append_insert([1], np.ones((1, 2), np.float32))
    w.truncate()
    assert w.n_records == 0
    assert list(iter_records(wal_file)) == []
    assert w.append_delete([1]) == 0             # sequence restarts
    w.close()
    assert [r.op for r in iter_records(wal_file)] == [OP_DELETE]


def test_empty_and_missing_log(tmp_path):
    assert list(iter_records(str(tmp_path / "nope.log"))) == []
    w = WriteAheadLog(str(tmp_path / "empty.log"))
    assert w.n_records == 0 and list(w.records()) == []
    w.close()


def test_group_commit_n_batches_fsyncs(wal_file, fsync_count):
    w = WriteAheadLog(wal_file, group_commit_n=3)
    for _ in range(7):
        w.append_delete([1])
    assert len(fsync_count) == 2            # after appends 3 and 6
    w.sync_now()                            # closes the open window (1)
    assert len(fsync_count) == 3
    w.sync_now()                            # nothing unsynced: no-op
    assert len(fsync_count) == 3
    w.append_delete([2])
    w.close()                               # open window flushed at close
    assert len(fsync_count) == 4
    assert [r.seq for r in iter_records(wal_file)] == list(range(8))


def test_group_commit_ms_window(wal_file, fsync_count):
    t = [0.0]
    w = WriteAheadLog(wal_file, group_commit_ms=50.0, clock=lambda: t[0])
    w.append_delete([1])                    # 0ms since last sync
    assert len(fsync_count) == 0
    t[0] = 0.049
    w.append_delete([2])                    # still inside the window
    assert len(fsync_count) == 0
    t[0] = 0.051
    w.append_delete([3])                    # window expired -> fsync
    assert len(fsync_count) == 1
    t[0] = 0.09
    w.append_delete([4])                    # new window from 0.051
    assert len(fsync_count) == 1
    w.close()
    assert len(fsync_count) == 2


def test_group_commit_validation(wal_file):
    with pytest.raises(ValueError, match="group_commit_n"):
        WriteAheadLog(wal_file, group_commit_n=0)
    with pytest.raises(ValueError, match="group_commit_ms"):
        WriteAheadLog(wal_file, group_commit_ms=-1.0)
    w = WriteAheadLog(wal_file)             # no group commit: plain close
    w.append_delete([1])
    w.close()


def test_partial_truncate_keeps_later_records(wal_file):
    """truncate(upto_seq=k) drops seq < k and keeps the rest verbatim --
    the background-snapshot form (appends landed while it wrote)."""
    w = WriteAheadLog(wal_file)
    pts = np.arange(6, dtype=np.float32).reshape(3, 2)
    for i in range(3):
        w.append_insert([10 + i], pts[i:i + 1])
    upto = w.n_records                      # snapshot covered seqs 0-2
    w.append_insert([13], pts[:1])          # lands "during the write"
    w.append_delete([10])
    w.truncate(upto_seq=upto)
    assert w.n_records == 5                 # sequence does NOT restart
    recs = list(w.records())
    assert [(r.op, r.seq) for r in recs] == [(OP_INSERT, 3), (OP_DELETE, 4)]
    np.testing.assert_array_equal(recs[0].gids, [13])
    np.testing.assert_array_equal(recs[0].points, pts[:1])
    w.append_delete([13])                   # continues at seq 5
    w.close()
    assert [r.seq for r in iter_records(wal_file)] == [3, 4, 5]

    # reopen after a partial truncate: sequence continues, replay sees
    # exactly the preserved tail
    w2 = WriteAheadLog(wal_file)
    assert w2.n_records == 6
    assert w2.append_delete([99]) == 6
    w2.close()
    assert [r.seq for r in iter_records(wal_file)] == [3, 4, 5, 6]


def test_partial_truncate_past_end_empties(wal_file):
    w = WriteAheadLog(wal_file)
    w.append_delete([1])
    w.truncate(upto_seq=10)                 # covered everything
    assert list(w.records()) == []
    assert w.append_delete([2]) == 1        # allocator keeps counting
    w.close()


# ---------------------------------------------------------------------
# Against the reference's WriteAheadLog
# ---------------------------------------------------------------------

def _stream(wal_cls, path, wal_kw):
    """One sequence of appends and truncates; returns the seqs."""
    rng = np.random.default_rng(3)
    w = wal_cls(path, **wal_kw)
    seqs = []
    for i in range(6):
        n = int(rng.integers(0, 5))
        gids = rng.integers(0, 2 ** 40, n)
        if i % 3 == 2:
            seqs.append(w.append_delete(gids))
        else:
            pts = rng.standard_normal((n, 7)).astype(np.float32)
            seqs.append(w.append_insert(gids, pts))
        if i == 3:
            w.truncate(upto_seq=2)
    w.close()
    w = wal_cls(path, **wal_kw)             # reopen continues the seqs
    seqs.append(w.append_delete([1, 2, 3]))
    w.close()
    return seqs


@pytest.mark.parametrize("wal_kw", [{}, {"sync": True},
                                    {"group_commit_n": 2}])
def test_same_appends_write_the_reference_bytes(tmp_path, wal_kw):
    from repro.persist import wal as ref_wal
    ours, theirs = str(tmp_path / "port.log"), str(tmp_path / "ref.log")
    assert (_stream(WriteAheadLog, ours, wal_kw)
            == _stream(ref_wal.WriteAheadLog, theirs, wal_kw))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read() and len(data) > 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_side_replays_the_others_log(tmp_path, writer):
    from repro.persist import wal as ref_wal
    path = str(tmp_path / "wal.log")
    w_cls, r_iter = ((WriteAheadLog, ref_wal.iter_records)
                     if writer == "port"
                     else (ref_wal.WriteAheadLog, iter_records))
    _stream(w_cls, path, {})
    own = list((iter_records if writer == "port"
                else ref_wal.iter_records)(path))
    other = list(r_iter(path))
    assert [(r.op, r.seq) for r in own] == [(r.op, r.seq) for r in other]
    assert len(own) == 5
    for a, b in zip(own, other):
        np.testing.assert_array_equal(a.gids, b.gids)
        if a.points is None:
            assert b.points is None
        else:
            assert a.points.tobytes() == b.points.tobytes()
