"""The port's snapshots, elastic restore and recovery, against the reference.

Cross-restore runs one reference subprocess at S = 8 (8 placeholder host
devices): it writes a snapshot of its own index and answers queries on
it, and it restores -- and recovers, WAL tail included -- a snapshot the
port wrote, answering the same queries.  The port restores the
reference's snapshot and must answer as the reference did; the reference
must answer the port's snapshot as the port does.  Tolerance: every
integer is EQUAL (top-K gids in order, hit counts, fq, loads, the
allocator); distances agree within rtol = atol = 1e-5.

In-process, on the port alone (the cases of ``tests/test_persist.py``):
snapshot -> restore at the same S is bitwise and holds live rows only;
elastic restore 8 -> 4, 8 -> 2 and 2 -> 8 is bitwise a fresh S' index
holding the same live rows; recovery from every kill point between WAL
append, apply, snapshot commit and WAL truncate converges to the
uninterrupted store; replayed writes are counted by ServiceStats.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, persist
from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
from repro_torch.serving import ShardedLSHService
from test_torch_cuda import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
N, M, D = 768, 64, 32
K = 5


def make_cfg(S=8, T=2):
    return LSHConfig(d=D, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=S,
                     scheme=Scheme.LAYERED, seed=0, n_tables=T)


def _data():
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
    q = data[rng.integers(0, N, M)] + rng.standard_normal((M, D)).astype(
        np.float32) * np.float32(0.3 / np.sqrt(D))
    return data, q.astype(np.float32)


DATA, QUERIES = _data()
VICTIMS = np.arange(0, N, 5)


def live_rows_sorted(idx):
    rows = idx.host_live_rows()
    order = np.lexsort((rows["table"], rows["gid"]))
    return {k: v[order] for k, v in rows.items()}


def assert_same_store(a, b):
    ra, rb = live_rows_sorted(a), live_rows_sorted(b)
    for k in ("gid", "table", "key", "packed", "x"):
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    np.testing.assert_array_equal(a.shard_load, b.shard_load)
    assert a._next_gid == b._next_gid, (a._next_gid, b._next_gid)


def assert_same_answers(a, b):
    """Bitwise equal query results."""
    np.testing.assert_array_equal(a.topk_gid, b.topk_gid)
    np.testing.assert_array_equal(a.topk_dist.view(np.uint32),
                                  b.topk_dist.view(np.uint32))
    np.testing.assert_array_equal(a.n_within_cr, b.n_within_cr)
    np.testing.assert_array_equal(a.fq, b.fq)
    assert a.drops == b.drops == 0


def _check_like_reference(r, ref, tag):
    np.testing.assert_array_equal(r.topk_gid, ref[tag + "_gid"])
    np.testing.assert_allclose(r.topk_dist, ref[tag + "_dist"], **TOL)
    np.testing.assert_array_equal(r.n_within_cr, ref[tag + "_emit"])
    np.testing.assert_array_equal(r.fq, ref[tag + "_fq"])
    np.testing.assert_array_equal(r.query_load, ref[tag + "_qload"])
    assert r.drops == 0


# ---------------------------------------------------------------------
# Cross-restore with the reference (one subprocess)
# ---------------------------------------------------------------------

_SCRIPT = """
import sys
import numpy as np
from repro.compat import make_mesh
from repro.core import DistributedLSHIndex, LSHConfig, Scheme
from repro import persist

out_dir, ref_snap, port_snap = sys.argv[1:4]
z = np.load(out_dir + "/inputs.npz")
data, queries, victims = z["data"], z["queries"], z["victims"]
mesh = make_mesh((8,), ("shard",))
cfg = LSHConfig(d=data.shape[1], k=8, W=1.2, r=0.3, c=2.0, L=8,
                n_shards=8, scheme=Scheme.LAYERED, seed=0, n_tables=2)
out = {}
def q(tag, idx):
    r = idx.query(queries, k_neighbors=%(K)d)
    out[tag + "_gid"] = r.topk_gid
    out[tag + "_dist"] = r.topk_dist
    out[tag + "_emit"] = r.n_within_cr
    out[tag + "_fq"] = r.fq
    out[tag + "_qload"] = r.query_load
    out[tag + "_load"] = np.asarray(idx.shard_load)
    out[tag + "_next_gid"] = np.int64(idx._next_gid)

idx = DistributedLSHIndex(cfg, mesh, k_neighbors=%(K)d)
idx.build(data)
idx.delete(victims)
q("ref", idx)
persist.snapshot(idx, ref_snap)

r = persist.restore(port_snap, mesh)
assert r.cfg == cfg, r.cfg
q("port_restored", r)
rr = persist.recover(port_snap, mesh)
assert rr.replayed_inserts == 1 and rr.replayed_deletes == 1
q("port_recovered", rr.index)
rr.wal.close()
np.savez(out_dir + "/ref.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port writes a snapshot (+ a WAL tail), the reference writes
    its own and answers both."""
    out = tmp_path_factory.mktemp("persist_cross")
    ref_snap, port_snap = str(out / "ref_snap"), str(out / "port_snap")
    np.savez(out / "inputs.npz", data=DATA, queries=QUERIES,
             victims=VICTIMS)
    # the port's snapshot: its own sampled parameters (not the
    # reference's) -- the reference must restore them from the files
    idx = DistributedLSHIndex(make_cfg(), device="cpu", k_neighbors=K)
    idx.build(DATA)
    idx.delete(VICTIMS)
    wal = persist.WriteAheadLog(persist.wal_path(port_snap))
    persist.snapshot(idx, port_snap, wal=wal)
    port = {"restored": idx.query(QUERIES)}
    svc = ShardedLSHService(idx, bucket_size=64, wal=wal)
    svc.insert(DATA[:40] * np.float32(0.5))
    svc.delete(np.arange(1, 200, 3))
    wal.close()
    port["recovered"] = idx.query(QUERIES)
    port["recovered_next_gid"] = idx._next_gid
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SCRIPT) % {"K": K},
         str(out), ref_snap, port_snap], capture_output=True, text=True,
        env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(ref=np.load(out / "ref.npz"), ref_snap=ref_snap,
                port_snap=port_snap, port=port)


def test_reference_snapshot_restores_in_the_port(cross):
    ref = cross["ref"]
    by_path, _, extra = checkpoint.load(cross["ref_snap"])
    assert extra["schema"] == 2 and extra["kind"] == "lsh-index-snapshot"
    idx = persist.restore(cross["ref_snap"], device="cpu")
    assert idx.cfg == make_cfg() and idx.k_neighbors == K
    # the saved parameters and keys are the reference's, installed
    p_a = [v for p, v in by_path.items() if "'p_A'" in p][0]
    np.testing.assert_array_equal(idx.stacked_params.A.numpy(), p_a)
    k_base = [v for p, v in by_path.items() if "'k_base'" in p][0]
    assert k_base.dtype == np.uint32
    np.testing.assert_array_equal(idx.base_key.numpy(), k_base)
    assert idx.n_live == extra["n_live_rows"] == (N - len(VICTIMS)) * 2
    np.testing.assert_array_equal(idx.shard_load, ref["ref_load"])
    assert idx._next_gid == int(ref["ref_next_gid"]) == N
    _check_like_reference(idx.query(QUERIES), ref, "ref")


@pytest.mark.parametrize("how", ["restored", "recovered"])
def test_port_snapshot_restores_in_the_reference(cross, how):
    ref, port = cross["ref"], cross["port"]
    _check_like_reference(port[how], ref, "port_" + how)
    if how == "recovered":
        assert port["recovered_next_gid"] == int(
            ref["port_recovered_next_gid"]) == N + 40


def test_port_snapshot_files_match_the_reference_layout(cross):
    """Every leaf the reference's snapshot holds, the port's holds with
    the same dtype (uint32 packing words and keys)."""
    ours, _, ex_ours = checkpoint.load(cross["port_snap"])
    theirs, _, ex_theirs = checkpoint.load(cross["ref_snap"])
    assert sorted(ours) == sorted(theirs)
    for p in theirs:
        assert ours[p].dtype == theirs[p].dtype, p
        assert ours[p].shape[1:] == theirs[p].shape[1:], p
    assert sorted(ex_ours) == sorted(ex_theirs)
    assert ex_ours["config"] == ex_theirs["config"]
    # the integer draws of one seed are jax's bit for bit: the keys and
    # the packing words the port sampled are the reference's
    for p in ("['k_base']", "['k_stacked']", "['p_pack_mult']",
              "['p_pack_add']"):
        np.testing.assert_array_equal(ours[p], theirs[p], err_msg=p)


# ---------------------------------------------------------------------
# The port alone (in-process)
# ---------------------------------------------------------------------

def test_snapshot_restore_roundtrip(tmp_path):
    idx = DistributedLSHIndex(make_cfg(), device="cpu", k_neighbors=10)
    idx.build(DATA)
    idx.delete(VICTIMS)
    qr = idx.query(QUERIES)
    persist.snapshot(idx, str(tmp_path))
    assert os.path.exists(os.path.join(tmp_path, "LATEST"))
    by_path, _, extra = checkpoint.load(str(tmp_path))
    gid_leaf = [v for p, v in by_path.items() if "rows_gid" in p]
    assert len(gid_leaf) == 1 and gid_leaf[0].shape == (idx.n_live,)
    assert extra["next_gid"] == idx._next_gid == N
    r = persist.restore(str(tmp_path), device="cpu")
    assert r.cfg == idx.cfg and r.k_neighbors == 10
    assert_same_store(r, idx)
    assert_same_answers(r.query(QUERIES), qr)
    res = r.insert(DATA[:16])
    assert res.gid_start == N and res.drops == 0
    with pytest.raises(FileNotFoundError):
        persist.restore(str(tmp_path / "nope"), device="cpu")


@pytest.mark.parametrize("T,S,S2", [(2, 8, 4), (2, 8, 2), (1, 2, 8)])
def test_elastic_restore_equals_a_fresh_index(tmp_path, T, S, S2):
    CAP = 4 * N * 2
    idx = DistributedLSHIndex(make_cfg(S=S, T=T), device="cpu",
                              k_neighbors=10)
    idx.build(DATA, capacity=CAP)
    victims = np.arange(0, N, 7)
    idx.delete(victims)
    persist.snapshot(idx, str(tmp_path))
    r = persist.restore(str(tmp_path), device="cpu", n_shards=S2,
                        capacity=CAP)
    assert r.cfg.n_shards == S2 and r.cfg.n_tables == T
    keep = np.setdiff1d(np.arange(N), victims)
    fresh = DistributedLSHIndex(make_cfg(S=S2, T=T), device="cpu",
                                k_neighbors=10)
    fresh.init_store(CAP)
    assert fresh.insert(DATA[keep], gids=keep).drops == 0
    assert_same_store(r, fresh)
    assert_same_answers(r.query(QUERIES), fresh.query(QUERIES))
    assert r.shard_load.sum() == len(keep) * T
    ra, rb = r.insert(DATA[:32]), fresh.insert(DATA[:32])
    assert ra.gid_start == rb.gid_start == N and ra.drops == rb.drops == 0
    assert_same_answers(r.query(QUERIES), fresh.query(QUERIES))
    # the default capacity keeps the saved total across shard counts
    d = persist.restore(str(tmp_path), device="cpu", n_shards=S2)
    assert d.store.capacity >= -(-idx.store.capacity * S // S2)


CAP = 4 * N * 2
OPS = [
    ("ins", (0, 256)),
    ("ins", (256, 384)),
    ("del", [3, 50, 120, 260]),
    ("snap", None),
    ("ins", (384, 512)),
    ("del", [200, 300, 400]),
]


def substeps(ops):
    out = []
    for i, (kind, _) in enumerate(ops):
        out += ([("snap", i), ("trunc", i)] if kind == "snap"
                else [("append", i), ("apply", i)])
    return out


STEPS = substeps(OPS)


def run_until(tmp, stop):
    """Execute the harness, stopping after ``stop`` substeps (a kill)."""
    idx = DistributedLSHIndex(make_cfg(), device="cpu")
    idx.init_store(CAP)
    wal = persist.WriteAheadLog(persist.wal_path(tmp))
    persist.snapshot(idx, tmp, wal=wal)          # boot snapshot
    next_gid, pending = 0, None
    for done, (kind, i) in enumerate(STEPS):
        if done == stop:
            break
        okind, arg = OPS[i]
        if kind == "append":
            if okind == "ins":
                lo, hi = arg
                gids = np.arange(next_gid, next_gid + (hi - lo))
                next_gid += hi - lo
                wal.append_insert(gids, DATA[lo:hi])
                pending = (DATA[lo:hi], gids)
            else:
                wal.append_delete(np.asarray(arg, np.int64))
                pending = arg
        elif kind == "apply":
            if okind == "ins":
                assert idx.insert(pending[0], gids=pending[1]).drops == 0
            else:
                idx.delete(pending)
        elif kind == "snap":
            persist.snapshot(idx, tmp)
        else:
            wal.truncate()
    wal.close()
    return idx


def reference_store(k):
    """The uninterrupted store of the ops whose WAL append ran in the
    first k substeps."""
    n = 0
    for kind, i in STEPS[:k]:
        if kind == "append":
            n = i + 1
    idx = DistributedLSHIndex(make_cfg(), device="cpu")
    idx.init_store(CAP)
    next_gid = 0
    for kind, arg in OPS[:n]:
        if kind == "ins":
            lo, hi = arg
            gids = np.arange(next_gid, next_gid + (hi - lo))
            next_gid += hi - lo
            assert idx.insert(DATA[lo:hi], gids=gids).drops == 0
        elif kind == "del":
            idx.delete(arg)
    return idx


@pytest.mark.parametrize("k", range(len(STEPS) + 1))
def test_recovery_from_every_kill_point(tmp_path, k):
    """Interrupt at every substep boundary (k = 0: the boot snapshot
    alone; k = len: a clean shutdown); recovery converges to the
    uninterrupted prefix store and answers as it does."""
    tmp = str(tmp_path)
    run_until(tmp, stop=k)
    rr = persist.recover(tmp, device="cpu", capacity=CAP)
    want = reference_store(k)
    assert rr.index.n_live == want.n_live
    assert_same_store(rr.index, want)
    if want.n_live:
        assert_same_answers(rr.index.query(QUERIES, k_neighbors=5),
                            want.query(QUERIES, k_neighbors=5))
    rr.wal.close()


def test_lost_truncate_replays_idempotently(tmp_path):
    tmp = str(tmp_path)
    run_until(tmp, stop=len(STEPS))
    rr = persist.recover(tmp, device="cpu", capacity=CAP)
    persist.snapshot(rr.index, tmp)              # truncate "lost"
    rr.wal.close()
    rr2 = persist.recover(tmp, device="cpu", capacity=CAP)
    # gid 400 was deleted by a LATER record, so ordered replay
    # re-inserts it and the delete record removes it again
    assert rr2.skipped_points == 127 and rr2.replayed_points == 1
    assert_same_store(rr2.index, rr.index)
    rr2.wal.close()


def test_service_counts_deletes_and_replayed_writes(tmp_path):
    tmp = str(tmp_path)
    idx = DistributedLSHIndex(make_cfg(), device="cpu")
    idx.init_store(idx._store_capacity(2 * N * 2))
    wal = persist.WriteAheadLog(persist.wal_path(tmp))
    svc = ShardedLSHService(idx, bucket_size=64, wal=wal)
    svc.insert(DATA[:512])
    persist.snapshot(idx, tmp, wal=wal)
    svc.insert(torch.as_tensor(DATA[512:640]))   # a tensor is logged too
    svc.delete([1, 2, 3, 3, 999999])
    st = svc.stats
    assert st.inserts == 640 and st.insert_rows == 1280
    assert st.deletes == 3 and st.delete_rows == 6
    assert st.delete_batches == 1 and "deletes=3" in st.summary()
    # a batch the index would refuse never reaches the log
    n_rec = wal.n_records
    with pytest.raises(ValueError):
        svc.insert(DATA[:2], gids=[-1, 5])
    with pytest.raises(ValueError):
        svc.insert(np.ones((2, 3), np.float32))
    assert wal.n_records == n_rec == 2
    rr = persist.recover(tmp, device="cpu", capacity=idx.store.capacity,
                         service=dict(bucket_size=64))
    st = rr.service.stats
    assert rr.replayed_inserts == 1 and rr.replayed_deletes == 1
    assert st.inserts == 128 and st.insert_rows == 256
    assert st.deletes == 3 and st.delete_rows == 6
    assert rr.wal.n_records == 2                  # replay does not re-append
    assert_same_store(rr.index, idx)
    rr.wal.close()
    wal.close()


def test_recover_raises_when_replay_drops_rows(tmp_path):
    """A replayed batch that overflows a capacity (here the saved
    config's per-block exchange capacity) must not pass as converged."""
    import dataclasses
    tmp = str(tmp_path)
    cfg = dataclasses.replace(make_cfg(), data_capacity=4)
    idx = DistributedLSHIndex(cfg, device="cpu")
    assert idx.build(DATA[:8]).drops == 0
    wal = persist.WriteAheadLog(persist.wal_path(tmp))
    persist.snapshot(idx, tmp, wal=wal)
    wal.append_insert(np.arange(8, N), DATA[8:])
    wal.close()
    with pytest.raises(RuntimeError, match="replay dropped"):
        persist.recover(tmp, device="cpu")
