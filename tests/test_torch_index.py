"""The port's index and service against the JAX reference at S = 8.

The reference index runs in a subprocess with 8 placeholder host
devices (jax fixes its device count when it starts) and dumps every
observable to npz files; the port replays the same stream on the CPU with
the reference's sampled parameters carried across (``convert.py``).

Each case -- together T in {1, 2}, K in {1, 5}, LAYERED and SIMPLE -- runs
build of a half, insert of the rest, delete, compact and an insert after
compact, querying after every step, plus a one-shot build of all data.
Tolerance: every integer is EQUAL (top-K gids in order, hit counts, fq,
per-shard loads, drops, n_sorted and the CSR columns after compact);
distances agree within rtol = atol = 1e-5.  Exchanges are counted: 1 per
insert, 2 per query, 0 per delete.  The service answers exactly as the
index.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch import convert  # noqa: E402
from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme  # noqa
from repro_torch.serving import ShardedLSHService  # noqa: E402
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
# every T, K and scheme value at least once; (2, 5, LAYERED) is the
# served configuration's
CASES = [(2, 5, "layered"), (1, 1, "simple")]
N, M, D = 512, 64, 32

_SCRIPT = """
import sys
import jax, numpy as np
from repro.compat import make_mesh
from repro.core import DistributedLSHIndex, LSHConfig, Scheme

out_dir, N, M, D = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
rng = np.random.default_rng(0)
data = (rng.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
idx_q = rng.integers(0, N, M)
queries = (data[idx_q] + rng.standard_normal((M, D)).astype(np.float32)
           * np.float32(0.3 / np.sqrt(D))).astype(np.float32)
victims = rng.choice(N, 24, replace=False).astype(np.int64)
extra = (rng.standard_normal((160, D)) / np.sqrt(D)).astype(np.float32)
mesh = make_mesh((8,), ("shard",))
for T, K, scheme in {cases}:
    cfg = LSHConfig(d=D, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=8,
                    scheme=Scheme(scheme), seed=0, n_tables=T)
    out = {{"data": data, "queries": queries, "victims": victims,
            "extra": extra}}
    def q(tag, idx):
        r = idx.query(queries, k_neighbors=K)
        out[tag + "_dist"] = r.topk_dist
        out[tag + "_gid"] = r.topk_gid
        out[tag + "_emit"] = r.n_within_cr
        out[tag + "_fq"] = r.fq
        out[tag + "_qload"] = r.query_load
        out[tag + "_drops"] = np.int64(r.drops)
        out[tag + "_load"] = np.asarray(idx.shard_load)
    full = DistributedLSHIndex(cfg, mesh, k_neighbors=K)
    full.build(data)
    q("full", full)
    idx = DistributedLSHIndex(cfg, mesh, k_neighbors=K, merge_min_rows=32,
                              merge_frac=0.1)
    for f in ("A", "b", "alpha", "beta", "alpha_cauchy", "pack_mult",
              "pack_add"):
        out["param_" + f] = np.asarray(getattr(idx.stacked_params, f))
    out["keys"] = np.asarray(idx.stacked_keys)
    idx.build(data[:N // 2])
    res = idx.insert(data[N // 2:])
    out["ins_drops"] = np.int64(res.drops)
    out["ins_rows"] = np.int64(res.rows_stored)
    q("half", idx)
    dr = idx.delete(victims)
    out["del"] = np.array([dr.n_deleted, dr.n_points])
    q("del", idx)
    idx.compact()
    st = idx.store
    out["n_sorted"] = np.int64(st.n_sorted)
    for f in ("gid", "table", "key", "valid", "bucket_start", "bucket_end"):
        out["csr_" + f] = np.asarray(getattr(st, f))
    out["csr_packed"] = np.asarray(st.packed).view(np.int32)
    q("compact", idx)
    idx.insert(extra[:4])
    q("tail", idx)
    idx.insert(extra[4:])
    out["merges"] = np.int64(idx.layout["merges"])
    q("merged", idx)
    np.savez(f"{{out_dir}}/T{{T}}_K{{K}}_{{scheme}}.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_index")
    env = dict(os.environ)
    # one compute thread: the suite runs in parallel workers
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    script = textwrap.dedent(_SCRIPT).format(cases=repr(CASES))
    proc = subprocess.run([sys.executable, "-c", script, str(out), str(N),
                           str(M), str(D)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


def _port(ref, T, K, scheme, **kw):
    cfg = LSHConfig(d=D, k=8, W=1.2, r=0.3, c=2.0, L=8, n_shards=8,
                    scheme=Scheme(scheme), seed=0, n_tables=T)
    idx = DistributedLSHIndex(cfg, device="cpu", k_neighbors=K, **kw)
    convert.install(idx, {f: ref["param_" + f] for f in convert.FIELDS},
                    ref["keys"])
    return idx


def _check_query(idx, ref, tag, K):
    calls = idx.a2a.calls
    r = idx.query(ref["queries"], k_neighbors=K)
    assert idx.a2a.calls == calls + 2
    np.testing.assert_array_equal(r.topk_gid, ref[tag + "_gid"])
    np.testing.assert_allclose(r.topk_dist, ref[tag + "_dist"], **TOL)
    np.testing.assert_array_equal(r.n_within_cr, ref[tag + "_emit"])
    np.testing.assert_array_equal(r.fq, ref[tag + "_fq"])
    np.testing.assert_array_equal(r.query_load, ref[tag + "_qload"])
    assert r.drops == int(ref[tag + "_drops"]) == 0
    np.testing.assert_array_equal(idx.shard_load, ref[tag + "_load"])
    return r


@pytest.mark.parametrize("T,K,scheme", CASES)
def test_build_matches_reference(ref_dir, T, K, scheme):
    ref = np.load(ref_dir / f"T{T}_K{K}_{scheme}.npz")
    idx = _port(ref, T, K, scheme)
    calls = idx.a2a.calls
    idx.build(ref["data"])
    assert idx.a2a.calls == calls + 1
    r = _check_query(idx, ref, "full", K)
    assert (r.topk_gid[:, 0] != np.iinfo(np.int32).max).mean() > 0.25


@pytest.mark.parametrize("T,K,scheme", CASES)
def test_stream_matches_reference(ref_dir, T, K, scheme):
    """half build + insert, delete, compact, insert after compact (tail),
    and an insert that trips the LSM merge."""
    ref = np.load(ref_dir / f"T{T}_K{K}_{scheme}.npz")
    data = ref["data"]
    idx = _port(ref, T, K, scheme, merge_min_rows=32, merge_frac=0.1)
    idx.build(data[:N // 2])
    res = idx.insert(data[N // 2:])
    assert res.drops == ref["ins_drops"] and \
        res.rows_stored == ref["ins_rows"]
    _check_query(idx, ref, "half", K)
    np.testing.assert_array_equal(idx.shard_load, ref["half_load"])

    calls = idx.a2a.calls
    dr = idx.delete(ref["victims"])
    assert idx.a2a.calls == calls
    assert [dr.n_deleted, dr.n_points] == list(ref["del"])
    _check_query(idx, ref, "del", K)

    idx.compact()
    st = idx.store
    assert st.n_sorted == int(ref["n_sorted"])
    cap = ref["csr_gid"].shape[1]
    for f in ("gid", "table", "key", "valid", "bucket_start", "bucket_end",
              "packed"):
        got = getattr(st, f)[:, :cap].numpy()
        np.testing.assert_array_equal(got, ref["csr_" + f], err_msg=f)
    _check_query(idx, ref, "compact", K)

    idx.insert(ref["extra"][:4])
    assert idx.layout["tail_rows"] == 4 * T
    _check_query(idx, ref, "tail", K)
    idx.insert(ref["extra"][4:])
    assert idx.layout["merges"] == int(ref["merges"]) == 2
    _check_query(idx, ref, "merged", K)


@pytest.mark.parametrize("T,K,scheme", CASES[:2])
def test_csr_bitwise_equals_full_scan(ref_dir, T, K, scheme):
    """Inside the port: a sorted store answers bitwise alike through the
    CSR gather and through the pinned full scan, with and without tail."""
    ref = np.load(ref_dir / f"T{T}_K{K}_{scheme}.npz")
    idx = _port(ref, T, K, scheme)
    idx.build(ref["data"][:400])
    idx.compact()
    for extra in (None, ref["data"][400:430]):
        if extra is not None:
            idx.insert(extra)
        idx.use_csr = True
        a = idx.query(ref["queries"])
        idx.use_csr = False
        b = idx.query(ref["queries"])
        np.testing.assert_array_equal(a.topk_dist.view(np.uint32),
                                      b.topk_dist.view(np.uint32))
        np.testing.assert_array_equal(a.topk_gid, b.topk_gid)
        np.testing.assert_array_equal(a.n_within_cr, b.n_within_cr)


@pytest.mark.parametrize("bucket", [16, 64])
def test_service_answers_as_the_index(ref_dir, bucket):
    T, K, scheme = CASES[0]
    ref = np.load(ref_dir / f"T{T}_K{K}_{scheme}.npz")
    idx = _port(ref, T, K, scheme)
    idx.build(ref["data"])
    svc = ShardedLSHService(idx, bucket_size=bucket,
                            max_latency_ms=float("inf"), k_neighbors=K)
    queries = ref["queries"]
    handles = svc.submit_batch(queries[:M - 3])
    handles.append(svc.submit(queries[M - 3]))
    handles += svc.submit_batch(queries[M - 2:])
    svc.drain()
    assert all(h.done for h in handles)
    for i in range(0, M, bucket):
        want = idx.query(queries[i:i + bucket], k_neighbors=K)
        for j in range(bucket):
            h = handles[i + j]
            np.testing.assert_array_equal(h.gids, want.topk_gid[j])
            np.testing.assert_array_equal(h.dists, want.topk_dist[j])
            assert h.n_within_cr == want.n_within_cr[j]
            assert h.fq == want.fq[j]
    st = svc.stats
    assert st.queries == M and st.batches == M // bucket and st.drops == 0
    assert st.collectives_issued == 2 * st.batches
    svc.insert(ref["extra"])
    svc.delete(ref["victims"][:5])
    assert svc.stats.inserts == len(ref["extra"])
    assert svc.stats.deletes == 5 and svc.stats.delete_rows == 5 * T


def test_service_rejects_a_write_ahead_log():
    cfg = LSHConfig(d=8, k=4, W=1.0, r=0.3, c=2.0, L=2, n_shards=2)
    idx = DistributedLSHIndex(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ShardedLSHService(idx, bucket_size=4, wal=object())


def test_dispatch_and_receive_side_hash_agree(monkeypatch):
    """The receive side re-hashes every routed row: every distinct
    (shard, qid, table) row that the dispatch shipped must own at least
    one of its probes there, so no shipped row goes unscanned."""
    from repro_torch.core import index as tindex
    cfg = LSHConfig(d=16, k=6, W=1.0, r=0.4, c=2.0, L=8, n_shards=4,
                    n_tables=2, seed=3)
    idx = DistributedLSHIndex(cfg, device="cpu", k_neighbors=3)
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((300, 16)) / 4).astype(np.float32)
    idx.build(data)
    seen = {}
    orig = tindex.kops.bucket_search

    def spy(*, query, **kw):
        seen["query"] = query
        return orig(query=query, **kw)
    monkeypatch.setattr(tindex.kops, "bucket_search", spy)
    res = idx.query(data[:40])
    q = seen["query"]
    probed = q.probe.sum(dim=-1) > 0                      # (S, R)
    rows = set()
    for s, r in zip(*torch.nonzero(probed, as_tuple=True)):
        rows.add((int(s), int(q.table[s, r])))
    assert int(probed.sum()) > 0 and res.drops == 0
    # a row that probes nothing is padding or a repeated (qid, table)
    assert int(probed.sum()) <= int(res.fq.sum())
    found = (res.topk_gid[:, 0] != np.iinfo(np.int32).max).mean()
    assert found > 0.5
