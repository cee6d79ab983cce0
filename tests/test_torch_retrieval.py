"""The whole slice: the port's retrieval service against the reference's.

The reference ``RetrievalService`` (gemma-7b's reduced config, float32,
and mamba2-130m's in the ``mamba2`` cases) runs at S = 8 in a subprocess with 8 placeholder host devices, with
``serve.py``'s LSH settings, and dumps its weights, hash parameters,
embeddings and answers; the port replays the same stream on the CPU with
those weights (``convert.model_params_from_arrays``).  Checks:
  * the port's embeddings are within rtol = atol = 1e-4 of the
    reference's (two layers of float32 products, summed in another order);
  * fed the reference's embeddings and hash parameters
    (``convert.install``), the port's index and service give
    the reference's gids exactly, squared distances within rtol = atol =
    1e-5 (the kernels' tolerance, which is on d^2: an exact duplicate's
    distance is the square root of a cancellation residue of order 1e-7,
    so its distance itself may read 5e-4 on one side and 0 on the other);
  * end to end (the port embeds for itself and samples its own hash
    parameters from the seed, bitwise the reference's), the same gids
    and the same exchange count, except where
    a difference is explained by an embedding that lies within 1e-5 of
    a bucket edge (a first-layer projection of a query offset or of a
    returned document) or of the radius cr: the 1e-4 embedding tolerance
    can move such a point across.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme  # noqa
from repro_torch.core.hashing import gamma  # noqa: E402
from repro_torch.core.offsets import query_offsets  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (RetrievalService,  # noqa: E402
                                 ShardedLSHService, embed_texts)
from test_torch_cuda import one_torch_thread  # noqa: E402,F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS, N_NEW, SEQ, M, K, BUCKET = 256, 64, 16, 64, 2, 64
LSH = dict(r=0.2, c=2.0, k=8, W=0.5, L=16, seed=0)
IMAX = np.iinfo(np.int32).max

_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_config
from repro.models import init_params
from repro.serving import RetrievalService
from repro.serving.retrieval import embed_texts

out_dir, arch = sys.argv[1:3]
N_DOCS, N_NEW, SEQ, M, K, BUCKET = map(int, sys.argv[3:])
cfg = get_config(arch, reduced=True)
params = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
docs = rng.integers(0, cfg.vocab, (N_DOCS, SEQ)).astype(np.int32)
new = rng.integers(0, cfg.vocab, (N_NEW, SEQ)).astype(np.int32)
src = rng.integers(0, N_DOCS, M)
mesh = make_mesh((8,), ("shard",))
svc = RetrievalService.build(cfg, params, jnp.asarray(docs), mesh,
                             bucket_size=BUCKET, k_neighbors=K, {lsh})
out = {{"docs": docs, "new": new, "src": src}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)
    out["w/" + name] = np.asarray(leaf)
for f in ("A", "b", "alpha", "beta", "alpha_cauchy", "pack_mult",
          "pack_add"):
    out["param_" + f] = np.asarray(getattr(svc.index.stacked_params, f))
out["keys"] = np.asarray(svc.index.stacked_keys)
out["emb_docs"] = np.asarray(embed_texts(params, cfg, jnp.asarray(docs)))
out["emb_new"] = np.asarray(embed_texts(params, cfg, jnp.asarray(new)))
g, d, _ = svc.query(jnp.asarray(docs[src]))
out["q1_gid"], out["q1_dist"] = g, d
out["new_gids"] = svc.insert_docs(jnp.asarray(new))
g, d, _ = svc.query(jnp.asarray(new))
out["q2_gid"], out["q2_dist"] = g, d
out["collectives"] = np.int64(svc.service.stats.collectives_issued)
np.savez(out_dir + "/retrieval.npz", **out)
print("OK")
"""


def _run_reference(tmp_path_factory, arch):
    out = tmp_path_factory.mktemp("ref_retrieval")
    env = dict(os.environ)
    # one compute thread: the suite runs in parallel workers
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    lsh = ", ".join(f"{k}={v!r}" for k, v in LSH.items())
    script = textwrap.dedent(_SCRIPT).format(lsh=lsh)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(out), arch,
         *map(str, (N_DOCS, N_NEW, SEQ, M, K, BUCKET))],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out / "retrieval.npz"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run_reference(tmp_path_factory, "gemma-7b")


@pytest.fixture(scope="module")
def ref_mamba2(tmp_path_factory):
    return _run_reference(tmp_path_factory, "mamba2-130m")


def _tree(ref):
    """The flat "w/<path>" arrays -> the reference's nested params."""
    root = {}
    for name, a in ref.items():
        if not name.startswith("w/"):
            continue
        *path, leaf = name[2:].split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    root["segments"] = [root["segments"][str(i)]
                        for i in range(len(root["segments"]))]
    return root


def _hash_arrays(ref):
    return ({f: ref["param_" + f] for f in convert.FIELDS}, ref["keys"])


def _lsh_config(arch="gemma-7b"):
    return LSHConfig(d=get_config(arch, reduced=True).d_model,
                     n_shards=8, scheme=Scheme.LAYERED, n_tables=1, **LSH)


@pytest.fixture(scope="module")
def model(ref):
    return convert.model_params_from_arrays(
        _tree(ref), get_config("gemma-7b", reduced=True), device="cpu")


@pytest.fixture(scope="module")
def model_mamba2(ref_mamba2):
    return convert.model_params_from_arrays(
        _tree(ref_mamba2), get_config("mamba2-130m", reduced=True),
        device="cpu")


def _embeddings_match(ref, model):
    for tokens, want in ((ref["docs"], ref["emb_docs"]),
                         (ref["new"], ref["emb_new"])):
        got = embed_texts(model, tokens).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_embeddings_match_reference(ref, model):
    _embeddings_match(ref, model)


def test_mamba2_embeddings_match_reference(ref_mamba2, model_mamba2):
    _embeddings_match(ref_mamba2, model_mamba2)


def test_service_on_reference_embeddings_gives_reference_gids(ref):
    """The index half of the slice, isolated from the embedder."""
    _service_on_reference_embeddings(ref, "gemma-7b")


def test_mamba2_service_on_reference_embeddings_gives_reference_gids(
        ref_mamba2):
    """The index at mamba2's embedding width, on its embeddings."""
    _service_on_reference_embeddings(ref_mamba2, "mamba2-130m")


def _service_on_reference_embeddings(ref, arch):
    idx = DistributedLSHIndex(_lsh_config(arch), device="cpu", k_neighbors=K)
    convert.install(idx, *_hash_arrays(ref))
    idx.build(ref["emb_docs"])
    svc = ShardedLSHService(idx, bucket_size=BUCKET, k_neighbors=K)

    def ask(q):
        hs = svc.submit_batch(q)
        svc.drain()
        return (np.stack([h.gids for h in hs]),
                np.stack([h.dists for h in hs]))

    g, d = ask(ref["emb_docs"][ref["src"]])
    np.testing.assert_array_equal(g, ref["q1_gid"])
    np.testing.assert_allclose(d ** 2, ref["q1_dist"] ** 2, rtol=1e-5,
                               atol=1e-5)
    res = svc.insert(ref["emb_new"])
    assert res.drops == 0
    np.testing.assert_array_equal(
        np.arange(res.gid_start, res.gid_start + res.n_inserted),
        ref["new_gids"])
    g, d = ask(ref["emb_new"])
    np.testing.assert_array_equal(g, ref["q2_gid"])
    np.testing.assert_allclose(d ** 2, ref["q2_dist"] ** 2, rtol=1e-5,
                               atol=1e-5)
    # exact duplicates find themselves when an offset probe lands in their
    # bucket (the queries themselves are not probed): about half here
    assert (ref["q1_gid"][:, 0] == ref["src"]).mean() > 0.25
    assert svc.stats.collectives_issued == int(ref["collectives"])


def _edge_gap(svc, x, qids=None):
    """Smallest distance of a first-layer projection (x A + b) / W of the
    rows of x -- or, with qids, of their L query offsets -- from an
    integer (a bucket edge), per row."""
    idx = svc.index
    cfg = idx.cfg
    x = torch.as_tensor(x, dtype=torch.float32)
    params = idx.stacked_params.table(0)
    if qids is not None:
        x = query_offsets(idx.stacked_keys[0], torch.as_tensor(qids), x,
                          cfg.L, cfg.r)                       # (n, L, d)
    g = gamma(params, x, cfg.W)
    gap = (g - torch.round(g)).abs()
    return gap.reshape(gap.shape[0], -1).min(dim=1).values.numpy()


def _check_differences(svc, emb, docs, got_g, got_d, want_g, want_d):
    """Rows whose answers differ must be explained by a bucket edge or
    the radius edge within 1e-5.  emb: the queries' embeddings; docs: the
    stored documents' (row = gid)."""
    bad = np.flatnonzero((got_g != want_g).any(axis=1))
    cr = svc.index.cfg.c * svc.index.cfg.r
    for i in bad:
        gaps = [_edge_gap(svc, emb[i:i + 1], np.array([i % BUCKET]))[0]]
        for g in np.concatenate([got_g[i], want_g[i]]):
            if g != IMAX:
                gaps.append(_edge_gap(svc, docs[g:g + 1])[0])
        near_cr = np.abs(np.concatenate([got_d[i], want_d[i]]) - cr)
        assert min(gaps) < 1e-5 or near_cr.min() < 1e-5, (
            f"query {i}: gids {got_g[i]} != {want_g[i]} with no point "
            f"within 1e-5 of an edge (gap {min(gaps):.2e})")


def test_retrieval_service_end_to_end(ref, model):
    _end_to_end(ref, model, "gemma-7b")


def test_mamba2_retrieval_service_end_to_end(ref_mamba2, model_mamba2):
    _end_to_end(ref_mamba2, model_mamba2, "mamba2-130m")


def _end_to_end(ref, model, arch):
    svc = RetrievalService.build(
        get_config(arch, reduced=True), model, ref["docs"],
        n_shards=8, device="cpu", bucket_size=BUCKET, k_neighbors=K, **LSH)
    # the parameters LAYERED hashing reads, sampled by the port
    params, keys = _hash_arrays(ref)
    for f in ("A", "b", "alpha", "beta"):
        np.testing.assert_array_equal(
            getattr(svc.index.stacked_params, f).numpy(), params[f])
    np.testing.assert_array_equal(svc.index.stacked_keys.numpy(),
                                  keys.astype(np.uint32))
    calls = svc.index.a2a.calls
    g1, d1, _ = svc.query(ref["docs"][ref["src"]])
    assert svc.index.a2a.calls == calls + 2
    gids = svc.insert_docs(ref["new"])
    np.testing.assert_array_equal(gids, ref["new_gids"])
    assert svc.index.a2a.calls == calls + 3
    g2, d2, _ = svc.query(ref["new"])
    assert svc.service.stats.drops == 0
    assert svc.service.stats.collectives_issued == int(ref["collectives"])
    docs = embed_texts(model, np.concatenate([ref["docs"], ref["new"]]))
    docs = docs.numpy()
    q1 = docs[ref["src"]]
    _check_differences(svc, q1, docs, g1, d1, ref["q1_gid"], ref["q1_dist"])
    _check_differences(svc, docs[N_DOCS:], docs, g2, d2, ref["q2_gid"],
                       ref["q2_dist"])
    same = (g1 == ref["q1_gid"]).all(axis=1)
    np.testing.assert_allclose(d1[same] ** 2, ref["q1_dist"][same] ** 2,
                               rtol=1e-4, atol=1e-4)
    svc.close()


def test_mamba2_long_documents_need_the_lossless_slack():
    """Mean-pooled embeddings of a random-weight mamba2 over 1,024-token
    documents lie close together, so Layered LSH sends most documents to
    one or two shards: the default slack of 4 overflows a shard's store,
    a slack of n_shards cannot."""
    cfg = get_config("mamba2-130m", reduced=True)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    docs = np.random.default_rng(0).integers(0, cfg.vocab, (128, 1024))
    emb = embed_texts(model, docs)
    lsh = _lsh_config("mamba2-130m")
    drops = {}
    for slack in (4.0, 8.0):
        idx = DistributedLSHIndex(lsh, device="cpu", slack=slack)
        drops[slack] = idx.build(emb).drops
    assert drops[4.0] > 0 and drops[8.0] == 0
    svc = RetrievalService.build(cfg, model, docs[:16], device="cpu",
                                 slack=8.0, **LSH)
    assert svc.index.slack == 8.0 and svc.index.build_result.drops == 0


def test_unported_paths_raise(ref, model):
    """The paths that raised before the durability and pipeline parts of
    the port now serve: ``build(pipelined=True)`` fronts the index with
    the async service, and ``recover_or_build`` without a snapshot
    directory builds cold (no recovery result)."""
    from repro_torch.serving import AsyncLSHService
    cfg = get_config("gemma-7b", reduced=True)
    svc = RetrievalService.build(cfg, model, ref["docs"][:8], device="cpu",
                                 pipelined=True)
    assert isinstance(svc.service, AsyncLSHService)
    svc.close()
    svc, rr = RetrievalService.recover_or_build(cfg, model,
                                                ref["docs"][:8],
                                                device="cpu")
    assert rr is None and isinstance(svc.service, ShardedLSHService)


def test_warm_restart_and_pipelined_answers_match_sync(ref, model,
                                                       tmp_path):
    """Reduced gemma-7b on the CPU: a durable pipelined service answers
    bitwise as the sync one, before and after a streamed insert; a warm
    restart from its snapshot directory replays the insert from the WAL
    and answers the same batch with the same gids and distances."""
    cfg = get_config("gemma-7b", reduced=True)
    docs, new = ref["docs"][:64], ref["new"][:16]
    queries = np.concatenate([docs[:12], new[:4]])
    snap = str(tmp_path / "snap")
    kw = dict(device="cpu", bucket_size=16, k_neighbors=K, **LSH)
    sync = RetrievalService.build(cfg, model, docs, **kw)
    svc, rr = RetrievalService.recover_or_build(
        cfg, model, docs, snapshot_dir=snap, pipelined=True, **kw)
    assert rr is None and svc.service.wal is not None
    for s in (sync, svc):
        np.testing.assert_array_equal(s.insert_docs(new),
                                      np.arange(64, 80))
    g0, d0, _ = sync.query(queries)
    g1, d1, _ = svc.query(queries)
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(d0.view(np.uint32), d1.view(np.uint32))
    # exact duplicates: some query finds its own document
    assert (g1[:, 0] == np.r_[np.arange(12), np.arange(64, 68)]).any()
    svc.close()
    with pytest.warns(UserWarning, match="keeps the snapshot's LSH"):
        warm, rr = RetrievalService.recover_or_build(
            cfg, model, None, snapshot_dir=snap, pipelined=True,
            **dict(kw, L=8))
    assert rr.replayed_inserts == 1 and rr.index.n_live == 80
    assert warm.lsh.L == LSH["L"]
    g2, d2, _ = warm.query(queries)
    np.testing.assert_array_equal(g2, g1)
    np.testing.assert_array_equal(d2.view(np.uint32), d1.view(np.uint32))
    warm.close()
    rr.wal.close()
