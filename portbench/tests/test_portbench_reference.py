"""The plain reference against the program's own arithmetic on the CPU:
the frozen PRNG draws bit for bit, the hash parameters and offsets it
derives from the configuration's seed, and its buckets."""
import numpy as np
import pytest
import torch

from portbench.reference import lsh, prng


def test_frozen_prng_draws_bitwise():
    from repro_torch.core import prng as port
    key = prng.PRNGKey(1234567)
    assert torch.equal(key, port.PRNGKey(1234567))
    k1 = prng.fold_in(prng.split(key, 3), torch.arange(3))
    assert torch.equal(k1, port.fold_in(port.split(key, 3),
                                        torch.arange(3)))
    for f in ("normal", "uniform"):
        a = getattr(prng, f)(k1, (50, 7))
        b = getattr(port, f)(k1, (50, 7))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


def _port_index(cfg):
    from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
    c = LSHConfig(d=cfg["d"], k=cfg["k"], W=cfg["W"], r=cfg["r"],
                  c=cfg["c"], L=cfg["L"], n_shards=cfg["n_shards"],
                  scheme=Scheme(cfg["scheme"]), seed=cfg["seed"],
                  n_tables=cfg["n_tables"])
    return DistributedLSHIndex(c, device="cpu")


@pytest.mark.parametrize("name", ["serve-d64", "random-1m"])
def test_params_offsets_and_buckets_match_the_port(name):
    from repro_torch.core.hashing import hash_h
    from repro_torch.core.offsets import query_offsets
    from portbench import spec
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    idx = _port_index(cfg)
    p = lsh.sample_params(cfg, "cpu")
    sp = idx.stacked_params
    assert torch.equal(p.A, sp.A) and torch.equal(p.b, sp.b)
    assert torch.equal(p.base_keys, idx.stacked_keys)
    g = torch.Generator().manual_seed(3)
    d = cfg["d"]
    x = torch.randn(4096, d, generator=g) / d ** 0.5
    h = lsh.Hasher(cfg, p, "exact")
    low = lsh.Hasher(cfg, p, "tf32")
    for t in range(cfg["n_tables"]):
        want = hash_h(sp.table(t), x, cfg["W"]).to(torch.int64)
        got, amb = h.project(x, t)
        # equal wherever the exact projection is not within eps of a floor
        assert torch.equal(got[~amb], want[~amb])
        assert amb.float().mean() < 1e-2
        qids = torch.arange(64)
        o32 = query_offsets(p.base_keys[t], qids, x[:64], cfg["L"],
                            cfg["r"])
        o64, _ = h.offsets(x[:64], qids, t)
        assert torch.allclose(o64, o32.double(), rtol=0, atol=1e-6)
        lo, _ = low.offsets(x[:64], qids, t)
        assert torch.allclose(lo, o32, rtol=0, atol=1e-6)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.0], dtype=torch.float32)
    got = lsh.tf32(x)
    want = torch.tensor([1.0, 1.0 + 4 * 2 ** -11, -1.0, 3.0])
    assert torch.equal(got, want)
    bits = got.view(torch.int32).numpy() & 0x1FFF
    assert not bits.any()
    assert np.isclose(lsh.cr2_of({"c": 2.0, "r": 0.3}), 0.36, rtol=1e-7)
