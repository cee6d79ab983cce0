"""The port's checkpoint module against the reference's files.

Round trips through the port (float32, uint32, int64, bfloat16 and
float8 leaves, nested dicts, lists and tuples, ``None`` subtrees) are
exact, and so are cross-reads: a checkpoint the port wrote loads in the
reference (bfloat16 as ``ml_dtypes``) and one the reference wrote loads
in the port, with the same leaf paths, shapes, dtypes and bits.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "rows_x": torch.randn((5, 3), generator=g),
        "k_base": np.array([7, 2 ** 32 - 1], np.uint32),
        "layers": [torch.randn((2, 4), generator=g).to(torch.bfloat16),
                   (np.arange(6, dtype=np.int64).reshape(2, 3), None)],
        "scale": torch.randn((8,), generator=g).to(torch.float8_e4m3fn),
        "step": 3,
    }


def _bits(v):
    if isinstance(v, torch.Tensor):
        if v.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            v = v.view(torch.int16 if v.dtype == torch.bfloat16
                       else torch.uint8)
        return v.numpy().tobytes()
    return np.asarray(v).tobytes()


PATHS = ["['k_base']", "['layers']/[0]", "['layers']/[1]/[0]", "['rows_x']",
         "['scale']", "['step']"]


def test_roundtrip_in_the_port(tmp_path):
    tree = _tree()
    path = checkpoint.save(str(tmp_path), 7, tree, extra={"a": 1},
                           nshards=3)
    assert os.path.basename(path) == "step_7"
    assert checkpoint.latest_step(str(tmp_path)) == 7
    by_path, step, extra = checkpoint.load(str(tmp_path))
    assert step == 7 and extra == {"a": 1} and sorted(by_path) == PATHS
    assert by_path["['layers']/[0]"].dtype == torch.bfloat16
    assert by_path["['scale']"].dtype == torch.float8_e4m3fn
    assert by_path["['k_base']"].dtype == np.uint32
    back, step, _ = checkpoint.restore(str(tmp_path), tree)
    assert back["layers"][1][1] is None and isinstance(back["layers"][1],
                                                       tuple)
    flat = lambda t: [t["k_base"], t["layers"][0], t["layers"][1][0],
                      t["rows_x"], t["scale"]]
    for a, b in zip(flat(tree), flat(back)):
        assert type(a) is type(b) and _bits(a) == _bits(b)
    assert back["step"] == 3
    bad = dict(tree, rows_x=torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(str(tmp_path), dict(tree, more=np.zeros(1)))


def test_latest_and_prune(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load(str(tmp_path))
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), s, {"v": np.full(2, s)})
    checkpoint.prune_old(str(tmp_path), keep=2)
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("step_")) == ["step_3", "step_4"]
    by_path, _, _ = checkpoint.load(str(tmp_path), step=3)
    np.testing.assert_array_equal(by_path["['v']"], [3, 3])


def test_the_reference_reads_the_ports_checkpoint(tmp_path):
    import ml_dtypes
    from repro import checkpoint as ref_ckpt
    tree = _tree()
    checkpoint.save(str(tmp_path), 2, tree, extra={"k": [1, 2]}, nshards=2)
    by_path, step, extra = ref_ckpt.load(str(tmp_path))
    ours, _, _ = checkpoint.load(str(tmp_path))
    assert step == 2 and extra == {"k": [1, 2]} and sorted(by_path) == PATHS
    assert by_path["['layers']/[0]"].dtype == ml_dtypes.bfloat16
    assert by_path["['scale']"].dtype == ml_dtypes.float8_e4m3fn
    for p in PATHS:
        assert _bits(ours[p]) == np.asarray(by_path[p]).tobytes(), p


def test_the_port_reads_the_references_checkpoint(tmp_path):
    import jax.numpy as jnp
    from repro import checkpoint as ref_ckpt
    rng = np.random.default_rng(1)
    tree = {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "rows": [np.arange(5, dtype=np.int32),
                     rng.standard_normal((2, 2)).astype(np.float32)],
            "packed": np.array([[1, 2 ** 32 - 2]], np.uint32)}
    ref_ckpt.save(str(tmp_path), 5, tree, extra={"kind": "x"}, nshards=3)
    ref_by_path, _, _ = ref_ckpt.load(str(tmp_path))
    by_path, step, extra = checkpoint.load(str(tmp_path))
    assert step == 5 and extra == {"kind": "x"}
    assert sorted(by_path) == sorted(ref_by_path) == [
        "['packed']", "['rows']/[0]", "['rows']/[1]", "['w']"]
    assert by_path["['w']"].dtype == torch.bfloat16
    for p, v in by_path.items():
        assert _bits(v) == np.asarray(ref_by_path[p]).tobytes(), p
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
            "rows": [np.zeros(5, np.int32), np.zeros((2, 2), np.float32)],
            "packed": np.zeros((1, 2), np.uint32)}
    back, _, _ = checkpoint.restore(str(tmp_path), like)
    assert _bits(back["w"]) == np.asarray(tree["w"]).tobytes()
    np.testing.assert_array_equal(back["packed"], tree["packed"])
