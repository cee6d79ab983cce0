"""The comparison that decides ``correct``, on tiny cells on the CPU: the
program passes it, the control (the reference in TF32) fails it, and so
does a run whose timed path is broken underneath, once for each fault a
cell can have."""
import numpy as np
import pytest
import torch

from conftest import CELLS
from portbench import control, faults, run


def _numbers(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(tiny, name):
    r = run.run_cell(tiny(name), 20240611, 1.0, False, device="cpu")
    assert r["failed"] == 0 and r["correct"], _numbers(r)
    assert r["_notes"]["compared"] == 3 * 32
    cell = tiny(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_compares_too(tiny, name):
    r = run.run_cell(tiny(name), 4242, 1.0, True, device="cpu")
    assert r["correct"], _numbers(r)
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(tiny, name):
    cell = tiny(name)
    for seed in (1, 2, 3):
        got = control.control(cell, seed, 40, "cpu")
        assert any(got[k] > cell.checks[k]["limit"] for k in cell.checks), \
            got


# each fault with every cell that can have it: the writes' only where a
# step writes
FAULTS = [("insert_unchanged", "serve-d64.stream"),
          ("delete_unchanged", "serve-d64.stream")] + [
    (fault, name) for fault in faults.QUERY_FAULTS for name in CELLS]


@pytest.mark.parametrize("fault,name", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault,
                                            name):
    undo = []
    real_setup = run.Driver.setup

    def setup(self):
        real_setup(self)         # a sound index; the fault acts in the window
        undo.append(faults.arm(fault))
    monkeypatch.setattr(run.Driver, "setup", setup)
    try:
        r = run.run_cell(tiny(name), 99, 1.5, False, device="cpu")
    finally:
        for u in undo:
            u()
    assert not r["correct"], _numbers(r)


def test_judge_never_excuses_a_dead_gid():
    from portbench.check import judge
    from portbench.reference import lsh
    from conftest import tiny_cell
    cfg = tiny_cell("serve-d64.query").config
    g = torch.Generator().manual_seed(0)
    x = torch.randn(512, cfg["d"], generator=g) / cfg["d"] ** 0.5
    t_in = torch.full((512,), -1, dtype=torch.int64)
    t_out = torch.full((512,), 2 ** 62, dtype=torch.int64)
    t_out[7] = 5                                  # row 7 deleted at seq 5
    store = lsh.Store(lsh.Hasher(cfg, lsh.sample_params(cfg, "cpu")), x,
                      t_in, t_out)
    q = x[:8] + 0.01
    qids = torch.arange(8)
    cands, _ = store.candidates(q, qids, 10, lsh.cr2_of(cfg), 0.0)
    gids, d2 = lsh.top_k(cands, 8, cfg["K"], lsh.cr2_of(cfg))
    gids, dists = gids.numpy(), np.sqrt(d2.numpy())
    assert judge(store, q, qids, 10, gids, dists, cfg["K"],
                 lsh.cr2_of(cfg)).wrong == 0
    gids[7, 0], dists[7, 0] = 7, 0.1               # the deleted row answers
    assert judge(store, q, qids, 10, gids, dists, cfg["K"],
                 lsh.cr2_of(cfg)).wrong == 1
