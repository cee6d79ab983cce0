"""The comparison that decides ``correct``: the program's answers to a
sample of query batches against the plain reference's
(``portbench/reference/lsh.py``), judged answer by answer.

Two numbers a run compares, each against the limit of its cell
(``checks`` in ``portbench/workloads/<cell>.json``):

* ``wrong_answers``: compared queries whose answer differs from the
  reference's in a way no float32 rounding explains.  A difference is
  explained where it involves a probe or a stored row whose projection
  lies within ``ambiguity_eps`` of a floor (the flip the index's fixed
  float32 order may take), a row within ``TIE`` of the radius, or rows
  within ``TIE`` of each other where the order or the K-th place is
  decided.  A gid that is not live when the batch was admitted (deleted,
  or never inserted), or a gid returned twice, is never explained.
* ``dist_rel_err``: the largest relative gap between a returned distance
  and the true distance of the row returned, over every live row
  returned.

Queries that got no answer, or whose batch reported capacity drops, are
``failed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.lsh import IMAX, Store, top_k

TIE = 1e-5   # squared-distance gap under which float32 may order either way


@dataclasses.dataclass
class Verdict:
    compared: int = 0
    wrong: int = 0
    excused: int = 0
    dist_rel_err: float = 0.0
    examples: list = dataclasses.field(default_factory=list)

    def add(self, other: "Verdict") -> None:
        self.compared += other.compared
        self.wrong += other.wrong
        self.excused += other.excused
        self.dist_rel_err = max(self.dist_rel_err, other.dist_rel_err)
        self.examples += other.examples[:max(0, 5 - len(self.examples))]


def judge(store: Store, q: torch.Tensor, qids: torch.Tensor, seq: int,
          gids: np.ndarray, dists: np.ndarray, K: int, cr2: float
          ) -> Verdict:
    """One batch: queries q (m, d) float32 on the reference's device,
    admitted at ``seq``; the program's answers gids (m, K) (IMAX pad) and
    distances (m, K) (inf pad)."""
    m = q.shape[0]
    cands, qamb = store.candidates(q, qids, seq, cr2, TIE)
    ref_g, _ = top_k(cands, m, K, cr2)
    ref_g = ref_g.cpu().numpy()
    gids = np.asarray(gids, np.int64)
    v = Verdict(compared=m)

    # every returned row's distance against its true distance
    ret = gids != IMAX
    qi, ki = np.nonzero(ret)
    rows = torch.as_tensor(gids[qi, ki], device=q.device)
    in_range = (rows >= 0) & (rows < store.x.shape[0])
    live = torch.zeros_like(in_range)
    live[in_range] = store.live(rows[in_range], seq)
    live_h = live.cpu().numpy()
    if live_h.any():
        r = rows[live]
        qq = torch.as_tensor(qi[live_h], device=q.device)
        d_ref = torch.sqrt(((q[qq].double() - store.x[r].double()) ** 2)
                           .sum(-1)).cpu().numpy()
        d_got = np.asarray(dists, np.float64)[qi[live_h], ki[live_h]]
        v.dist_rel_err = float(np.max(np.abs(d_got - d_ref) / d_ref))

    bad = np.nonzero((gids != ref_g).any(axis=1))[0]
    if not len(bad):
        return v
    dead = {(int(a), int(g)) for a, g, ok in
            zip(qi, gids[qi, ki], live_h) if not ok}
    cq, cr, cd = (t.cpu().numpy() for t in cands)
    qamb = qamb.cpu().numpy()
    start = np.searchsorted(cq, bad, side="left")
    stop = np.searchsorted(cq, bad, side="right")
    for i, lo, hi in zip(bad, start, stop):
        cand = dict(zip(cr[lo:hi].tolist(), cd[lo:hi].tolist()))
        got = [int(g) for g in gids[i] if g != IMAX]
        want = [int(g) for g in ref_g[i] if g != IMAX]
        ok = _explained(i, got, want, cand, qamb[i], dead, store, cr2)
        if ok:
            v.excused += 1
        else:
            v.wrong += 1
            if len(v.examples) < 5:
                v.examples.append({"seq": seq, "row": int(i), "got": got,
                                   "want": want})
    return v


def _explained(i, got, want, cand, qamb, dead, store, cr2) -> bool:
    """Whether float32 rounding explains the program's answer ``got``
    where the reference gave ``want``."""
    if len(set(got)) != len(got) or any((i, g) in dead for g in got):
        return False
    if set(got) == set(want):
        return all(abs(cand[a] - cand[b]) <= TIE
                   for a, b in zip(got, want) if a != b)
    extra, missing = set(got) - set(want), set(want) - set(got)
    rows = sorted(extra | missing)
    amb = store.amb[torch.as_tensor(rows, device=store.amb.device)]
    for g, a in zip(rows, amb.tolist()):
        if qamb or a:
            continue                   # a floor either way moves a bucket
        d2 = cand.get(g)
        if d2 is None:
            return False               # shares no probed bucket
        if abs(d2 - cr2) <= TIE:
            continue                   # at the radius
        other = missing if g in extra else extra
        if any(abs(cand.get(h, np.inf) - d2) <= TIE for h in other):
            continue                   # tied with the row it displaced
        return False
    return True
