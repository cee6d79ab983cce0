"""Requests enter through ``DistributedLSHIndex.query``, called
synchronously by one caller, one call of ``batch`` queries after
another: a batch job, with no serving front.  A call that drops routed
rows fails whole.
"""
from __future__ import annotations

import time

from portbench.drive import Request


def start(drv) -> None:
    pass


def stop(drv) -> None:
    pass


def dropped(drv) -> int:
    """Drops fail their call; none are left uncounted."""
    return 0


def admit(drv, j: int, sent: float, program: bool = True) -> list:
    """Step j's call; made, and answered, where ``program``."""
    q = drv.traffic.queries(j)
    rec = Request("query", j, drv.next_seq(), sent, len(q))
    if not program:
        return [rec]
    try:
        res = drv.idx.query(q, k_neighbors=drv.K)
        rec.gids, rec.dists = res.topk_gid, res.topk_dist
        rec.drops = int(res.drops)
    except Exception as exc:   # noqa: BLE001 -- a failed request
        rec.error = repr(exc)
    rec.t_done = time.perf_counter()
    if rec.error is None and rec.drops:
        rec.error = f"{rec.drops} routed rows dropped"
    return [rec]


def window(drv, j0: int, seconds, steps) -> list:
    recs = []
    t0 = time.perf_counter()
    t_end = None if seconds is None else t0 + seconds
    j = j0
    while not drv.done(j, j0, t_end, steps):
        rec, = admit(drv, j, time.perf_counter())
        drv.sample.offer(rec)
        recs.append(rec)
        j += 1
    drv.t_start = t0
    return recs
