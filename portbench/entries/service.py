"""Requests enter through the program's serving front,
``AsyncLSHService`` (``submit_batch``, ``insert``, ``delete``), from one
client thread in a closed loop: ``ahead`` steps outstanding, the next
admitted when the oldest completes.  The service's pipeline depth is the
mix's ``pipeline_depth`` and its bucket the mix's ``batch``.  A step
admits an insert where the mix has ``insert``, a delete where it has
``delete``, and a query batch.
"""
from __future__ import annotations

import queue
import threading
import time

from portbench.drive import WAIT_S, Request


def start(drv) -> None:
    from repro_torch.serving import AsyncLSHService
    drv.svc = AsyncLSHService(
        drv.idx, bucket_size=drv.mix["batch"], k_neighbors=drv.K,
        pipeline_depth=drv.mix["pipeline_depth"])


def stop(drv) -> None:
    if drv.svc is not None:
        drv.svc.close(drain=False)


def dropped(drv) -> int:
    """The service counts the routed rows it dropped, by no batch."""
    return drv.svc.stats.drops if drv.svc is not None else 0


def admit(drv, j: int, sent: float, program: bool = True) -> list:
    """Step j's requests, admitted to the service where ``program``."""
    mix, svc, out = drv.mix, drv.svc if program else None, []
    if mix.get("insert"):
        pts, gids = drv.traffic.insert_rows(j)
        rec = Request("insert", j, drv.next_seq(), sent, len(gids))
        rec.handles = svc and svc.insert(pts, gids=gids)
        drv.inserted(gids, rec.seq)
        out.append(rec)
    if mix.get("delete"):
        rec = Request("delete", j, drv.next_seq(), sent, mix["delete"])
        gids = drv.deleted(mix["delete"], rec.seq)
        rec.handles = svc and svc.delete(gids)
        out.append(rec)
    rec = Request("query", j, drv.next_seq(), sent, mix["batch"])
    rec.handles = svc and svc.submit_batch(drv.traffic.queries(j))
    out.append(rec)
    return out


def window(drv, j0: int, seconds, steps) -> list:
    """The closed loop; returns once every admitted request completed."""
    ahead = threading.Semaphore(drv.mix["ahead"])
    todo: queue.Queue = queue.Queue()
    recs: list = []
    waiter = threading.Thread(target=_collect, args=(todo, drv.sample),
                              name="portbench-collector", daemon=True)
    waiter.start()
    t0 = time.perf_counter()
    t_end = None if seconds is None else t0 + seconds
    j = j0
    try:
        while not drv.done(j, j0, t_end, steps):
            if not ahead.acquire(timeout=WAIT_S):
                raise RuntimeError(f"no step completed in {WAIT_S} s")
            if drv.done(j, j0, t_end, steps):
                break
            step = admit(drv, j, time.perf_counter())
            for i, rec in enumerate(step):
                todo.put((rec, ahead if i == len(step) - 1 else None))
            recs += step
            j += 1
    finally:
        todo.put(None)
        waiter.join(timeout=WAIT_S + 60.0)
    if waiter.is_alive():
        raise RuntimeError("requests still outstanding after the window")
    drv.t_start = t0
    return recs


def _collect(todo: queue.Queue, sample) -> None:
    """Wait for each admitted request in admission order (the order the
    service completes them in), stamp its completion, offer each query
    batch to the sample, and free a closed loop's slot when a step's last
    request completes."""
    while True:
        item = todo.get()
        if item is None:
            return
        rec, slot = item
        try:
            if rec.kind == "query":
                # the handle's own event: ``result()`` would ask the
                # engine for a flush, which drains the pipeline
                if not rec.handles[-1]._event.wait(WAIT_S):
                    raise TimeoutError(f"no answer within {WAIT_S} s")
                rec.t_done = time.perf_counter()
                # a batch fails or resolves as a whole: its last handle
                # is resolved after every other one
                last_h = rec.handles[-1]
                if last_h._error is not None or not last_h.done:
                    raise RuntimeError(repr(last_h._error))
            else:
                rec.handles.result(timeout=WAIT_S)
                rec.t_done = time.perf_counter()
        except Exception as exc:   # noqa: BLE001 -- a failed request
            rec.t_done = rec.t_done or time.perf_counter()
            rec.error = repr(exc)
        if rec.kind == "query":
            sample.offer(rec)
        elif rec.error is None:
            rec.handles = None
        if slot is not None:
            slot.release()
