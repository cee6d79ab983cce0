"""Fault-tolerant training step loop (the reference's ``runtime/loop.py``,
with the same resume, injected-failure, checkpoint-every and straggler
semantics):

  * checkpoint every ``ckpt_every`` steps and at the last (atomic; the
    data-pipeline state rides in ``extra`` so restarts resume the exact
    batch sequence);
  * auto-restart: on an (injected) worker failure the loop restores the
    latest checkpoint and replays; with deterministic steps the loss
    trajectory is bitwise that of an uninterrupted run;
  * straggler counting: a step slower than ``step_deadline_s`` is counted
    (the re-dispatch decision point of a real deployment); the loss is
    read before the clock stops, so a step's time includes the device's
    work, not only its dispatch;
  * a run that finds a checkpoint in ``ckpt_dir`` resumes from it, so
    ``run`` refuses a ``FaultConfig`` without one (the reference's
    default is a fixed path, where a run resumes a stale one).

The reference also re-places restored leaves with new shardings (its
elastic re-mesh); the port runs on one card, and ``checkpoint.restore``
places each leaf on its template leaf's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import checkpoint as ckpt_lib


@dataclasses.dataclass
class FaultConfig:
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None            # required by ``run``
    keep: int = 3
    step_deadline_s: Optional[float] = None   # straggler threshold
    fail_at_steps: tuple = ()                 # injected failures (testing)


class WorkerFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopStats:
    steps_run: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    losses: list = dataclasses.field(default_factory=list)


def _restore(fault: FaultConfig, state, restore_pipeline_fn):
    state, step, extra = ckpt_lib.restore(fault.ckpt_dir, state)
    if restore_pipeline_fn and "pipeline" in extra:
        restore_pipeline_fn(extra["pipeline"])
    return state, step


def run(step_fn: Callable, state: Any, data_iter, n_steps: int,
        fault: FaultConfig, *, pipeline_state_fn=None,
        restore_pipeline_fn=None) -> LoopStats:
    """Drive ``state = step_fn(state, batch)`` for n_steps with fault
    tolerance.  step_fn returns (state, loss).

    pipeline_state_fn() -> dict and restore_pipeline_fn(dict) snapshot /
    restore the data iterator so replays are deterministic.
    """
    if fault.ckpt_dir is None:
        raise ValueError("FaultConfig.ckpt_dir must name the run's own "
                         "checkpoint directory (a run resumes from any "
                         "checkpoint it finds there)")
    stats = LoopStats()
    step = 0
    injected = set(fault.fail_at_steps)

    # resume if a checkpoint exists
    if ckpt_lib.latest_step(fault.ckpt_dir) is not None:
        state, step = _restore(fault, state, restore_pipeline_fn)

    while step < n_steps:
        try:
            if step in injected:
                injected.discard(step)
                raise WorkerFailure(f"injected failure at step {step}")
            t0 = time.monotonic()
            batch = next(data_iter)
            state, loss = step_fn(state, batch)
            loss = float(loss)
            dt = time.monotonic() - t0
            if fault.step_deadline_s and dt > fault.step_deadline_s:
                stats.straggler_steps += 1   # re-dispatch decision point
            stats.losses.append(loss)
            stats.steps_run += 1
            step += 1
            if step % fault.ckpt_every == 0 or step == n_steps:
                extra = {}
                if pipeline_state_fn:
                    extra["pipeline"] = pipeline_state_fn()
                ckpt_lib.save(fault.ckpt_dir, step, state, extra=extra)
                ckpt_lib.prune_old(fault.ckpt_dir, keep=fault.keep)
        except WorkerFailure:
            stats.restarts += 1
            if ckpt_lib.latest_step(fault.ckpt_dir) is None:
                # no checkpoint yet: restart from scratch is the policy
                raise
            state, step = _restore(fault, state, restore_pipeline_fn)
    return stats
