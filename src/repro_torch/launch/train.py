"""End-to-end training driver (the reference's ``repro.launch.train``):
token pipeline -> train step -> AdamW -> checkpoint/restart, on one
device, for every arch that trains on tokens alone (all but the
encoder-decoder whisper-medium, whose ``loss_fn`` needs its encoder's
frames and raises ``ValueError`` without them, as the token batches
here have none).  Examples (CPU, reduced configs):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch mamba2-130m --reduced --steps 30 --fail-at 15
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma-7b --reduced --steps 30 --fail-at 15
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch recurrentgemma-2b --reduced --steps 30 --fail-at 15

The training state is the reference's: ``(params, OptState)`` with the
parameters in the reference's pytree layout (``models.param_tree``), so a
checkpoint has the reference's leaf paths.  Each step copies the state's
parameters into the model, takes the loss and its gradient (on the card
the flash-attention or SSD forward and gradient kernels; the RG-LRU
through autograd of its plain scan), and applies AdamW.  ``--layers``
cuts a config to its first N blocks at its published width, across its
segments (the reference trains the config as it is; a model too deep
for one card's memory trains cut).
The run is deterministic: PyTorch's deterministic algorithms are on for
its length (the embedding gradient's scatter-add is otherwise a float
atomic on the card), so a replay after an injected failure repeats the
loss trajectory bit for bit.

The reference builds a device mesh (``compat.make_mesh``) and sets its
sharding axes (``pspec.set_axes``); on one card there is no mesh, and
the 512-device step builders of ``launch/steps.py`` are tooling (ROADMAP
Queue 1 item 13).  ``--ckpt-dir`` defaults to a fresh temporary
directory removed at the end (the reference's fixed path would resume a
stale run), and ``--ckpt-every`` to 10, so that a failure injected half
way through a short run has a checkpoint to restart from.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core.index import resolve_device
from repro_torch.data import PipelineState, TokenPipeline
from repro_torch.models import (check_trainable, init_params,
                                load_param_tree, param_tree, value_and_grad)
from repro_torch.runtime import FaultConfig, LoopStats, run


# cuBLAS's fixed workspace for deterministic GEMMs.  PyTorch reads the
# variable once, at the process's first cuBLAS call, so a process that
# trains on the card sets it before that call: ``main`` does so before any
# device work, and a program that runs other GPU work first (chip_smoke.py)
# sets it at its start.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"
# The caching allocator's expandable segments: a functional AdamW step
# allocates float32 temporaries of every leaf's size, which otherwise
# strand reserved blocks that a later leaf cannot use (9.9 GB of the
# card, and an out-of-memory failure, at gemma-7b's published width cut
# to 6 blocks).  PyTorch reads it at the process's first CUDA allocation:
# ``main`` sets it before any device work, and chip_smoke.py at its start.
CUDA_ALLOC_CONF = "expandable_segments:True"


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the length of the block.
    Where the environment lacks ``CUBLAS_WORKSPACE_CONFIG`` (which
    PyTorch's deterministic mode asks for before a cuBLAS call), the block
    sets it and takes it out again at its end; it is in effect only if it
    was in place before the process's first cuBLAS call (see above)."""
    had = "CUBLAS_WORKSPACE_CONFIG" in os.environ
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)
        if not had:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def make_step(model, opt_cfg: optim.AdamWConfig):
    """``step_fn((params, opt_state), (tokens, labels)) -> ((params,
    opt_state), loss)`` for ``runtime.run``, on ``model``'s device."""
    def step_fn(state, batch):
        params, opt_state = state
        tokens, labels = batch
        load_param_tree(model, params)
        loss, grads = value_and_grad(model, tokens, labels)
        params, opt_state, _ = optim.update(opt_cfg, grads, opt_state,
                                            params)
        return (params, opt_state), loss
    return step_fn


def cut_depth(cfg, layers: int | None):
    """``cfg`` cut to its first ``layers`` blocks in order (``None``: as
    it is): the segments before the cut whole, the one it falls in
    shortened, the ones after it dropped (deepseek-v2-lite at 3 blocks
    is its dense block and 2 of its MoE blocks).  The cut must fall on a
    whole unit of the segment it shortens."""
    if layers is None:
        return cfg
    if not 0 < layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: --layers {layers} must be in 1 .. "
                         f"{cfg.n_layers}")
    segments, left = [], layers
    for seg in cfg.segments:
        unit = len(seg.kinds)
        take = min(left, unit * seg.repeat)
        if take % unit:
            raise ValueError(f"{cfg.name}: --layers {layers} cuts a unit of "
                             f"{unit} blocks")
        if take:
            segments.append(dataclasses.replace(seg, repeat=take // unit))
        left -= take
    return dataclasses.replace(cfg, segments=tuple(segments))


def main(argv=None) -> LoopStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="train the config cut to its first N blocks")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a run that finds a "
                         "checkpoint there resumes from it (default: a "
                         "fresh temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject worker failures at these steps (testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", CUDA_ALLOC_CONF)
    device = resolve_device(args.device)
    cfg = cut_depth(get_config(args.arch, reduced=args.reduced), args.layers)
    check_trainable(cfg)
    opt_cfg = optim.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    with contextlib.ExitStack() as stack:
        stack.enter_context(deterministic())
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_train_"))
        model = init_params(cfg, generator=torch.Generator(
            device=device).manual_seed(args.seed), device=device)
        params = param_tree(model)
        pipe = TokenPipeline(vocab_size=cfg.vocab, batch=args.batch,
                             seq_len=args.seq, seed=args.seed, device=device)
        fault = FaultConfig(ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                            fail_at_steps=tuple(args.fail_at))
        t0 = time.monotonic()
        stats = run(make_step(model, opt_cfg), (params, optim.init(params)),
                    pipe, args.steps, fault,
                    pipeline_state_fn=lambda: pipe.state.to_dict(),
                    restore_pipeline_fn=lambda d: pipe.restore(
                        PipelineState.from_dict(d)))
        dt = time.monotonic() - t0
    first = np.mean(stats.losses[:5])
    last = np.mean(stats.losses[-5:])
    print(f"[train] arch={cfg.name} device={device} steps={stats.steps_run} "
          f"restarts={stats.restarts} time={dt:.1f}s "
          f"loss {first:.4f} -> {last:.4f}")
    if not last < first:
        raise RuntimeError(f"loss did not decrease: {first} -> {last}")
    return stats


if __name__ == "__main__":
    main()
