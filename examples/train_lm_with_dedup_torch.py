"""Training driver with the paper's technique in the data path, on the
PyTorch/CUDA port (``examples/train_lm_with_dedup.py`` on
``repro_torch``): LSH near-duplicate detection runs as a pre-pass over
example embeddings (the p-stable hash kernel on the card), then an LM
trains with checkpoint/restart fault tolerance (a failure is injected
mid-run to demonstrate).

  PYTHONPATH=src python examples/train_lm_with_dedup_torch.py \\
      [--arch mamba2-130m] [--steps 200] [--full] [--device cpu]

Without --device it runs on the card (``cuda``) and raises without one.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.data import dedup_embeddings
from repro_torch.launch import train as train_cli

N_BASE, N_DUPS, DIM = 2000, 400, 64


def planted_embeddings(seed: int = 0) -> np.ndarray:
    """2,000 random embeddings followed by 400 near-copies of the first
    400 (the example's planted duplicates)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N_BASE, DIM)).astype(np.float32)
    dups = base[:N_DUPS] + rng.normal(scale=1e-4, size=(N_DUPS, DIM)).astype(
        np.float32)
    return np.concatenate([base, dups])


def dedup_stage(device=None) -> np.ndarray:
    """Stage 1: the keep-mask of LSH dedup over the planted embeddings."""
    emb = planted_embeddings()
    keep = dedup_embeddings(emb, r=0.01, k=8, W=0.3, device=device)
    print(f"[dedup] kept {keep.sum()}/{len(emb)} examples "
          f"({(~keep[N_BASE:]).sum()}/{N_DUPS} planted dups removed)")
    return keep


def train_argv(arch: str, steps: int, full: bool, ckpt_dir: str,
               device=None, batch: int = 4, seq: int = 128,
               ckpt_every: int = 50, fail: bool = True) -> list:
    """Stage 2's command line: checkpoints every ``ckpt_every`` steps and,
    with ``fail``, one failure injected half way."""
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(ckpt_every)]
    if fail:
        argv += ["--fail-at", str(steps // 2)]
    if not full:
        argv.append("--reduced")
    if device is not None:
        argv += ["--device", device]
    return argv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full config (~130M for mamba2) instead of reduced")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    dedup_stage(args.device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as ckpt:
        stats = train_cli.main(train_argv(args.arch, args.steps, args.full,
                                          ckpt, args.device))
    print(f"[train] survived {stats.restarts} injected failure(s); "
          f"final loss {stats.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
