"""Sharded, atomic, resumable checkpointing (the reference's on-disk format).

Layout:  <dir>/step_<N>/
           manifest.json        -- leaf paths, shapes, dtypes, step, extra
           shard_<i>.npz        -- flat leaves, split round-robin into
                                   ``nshards`` files
         <dir>/LATEST           -- atomically updated pointer

A step directory is written under a temporary name and committed by one
rename, then ``LATEST`` is replaced.  The format is the JAX reference's
byte for byte in its structure, so each side's ``load`` reads the
other's files:

  * a tree and its leaves' paths are ``repro_torch.tree``'s (jax's
    order and key paths); its leaves are tensors, numpy arrays or Python
    scalars;
  * bfloat16 and float8_e4m3fn leaves (no numpy dtype) are stored as
    same-width integer views (uint16, uint8) and the manifest records the
    logical dtype.  ``load`` returns them as torch tensors of that dtype;
    every other leaf comes back as a numpy array.

``restore`` re-places leaves like a template tree: a torch leaf of the
template gets a tensor of its dtype on its device, so a checkpoint saved
at one shard count restores at another (the caller re-routes).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten

# dtypes numpy can't hold: stored as a same-width integer view
_VIEW_DTYPES = {"bfloat16": (np.uint16, torch.int16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.uint8,
                                  torch.float8_e4m3fn)}
_TORCH_VIEW = {v[2]: k for k, v in _VIEW_DTYPES.items()}


def _storable(v) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its logical dtype name."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        name = _TORCH_VIEW.get(v.dtype)
        if name is not None:
            np_view, t_view, _ = _VIEW_DTYPES[name]
            return v.contiguous().view(t_view).numpy().view(np_view), name
        v = v.numpy()
    v = np.asarray(v)
    return v, str(v.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         nshards: int = 4) -> str:
    """Atomic checkpoint write; returns the final step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    paths, vals = leaves_with_paths(tree)
    stored = [_storable(v) for v in vals]

    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    manifest = {
        "step": step,
        "leaves": [{"path": p, "shape": list(v.shape), "dtype": dt,
                    "shard": i % nshards}
                   for i, (p, (v, dt)) in enumerate(zip(paths, stored))],
        "nshards": nshards,
        "extra": extra or {},
    }
    for s in range(nshards):
        arrs = {f"leaf_{i}": v for i, (v, _) in enumerate(stored)
                if i % nshards == s}
        np.savez(os.path.join(tmp, f"shard_{s}.npz"), **arrs)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _point_latest(ckpt_dir, f"step_{step}")
    return final


def _point_latest(ckpt_dir: str, name: str):
    tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def load(ckpt_dir: str, *, step: Optional[int] = None
         ) -> tuple[dict, int, dict]:
    """Load a checkpoint WITHOUT a template tree: ``(by_path, step,
    extra)``, ``by_path`` mapping each manifest leaf path to its array
    (a torch tensor for bfloat16 and float8 leaves, numpy otherwise)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shards = {s: np.load(os.path.join(d, f"shard_{s}.npz"))
              for s in range(manifest["nshards"])}
    by_path = {}
    for i, leaf in enumerate(manifest["leaves"]):
        arr = shards[leaf["shard"]][f"leaf_{i}"]
        view = _VIEW_DTYPES.get(leaf["dtype"])
        if view is not None:
            arr = torch.from_numpy(np.ascontiguousarray(arr)).view(
                view[1]).view(view[2])
        by_path[leaf["path"]] = arr
    return by_path, step, manifest["extra"]


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None
            ) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like``: each leaf takes the
    template leaf's dtype (and, for a tensor, its device).  Returns
    (tree, step, extra)."""
    by_path, step, extra = load(ckpt_dir, step=step)
    paths, cur_vals = leaves_with_paths(tree_like)
    out_vals = []
    for p, cur in zip(paths, cur_vals):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p}")
        v = by_path[p]
        if tuple(v.shape) != tuple(np.shape(cur)):
            raise ValueError(f"shape mismatch at {p}: "
                             f"{tuple(v.shape)} vs {tuple(np.shape(cur))}")
        if isinstance(cur, torch.Tensor):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            out_vals.append(t.to(device=cur.device, dtype=cur.dtype))
        else:
            if isinstance(v, torch.Tensor):
                v = v.float().numpy()
            out_vals.append(np.asarray(v).astype(np.asarray(cur).dtype))
    return unflatten(tree_like, out_vals), step, extra


def prune_old(ckpt_dir: str, keep: int = 3):
    """Keep the newest ``keep`` step dirs (garbage collection)."""
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
