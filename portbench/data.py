"""The seeded generators a run draws from, and the dataset a
configuration names: ``"dataset": "<name>"`` in its file is
``portbench/datasets/<name>.py``, which makes the stored points and the
perturbation that turns a stored point into a query near it.  A new
dataset adds a file there, and no code here changes.
"""
from __future__ import annotations

import torch

from portbench import spec


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def shuffled(x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The rows of x in an order drawn from g."""
    return x[torch.randperm(x.shape[0], generator=g, device=x.device)]


def dataset(cfg: dict):
    """The module ``datasets/<cfg["dataset"]>.py``: ``points(g, n, cfg,
    device)`` and ``noise(g, m, cfg, device)``."""
    return spec.plugin("datasets", cfg["dataset"])


def near(ds, g: torch.Generator, rows: torch.Tensor, m: int,
         cfg: dict) -> torch.Tensor:
    """(m, d) queries, each a uniformly drawn row of ``rows`` plus the
    dataset's noise."""
    idx = torch.randint(0, rows.shape[0], (m,), generator=g,
                        device=rows.device)
    return rows[idx] + ds.noise(g, m, cfg, rows.device)
