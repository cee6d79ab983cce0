"""The planted dataset, made from a seed on the device in a few large
calls: points N(0, I/d); a query is a stored point plus N(0, r^2 I/d)
noise.  A frozen copy of ``chip_smoke.py:824-834`` (itself the
reference's ``repro.data.planted_random``), rewritten for a
``torch.Generator`` on the card; the same seed gives the same tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def points(g: torch.Generator, n: int, cfg: dict, device) -> torch.Tensor:
    """(n, d) float32 points N(0, I/d)."""
    d = cfg["d"]
    x = torch.randn((n, d), generator=g, device=device)
    return x.mul_(np.float32(1.0 / math.sqrt(d)))


def noise(g: torch.Generator, m: int, cfg: dict, device) -> torch.Tensor:
    """(m, d) float32 noise N(0, r^2 I/d)."""
    d, r = cfg["d"], float(cfg["r"])
    e = torch.randn((m, d), generator=g, device=device)
    return e.mul_(np.float32(r / math.sqrt(d)))
