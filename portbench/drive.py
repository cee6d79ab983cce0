"""The one general traffic generator, and the run's bookkeeping.

A traffic mix (``portbench/traffic/<mix>.json``) and a cell's parameters
(``portbench/workloads/<cell>.json``) are merged into one dict of
parameters; nothing here knows a cell by name.  The mix's ``entry``
names the module that puts its requests to the program,
``portbench/entries/<entry>.py``; the configuration's ``dataset`` names
the module that makes its points, ``portbench/datasets/<dataset>.py``.

* Set-up: the configuration's ``points`` are built into the index, which
  is compacted, then ``tail`` further points are inserted into its
  unsorted tail.  The entry starts, and ``warmup_steps`` steps run
  untimed.
* A step admits, in this order, an insert of ``insert`` new points with
  fresh gids, a delete of the ``delete`` oldest tail points, and a query
  batch of ``batch`` queries (an entry takes the kinds it serves).  A
  query is a stored point plus the dataset's noise: ``tail_share`` of a
  batch on points inserted in the ``tail_steps`` steps before (live or
  deleted since), the rest drawn in order from a pool of ``pool``
  queries made on the built points.
* Every admitted item gets a sequence number in admission order; the
  program applies items in that order, so the plain reference knows the
  live rows each batch saw.  Row id == gid: the built points take gids
  0..n-1, later inserts the next gids in order.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from portbench import data as pdata
from portbench import spec

WAIT_S = 120.0      # the longest a request may take before it is failed
NEVER = 2 ** 62


@dataclasses.dataclass
class Request:
    kind: str                 # "query", "insert" or "delete"
    step: int
    seq: int
    t_sent: float
    n: int
    handles: object = None    # query handles, or a write's future
    t_done: Optional[float] = None
    error: Optional[str] = None
    gids: Optional[np.ndarray] = None    # query answers (index entry)
    dists: Optional[np.ndarray] = None
    drops: int = 0


class Reservoir:
    """A uniform sample of ``k`` completed query batches of a window of
    unknown length, drawn from the seed (Algorithm R): a batch that leaves
    the sample drops its answers, so the window's heap stays small."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = np.random.default_rng([seed % 2 ** 63, 1])

    def offer(self, rec: "Request") -> None:
        if rec.error is not None:
            return self._drop(rec)
        i = self.seen if self.seen < self.k else int(
            self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if i >= self.k:
            return self._drop(rec)
        if i < len(self.kept):
            self._drop(self.kept[i])
            self.kept[i] = rec
        else:
            self.kept.append(rec)

    @staticmethod
    def _drop(rec: "Request") -> None:
        rec.handles = rec.gids = rec.dists = None


class Traffic:
    """The requests of one run, made from the seed: the points' order, the
    query pools and each step's rows."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = device
        self.n = cfg["points"]
        ds = pdata.dataset(cfg)
        # the point sets are drawn once from the configuration's data_seed
        # and put in an order drawn from the run's seed, so every seed
        # stores the same points (the same buckets and shard loads: the
        # same work) under other gids; the queries and their noise come
        # from the run's seed
        gd = pdata.generator(cfg["data_seed"], device)
        g = pdata.generator(seed, device)
        self.base = pdata.shuffled(ds.points(gd, self.n, cfg, device), g)
        self.pool = pdata.near(ds, g, self.base, mix["pool"], cfg)
        self.pool_h = self.pool.cpu().numpy()
        self.ins_pool = None
        if mix.get("insert") or mix.get("tail"):
            self.ins_pool = pdata.shuffled(
                ds.points(gd, mix["insert_pool"], cfg, device), g)
            self.ins_h = self.ins_pool.cpu().numpy()
            self.noise_h = ds.noise(g, mix["pool"], cfg, device).cpu().numpy()
        self.b_tail = int(round(mix["batch"] * mix.get("tail_share", 0.0)))
        self.b_base = mix["batch"] - self.b_tail

    def first_gid(self, step: int) -> int:
        """The first gid step ``step`` inserts (the set-up tail is the
        pseudo-step -1)."""
        return self.n + self.mix.get("tail", 0) + step * self.mix.get(
            "insert", 0)

    def points_of(self, gids) -> torch.Tensor:
        """Rows by gid, on the device."""
        gids = torch.as_tensor(gids, device=self.dev)
        out = torch.empty((gids.numel(), self.cfg["d"]), device=self.dev)
        b = gids < self.n
        out[b] = self.base[gids[b]]
        if (~b).any():
            out[~b] = self.ins_pool[(gids[~b] - self.n)
                                    % self.ins_pool.shape[0]]
        return out

    def insert_rows(self, step: int):
        """(points on the device, gids) of step ``step``'s insert; step -1
        is the set-up tail."""
        n = self.mix["tail"] if step < 0 else self.mix["insert"]
        g0 = self.n if step < 0 else self.first_gid(step)
        gids = np.arange(g0, g0 + n, dtype=np.int64)
        return self.points_of(gids), gids

    def queries(self, step: int) -> np.ndarray:
        """Step ``step``'s query rows (batch, d) float32 on the host."""
        P = self.pool_h.shape[0]
        start = (step * self.b_base) % P
        idx = (start + np.arange(self.b_base)) % P
        rows = [self.pool_h[idx]]
        if self.b_tail:
            hi = self.first_gid(step)
            lo = max(self.n, hi - self.mix["tail_steps"] * self.mix["insert"])
            rng = np.random.default_rng([self.seed % 2 ** 63, step + 2])
            gids = rng.integers(lo, hi, self.b_tail)
            pts = self.ins_h[(gids - self.n) % self.ins_h.shape[0]]
            e = (step * self.b_tail + np.arange(self.b_tail)) % P
            rows.append(pts + self.noise_h[e])
        return np.ascontiguousarray(np.concatenate(rows), np.float32)


class Driver:
    """One run of one cell: set-up, a window, the records."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.K = cfg["K"]
        self.entry = spec.plugin("entries", mix["entry"])
        self.seq = 0
        self.tail = collections.deque()      # live tail gids, oldest first
        self.t_in: dict[int, int] = {}       # gid -> admission seq
        self.t_out: dict[int, int] = {}
        self.svc = None
        self.idx = None

    # ------------------------------------------------------------------
    def setup(self) -> None:
        """Make the data, build and compact the program's index, start the
        entry and run the warm-up steps."""
        from repro_torch.core import DistributedLSHIndex, LSHConfig, Scheme
        c, mix = self.cfg, self.mix
        self.traffic = Traffic(c, mix, self.seed, self.dev)
        lsh = LSHConfig(d=c["d"], k=c["k"], W=float(c["W"]), r=float(c["r"]),
                        c=float(c["c"]), L=c["L"], n_shards=c["n_shards"],
                        scheme=Scheme(c["scheme"]), seed=c["seed"],
                        n_tables=c["n_tables"],
                        query_capacity=c.get("query_capacity"),
                        data_capacity=c.get("data_capacity"))
        self.idx = DistributedLSHIndex(lsh, device=self.dev,
                                       k_neighbors=self.K)
        # the build: one insert, or inserts of build_chunk points into a
        # store of build_capacity rows a shard
        base, chunk = self.traffic.base, c.get("build_chunk") or c["points"]
        self.idx.build(base[:chunk], capacity=c.get("build_capacity"))
        for lo in range(chunk, c["points"], chunk):
            self.idx.insert(base[lo:lo + chunk])
        if self.idx.build_result.drops:
            raise RuntimeError(
                f"the build dropped {self.idx.build_result.drops} rows")
        self.idx.compact()
        if mix.get("tail"):
            pts, gids = self.traffic.insert_rows(-1)
            res = self.idx.insert(pts, gids=gids)
            if res.drops:
                raise RuntimeError(f"the tail insert dropped {res.drops}")
        self._after_tail()
        self.entry.start(self)
        self.warm = self.window(steps=mix["warmup_steps"], first_step=0)
        bad = [r for r in self.warm if r.error]
        if bad:
            raise RuntimeError(f"warm-up failed: {bad[0].error}")
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def dry(self, steps: int) -> list[Request]:
        """The requests of the warm-up and ``steps`` further steps, with
        their sequence numbers and rows' live intervals, admitted to no
        program (the control reads them).  Returns the further steps'."""
        self.traffic = Traffic(self.cfg, self.mix, self.seed, self.dev)
        self._after_tail()
        n_warm = self.mix["warmup_steps"]
        recs = []
        for j in range(n_warm + steps):
            recs += self.entry.admit(self, j, 0.0, program=False)
        return [r for r in recs if r.step >= n_warm]

    def _after_tail(self) -> None:
        """The set-up tail's rows are live from sequence number 0; the
        first admitted request takes 1."""
        if self.mix.get("tail"):
            self.inserted(np.arange(self.traffic.n,
                                    self.traffic.n + self.mix["tail"]), 0)
        self.seq = 1

    def inserted(self, gids, seq) -> None:
        """Rows ``gids`` are live from admission ``seq``."""
        for g in gids.tolist():
            self.t_in[g] = seq
            self.tail.append(g)

    def deleted(self, n: int, seq: int) -> np.ndarray:
        """The ``n`` oldest live tail rows, dead from admission ``seq``."""
        gids = np.array([self.tail.popleft() for _ in range(n)], np.int64)
        for g in gids.tolist():
            self.t_out[g] = seq
        return gids

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq - 1

    def dropped(self) -> int:
        """Routed rows the entry has dropped so far that no request's
        error counts."""
        return self.entry.dropped(self)

    def close(self) -> None:
        self.entry.stop(self)
        self.svc = self.idx = None

    # ------------------------------------------------------------------
    def window(self, seconds: Optional[float] = None,
               steps: Optional[int] = None,
               first_step: Optional[int] = None) -> list[Request]:
        """Run steps until ``seconds`` have passed or ``steps`` steps are
        admitted, then wait for every admitted request.  Returns the
        window's requests; the answers of the ``sample_batches`` query
        batches that ``self.sample`` draws are kept, the rest dropped as
        they complete.  Sets ``t_start``, the window's start."""
        j0 = self.next_step if first_step is None else first_step
        self.sample = Reservoir(self.mix["sample_batches"], self.seed)
        recs = self.entry.window(self, j0, seconds, steps)
        self.next_step = j0 + len({r.step for r in recs})
        return recs

    @staticmethod
    def done(j: int, j0: int, t_end: Optional[float],
             steps: Optional[int]) -> bool:
        """Whether the window admits no step ``j``."""
        if steps is not None and j - j0 >= steps:
            return True
        return t_end is not None and time.perf_counter() >= t_end

    # ------------------------------------------------------------------
    def answers(self, rec: Request):
        """A completed query batch's (gids (b, K), dists (b, K))."""
        if rec.gids is not None:
            return rec.gids, rec.dists
        hs = rec.handles
        return (np.stack([h.gids for h in hs]).astype(np.int64),
                np.stack([h.dists for h in hs]))

    def live_intervals(self, n_rows: int):
        """(t_in, t_out) int64 of rows 0..n_rows-1 for the reference."""
        t_in = np.full(n_rows, -1, np.int64)
        t_out = np.full(n_rows, NEVER, np.int64)
        for g, s in self.t_in.items():
            if g < n_rows:
                t_in[g] = s
        for g, s in self.t_out.items():
            if g < n_rows:
                t_out[g] = s
        n = self.traffic.n
        t_in[n:][t_in[n:] < 0] = NEVER      # gids never inserted
        return t_in, t_out

