"""Tiny cells for the benchmark's CPU tests: each real cell, and each
cell held out of BENCHMARK.json, with its widths cut so that a run on
the CPU takes seconds, and the general generator's write path, which no
cell drives yet."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# "serve-d64.query" is no cell of BENCHMARK.json: its rate is the host's
# speed and spread past any bound (PERF.md, Open questions).  Its files
# stay, and it is built from them with the metrics it reported, so that
# the service's path stays tested until a cell drives it again.
# "serve-d64.stream" is that cell with a step of an insert, a delete of
# the oldest tail points and a query batch over an unsorted tail, so that
# the write path, the full scan and write_p95_ms stay tested too.
CELLS = ("serve-d64.query", "random-1m.batch", "serve-d64.stream")
HELD = {"serve-d64.query": (
    [("query_throughput", "queries/s"), ("query_p95_ms", "ms"),
     ("setup_s", "s")],
    [("host_syncs_per_batch", "syncs"), ("launches_per_batch", "launches"),
     ("lsh_hash_roofline", "%"), ("bucket_gather_roofline", "%"),
     ("device_idle_pct", "%")])}
WRITES = dict(tail=256, insert=32, delete=32, insert_pool=4096,
              tail_share=0.5, tail_steps=16)


def held_cell(name):
    """A cell of ``HELD`` built from its files under ``portbench/``."""
    from portbench import spec
    work = spec.load_json(spec.HERE / "workloads" / f"{name}.json")
    mix = dict(spec.load_json(spec.HERE / "traffic"
                              / f"{work['traffic']}.json"))
    mix.update(work.get("params", {}))
    e2e, layers = HELD[name]
    return spec.Cell(
        name=name, chips=1, config=spec.load_json(
            spec.HERE / "configs" / f"{work['config']}.json"),
        mix=mix, checks=work["checks"],
        end_to_end=[{"name": n, "unit": u} for n, u in e2e],
        per_layer=[{"name": n, "unit": u} for n, u in layers])


def tiny_cell(name):
    from portbench import spec
    writes = name == "serve-d64.stream"
    base = "serve-d64.query" if writes else name
    c = held_cell(base) if base in HELD else spec.cell(base)
    c.config = dict(c.config, d=16, k=4, L=4, n_shards=4, points=2048, K=5)
    c.mix = dict(c.mix, batch=32, pool=256, warmup_steps=1, trace_steps=2,
                 sample_batches=3)
    if writes:
        c.name = name
        c.mix.update(WRITES)
        c.end_to_end = c.end_to_end + [{"name": "write_p95_ms",
                                        "unit": "ms"}]
        c.per_layer = c.per_layer + [{"name": "bucket_search_roofline",
                                      "unit": "%"}]
    return c


@pytest.fixture
def tiny():
    return tiny_cell
