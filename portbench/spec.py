"""The benchmark's data and code, found by name: ``BENCHMARK.json`` at the
root of the checkout, and under ``portbench/``

* each configuration, ``configs/<config>.json``, which names its dataset
  (``datasets/<dataset>.py``: the points and the queries' noise);
* each traffic mix, ``traffic/<mix>.json``: parameters only, which name
  the way requests enter the program (``entries/<entry>.py``);
* each cell, ``workloads/<cell>.json``: its configuration, its mix, the
  mix's parameters for the cell and the limits of its checks;
* each end-to-end metric's reader, ``end_to_end/<metric>.py``, and each
  per-layer metric's, ``metrics/<metric>.py``.

A new configuration, dataset, mix, entry, cell or metric adds files and
``BENCHMARK.json`` entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict            # the traffic mix with the cell's parameters
    checks: dict         # number -> {"limit": ...}
    end_to_end: list     # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = root / "portbench"
    work = load_json(here / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"{name}: workloads/{name}.json names "
                         f"{work['config']}/{work['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    config = load_json(here / "configs" / f"{entry['config']}.json")
    mix = dict(load_json(here / "traffic" / f"{entry['traffic']}.json"))
    mix.update(work.get("params", {}))
    return Cell(name=name, chips=entry["chips"], config=config, mix=mix,
                checks=work["checks"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py``, loaded from its path (a
    name may hold dots and dashes)."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} {name!r}: {path} is missing")
    modname = f"portbench.{kind}.{name.replace('-', '_').replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(tracer)`` function of ``metrics/<name>.py``."""
    return plugin("metrics", name, root).read


def end_to_end_reader(name: str, root: Path = ROOT):
    """The ``read(window)`` function of ``end_to_end/<name>.py``."""
    return plugin("end_to_end", name, root).read
