"""BENCHMARK.json and the files it names: the contract's limits on names,
units and keys, and every cell resolving, by name, to its files."""
import json
import re

import pytest
from pathlib import Path

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_budget_fits_the_full_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[key]), (e["name"], key)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = spec.cell(cell)
    assert c.config["d"] > 0 and c.mix["batch"] % c.config["n_shards"] == 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(spec.metric_reader(m["name"]))
    assert set(c.checks) == {"wrong_answers", "dist_rel_err"}


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    for m in BENCH[kind]:
        read = (spec.end_to_end_reader if kind == "end_to_end"
                else spec.metric_reader)(m["name"])
        assert callable(read), m["name"]


def test_every_mix_names_its_entry_and_source():
    for w in BENCH["workloads"]:
        mix = spec.cell(w["name"]).mix
        assert LINE.match(mix["source"]), w["name"]
        entry = spec.plugin("entries", mix["entry"])
        for f in ("start", "stop", "dropped", "admit", "window"):
            assert callable(getattr(entry, f)), (mix["entry"], f)


def test_every_config_names_its_dataset():
    for c in BENCH["configs"]:
        cfg = spec.load_json(ROOT / c["file"])
        ds = spec.plugin("datasets", cfg["dataset"])
        assert callable(ds.points) and callable(ds.noise), c["name"]


def test_a_missing_plugin_is_named():
    with pytest.raises(KeyError, match="no entries 'nowhere'"):
        spec.plugin("entries", "nowhere")
