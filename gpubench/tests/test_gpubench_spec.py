"""Cells, configurations and metrics are found by name from their files,
and BENCHMARK.json keeps to the contract's shape."""
import json
import re

import pytest

from harness.generator import generate
from harness.spec import BENCH_DIR, ROOT, load_cell, load_json, load_metric

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert c.config == load_json(ROOT / conf["file"])
    assert c.config["name"] == w["config"]
    traffic = BENCH_DIR / "traffic" / f"{w['traffic']}.json"
    assert c.traffic == load_json(traffic)
    assert c.chips == w["chips"]
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_generator_found_by_name(config):
    conf = load_json(ROOT / config)
    db = generate(conf["generator"], 3, 1, **conf.get("generator_args", {}))
    assert len(db) == 3
    assert all(g.edges.shape[1] == 2 and g.elabels.shape[0] ==
               g.edges.shape[0] for g in db)


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        load_cell("no-such-cell")


@pytest.mark.parametrize(
    "metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = load_metric(metric)
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    assert mod.UNIT == entry["unit"]
    assert callable(mod.read)
    if "layer" in entry:
        assert mod.LAYER == entry["layer"]
        assert mod.MOVES == entry["moves"]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/")
        assert load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024
