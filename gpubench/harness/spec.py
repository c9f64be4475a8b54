"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's
root lists the cells (``workloads``), configurations and metrics; each
configuration is ``gpubench/configs/<name>.json`` (which names its
generator, ``gpubench/generators/<name>.py``), each traffic mix
``gpubench/traffic/<name>.json`` and each metric's reader
``gpubench/metrics/<name>.py``.  A later change adds a cell, a
configuration or a metric by adding files and entries; nothing here
names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_json",
           "load_metric", "load_generator"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the deployment: data, partitions, scheme
    traffic: dict           # the job: minsup, max_size, warm-up slice
    end_to_end: list[str]   # metric names a --trace 0 run reports
    per_layer: list[str]    # metric names a --trace 1 run reports


def _reported(metrics: list[dict], cell: str) -> list[str]:
    return [m["name"] for m in metrics
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration and
    traffic files read."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                _reported(bench["end_to_end"], name),
                _reported(bench["per_layer"], name))


def _load(kind: str, name: str) -> ModuleType:
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str) -> ModuleType:
    """The reader ``gpubench/metrics/<name>.py``: a module with ``UNIT``,
    ``read(record)`` (a number, or None when the run holds nothing to
    read) and, optionally, ``install(hooks)`` for a traced run."""
    return _load("metrics", name)


def load_generator(name: str) -> ModuleType:
    """The database generator ``gpubench/generators/<name>.py``."""
    return _load("generators", name)
