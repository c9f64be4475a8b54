"""The system under test, as its users call it:
``repro_torch.core.Mirage(MirageConfig(...)).fit(graphs)``, with the
defaults a user gets (single-sync pipeline, the backend and the packed
support path chosen for the device and the database, speculative host
candgen, shape buckets, the audit word) and the cell's minsup, maximum
pattern size, partition count and partition scheme.  This module is the
only one of the benchmark that imports the program."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from .generator import PlainGraph

__all__ = ["FitRecord", "build_kernels", "to_graphs", "make_config",
           "fit_once"]


@dataclasses.dataclass
class FitRecord:
    """What one fit left for the metrics and the check."""

    seconds: float                   # the host's clock around fit()
    stats: list[dict]                # the program's LevelStats, per level
    levels: list[list[tuple]]        # frequent codes per level
    supports: dict                   # code -> support
    minsup: int                      # the absolute threshold it used


def build_kernels() -> bool:
    """Build the program's kernel library into its cache inside the
    checkout, unless it is there already.  True when it was built."""
    from repro_torch.kernels.build import build_kernels as build
    return bool(build()[1])


def to_graphs(db: Sequence[PlainGraph]) -> list:
    """The benchmark's graphs as the program's ``Graph`` objects."""
    from repro_torch.core.graphdb import Graph
    return [Graph(g.vlabels, g.edges, g.elabels) for g in db]


def make_config(config: dict, traffic: dict, overrides: Optional[dict] = None):
    """The ``MirageConfig`` of a cell: only what the deployment and the
    job fix; every other field keeps the program's default.
    ``overrides`` serves the control runs alone (``control.py``)."""
    from repro_torch.core.mining import MirageConfig
    kw = dict(minsup=traffic["minsup"],
              n_partitions=int(config["n_partitions"]),
              scheme=config["scheme"], max_size=traffic["max_size"])
    kw.update(overrides or {})
    return MirageConfig(**kw)


def fit_once(graphs: list, config: dict, traffic: dict, device: str,
             overrides: Optional[dict] = None, sync=None) -> FitRecord:
    """One fresh ``Mirage(...).fit(graphs)``, timed on the host's clock
    (``sync`` is called before the clock stops: the device's queue is
    drained, so the time is the whole fit's)."""
    from repro_torch.core.mining import Mirage
    t0 = time.perf_counter()
    miner = Mirage(make_config(config, traffic, overrides), device=device)
    res = miner.fit(graphs)
    if sync is not None:
        sync()
    seconds = time.perf_counter() - t0
    return FitRecord(seconds, [dataclasses.asdict(s) for s in res.stats],
                     [list(l) for l in res.levels], dict(res.supports),
                     int(res.minsup))
