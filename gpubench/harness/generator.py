"""The benchmark's databases: a configuration names its generator,
``gpubench/generators/<name>.py`` (a module with ``generate(n_graphs, *,
seed, **generator_args)`` that returns ``(vlabels, edges, elabels)``
tuples of int32 arrays), and a run's seed shuffles what it made.  A
graph is a plain ``PlainGraph``; the harness turns them into the
program's ``Graph`` objects and the reference reads them as they are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .spec import load_generator

__all__ = ["PlainGraph", "shuffled", "generate", "make_db"]


class PlainGraph(NamedTuple):
    vlabels: np.ndarray     # (n_v,) int32
    edges: np.ndarray       # (n_e, 2) int32, u < v
    elabels: np.ndarray     # (n_e,) int32


def shuffled(db: list[PlainGraph], seed: int) -> list[PlainGraph]:
    """``db`` in an order drawn from ``seed``, each graph's vertices
    renumbered and its edges reordered by the same stream: the same
    graphs, so the same frequent set and the same work, as other bytes
    in another order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.permutation(len(db)):
        g = db[int(i)]
        new_id = rng.permutation(g.vlabels.shape[0]).astype(np.int32)
        vlabels = np.empty_like(g.vlabels)
        vlabels[new_id] = g.vlabels
        edges = np.sort(new_id[g.edges], axis=1)
        order = rng.permutation(g.edges.shape[0])
        out.append(PlainGraph(vlabels, edges[order], g.elabels[order]))
    return out


def generate(name: str, n_graphs: int, seed: int,
             **args) -> list[PlainGraph]:
    """``n_graphs`` graphs of the generator ``name``, from ``seed``."""
    return [PlainGraph(*g) for g in load_generator(name).generate(
        n_graphs, seed=seed, **args)]


def make_db(config: dict, seed: int) -> list[PlainGraph]:
    """The database a configuration file describes: its graphs are made
    from the configuration's ``base_seed``, and ``seed`` (any integer,
    taken modulo 2**64) shuffles them (``shuffled``), so that every seed
    gives the work of the same deployment."""
    base = generate(config["generator"], int(config["n_graphs"]),
                    int(config["base_seed"]),
                    **config.get("generator_args", {}))
    return shuffled(base, int(seed) % (1 << 64))
