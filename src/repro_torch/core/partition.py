"""Data-partition phase (paper §IV-C.1).

Splits the transaction database into many partitions — deliberately far
more partitions than workers (paper Fig. 20: mapper cost is exponential
in partition size, shuffle cost only linear) — and strips globally
infrequent edges while doing so (paper Fig. 11).

Three schemes:
  scheme 1 — balance the number of graphs per partition (paper);
  scheme 2 — balance the total number of *edges* per partition (greedy
             LPT bin packing), the load-balancing win of Table IV (paper);
  "density" — balance edge DENSITY, à la Aridhi et al. (arXiv
             1212.0017): graphs sorted by density 2E/(V(V-1)) and
             snake-dealt across partitions, so the densest graphs — the
             ones whose embedding joins dominate map cost superlinearly
             in E — spread evenly instead of pooling in one LPT bin and
             serializing a shard.  Edge count is the tie-break within
             equal density, graph count the final tie-break.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..runtime import trace
from .graphdb import Graph, validate_db
from .host_miner import frequent_edges
from .candgen import EdgeAlphabet

__all__ = ["PartitionResult", "filter_infrequent_edges", "graph_density",
           "make_partitions"]


@dataclasses.dataclass
class PartitionResult:
    partitions: list[list[Graph]]      # filtered graphs per partition
    graph_ids: list[list[int]]         # original indices (for support audit)
    alphabet: EdgeAlphabet             # global F_1 label triples
    minsup: int                        # absolute threshold
    n_graphs: int                      # original database size


def filter_infrequent_edges(
    graphs: Sequence[Graph], minsup: int
) -> tuple[list[Graph], EdgeAlphabet]:
    """Drop every edge whose label triple is globally infrequent."""
    alphabet, _ = frequent_edges(graphs, minsup)
    out = []
    for g in graphs:
        keep = np.zeros(g.n_edges, bool)
        for k, ((u, v), el) in enumerate(zip(g.edges, g.elabels)):
            t = (int(g.vlabels[u]), int(el), int(g.vlabels[v]))
            keep[k] = t in alphabet
        out.append(g.keep_edges(keep))
    return out, alphabet


def graph_density(g: Graph) -> float:
    """Undirected edge density 2E/(V(V-1)); a single-vertex (or empty)
    graph has density 0 by convention."""
    v = g.n_vertices
    return 0.0 if v < 2 else 2.0 * g.n_edges / (v * (v - 1))


def make_partitions(
    graphs: Sequence[Graph],
    minsup: int | float,
    n_partitions: int,
    *,
    scheme: int | str = 2,
) -> PartitionResult:
    """Filter + split.  ``minsup`` may be absolute (int) or a fraction.

    Raises when the split would leave partitions empty: an empty
    partition pads silently into the dense device encoding and wastes a
    worker slot — the caller (``Mirage.fit``) auto-clamps instead.  An
    EMPTY database is exempt (its partitions are necessarily empty;
    mining short-circuits to an empty result).
    """
    n = len(graphs)
    if n:
        # the load boundary: user input is validated HERE, before any
        # filtering (keep_edges legitimately empties graphs later).
        # An empty database stays exempt per the contract above.
        with trace.span("prep.partition.validate"):
            validate_db(graphs)
    if n_partitions < 1:
        raise ValueError(f"n_partitions={n_partitions} must be >= 1")
    if n and n_partitions > n:
        raise ValueError(
            f"n_partitions={n_partitions} exceeds the database size {n}: "
            f"every partition must hold at least one graph (clamp "
            f"n_partitions or pass more graphs)")
    abs_minsup = (int(np.ceil(minsup * n)) if isinstance(minsup, float)
                  else int(minsup))
    with trace.span("prep.partition.filter"):
        filtered, alphabet = filter_infrequent_edges(graphs, abs_minsup)
    with trace.span("prep.partition.split"):
        return _split(filtered, alphabet, abs_minsup, n_partitions, scheme)


def _split(filtered: list[Graph], alphabet: EdgeAlphabet, abs_minsup: int,
           n_partitions: int, scheme: int | str) -> PartitionResult:
    """The filtered graphs dealt into ``n_partitions`` by ``scheme``."""
    n = len(filtered)
    ids = list(range(n))
    parts: list[list[int]] = [[] for _ in range(n_partitions)]
    if scheme == 1:
        for i in ids:
            parts[i % n_partitions].append(i)
    elif scheme == 2:
        load = np.zeros(n_partitions, np.int64)
        # LPT: heaviest graphs first onto the lightest partition;
        # ties (e.g. fully-filtered zero-edge graphs) break on graph
        # count so no partition is starved empty
        order = sorted(ids, key=lambda i: -filtered[i].n_edges)
        for i in order:
            p = min(range(n_partitions),
                    key=lambda b: (load[b], len(parts[b])))
            parts[p].append(i)
            load[p] += filtered[i].n_edges
    elif scheme == "density":
        # densest graphs first, snake-dealt (0..NP-1, NP-1..0, ...): each
        # pass hands every partition exactly one graph of comparable
        # density, and the direction flip cancels the within-pass bias —
        # graph counts stay balanced (|Δ| <= 1) by construction, so no
        # partition starves even when the DB is density-uniform
        order = sorted(ids, key=lambda i: (-graph_density(filtered[i]),
                                           -filtered[i].n_edges))
        for rank, i in enumerate(order):
            sweep, pos = divmod(rank, n_partitions)
            parts[pos if sweep % 2 == 0 else
                  n_partitions - 1 - pos].append(i)
    else:
        raise ValueError(f"unknown scheme {scheme!r} (1 | 2 | 'density')")

    return PartitionResult(
        partitions=[[filtered[i] for i in p] for p in parts],
        graph_ids=parts,
        alphabet=alphabet,
        minsup=abs_minsup,
        n_graphs=n,
    )
