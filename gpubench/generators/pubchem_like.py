"""The PubChem-like database: a frozen copy of the program's
``pubchem_like_db`` (``repro_torch.core.graphdb``, commit 3864662), so
that the yardstick's data does not move when the program's generator
does.

It makes graphs with the statistics of one PubChem NCI-60 anticancer
screen as the MIRAGE paper's Table I gives them (~25-30 bonds a
molecule): 8 atom labels with 60 % carbon, 3 bond labels, a random
spanning tree plus a few extra edges (near-tree, a ring or two).  Each
graph is a ``(vlabels, edges, elabels)`` tuple of int32 arrays, edges
undirected with ``u < v``.
"""
from __future__ import annotations

import numpy as np

Graph = tuple[np.ndarray, np.ndarray, np.ndarray]


def _random_connected_graph(rng: np.random.Generator, n_v: int,
                            extra_edge_prob: float, n_vlabels: int,
                            n_elabels: int) -> Graph:
    """Random spanning tree (random attachment) + Bernoulli extra edges,
    drawing from ``rng`` in the program's order."""
    vlabels = rng.integers(0, n_vlabels, size=n_v)
    edge_set: set[tuple[int, int]] = set()
    order = rng.permutation(n_v)
    for idx in range(1, n_v):
        u = int(order[idx])
        v = int(order[rng.integers(0, idx)])
        edge_set.add((min(u, v), max(u, v)))
    if n_v >= 3 and extra_edge_prob > 0:
        for _ in range(int(extra_edge_prob * n_v)):
            u, v = rng.integers(0, n_v, size=2)
            if u != v:
                edge_set.add((min(int(u), int(v)), max(int(u), int(v))))
    edges = np.array(sorted(edge_set), dtype=np.int32).reshape(-1, 2)
    elabels = rng.integers(0, n_elabels, size=edges.shape[0])
    return (vlabels.astype(np.int32), edges, elabels.astype(np.int32))


def generate(n_graphs: int, *, seed: int,
             avg_edges: float = 28.0) -> list[Graph]:
    """Molecule-like database: ~``avg_edges`` bonds a graph (normal, sd
    4), |V| ~ 0.92 |E|, 8 atom labels skewed 60 % to label 0 ("carbon"),
    3 bond labels."""
    rng = np.random.default_rng(seed)
    out = []
    n_vlabels, n_elabels = 8, 3
    for _ in range(n_graphs):
        n_e_target = max(3, int(rng.normal(avg_edges, 4.0)))
        n_v = max(3, int(n_e_target * 0.92))
        g = _random_connected_graph(rng, n_v, 0.12, n_vlabels, n_elabels)
        skew = rng.random(g[0].shape[0]) < 0.6
        g[0][skew] = 0
        out.append(g)
    return out
