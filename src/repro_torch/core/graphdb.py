"""Dense tensor encoding of a labeled-graph transaction database.

The paper's input is a database ``G = {G_1..G_n}`` of labeled, undirected,
connected graphs (PubChem molecules / Graphgen synthetics).  Hadoop-MIRAGE
keeps each partition as adjacency lists in Java objects; on an
accelerator we need a fixed-shape, masked, integer encoding so a
partition is a handful of dense arrays.

Encoding (one partition, ``G`` graphs padded to ``V`` vertices / ``E``
undirected edges):

  vlabels : (G, V)  int32   vertex labels, -1 where padded
  edges   : (G, E, 2) int32 endpoints (u < v), 0 where padded
  elabels : (G, E)  int32   edge labels, -1 where padded
  emask   : (G, E)  bool    real-edge mask
  nglobal : ()      int32   number of real graphs in the partition

Vertex ids are 0-based and dense per graph.  Undirected edges are stored
once with u < v; the mining layer expands both directions when needed.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Graph",
    "GraphDB",
    "GraphValidationError",
    "validate_db",
    "encode_db",
    "decode_db",
    "random_db",
    "pubchem_like_db",
]


class GraphValidationError(ValueError):
    """A malformed input graph database (DESIGN.md §10: garbage is
    rejected at the door, never mined into silently wrong supports)."""


@dataclasses.dataclass
class Graph:
    """Host-side labeled undirected graph (adjacency-list form)."""

    vlabels: np.ndarray            # (n_v,) int
    edges: np.ndarray              # (n_e, 2) int, u < v
    elabels: np.ndarray            # (n_e,) int

    def __post_init__(self) -> None:
        self.vlabels = np.asarray(self.vlabels, dtype=np.int32)
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)
        self.elabels = np.asarray(self.elabels, dtype=np.int32)
        if self.edges.size:
            lo = np.minimum(self.edges[:, 0], self.edges[:, 1])
            hi = np.maximum(self.edges[:, 0], self.edges[:, 1])
            self.edges = np.stack([lo, hi], axis=1)

    @property
    def n_vertices(self) -> int:
        return int(self.vlabels.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def neighbors(self, u: int) -> list[tuple[int, int]]:
        """List of (vertex, edge-label) incident to ``u``."""
        out = []
        for (a, b), el in zip(self.edges, self.elabels):
            if a == u:
                out.append((int(b), int(el)))
            elif b == u:
                out.append((int(a), int(el)))
        return out

    def keep_edges(self, keep: np.ndarray) -> "Graph":
        """Return a copy with only the edges where ``keep`` is True,
        dropping now-isolated vertices and re-densifying vertex ids.

        ``keep`` is a KEEP mask, not a drop mask::

            >>> g = Graph(np.array([0, 1, 2]),
            ...           np.array([[0, 1], [1, 2]]), np.array([7, 8]))
            >>> g.keep_edges(np.array([True, False])).n_edges  # keeps 0-1
            1
        """
        edges = self.edges[keep]
        elabels = self.elabels[keep]
        used = np.zeros(self.n_vertices, dtype=bool)
        if edges.size:
            used[edges.reshape(-1)] = True
        remap = -np.ones(self.n_vertices, dtype=np.int32)
        remap[used] = np.arange(int(used.sum()), dtype=np.int32)
        new_edges = remap[edges] if edges.size else edges
        return Graph(self.vlabels[used], new_edges, elabels)


@dataclasses.dataclass
class GraphDB:
    """Dense-encoded database (or one partition of it)."""

    vlabels: np.ndarray   # (G, V) int32, -1 pad
    edges: np.ndarray     # (G, E, 2) int32
    elabels: np.ndarray   # (G, E) int32, -1 pad
    emask: np.ndarray     # (G, E) bool
    n_graphs: int         # real graph count (<= G)

    @property
    def shape(self) -> tuple[int, int, int]:
        g, v = self.vlabels.shape
        e = self.edges.shape[1]
        return g, v, e

    @property
    def n_vertex_labels(self) -> int:
        return int(self.vlabels.max()) + 1 if self.vlabels.size else 0

    @property
    def n_edge_labels(self) -> int:
        m = int(self.elabels.max()) if self.elabels.size else -1
        return m + 1

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "vlabels": self.vlabels,
            "edges": self.edges,
            "elabels": self.elabels,
            "emask": self.emask,
        }


def validate_db(graphs: Sequence[Graph]) -> None:
    """Validate a user-supplied transaction database at the load
    boundary (``make_partitions`` calls this before any filtering).

    Rejected with a :class:`GraphValidationError` naming the offending
    graph AND (for per-edge defects) the offending edge index: empty
    graphs, negative vertex/edge labels, edge-label arrays not matching
    the edge count, dangling edge endpoints (out of ``[0, n_v)``),
    self-loops, and duplicate undirected edges.  Only
    *user input* is checked — internally derived graphs (e.g. after
    infrequent-edge filtering, which legitimately empties graphs) never
    pass through here.
    """
    if len(graphs) == 0:
        raise GraphValidationError("empty database: no graphs to mine")
    for i, g in enumerate(graphs):
        if not isinstance(g, Graph):
            raise GraphValidationError(
                f"graph {i}: expected a Graph, got {type(g).__name__}")
        if g.n_vertices == 0:
            raise GraphValidationError(f"graph {i}: no vertices")
        if g.elabels.shape[0] != g.n_edges:
            raise GraphValidationError(
                f"graph {i}: {g.n_edges} edges but "
                f"{g.elabels.shape[0]} edge labels")
        if g.vlabels.min(initial=0) < 0:
            raise GraphValidationError(
                f"graph {i}: negative vertex label "
                f"{int(g.vlabels.min())}")
        if g.n_edges == 0:
            continue
        if g.elabels.min() < 0:
            j = int(np.flatnonzero(g.elabels < 0)[0])
            raise GraphValidationError(
                f"graph {i}, edge {j}: negative edge label "
                f"{int(g.elabels[j])}")
        bad = np.flatnonzero((g.edges < 0).any(axis=1)
                             | (g.edges >= g.n_vertices).any(axis=1))
        if bad.size:
            j = int(bad[0])
            u, v = (int(x) for x in g.edges[j])
            raise GraphValidationError(
                f"graph {i}, edge {j}: dangling edge endpoint "
                f"{u if u < 0 or u >= g.n_vertices else v} "
                f"outside [0, {g.n_vertices})")
        loops = np.flatnonzero(g.edges[:, 0] == g.edges[:, 1])
        if loops.size:
            j = int(loops[0])
            raise GraphValidationError(
                f"graph {i}, edge {j}: self-loop at vertex "
                f"{int(g.edges[j, 0])}")
        # Graph.__post_init__ normalized endpoints to u < v, so exact
        # row duplicates are exactly duplicate undirected edges
        uniq, first, counts = np.unique(g.edges, axis=0,
                                        return_index=True,
                                        return_counts=True)
        if uniq.shape[0] != g.n_edges:
            j = int(first[counts > 1][0])
            u, v = (int(x) for x in g.edges[j])
            raise GraphValidationError(
                f"graph {i}, edge {j}: duplicate edge ({u}, {v}) — "
                f"{g.n_edges - uniq.shape[0]} repeated row(s)")


def encode_db(
    graphs: Sequence[Graph],
    *,
    pad_graphs: int | None = None,
    pad_vertices: int | None = None,
    pad_edges: int | None = None,
) -> GraphDB:
    """Pad/stack host graphs into a :class:`GraphDB`."""
    n = len(graphs)
    gpad = pad_graphs or n
    vpad = pad_vertices or max((g.n_vertices for g in graphs), default=1)
    epad = pad_edges or max((g.n_edges for g in graphs), default=1)
    vpad, epad = max(vpad, 1), max(epad, 1)
    if gpad < n:
        raise ValueError(f"pad_graphs={gpad} < {n} graphs")

    vlabels = -np.ones((gpad, vpad), dtype=np.int32)
    edges = np.zeros((gpad, epad, 2), dtype=np.int32)
    elabels = -np.ones((gpad, epad), dtype=np.int32)
    emask = np.zeros((gpad, epad), dtype=bool)
    for i, g in enumerate(graphs):
        if g.n_vertices > vpad or g.n_edges > epad:
            raise ValueError(
                f"graph {i} ({g.n_vertices}v,{g.n_edges}e) exceeds pad "
                f"({vpad}v,{epad}e)")
        vlabels[i, : g.n_vertices] = g.vlabels
        if g.n_edges:
            edges[i, : g.n_edges] = g.edges
            elabels[i, : g.n_edges] = g.elabels
            emask[i, : g.n_edges] = True
    return GraphDB(vlabels, edges, elabels, emask, n_graphs=n)


def decode_db(db: GraphDB) -> list[Graph]:
    out = []
    for i in range(db.n_graphs):
        nv = int((db.vlabels[i] >= 0).sum())
        keep = db.emask[i]
        out.append(Graph(db.vlabels[i, :nv], db.edges[i][keep], db.elabels[i][keep]))
    return out


# ---------------------------------------------------------------------------
# Synthetic dataset generators
# ---------------------------------------------------------------------------

def _random_connected_graph(
    rng: np.random.Generator,
    n_v: int,
    extra_edge_prob: float,
    n_vlabels: int,
    n_elabels: int,
) -> Graph:
    """Random connected graph: random spanning tree + Bernoulli extra edges."""
    vlabels = rng.integers(0, n_vlabels, size=n_v)
    edge_set: set[tuple[int, int]] = set()
    # random spanning tree (random attachment)
    order = rng.permutation(n_v)
    for idx in range(1, n_v):
        u = int(order[idx])
        v = int(order[rng.integers(0, idx)])
        edge_set.add((min(u, v), max(u, v)))
    # extra edges
    if n_v >= 3 and extra_edge_prob > 0:
        n_try = int(extra_edge_prob * n_v)
        for _ in range(n_try):
            u, v = rng.integers(0, n_v, size=2)
            if u != v:
                edge_set.add((min(int(u), int(v)), max(int(u), int(v))))
    edges = np.array(sorted(edge_set), dtype=np.int32).reshape(-1, 2)
    elabels = rng.integers(0, n_elabels, size=edges.shape[0])
    return Graph(vlabels, edges, elabels)


def random_db(
    n_graphs: int,
    *,
    n_vertices: int = 10,
    vertex_jitter: int = 3,
    extra_edge_prob: float = 0.3,
    n_vlabels: int = 5,
    n_elabels: int = 2,
    seed: int = 0,
) -> list[Graph]:
    """Random transaction DB; Graphgen-style knobs (|V|, density, labels)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        nv = int(np.clip(n_vertices + rng.integers(-vertex_jitter, vertex_jitter + 1), 2, None))
        out.append(_random_connected_graph(rng, nv, extra_edge_prob, n_vlabels, n_elabels))
    return out


def pubchem_like_db(n_graphs: int, *, seed: int = 0,
                    avg_edges: float = 28.0) -> list[Graph]:
    """Molecule-like DB matching the paper's Table I statistics:
    ~25-30 edges/graph, small label alphabet (atoms/bonds), sparse
    near-tree topology (rings via a few extra edges).
    """
    rng = np.random.default_rng(seed)
    out = []
    # ~atom alphabet: C,N,O,S,P,halogens... ; bonds: single/double/triple
    n_vlabels, n_elabels = 8, 3
    for _ in range(n_graphs):
        n_e_target = max(3, int(rng.normal(avg_edges, 4.0)))
        n_v = max(3, int(n_e_target * 0.92))  # near-tree: |E| slightly > |V|-1
        g = _random_connected_graph(rng, n_v, 0.12, n_vlabels, n_elabels)
        # skew vertex labels toward "carbon"
        skew = rng.random(g.n_vertices) < 0.6
        g.vlabels[skew] = 0
        out.append(g)
    return out


def paper_toy_db() -> list[Graph]:
    """The 3-graph toy database of paper Fig. 1(a).

    Labels: A=0, B=1, C=2, D=3, E=4.  Edges unlabeled (label 0).
    G1: A-B, B-C, B-D, C-D          (vertices 1:A 2:B 3:C 4:D)
    G2: A-B, B-C, B-D, B-E, D-E     (1:A 2:B 3:D 4:C 5:E  per Fig.)
    G3: B-D, B-E, D-E               (1:D 2:B 3:E)

    Mined with minsup=2 this yields the 13 frequent subgraphs of Fig. 1(b).
    """
    A, B, C, D, E = range(5)
    g1 = Graph([A, B, C, D], [(0, 1), (1, 2), (1, 3), (2, 3)], [0, 0, 0, 0])
    g2 = Graph([A, B, D, C, E], [(0, 1), (1, 3), (1, 2), (1, 4), (2, 4)],
               [0, 0, 0, 0, 0])
    g3 = Graph([D, B, E], [(0, 1), (1, 2), (0, 2)], [0, 0, 0])
    return [g1, g2, g3]
