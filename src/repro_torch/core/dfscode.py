"""DFS codes and min-dfs-code canonical labeling (paper §IV-A.2).

MIRAGE adopts gSpan's canonical coding scheme: a pattern's edges are
serialized as 5-tuples ``(i, j, l_i, l_e, l_j)`` where ``i, j`` are DFS
discovery ids, and the lexicographically smallest valid DFS serialization
(the *min-dfs-code*) is the pattern's canonical key.  A candidate
generation path is valid iff the insertion order of its edges equals the
min-dfs-code edge order — this is the isomorphism_checking() of the
paper's mapper (Fig. 7, line 3) and what makes the algorithm complete
*without duplicates* (the concrete failure of Hill et al. [32]).

Pattern graphs are tiny (≤ ~15 edges in practice), so this module is exact
host-side Python/numpy.  The data-scale work (support counting over the
partitioned database) lives on-device in ``embedding.py`` / ``kernels/``.
This is the host half of ``repro.core.dfscode``; the array canonicality
machine of the whole-run device loop is not ported yet.

Edge order (gSpan, Yan & Han 2002, DFS lexicographic order) for
``e1 = (i1, j1)``, ``e2 = (i2, j2)``:

  * both forward (i < j):  e1 < e2  iff  j1 < j2, or (j1 == j2 and i1 > i2)
  * both backward (i > j): e1 < e2  iff  i1 < i2, or (i1 == i2 and j1 < j2)
  * e1 backward, e2 forward: e1 < e2  iff  i1 < j2
  * e1 forward, e2 backward: e1 < e2  iff  j1 <= i2

with ties broken by the label triple ``(l_i, l_e, l_j)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graphdb import Graph

# A code edge is a 5-tuple of ints: (i, j, l_i, l_e, l_j)
Edge5 = tuple[int, int, int, int, int]
Code = tuple[Edge5, ...]

__all__ = [
    "Edge5",
    "Code",
    "edge_lt",
    "code_lt",
    "code_to_graph",
    "min_dfs_code",
    "is_canonical",
    "rightmost_path",
    "code_to_array",
    "array_to_code",
]


def edge_lt(a: Edge5, b: Edge5) -> bool:
    """gSpan DFS-lexicographic edge order ``a < b`` (strict)."""
    ia, ja = a[0], a[1]
    ib, jb = b[0], b[1]
    fa, fb = ia < ja, ib < jb
    if fa and fb:
        if (ja, -ia) != (jb, -ib):
            return (ja, -ia) < (jb, -ib)
    elif (not fa) and (not fb):
        if (ia, ja) != (ib, jb):
            return (ia, ja) < (ib, jb)
    elif (not fa) and fb:      # backward vs forward
        return ia < jb
    else:                      # forward vs backward
        return ja <= ib
    # identical (i, j) structure -> label order
    return a[2:] < b[2:]


def code_lt(a: Code, b: Code) -> bool:
    """Strict DFS-lexicographic order on whole codes (prefix-aware)."""
    for ea, eb in zip(a, b):
        if ea == eb:
            continue
        return edge_lt(ea, eb)
    return len(a) < len(b)


def code_to_graph(code: Code) -> Graph:
    """Materialize the pattern graph of a DFS code (dense 0-based ids)."""
    n_v = max(max(e[0], e[1]) for e in code) + 1
    vlabels = -np.ones(n_v, dtype=np.int32)
    edges, elabels = [], []
    for (i, j, li, le, lj) in code:
        vlabels[i] = li
        vlabels[j] = lj
        edges.append((min(i, j), max(i, j)))
        elabels.append(le)
    assert (vlabels >= 0).all(), f"disconnected code {code}"
    return Graph(vlabels, np.array(edges, np.int32), np.array(elabels, np.int32))


@dataclasses.dataclass
class _State:
    """One partial DFS traversal of the pattern graph."""

    g2d: dict[int, int]          # graph vid -> dfs id
    d2g: list[int]               # dfs id -> graph vid
    used: frozenset[int]         # used (undirected) edge indices
    rmp: tuple[int, ...]         # rightmost path, as dfs ids root..rightmost


def min_dfs_code(
    g: Graph,
    bound: Optional[Code] = None,
) -> Optional[Code]:
    """Exact min-dfs-code of ``g`` by breadth-parallel minimal extension.

    Maintains *all* partial DFS traversals that realize the current minimal
    code prefix; at each step enumerates every legal gSpan extension
    (backward from the rightmost vertex, then forward from rightmost-path
    vertices), keeps the minimal edge tuple, and prunes states.

    If ``bound`` is given, returns ``None`` as soon as the minimal code is
    provably *smaller* than ``bound`` at some position (early exit for
    canonicality checking: a non-None result equal to bound ⇒ canonical).
    """
    if g.n_edges == 0:
        raise ValueError("empty pattern")
    adj: dict[int, list[tuple[int, int, int]]] = {}  # u -> [(v, elabel, eidx)]
    for k, ((u, v), el) in enumerate(zip(map(tuple, g.edges), g.elabels)):
        adj.setdefault(int(u), []).append((int(v), int(el), k))
        adj.setdefault(int(v), []).append((int(u), int(el), k))

    vl = g.vlabels

    # --- initial edge: minimal (l_u, l_e, l_v) over all orientations
    best0: Optional[Edge5] = None
    inits: list[tuple[Edge5, int, int, int]] = []
    for k, ((u, v), el) in enumerate(zip(map(tuple, g.edges), g.elabels)):
        for a, b in ((int(u), int(v)), (int(v), int(u))):
            t: Edge5 = (0, 1, int(vl[a]), int(el), int(vl[b]))
            inits.append((t, a, b, k))
            if best0 is None or t[2:] < best0[2:]:
                best0 = t
    assert best0 is not None
    code: list[Edge5] = [best0]
    if bound is not None and code[0] != bound[0]:
        # min first edge differs from bound's: it can only be smaller.
        return None
    states = [
        _State({a: 0, b: 1}, [a, b], frozenset([k]), (0, 1))
        for (t, a, b, k) in inits
        if t == best0
    ]

    n_edges = g.n_edges
    while len(code) < n_edges:
        best: Optional[Edge5] = None
        nexts: list[tuple[Edge5, _State]] = []
        for st in states:
            rm_dfs = st.rmp[-1]
            rm_g = st.d2g[rm_dfs]
            # backward extensions: rightmost vertex -> rightmost-path vertex
            # (never the immediate parent; edge must exist and be unused)
            for (nbr, el, k) in adj[rm_g]:
                if k in st.used or nbr not in st.g2d:
                    continue
                jd = st.g2d[nbr]
                # target must be a strict ancestor (on RMP, not rightmost
                # itself); the parent edge is already in `used` and the
                # graph is simple, so the no-multigraph rule holds.
                if jd not in st.rmp[:-1]:
                    continue
                t = (rm_dfs, jd, int(vl[rm_g]), el, int(vl[nbr]))
                nexts.append((t, _ext_backward(st, k)))
                if best is None or edge_lt(t, best):
                    best = t
            # forward extensions: from rightmost-path vertices to new vertices
            for pos in range(len(st.rmp) - 1, -1, -1):
                wd = st.rmp[pos]
                wg = st.d2g[wd]
                for (nbr, el, k) in adj[wg]:
                    if k in st.used or nbr in st.g2d:
                        continue
                    nd = len(st.d2g)
                    t = (wd, nd, int(vl[wg]), el, int(vl[nbr]))
                    nexts.append((t, _ext_forward(st, k, nbr, wd)))
                    if best is None or edge_lt(t, best):
                        best = t
        assert best is not None, "graph must be connected"
        pos = len(code)
        code.append(best)
        if bound is not None:
            if best != bound[pos]:
                # best < bound[pos] (bound is realizable, so min <= bound)
                return None
        states = [st for (t, st) in nexts if t == best]
    return tuple(code)


def _ext_backward(st: _State, eidx: int) -> _State:
    return _State(st.g2d, st.d2g, st.used | {eidx}, st.rmp)


def _ext_forward(st: _State, eidx: int, nbr_g: int, from_dfs: int) -> _State:
    nd = len(st.d2g)
    g2d = dict(st.g2d)
    g2d[nbr_g] = nd
    d2g = st.d2g + [nbr_g]
    # new rightmost path: truncate at the extension stub, append new vertex
    cut = st.rmp.index(from_dfs) + 1
    rmp = st.rmp[:cut] + (nd,)
    return _State(g2d, d2g, frozenset(st.used | {eidx}), rmp)


def is_canonical(code: Code) -> bool:
    """True iff ``code`` equals the min-dfs-code of its own pattern graph.

    This is exactly the mapper's isomorphism_checking() (paper Fig. 7
    line 3): of all generation paths of a pattern, only the one matching
    the min-dfs-code survives.
    """
    return min_dfs_code(code_to_graph(code), bound=code) == code


def rightmost_path(code: Code) -> tuple[int, ...]:
    """Rightmost path of a (valid) DFS code, as dfs ids root..rightmost."""
    parent: dict[int, int] = {}
    max_id = 0
    for (i, j, *_l) in code:
        if i < j:  # forward edge
            parent[j] = i
            max_id = max(max_id, j)
    path = [max_id]
    while path[-1] != 0:
        path.append(parent[path[-1]])
    return tuple(reversed(path))


# ---------------------------------------------------------------------------
# Fixed-shape array interop (device representation of pattern metadata)
# ---------------------------------------------------------------------------

def code_to_array(code: Code, max_edges: int) -> np.ndarray:
    """Pack a code into a (max_edges, 5) int32 array, -1 padded."""
    a = -np.ones((max_edges, 5), dtype=np.int32)
    if len(code) > max_edges:
        raise ValueError(f"code of size {len(code)} exceeds max_edges={max_edges}")
    for r, e in enumerate(code):
        a[r] = e
    return a


def array_to_code(a: np.ndarray) -> Code:
    out = []
    for row in np.asarray(a):
        if row[0] < 0 and row[1] < 0:
            break
        out.append(tuple(int(x) for x in row))
    return tuple(out)  # type: ignore[return-value]
