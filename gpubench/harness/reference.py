"""The benchmark's plain reference: the complete frequent subgraph set of a
graph database, every pattern's minimum DFS code with its support (the
number of graphs that hold at least one embedding), by breadth-first
pattern growth in NumPy.

The semantics are those of MIRAGE's sequential baseline (the paper's
Fig. 3): the frequent single edges, then level by level every rightmost
extension of a frequent pattern that is its own minimum DFS code and
reaches ``minsup``, until a level has none or ``max_size`` edges are
reached.  The implementation is the benchmark's own, independent of
the program: all graphs are laid end to end as one vertex array, a
pattern's occurrence list is one ``(N, vertices)`` array of global
vertex ids (every embedding, automorphic ones included, in graph
order), and an extension joins it with the adjacency lists in a few
array operations.  Children are read off the embeddings (pattern
growth), so only children that occur are ever built.  A child is kept
under its minimum DFS code, which ``canon.py`` finds by trying every
depth-first traversal of the pattern.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .canon import Code, is_canonical
from .generator import PlainGraph

__all__ = ["FrequentSet", "mine", "abs_minsup"]


class FrequentSet:
    """``levels[k]``: the frequent codes with k + 1 edges, sorted;
    ``supports``: code -> support; ``minsup``: the absolute threshold."""

    def __init__(self, levels: list[list[Code]], supports: dict[Code, int],
                 minsup: int):
        self.levels, self.supports, self.minsup = levels, supports, minsup


def abs_minsup(minsup: float | int, n_graphs: int) -> int:
    """A fraction of the database as the program reads it (rounded up),
    or an absolute count as given."""
    if isinstance(minsup, float):
        return int(np.ceil(minsup * n_graphs))
    return int(minsup)


class _DB:
    """All graphs end to end: vertex labels and graph ids, directed
    adjacency in CSR form, and the undirected edges as sorted keys."""

    def __init__(self, graphs: Sequence[PlainGraph]):
        nv = np.array([g.vlabels.shape[0] for g in graphs], np.int64)
        off = np.concatenate([[0], np.cumsum(nv)])
        self.n_graphs = len(graphs)
        self.vl = np.concatenate([g.vlabels for g in graphs]).astype(np.int64)
        self.vg = np.repeat(np.arange(len(graphs), dtype=np.int64), nv)
        ne = np.array([g.edges.shape[0] for g in graphs], np.int64)
        eo = np.repeat(off[:-1], ne)
        e = np.concatenate([g.edges.reshape(-1, 2) for g in graphs]
                           ).astype(np.int64) + eo[:, None]
        el = np.concatenate([g.elabels for g in graphs]).astype(np.int64)
        self.n_v = int(off[-1])
        u = np.concatenate([e[:, 0], e[:, 1]])
        v = np.concatenate([e[:, 1], e[:, 0]])
        lab = np.concatenate([el, el])
        order = np.argsort(u, kind="stable")
        self.dst, self.dlab = v[order], lab[order]
        self.src = u[order]
        self.indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(u, minlength=self.n_v))])
        key = np.minimum(e[:, 0], e[:, 1]) * self.n_v + np.maximum(e[:, 0],
                                                                  e[:, 1])
        korder = np.argsort(key)
        self.ekey, self.elab = key[korder], el[korder]
        self.n_vl = int(self.vl.max()) + 1 if self.n_v else 1
        self.n_el = int(el.max()) + 1 if el.size else 1

    def edge_label(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Label of the edge between global vertices ``a`` and ``b``, or
        -1 where there is none."""
        key = np.minimum(a, b) * self.n_v + np.maximum(a, b)
        i = np.searchsorted(self.ekey, key)
        i = np.minimum(i, self.ekey.shape[0] - 1)
        return np.where(self.ekey[i] == key, self.elab[i], -1)


def _supports(keys: np.ndarray, graph: np.ndarray, n_keys: int,
              n_graphs: int) -> np.ndarray:
    """Distinct graphs per key: (n_keys,) counts."""
    if keys.size == 0:
        return np.zeros(n_keys, np.int64)
    pairs = np.unique(keys * n_graphs + graph)
    return np.bincount(pairs // n_graphs, minlength=n_keys)


def _rightmost_path(code: Code) -> tuple[int, ...]:
    parent: dict[int, int] = {}
    top = 0
    for (i, j, *_l) in code:
        if i < j:
            parent[j] = i
            top = max(top, j)
    path = [top]
    while path[-1] != 0:
        path.append(parent[path[-1]])
    return tuple(reversed(path))


def _children(db: _DB, code: Code, emb: np.ndarray, minsup: int,
              out: dict[Code, np.ndarray]) -> None:
    """Every frequent canonical child of ``code`` (embeddings ``emb``)
    into ``out``."""
    nvp = emb.shape[1]
    labels = {}
    for (i, j, li, _le, lj) in code:
        labels[i], labels[j] = li, lj
    have = {(min(i, j), max(i, j)) for (i, j, *_l) in code}
    rmp = _rightmost_path(code)
    r = rmp[-1]
    # backward: the rightmost vertex to an ancestor on the path
    for v in rmp[:-1]:
        if (min(r, v), max(r, v)) in have:
            continue
        lab = db.edge_label(emb[:, r], emb[:, v])
        hit = lab >= 0
        if not hit.any():
            continue
        rows = np.flatnonzero(hit)
        sup = _supports(lab[rows], db.vg[emb[rows, 0]], db.n_el,
                        db.n_graphs)
        for el in np.flatnonzero(sup >= minsup):
            child = code + ((r, v, labels[r], int(el), labels[v]),)
            if is_canonical(child):
                out[child] = emb[rows[lab[rows] == el]]
    # forward: a path vertex to a new vertex
    for p in rmp:
        u = emb[:, p]
        lo, hi = db.indptr[u], db.indptr[u + 1]
        deg = hi - lo
        n = int(deg.sum())
        if n == 0:
            continue
        row = np.repeat(np.arange(emb.shape[0]), deg)
        start = np.repeat(lo - np.cumsum(deg) + deg, deg)
        pos = start + np.arange(n)
        w = db.dst[pos]
        ok = np.ones(n, bool)
        for c in range(nvp):
            ok &= w != emb[row, c]
        row, w, el = row[ok], w[ok], db.dlab[pos[ok]]
        key = el * db.n_vl + db.vl[w]
        sup = _supports(key, db.vg[w], db.n_el * db.n_vl, db.n_graphs)
        for k in np.flatnonzero(sup >= minsup):
            el_k, lw = divmod(int(k), db.n_vl)
            child = code + ((p, nvp, labels[p], el_k, lw),)
            if is_canonical(child):
                sel = key == k
                out[child] = np.concatenate(
                    [emb[row[sel]], w[sel, None]], axis=1)


def mine(graphs: Sequence[PlainGraph], minsup: float | int, *,
         max_size: Optional[int] = None) -> FrequentSet:
    """The complete frequent set of ``graphs`` at ``minsup`` (a fraction
    of the database or an absolute count), up to ``max_size`` edges
    (None: to the fixpoint)."""
    ms = abs_minsup(minsup, len(graphs))
    db = _DB(graphs)
    src, dst, lab = db.src, db.dst, db.dlab
    la, lb = db.vl[src], db.vl[dst]
    key = (la * db.n_el + lab) * db.n_vl + lb
    n_keys = db.n_vl * db.n_el * db.n_vl
    sup = _supports(key, db.vg[src], n_keys, db.n_graphs)
    current: dict[Code, np.ndarray] = {}
    for k in np.flatnonzero(sup >= ms):
        rest, b = divmod(int(k), db.n_vl)
        a, e = divmod(rest, db.n_el)
        if a <= b:
            sel = key == k
            current[((0, 1, a, e, b),)] = np.stack([src[sel], dst[sel]], 1)
    levels: list[list[Code]] = []
    supports: dict[Code, int] = {}
    while current:
        for c, emb in current.items():
            supports[c] = int(np.unique(db.vg[emb[:, 0]]).shape[0])
        levels.append(sorted(current))
        if max_size is not None and len(levels) >= max_size:
            break
        nxt: dict[Code, np.ndarray] = {}
        for c in levels[-1]:
            _children(db, c, current[c], ms, nxt)
        current = nxt
    return FrequentSet(levels, supports, ms)
