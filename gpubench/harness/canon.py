"""The canonical key of a pattern, for the benchmark's reference: its
minimum DFS code, found by trying every depth-first traversal of the
pattern and keeping the least code, with nothing pruned but traversals
whose code is already past the best one.

A DFS code lists a pattern's edges as ``(i, j, l_i, l_e, l_j)``, where
``i, j`` are the order in which a depth-first traversal discovers the
two ends.  A traversal fixes the code: vertex ``k`` (``k >= 1``) brings
its tree edge ``(parent, k)`` and then its edges back to the vertices
discovered before it (its ancestors, as in any depth-first search of an
undirected graph), by ascending id.

Two codes are compared at their first differing edge.  There both share
every edge before it, so the rightmost vertex ``r`` and the vertex count
``n`` are the same on both sides, and the edge is either back from ``r``
to an ancestor ``j`` or a tree edge from some ``i`` to the new vertex
``n``.  A back edge comes first; of two back edges, the lower ``j``; of
two tree edges, the higher (deeper) ``i``; then the label triple.  That
is ``_key``, and the code's order is the order of its tuple of keys.
"""
from __future__ import annotations

Edge = tuple[int, int, int, int, int]
Code = tuple[Edge, ...]

__all__ = ["Code", "min_code", "is_canonical"]


def _key(e: Edge) -> tuple:
    i, j, li, le, lj = e
    if i > j:
        return (0, j, li, le, lj)
    return (1, -i, li, le, lj)


def min_code(vlabels: list[int], edges: list[tuple[int, int, int]]) -> Code:
    """The least DFS code of the connected graph ``(vlabels, edges)``,
    ``edges`` as ``(u, v, edge label)``."""
    if not edges:
        raise ValueError("empty pattern")
    nbrs: dict[int, dict[int, int]] = {}
    for (u, v, el) in edges:
        nbrs.setdefault(u, {})[v] = el
        nbrs.setdefault(v, {})[u] = el
    n_e = len(edges)
    best: list = [None, None]          # [key tuple, code]

    def visit(ids: dict[int, int], stack: list[int], code: list[Edge],
              keys: list[tuple]) -> None:
        if best[0] is not None and tuple(keys) > best[0][:len(keys)]:
            return
        if len(code) == n_e:
            if best[0] is None or tuple(keys) < best[0]:
                best[0], best[1] = tuple(keys), tuple(code)
            return
        stack = list(stack)
        while stack and all(w in ids for w in nbrs[stack[-1]]):
            stack.pop()
        if not stack:
            raise ValueError("pattern graph is not connected")
        top = stack[-1]
        for w in nbrs[top]:
            if w in ids:
                continue
            k = len(ids)
            new = [(ids[top], k, vlabels[top], nbrs[top][w], vlabels[w])]
            back = sorted((ids[x], x) for x in nbrs[w] if x in ids
                          and x != top)
            new += [(k, jx, vlabels[w], nbrs[w][x], vlabels[x])
                    for (jx, x) in back]
            visit({**ids, w: k}, stack + [w], code + new,
                  keys + [_key(e) for e in new])

    for s in nbrs:
        visit({s: 0}, [s], [], [])
    return best[1]


def is_canonical(code: Code) -> bool:
    """True iff ``code`` is the least DFS code of the graph it spells."""
    n_v = max(max(e[0], e[1]) for e in code) + 1
    vlabels = [-1] * n_v
    for (i, j, li, _le, lj) in code:
        vlabels[i], vlabels[j] = li, lj
    return min_code(vlabels, [(i, j, le) for (i, j, _li, le, _lj) in code]
                    ) == tuple(code)
