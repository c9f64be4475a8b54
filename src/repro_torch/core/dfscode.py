"""DFS codes and min-dfs-code canonical labeling (paper §IV-A.2).

MIRAGE adopts gSpan's canonical coding scheme: a pattern's edges are
serialized as 5-tuples ``(i, j, l_i, l_e, l_j)`` where ``i, j`` are DFS
discovery ids, and the lexicographically smallest valid DFS serialization
(the *min-dfs-code*) is the pattern's canonical key.  A candidate
generation path is valid iff the insertion order of its edges equals the
min-dfs-code edge order — this is the isomorphism_checking() of the
paper's mapper (Fig. 7, line 3) and what makes the algorithm complete
*without duplicates* (the concrete failure of Hill et al. [32]).

Pattern graphs are tiny (≤ ~15 edges in practice), so the host half of
this module is exact Python/numpy.  The data-scale work (support counting
over the partitioned database) lives on-device in ``embedding.py`` /
``kernels/``.  The array half at the end is the canonicality machine of
the whole-run device loop (``min_dfs_canonical_array``): fixed-shape
PyTorch ops over a leading batch of -1-padded code arrays, the port of
``repro.core.dfscode``'s vmapped ``jnp`` twin.

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
import torch

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
    "edge_struct_key",
    "code_array_vertex_labels",
    "code_array_rightmost_path",
    "min_dfs_canonical_array",
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


# ---------------------------------------------------------------------------
# Array twin for the whole-run device loop (DESIGN.md §13): fixed-shape
# PyTorch ops over a leading batch of (L, 5) -1-padded code arrays
# (``code_to_array`` layout), the port of ``repro.core.dfscode``'s
# vmapped ``jnp`` functions (their ``fori_loop``s are Python loops over
# static counts).  JAX clamps out-of-range gathers and drops out-of-range
# scatters; here every gather index is clamped and every scatter writes
# an extra dump slot that is sliced off, so no index leaves its tensor
# (on the card an out-of-range index is a device-side assert).
# ---------------------------------------------------------------------------

_BIG = 1 << 29  # lexicographic sentinel (labels/keys are << this)


def edge_struct_key(i, j, nv: int) -> torch.Tensor:
    """Linearize `edge_lt`'s structural (i, j) comparison into one int key.

    forward  (i < j): key = (2j)   * (nv+1) + (nv - i)   — orders by (j, -i)
    backward (i > j): key = (2i+1) * (nv+1) + j          — orders by (i, j)

    The parity of the leading coefficient resolves the mixed cases exactly
    (the four `edge_lt` structural rules); label triples break the
    remaining ties separately (see `min_dfs_canonical_array`)."""
    return torch.where(i < j, (2 * j) * (nv + 1) + (nv - i),
                       (2 * i + 1) * (nv + 1) + j)


def _lex_min(mask: torch.Tensor, comps) -> tuple[list, torch.Tensor]:
    """Masked lexicographic min per batch row over broadcastable int
    components.  Returns ([min components, each (B,)], achiever mask);
    ``mask`` has the full (B, ...) broadcast shape."""
    best = []
    tail = (1,) * (mask.dim() - 1)
    for c in comps:
        m = torch.where(mask, c, _BIG).flatten(1).amin(1)
        mask = mask & (c == m.view(-1, *tail))
        best.append(m)
    return best, mask


def _dump_index(idx: torch.Tensor, ok: torch.Tensor, cap: int
                ) -> torch.Tensor:
    """``idx`` where ``ok`` and inside [0, cap), else the dump slot
    ``cap`` — the scatter twin of JAX's ``mode="drop"``."""
    return torch.where(ok & (idx >= 0) & (idx < cap), idx, cap)


def _compact_rows(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap) int64: per batch row, the indices of the first ``cap``
    set entries of ``mask`` (B, N) in order, 0-filled past their count
    (a prefix-sum rank and one scatter)."""
    B, N = mask.shape
    pos = mask.cumsum(1) - 1
    src = torch.arange(N, device=mask.device).expand(B, N)
    out = torch.zeros((B, cap + 1), dtype=torch.int64, device=mask.device)
    return out.scatter_(1, _dump_index(pos, mask, cap), src)[:, :cap]


def _gather_clamped(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, clip(idx[b, ...])]`` for ``x`` (B, N) and ``idx`` (B, ...)."""
    flat = idx.clamp(0, x.shape[1] - 1).reshape(idx.shape[0], -1)
    return x.gather(1, flat).reshape(idx.shape)


def code_array_vertex_labels(code: torch.Tensor, n_vertex_slots: int
                             ) -> torch.Tensor:
    """(B, L, 5) code arrays -> (B, NV) vertex labels, -1 on unused slots."""
    NV = n_vertex_slots
    code = code.long()
    valid = code[..., 0] >= 0
    vl = torch.full((code.shape[0], NV + 1), -1, dtype=torch.int64,
                    device=code.device)
    vl.scatter_(1, _dump_index(code[..., 0], valid, NV), code[..., 2])
    vl.scatter_(1, _dump_index(code[..., 1], valid, NV), code[..., 4])
    return vl[:, :NV]


def _dfs_parents(code: torch.Tensor, n_vertex_slots: int,
                 row_mask: torch.Tensor) -> torch.Tensor:
    """(B, NV): parent[j] = i over the forward rows selected by
    ``row_mask`` (broadcastable to (B, L))."""
    NV = n_vertex_slots
    fwd = row_mask & (code[..., 0] < code[..., 1]) & (code[..., 0] >= 0)
    par = torch.full((code.shape[0], NV + 1), -1, dtype=torch.int64,
                     device=code.device)
    par.scatter_(1, _dump_index(code[..., 1], fwd, NV), code[..., 0])
    return par[:, :NV]


def _walk_up(par: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """One step up the forward-edge parent chain (-1 past the root)."""
    return torch.where(cur > 0, _gather_clamped(par, cur[:, None])[:, 0], -1)


def code_array_rightmost_path(code: torch.Tensor, n_vertex_slots: int):
    """(B, L, 5) code arrays -> (rmp (B, NV) root-first -1-padded,
    rmp_len (B,), n_v (B,)): walk the forward-edge parent chain from the
    rightmost (max dfs id) vertex to the root."""
    NV = n_vertex_slots
    code = code.long()
    valid = code[..., 0] >= 0
    n_v = torch.where(valid, torch.maximum(code[..., 0], code[..., 1]),
                      -1).amax(1) + 1
    par = _dfs_parents(code, NV, torch.ones((), dtype=torch.bool,
                                            device=code.device))
    cur = n_v - 1
    rev = []
    for _ in range(NV):
        rev.append(cur)
        cur = _walk_up(par, cur)
    rev = torch.stack(rev, 1)                                   # (B, NV)
    rmp_len = (rev >= 0).sum(1)
    idx = rmp_len[:, None] - 1 - torch.arange(NV, device=code.device)
    rmp = torch.where(idx >= 0, _gather_clamped(rev, idx), -1)
    return rmp, rmp_len, n_v


def _onpath_mask(par: torch.Tensor, rm: torch.Tensor, n_vertex_slots: int
                 ) -> torch.Tensor:
    """(B, NV) bool: dfs ids on the rightmost path (root..rm inclusive)."""
    cols = torch.arange(n_vertex_slots, device=par.device)
    onpath = torch.zeros((par.shape[0], n_vertex_slots), dtype=torch.bool,
                         device=par.device)
    cur = rm
    for _ in range(n_vertex_slots):
        onpath = onpath | ((cols == cur[:, None]) & (cur[:, None] >= 0))
        cur = _walk_up(par, cur)
    return onpath


def min_dfs_canonical_array(code: torch.Tensor, *, n_vertex_slots: int,
                            max_states: int):
    """Array twin of `is_canonical` over a batch of (L, 5) code arrays:
    ``(canonical, overflow)``, each (B,) bool.

    Runs the breadth-parallel minimal-extension machine of `min_dfs_code`
    under a fixed state budget: all partial traversals realizing the
    minimal prefix live in ``max_states`` slots of (graph->dfs, dfs->graph,
    used-edge-bitmask) arrays.  The dfs-side quantities (vertex count,
    rightmost path) are shared across states — they are functions of the
    code prefix alone — so only the graph-side mappings are per-state.

    If the live state set ever exceeds ``max_states`` the result is
    unreliable and ``overflow`` is set — callers must fall back to the
    host `is_canonical` (the device loop bails the whole run).  Requires
    L < 32, the width of the JAX package's int32 edge bitmask."""
    B, L = code.shape[0], code.shape[1]
    NV = n_vertex_slots
    MS = max_states
    if L >= 32:
        raise ValueError(f"max_edges={L} exceeds the int32 edge-bitmask width")
    dev = code.device
    code = code.long()
    ar_l = torch.arange(L, device=dev)
    ar_ms = torch.arange(MS, device=dev)
    cols = torch.arange(NV, device=dev)
    i_, j_, li_, le_, lj_ = code.unbind(-1)                      # (B, L)
    valid_e = i_ >= 0
    ne = valid_e.sum(1)
    vl = code_array_vertex_labels(code, NV)

    # directed orientation table (B, 2L): first L rows umin->umax, then
    # flipped
    umin, umax = torch.minimum(i_, j_), torch.maximum(i_, j_)
    du = torch.cat([umin, umax], 1)
    dv = torch.cat([umax, umin], 1)
    de = torch.cat([le_, le_], 1)
    dk = torch.cat([ar_l, ar_l])                                 # (2L,)
    dvalid = torch.cat([valid_e, valid_e], 1)
    dlu = _gather_clamped(vl, du)
    dlv = _gather_clamped(vl, dv)
    one = torch.ones((), dtype=torch.int64, device=dev)

    # --- initial edge: minimal (l_u, l_e, l_v) over valid orientations
    (b0l, b0e, b0r), m0 = _lex_min(dvalid, (dlu, de, dlv))
    ok0 = (b0l == li_[:, 0]) & (b0e == le_[:, 0]) & (b0r == lj_[:, 0])
    n0 = m0.sum(1)
    src_o = _compact_rows(m0, MS)                                # (B, MS)
    alive = ar_ms[None, :] < n0[:, None]
    su, sv = du.gather(1, src_o), dv.gather(1, src_o)
    g2d = torch.where(cols == su[..., None], 0,
                      torch.where(cols == sv[..., None], 1, -1))
    d2g = torch.where(cols == 0, su[..., None],
                      torch.where(cols == 1, sv[..., None], -1))
    used = torch.where(alive, torch.bitwise_left_shift(one, dk[src_o]), 0)

    fwd_rows = valid_e & (i_ < j_)
    result, done, ovf = ok0, ~ok0, n0 > MS
    O = 2 * L
    du_c = du.clamp(0, NV - 1)[:, None, :].expand(B, MS, O)
    dv_c = dv.clamp(0, NV - 1)[:, None, :].expand(B, MS, O)
    for t in range(1, L):
        act = (~done) & (t < ne)
        # shared dfs-space prefix quantities (rows [0, t) are consumed)
        pre = ar_l < t
        nmap = 1 + (fwd_rows & pre).sum(1)                       # (B,)
        rm = nmap - 1
        onpath = _onpath_mask(_dfs_parents(code, NV, pre), rm, NV)

        # extension slots: (state, orientation) -> candidate edge
        fu = g2d.gather(2, du_c)                                 # (B, MS, 2L)
        fv = g2d.gather(2, dv_c)
        unused = ((used[:, :, None] >> dk) & 1) == 0
        base = alive[:, :, None] & dvalid[:, None, :] & unused
        rm3, nmap3 = rm[:, None, None], nmap[:, None, None]
        is_b = (fu == rm3) & (fv >= 0)
        okb = base & is_b & (fv != rm3) & _gather_clamped(onpath, fv)
        is_f = (fv < 0) & (fu >= 0)
        okf = base & is_f & _gather_clamped(onpath, fu)
        okx = okb | okf
        skey = edge_struct_key(torch.where(is_b, rm3, fu),
                               torch.where(is_b, fv, nmap3), NV)
        (bk_, bl1, bl2, bl3), mbest = _lex_min(
            okx, (skey, dlu[:, None, :], de[:, None, :], dlv[:, None, :]))
        flat = mbest.reshape(B, -1)
        bkey_t = edge_struct_key(i_[:, t], j_[:, t], NV)
        match = ((bk_ == bkey_t) & (bl1 == li_[:, t]) & (bl2 == le_[:, t])
                 & (bl3 == lj_[:, t]) & flat.any(1))

        # compact achiever (state, orientation) pairs into the state slots
        nn = flat.sum(1)
        sidx = _compact_rows(flat, MS)                           # (B, MS)
        s_sel, o_sel = sidx // O, sidx % O
        isf_sel = okf.reshape(B, -1).gather(1, sidx)[..., None]
        gv = dv.gather(1, o_sel)[..., None]
        rows = s_sel[..., None].expand(B, MS, NV)
        ng2d = torch.where((cols == gv) & isf_sel, nmap3, g2d.gather(1, rows))
        nd2g = torch.where((cols == nmap3) & isf_sel, gv, d2g.gather(1, rows))
        nused = (used.gather(1, s_sel)
                 | torch.bitwise_left_shift(one, dk[o_sel]))
        nalive = ar_ms[None, :] < nn.clamp(max=MS)[:, None]

        a2, a3 = act[:, None], act[:, None, None]
        g2d = torch.where(a3, ng2d, g2d)
        d2g = torch.where(a3, nd2g, d2g)
        used = torch.where(a2, nused, used)
        alive = torch.where(a2, nalive, alive)
        result = result & torch.where(act, match, True)
        done = done | (act & ~match)
        ovf = ovf | (act & (nn > MS))
    return result, ovf
