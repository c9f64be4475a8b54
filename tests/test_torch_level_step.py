"""The port's level program against the JAX package's: on the same
inputs both must produce the same wire, word for word (supports, survivor
count, overflow, imbalance, audit word, permutation and checksum), and
the same child OL store.  The cap-miss retry and the escalation valve
must give the same levels, statistics and supports."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import level_step as jls
from repro.core import mining as jmining
from repro.core.candgen import generate_candidates
from repro.core.embedding import build_edge_ol, candidate_meta, level1_ol
from repro.core.graphdb import paper_toy_db, random_db
from repro.core.host_miner import mine_host
from repro.core.mapreduce import MiningMesh as JMesh
from repro.core.partition import make_partitions
from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import level_step as tls
from repro_torch.core import mining as tmining
from repro_torch.core.mapreduce import MiningMesh as TMesh


def _prep(graphs, minsup, n_parts, M=8, K=None):
    """Phase 1+2 of the driver, host-side (as tests/test_level_step.py)."""
    part = make_partitions(graphs, minsup, n_parts)
    alphabet = part.alphabet
    triples = sorted({t for c in alphabet.canonical()
                      for t in (c, (c[2], c[1], c[0]))})
    G = max(len(p) for p in part.partitions)
    eols = [build_edge_ol(p, triples, pad_graphs=G) for p in part.partitions]
    F = max(e.src.shape[-1] for e in eols)

    def padf(a, fill):
        w = [(0, 0)] * (a.ndim - 1) + [(0, F - a.shape[-1])]
        return np.pad(a, w, constant_values=fill)

    src = np.stack([padf(e.src, -1) for e in eols])
    dst = np.stack([padf(e.dst, -1) for e in eols])
    emask = np.stack([padf(e.mask, False) for e in eols])
    codes = [((0, 1, a, e, b),) for (a, e, b) in alphabet.canonical()]
    lvl1 = [level1_ol(codes, e, max_embeddings=max(M, F)) for e in eols]
    pol = np.stack([np.asarray(l.ol) for l in lvl1])
    pmask = np.stack([np.asarray(l.mask) for l in lvl1])
    if K is not None:                       # bucketed vertex slots
        pol = np.pad(pol, [(0, 0)] * 4 + [(0, K - pol.shape[-1])],
                     constant_values=-1)
    cands = generate_candidates(codes, alphabet)
    meta = candidate_meta(cands, eols[0])
    psup = np.array([int(emask[:, eols[0].triple_index[c[0][2:]]]
                         .any(-1).sum()) for c in codes], np.int32)
    return meta, (pol, pmask, src, dst, emask), part.minsup, psup


_DATA = {}


def _data():
    if "d" not in _DATA:
        graphs = random_db(12, n_vertices=6, extra_edge_prob=0.3,
                           n_vlabels=2, n_elabels=2, seed=5)
        _DATA["d"] = (len(graphs),) + _prep(graphs, 3, 2, K=8)
    return _DATA["d"]


def _pad_meta(meta, Cp):
    C = meta.shape[0]
    return np.concatenate([meta, np.tile([[0, 0, 0, 1, 0]], (Cp - C, 1))]
                          ).astype(np.int32)


_JAX_WIRES = {}


def _jax_level(key, meta_p, C, stores, minsup, **kw):
    if key not in _JAX_WIRES:
        pend = jls.dispatch_level(
            JMesh.single_device(), meta_p, C,
            *(jnp.asarray(a) for a in stores), minsup=minsup,
            rebalance=True, threshold=1.25, donate=False, **kw)
        _JAX_WIRES[key] = (np.asarray(pend.wire_d), np.asarray(pend.pol),
                           np.asarray(pend.pmask))
    return _JAX_WIRES[key]


# (packed, reduce, sharded, survivor cap, bad parent support)
WIRE_CASES = [
    pytest.param(False, "psum", False, None, False, id="dense-psum"),
    pytest.param(False, "reduce_scatter", False, None, False,
                 id="dense-rs"),
    pytest.param(False, "reduce_scatter", True, None, False,
                 id="dense-rs-sharded"),
    pytest.param(True, "psum", False, None, False, id="packed-psum"),
    pytest.param(True, "reduce_scatter", True, None, False,
                 id="packed-rs-sharded"),
    pytest.param(True, "reduce_scatter", True, 2, False, id="cap-miss"),
    pytest.param(True, "reduce_scatter", True, None, True,
                 id="audit-monotonic"),
]


# the port's backend and the JAX backend it is held against: the plain
# join computes the padded candidate rows while the fused schedule parks
# them on an invalid row (support 0), so each matches its own kind
BACKENDS = [("ref", "ref"), ("fused", "fused_interpret")]
_FUSED_CASES = {"dense-rs-sharded", "packed-rs-sharded", "cap-miss"}
BACKEND_CASES = [
    pytest.param(tb, jb, *case.values, id=f"{tb}-{case.id}")
    for tb, jb in BACKENDS for case in WIRE_CASES
    if tb == "ref" or case.id in _FUSED_CASES]


@pytest.mark.parametrize(
    "backend,jax_backend,packed,reduce,sharded,cap,bad_psup", BACKEND_CASES)
def test_wire_and_child_store_match_reference(backend, jax_backend, packed,
                                              reduce, sharded, cap,
                                              bad_psup):
    n_graphs, meta, stores, minsup, psup = _data()
    C = meta.shape[0]
    Cp = 64 * (-(-C // 64))
    meta_p = _pad_meta(meta, Cp)
    S = cap if cap is not None else C
    psup = psup.copy()
    if bad_psup:
        psup[0] = 0                  # every child of parent 0 now violates
    kw = dict(max_embeddings=8, survivor_cap=S, child_width=8,
              sched_floor=64, tile_c=4, level=2, sharded=sharded,
              packed=packed, psup=psup, n_graphs=n_graphs)
    wire_j, pol_j, pmask_j = _jax_level(
        (jax_backend, packed, reduce, sharded, cap, bad_psup), meta_p, C,
        stores, minsup, backend=jax_backend, reduce=reduce, **kw)
    pend = tls.dispatch_level(
        TMesh(), meta_p, C, *(torch.from_numpy(a) for a in stores),
        minsup=minsup, backend=backend, reduce=reduce, **kw)
    np.testing.assert_array_equal(pend.wire_d.numpy(), wire_j)
    np.testing.assert_array_equal(pend.pol.numpy(), pol_j)
    np.testing.assert_array_equal(pend.pmask.numpy(), pmask_j)
    out = pend.finish().wire
    want = jls.unpack_wire(
        jls.reassemble_wire(wire_j, stores[0].shape[0], 1, packed=packed,
                            cp=Cp), C, Cp, stores[0].shape[0])
    np.testing.assert_array_equal(out.gsup, want.gsup)
    assert (out.n_keep, out.overflow, out.audit, out.imbalance) == (
        want.n_keep, want.overflow, want.audit, want.imbalance)
    if bad_psup:
        assert out.audit == tls.AUDIT_MONOTONIC
    if cap is not None:
        assert out.n_keep > S


def test_wire_matches_reference_fused_interpret():
    """The JAX fused (Pallas interpret) level program and the port's
    fused level program give the same wire without bucketing."""
    n_graphs, meta, stores, minsup, psup = _data()
    C = meta.shape[0]
    kw = dict(max_embeddings=8, survivor_cap=C, child_width=None,
              sched_floor=None, tile_c=None, level=2, sharded=True,
              packed=True, psup=psup, n_graphs=n_graphs)
    wire_j, pol_j, _ = _jax_level("interp", meta.astype(np.int32), C,
                                  stores, minsup,
                                  backend="fused_packed_interpret",
                                  reduce="reduce_scatter", **kw)
    pend = tls.dispatch_level(
        TMesh(), meta.astype(np.int32), C,
        *(torch.from_numpy(a) for a in stores), minsup=minsup,
        backend="fused", reduce="reduce_scatter", **kw)
    np.testing.assert_array_equal(pend.wire_d.numpy(), wire_j)
    np.testing.assert_array_equal(pend.pol.numpy(), pol_j)


def test_sharded_wire_needs_reduce_scatter():
    _, meta, stores, minsup, _ = _data()
    with pytest.raises(ValueError, match="reduce_scatter"):
        tls.dispatch_level(
            TMesh(), meta.astype(np.int32), meta.shape[0],
            *(torch.from_numpy(a) for a in stores), minsup=minsup,
            backend="ref", reduce="psum", max_embeddings=8,
            survivor_cap=4, sharded=True)


def _stats(res):
    return [(s.level, s.n_candidates, s.n_frequent, s.overflow,
             s.escalations, s.retried, s.survivor_cap) for s in res.stats]


@pytest.mark.parametrize("case", ["cap-miss", "escalation"])
def test_retry_paths_match_reference(case, monkeypatch):
    if case == "cap-miss":
        graphs, tgraphs = paper_toy_db(), tgraphdb.paper_toy_db()
        minsup, max_size = 2, None
        kw = dict(n_partitions=2, max_embeddings=8)
        for cls in (jmining.Mirage, tmining.Mirage):
            monkeypatch.setattr(cls, "_survivor_cap",
                                lambda self, C, Cp, hist: 1)
    else:
        db = dict(n_vertices=7, extra_edge_prob=0.5, n_vlabels=2,
                  n_elabels=1, seed=3)
        graphs, tgraphs = random_db(14, **db), tgraphdb.random_db(14, **db)
        minsup, max_size = 4, 4
        kw = dict(n_partitions=2, max_embeddings=2)
    cfg = dict(minsup=minsup, max_size=max_size, **kw)
    ref = jmining.Mirage(jmining.MirageConfig(**cfg)).fit(graphs)
    got = tmining.Mirage(tmining.MirageConfig(**cfg),
                         device="cpu").fit(tgraphs)
    assert _stats(got) == _stats(ref)
    assert any(s.retried for s in got.stats)
    if case == "escalation":
        assert sum(s.escalations for s in got.stats) > 0
    assert got.levels == ref.levels
    assert got.supports == ref.supports
    assert got.total_overflow == ref.total_overflow
    oracle = mine_host(graphs, minsup, max_size=max_size)
    assert got.supports == {c: i.support for c, i in oracle.frequent.items()}


@pytest.mark.parametrize("packed,sharded", [(False, False), (True, True)],
                         ids=["dense-rs", "packed-rs-sharded"])
def test_run_level_equals_dispatch_finish_and_jax(packed, sharded,
                                                  monkeypatch):
    """``run_level`` is ``dispatch_level(...).finish()``; the host wire its
    one fetch verified equals ``repro``'s ``run_level`` wire word for
    word, checksum included, and the decoded outputs agree."""
    n_graphs, meta, stores, minsup, psup = _data()
    C = meta.shape[0]
    Cp = 64 * (-(-C // 64))
    meta_p = _pad_meta(meta, Cp)
    kw = dict(minsup=minsup, backend="ref", reduce="reduce_scatter",
              max_embeddings=8, survivor_cap=C, child_width=8,
              sched_floor=64, tile_c=4, level=2, sharded=sharded,
              packed=packed, psup=psup, n_graphs=n_graphs, rebalance=True,
              threshold=1.25)
    wires = {}
    for name, mod in (("jax", jls), ("port", tls)):
        def recorded(host, *a, _name=name, _orig=mod.reassemble_wire,
                     **k):
            wires[_name] = np.array(host)
            return _orig(host, *a, **k)
        monkeypatch.setattr(mod, "reassemble_wire", recorded)
    t_stores = [torch.from_numpy(a) for a in stores]
    got = tls.run_level(TMesh(), meta_p, C, *t_stores, **kw)
    port_wire = wires.pop("port")
    again = tls.dispatch_level(TMesh(), meta_p, C, *t_stores, **kw).finish()
    want = jls.run_level(JMesh.single_device(), meta_p, C,
                         *(jnp.asarray(a) for a in stores), donate=False,
                         **kw)
    np.testing.assert_array_equal(port_wire, wires["port"])
    np.testing.assert_array_equal(port_wire, wires["jax"])
    for out in (again, want):
        np.testing.assert_array_equal(got.wire.gsup, out.wire.gsup)
        np.testing.assert_array_equal(got.wire.perm, out.wire.perm)
        assert (got.wire.n_keep, got.wire.overflow, got.wire.rebalanced,
                got.wire.imbalance, got.wire.audit) == (
            out.wire.n_keep, out.wire.overflow, out.wire.rebalanced,
            out.wire.imbalance, out.wire.audit)
        np.testing.assert_array_equal(got.pol.numpy(), np.asarray(out.pol))
        np.testing.assert_array_equal(got.pmask.numpy(),
                                      np.asarray(out.pmask))
