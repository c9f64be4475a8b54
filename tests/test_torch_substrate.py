"""The port's host substrate against the JAX package's: graph databases,
DFS codes, candidate generation, the fused schedule, partitioning, shape
buckets and the host miner.  Every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from repro.core import buckets as jbuckets
from repro.core import candgen as jcandgen
from repro.core import dfscode as jdfscode
from repro.core import graphdb as jgraphdb
from repro.core import host_miner as jhost
from repro.core import partition as jpartition
from repro_torch.core import buckets as tbuckets
from repro_torch.core import candgen as tcandgen
from repro_torch.core import dfscode as tdfscode
from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import host_miner as thost
from repro_torch.core import partition as tpartition


def _graph_tuple(g):
    return (g.vlabels.tolist(), g.edges.tolist(), g.elabels.tolist())


def _cand_tuple(c):
    e = c.ext
    return (c.code, c.parent, e.forward, e.stub, e.to, e.triple)


DB_CASES = [
    ("random_db", dict(n_graphs=18, n_vertices=6, extra_edge_prob=0.35,
                       n_vlabels=3, n_elabels=2, seed=42)),
    ("random_db", dict(n_graphs=30, seed=7)),
    ("pubchem_like_db", dict(n_graphs=25, seed=3)),
    ("pubchem_like_db", dict(n_graphs=10, seed=0, avg_edges=12.0)),
    ("paper_toy_db", {}),
]


@pytest.mark.parametrize("name,kw", DB_CASES)
def test_same_seed_same_graphs(name, kw):
    want = [_graph_tuple(g) for g in getattr(jgraphdb, name)(**kw)]
    got = [_graph_tuple(g) for g in getattr(tgraphdb, name)(**kw)]
    assert got == want


def test_encode_decode_roundtrip_matches():
    graphs = jgraphdb.random_db(9, seed=2)
    tg = tgraphdb.random_db(9, seed=2)
    je, te = jgraphdb.encode_db(graphs), tgraphdb.encode_db(tg)
    for k in ("vlabels", "edges", "elabels", "emask"):
        np.testing.assert_array_equal(te.arrays()[k], je.arrays()[k])
    assert ([_graph_tuple(g) for g in tgraphdb.decode_db(te)]
            == [_graph_tuple(g) for g in jgraphdb.decode_db(je)])


def test_validate_db_rejects_like_reference():
    bad = [tgraphdb.Graph([0, 1], [(0, 1), (0, 1)], [0, 0])]
    with pytest.raises(tgraphdb.GraphValidationError, match="duplicate"):
        tgraphdb.validate_db(bad)
    with pytest.raises(tgraphdb.GraphValidationError, match="empty"):
        tgraphdb.validate_db([])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_min_dfs_code_and_canonicality(seed):
    for jg, tg in zip(jgraphdb.random_db(8, n_vertices=5, seed=seed),
                      tgraphdb.random_db(8, n_vertices=5, seed=seed)):
        code = tdfscode.min_dfs_code(tg)
        assert code == jdfscode.min_dfs_code(jg)
        assert tdfscode.is_canonical(code) and jdfscode.is_canonical(code)
        assert (tdfscode.rightmost_path(code)
                == jdfscode.rightmost_path(code))
        arr = tdfscode.code_to_array(code, len(code) + 2)
        np.testing.assert_array_equal(
            arr, jdfscode.code_to_array(code, len(code) + 2))
        assert tdfscode.array_to_code(arr) == code
        # a non-minimal serialization of the same graph is not canonical
        rev = tuple(reversed(code))
        assert tdfscode.is_canonical(rev) == jdfscode.is_canonical(rev)


def _alphabet_and_codes(graphs, minsup, mod):
    alpha, _ = mod.frequent_edges(graphs, minsup)
    return alpha, [((0, 1, a, e, b),) for (a, e, b) in alpha.canonical()]


@pytest.mark.parametrize("seed,minsup", [(42, 5), (7, 3), (11, 4)])
def test_generate_candidates_two_levels(seed, minsup):
    jg = jgraphdb.random_db(18, n_vertices=6, extra_edge_prob=0.35,
                            n_vlabels=3, n_elabels=2, seed=seed)
    tg = tgraphdb.random_db(18, n_vertices=6, extra_edge_prob=0.35,
                            n_vlabels=3, n_elabels=2, seed=seed)
    ja, jcodes = _alphabet_and_codes(jg, minsup, jhost)
    ta, tcodes = _alphabet_and_codes(tg, minsup, thost)
    assert ta.canonical() == ja.canonical() and tcodes == jcodes
    jc = jcandgen.generate_candidates(jcodes, ja)
    tc = tcandgen.generate_candidates(tcodes, ta)
    assert [_cand_tuple(c) for c in tc] == [_cand_tuple(c) for c in jc]
    # one level deeper, from every candidate (the speculative superset),
    # and its narrowing to a survivor subset
    jc2 = jcandgen.generate_candidates([c.code for c in jc], ja)
    tc2 = tcandgen.generate_candidates([c.code for c in tc], ta)
    assert [_cand_tuple(c) for c in tc2] == [_cand_tuple(c) for c in jc2]
    keep = list(range(0, len(jc), 3))
    assert ([_cand_tuple(c) for c in tcandgen.filter_speculative(tc2, keep)]
            == [_cand_tuple(c) for c in
                jcandgen.filter_speculative(jc2, keep)])


def _random_meta(rng, C, P, K, T):
    return np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)


SCHED_CASES = [
    # (C, P, T, tile_c, max_inflation, rows_to, inv_to)
    (23, 4, 3, 4, 1.5, None, None),
    (16, 16, 1, 8, 1.5, None, None),     # scattered: tile_c halves to 1
    (17, 5, 4, 8, float("inf"), 64, 32),  # bucketed rows + parked inv
    (9, 2, 2, 2, 1.5, None, 16),          # parked inv needs an extra tile
    (0, 1, 1, 4, 1.5, 8, 8),              # empty candidate set
    (40, 3, 3, 8, float("inf"), 128, 64),
]


@pytest.mark.parametrize("C,P,T,tc,infl,rows_to,inv_to", SCHED_CASES)
def test_schedule_and_pad_schedule(C, P, T, tc, infl, rows_to, inv_to):
    rng = np.random.default_rng(C + 13 * T)
    meta = _random_meta(rng, C, P, 4, T)
    if C == 16:
        meta[:, 0] = np.arange(16)
    js = jcandgen.schedule_candidates(meta, tc, max_inflation=infl)
    ts = tcandgen.schedule_candidates(meta, tc, max_inflation=infl)
    assert ts.tile_c == js.tile_c
    for a in ("meta", "tiles", "inv"):
        np.testing.assert_array_equal(getattr(ts, a), getattr(js, a))
    if rows_to is not None or inv_to is not None:
        jp = jcandgen.pad_schedule(js, rows_to=rows_to, inv_to=inv_to)
        tp = tcandgen.pad_schedule(ts, rows_to=rows_to, inv_to=inv_to)
        assert tp.tile_c == jp.tile_c
        for a in ("meta", "tiles", "inv"):
            np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))


@pytest.mark.parametrize("scheme", [1, 2, "density"])
@pytest.mark.parametrize("minsup", [4, 0.3])
def test_make_partitions(scheme, minsup):
    jg = jgraphdb.random_db(20, n_vertices=7, seed=9)
    tg = tgraphdb.random_db(20, n_vertices=7, seed=9)
    jp = jpartition.make_partitions(jg, minsup, 4, scheme=scheme)
    tp = tpartition.make_partitions(tg, minsup, 4, scheme=scheme)
    assert tp.graph_ids == jp.graph_ids
    assert tp.minsup == jp.minsup and tp.n_graphs == jp.n_graphs
    assert tp.alphabet.canonical() == jp.alphabet.canonical()
    assert ([[_graph_tuple(g) for g in p] for p in tp.partitions]
            == [[_graph_tuple(g) for g in p] for p in jp.partitions])


def test_buckets():
    for floor in (1, 8, 32, 64):
        for x in range(0, 300, 7):
            assert (tbuckets.bucket_size(x, floor)
                    == jbuckets.bucket_size(x, floor))
    jb, tb = jbuckets.BucketSpec(16, 8, 8), tbuckets.BucketSpec(16, 8, 8)
    for c in range(1, 200, 9):
        assert tb.candidates(c, 1) == jb.candidates(c, 1)
        assert tb.survivors(c, 128) == jb.survivors(c, 128)
        assert tb.vertex_slots(c % 20 + 1, 8) == jb.vertex_slots(
            c % 20 + 1, 8)
        assert tb.embeddings(c, 32) == jb.embeddings(c, 32)
    assert tbuckets.round_up_multiple(13, 4) == 16


@pytest.mark.parametrize("db,minsup,max_size", [
    ("paper_toy", 2, None), ("random", 5, 3), ("random", 3, 4)])
def test_mine_host_matches_reference(db, minsup, max_size):
    if db == "paper_toy":
        jg, tg = jgraphdb.paper_toy_db(), tgraphdb.paper_toy_db()
    else:
        kw = dict(n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                  n_elabels=2, seed=42)
        jg, tg = jgraphdb.random_db(18, **kw), tgraphdb.random_db(18, **kw)
    jr = jhost.mine_host(jg, minsup, max_size=max_size)
    tr = thost.mine_host(tg, minsup, max_size=max_size)
    assert tr.levels == jr.levels
    assert tr.n_candidates == jr.n_candidates
    assert ({c: i.support for c, i in tr.frequent.items()}
            == {c: i.support for c, i in jr.frequent.items()})
    assert ({c: i.ol for c, i in tr.frequent.items()}
            == {c: i.ol for c, i in jr.frequent.items()})
    if db == "paper_toy":
        assert len(tr.frequent) == 13


def test_naive_baseline_matches_reference():
    from repro.core.naive import mine_naive as jnaive
    from repro_torch.core.naive import mine_naive as tnaive
    got = tnaive(tgraphdb.paper_toy_db(), 2, n_iterations=6)
    want = jnaive(jgraphdb.paper_toy_db(), 2, n_iterations=6)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.distinct_frequent == 13 and got.duplicate_ratio > 1.0
