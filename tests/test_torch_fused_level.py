"""The fused join+support kernels' plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and its bitset
oracle, plus the embedding data plane they are built on.  Every
comparison is exact.  The CUDA kernels themselves run only on a card:
``test_cuda_kernels_equal_plain_versions`` is marked ``cuda`` and skips
on a host without one.  The JAX package comes in through the ``ref``
fixture, so that on a GPU machine without JAX
``pytest -m cuda tests/test_torch_fused_level.py`` still imports this
file and runs the CUDA cases."""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import embedding as temb
from repro_torch.core.candgen import (CandidateSchedule, pad_schedule,
                                      schedule_candidates)
from repro_torch.kernels import fused_level as tfl
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bitset import n_words


@pytest.fixture(scope="module")
def ref():
    """The JAX package's embedding module and kernel dispatch."""
    from repro.core import embedding
    from repro.kernels import ops
    return types.SimpleNamespace(emb=embedding, ops=ops)


def _masks(rng, shape, kind):
    """Occurrence masks: "random" (dense, with holes), "holes" (sparse,
    so spans end anywhere) or "prefix" (the stores' layout: each row set
    from slot 0, to a length uniform in [0, width])."""
    if kind == "prefix":
        n = rng.integers(0, shape[-1] + 1, shape[:-1])
        return np.arange(shape[-1]) < n[..., None]
    return rng.random(shape) < (0.1 if kind == "holes" else 0.7)


def _random_level(rng, C=7, P=5, G=20, M=8, K=4, T=6, F=8, masks="random"):
    """Random-but-consistent join inputs (ids in [0, 32), PAD -1),
    deliberately misaligned (C % tile_c != 0, G % 32 != 0)."""
    pol = rng.integers(0, 32, (P, G, M, K)).astype(np.int32)
    pmask = _masks(rng, (P, G, M), masks)
    pol = np.where(rng.random((P, G, M, K)) < 0.15, -1, pol)
    src = rng.integers(0, 32, (T, G, F)).astype(np.int32)
    dst = rng.integers(0, 32, (T, G, F)).astype(np.int32)
    emask = _masks(rng, (T, G, F), masks)
    src = np.where(emask, src, -1)
    dst = np.where(emask, dst, -1)
    meta = np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)
    return meta, pol, pmask, src, dst, emask


def _stack_pp(rng, PP, **shape):
    meta, pol, pmask, src, dst, emask = _random_level(rng, **shape)
    if PP == 1:
        return meta, pol[None], pmask[None], src[None], dst[None], emask[None]
    pols = np.stack([np.roll(pol, i, axis=1) for i in range(PP)])
    pmasks = np.stack([np.roll(pmask, i, axis=1) for i in range(PP)])
    return (meta, pols, pmasks, np.stack([src] * PP), np.stack([dst] * PP),
            np.stack([emask] * PP))


# (shape, PP, tile_c, bucket rows, tile_g); besides _random_level's
# arguments a shape may name "slots" (stub/to outside [0, K)) and
# "unsorted" (tiles not in parent order)
KERNEL_CASES = [
    pytest.param(dict(C=9, G=37), 1, 8, None, 128, id="G37"),
    pytest.param(dict(C=7, G=20), 1, 4, None, 128, id="C7-tc4"),
    pytest.param(dict(C=9, G=37), 1, 1, None, 128, id="tc1"),
    pytest.param(dict(C=9, G=37), 1, 2, 32, 128, id="tc2-invalid-tiles"),
    pytest.param(dict(C=6, P=3, G=24, M=4, K=3, T=3, F=5), 2, 4, None, 128,
                 id="PP2"),
    pytest.param(dict(C=12, P=3, G=16, M=6, K=3, T=3, F=6), 1, 4, None, 128,
                 id="dup-parents"),
    pytest.param(dict(C=5, G=70, M=4, K=3, T=3, F=5), 1, 8, 16, 64,
                 id="G70-tail-words"),
    pytest.param(dict(C=9, G=37, M=300, F=6, masks="prefix"), 1, 8, None,
                 128, id="M300-prefix"),
    pytest.param(dict(C=8, G=40, M=40, F=60, masks="prefix"), 1, 4, None,
                 128, id="F60-prefix"),
    pytest.param(dict(C=9, G=37, M=48, F=20, masks="holes"), 1, 2, 32, 128,
                 id="M48-holes"),
    pytest.param(dict(C=9, G=37, slots=True), 1, 4, None, 128,
                 id="slots-out-of-range"),
    pytest.param(dict(C=80, P=4, G=33, T=3), 1, 1, 96, 128,
                 id="tc1-80-tiles"),
    pytest.param(dict(C=80, P=4, G=33, T=3, unsorted=True), 1, 1, 96, 128,
                 id="tc1-unsorted"),
    pytest.param(dict(C=10, P=3, G=50, M=64, F=10, masks="prefix"), 3, 2,
                 None, 128, id="PP3-prefix"),
    # G = 130 at the 128-graph tile: Gw = 8 words, the last 3 past G
    pytest.param(dict(C=9, G=130, M=6, F=6), 1, 4, 16, 128,
                 id="G130-tail-words"),
]


def _unsort(sched, rng):
    """The same schedule with its tiles (and their rows) in a random
    order, so that runs of one parent are broken up."""
    tc = sched.tile_c
    perm = rng.permutation(sched.n_tiles)
    rows = (perm[:, None] * tc + np.arange(tc)).reshape(-1)
    where = np.empty_like(rows)
    where[rows] = np.arange(rows.size)
    return CandidateSchedule(sched.meta[rows], sched.tiles[perm],
                             where[sched.inv].astype(np.int32), tc)


def _kernel_inputs(shape, PP, tc, rows, seed):
    shape = dict(shape)
    slots, unsorted = shape.pop("slots", False), shape.pop("unsorted", False)
    rng = np.random.default_rng(seed)
    meta, pol, pmask, src, dst, emask = _stack_pp(rng, PP, **shape)
    if shape.get("C") == 12:                      # heavy parent skew
        meta[:, 0] = np.asarray([1] * 9 + [2] * 3)
        meta[:, 4] = np.asarray([0] * 6 + [2] * 6)
    if slots:                                     # stub/to outside [0, K)
        K = pol.shape[-1]
        meta[::2, 1] = K + 1
        meta[1::3, 2] = -1
        meta[2::3, 2] = K
    sched = schedule_candidates(meta, tc)
    if rows is not None:
        sched = pad_schedule(sched, rows_to=rows, inv_to=len(meta) + 2)
    if unsorted:
        sched = _unsort(sched, rng)
    return meta, sched, (pol, pmask, src, dst, emask)


@pytest.mark.parametrize("shape,PP,tc,rows,tile_g", KERNEL_CASES)
def test_packed_plain_matches_pallas_interpret(ref, shape, PP, tc, rows,
                                               tile_g):
    meta, sched, stores = _kernel_inputs(shape, PP, tc, rows,
                                         seed=shape["G"] + tc)
    sup_j, emb_j, vb_j = ref.ops.fused_level_supports_packed(
        sched.meta, sched.tiles, *stores, tile_g=tile_g, interpret=True)
    t = [torch.from_numpy(x) for x in (sched.meta, sched.tiles, *stores)]
    sup_t, emb_t, vb_t = tops.fused_level_supports_packed(*t, tile_g=tile_g)
    np.testing.assert_array_equal(sup_t.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    assert vb_t.dtype == torch.uint32
    np.testing.assert_array_equal(vb_t.numpy(), np.asarray(vb_j))
    # words past n_words(G) (graph-tile padding) are zero
    np.testing.assert_array_equal(
        vb_t.numpy()[:, :, n_words(shape["G"]):], 0)
    # against the per-candidate bitset oracle, in canonical order
    inv = sched.inv[:len(meta)]
    for pp in range(PP):
        sup_o, emb_o, vb_o = ref.emb.support_bits_ref(
            meta, stores[0][pp], stores[1][pp], stores[2][pp],
            stores[3][pp], stores[4][pp])
        np.testing.assert_array_equal(sup_t.numpy()[pp][inv],
                                      np.asarray(sup_o))
        np.testing.assert_array_equal(emb_t.numpy()[pp][inv],
                                      np.asarray(emb_o))
        np.testing.assert_array_equal(
            vb_t.numpy()[pp][inv][:, :n_words(shape["G"])],
            np.asarray(vb_o))


@pytest.mark.parametrize("shape,PP,tc,rows,tile_g", KERNEL_CASES)
def test_dense_plain_matches_pallas_interpret(ref, shape, PP, tc, rows,
                                              tile_g):
    _, sched, stores = _kernel_inputs(shape, PP, tc, rows, seed=3)
    sup_j, emb_j = ref.ops.fused_level_supports(
        sched.meta, sched.tiles, *stores, tile_g=tile_g, interpret=True)
    t = [torch.from_numpy(x) for x in (sched.meta, sched.tiles, *stores)]
    sup_t, emb_t = tops.fused_level_supports(*t)
    np.testing.assert_array_equal(sup_t.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_reference_joins_match(ref, seed):
    rng = np.random.default_rng(seed)
    meta, pol, pmask, src, dst, emask = _random_level(rng, C=9, G=37)
    sup_j, emb_j, vb_j = ref.emb.support_bits_ref(meta, pol, pmask, src, dst,
                                               emask)
    t = [torch.from_numpy(x) for x in (pol, pmask, src, dst, emask)]
    sup_t, emb_t, vb_t = temb.support_bits_ref(meta, *t)
    np.testing.assert_array_equal(sup_t.numpy(), np.asarray(sup_j))
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    np.testing.assert_array_equal(vb_t.numpy(), np.asarray(vb_j))
    ls_j = ref.emb.local_supports_ref(ref.emb.LevelOL(pol, pmask), src, dst,
                                   emask, meta)
    ls_t = temb.local_supports_ref(temb.LevelOL(t[0], t[1]), *t[2:], meta)
    for a, b in zip(ls_t, ls_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,out_width,mc", [(0, None, 4), (1, 5, 8),
                                              (2, 4, 2)])
def test_materialize_matches_reference(ref, seed, out_width, mc):
    rng = np.random.default_rng(seed)
    meta, pol, pmask, src, dst, emask = _random_level(rng, C=6, G=9, M=5,
                                                      K=4, F=6)
    lvl_j, over_j = ref.emb.materialize_ol(
        ref.emb.LevelOL(pol, pmask), src, dst, emask, meta,
        max_embeddings=mc, out_width=out_width)
    t = [torch.from_numpy(x) for x in (pol, pmask, src, dst, emask)]
    lvl_t, over_t = temb.materialize_ol(
        temb.LevelOL(t[0], t[1]), *t[2:], meta, max_embeddings=mc,
        out_width=out_width)
    np.testing.assert_array_equal(lvl_t.ol.numpy(), np.asarray(lvl_j.ol))
    np.testing.assert_array_equal(lvl_t.mask.numpy(),
                                  np.asarray(lvl_j.mask))
    np.testing.assert_array_equal(over_t.numpy(), np.asarray(over_j))
    # one candidate row given as device-style 0-dim tensors
    ch, mk, ov = temb.materialize_one(
        temb.LevelOL(t[0], t[1]), *t[2:], torch.from_numpy(meta[2]),
        max_embeddings=mc, out_width=out_width)
    np.testing.assert_array_equal(ch.numpy(), np.asarray(lvl_j.ol)[2])
    assert int(ov) == int(np.asarray(over_j)[2])


def test_edge_ol_and_level1_match(ref):
    from repro_torch.core.graphdb import random_db
    graphs = random_db(7, seed=4)
    triples = [(0, 0, 1), (1, 0, 0), (1, 1, 2), (2, 1, 1), (0, 1, 0)]
    je = ref.emb.build_edge_ol(graphs, triples, pad_graphs=8)
    te = temb.build_edge_ol(graphs, triples, pad_graphs=8)
    for a in ("src", "dst", "mask", "triples"):
        np.testing.assert_array_equal(getattr(te, a), getattr(je, a))
    codes = [((0, 1, 0, 0, 1),), ((0, 1, 1, 1, 2),)]
    jl = ref.emb.level1_ol(codes, je, max_embeddings=6)
    tl = temb.level1_ol(codes, te, max_embeddings=6)
    np.testing.assert_array_equal(tl.ol.numpy(), np.asarray(jl.ol))
    np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask))


def test_wrappers_check_inputs_and_use_plain_versions_on_cpu():
    _, sched, stores = _kernel_inputs(dict(C=7, G=20), 1, 4, None, 1)
    t = [torch.from_numpy(x) for x in (sched.meta, sched.tiles, *stores)]
    tfl.reset_launches()
    tops.fused_level_supports_packed(*t)
    tops.fused_level_supports(*t)
    assert tfl.launches == {"fused_level_packed": 0, "fused_level": 0}
    bad = list(t)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(TypeError, match="pol must be int32"):
        tops.fused_level_supports(*bad)
    bad = list(t)
    bad[2] = bad[2].transpose(2, 3)
    with pytest.raises(ValueError):
        tops.fused_level_supports(*bad)
    bad = list(t)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="multiple of NT"):
        tops.fused_level_supports(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,PP,tc,rows,tile_g", KERNEL_CASES)
def test_cuda_kernels_equal_plain_versions(shape, PP, tc, rows, tile_g):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    _, sched, stores = _kernel_inputs(shape, PP, tc, rows, seed=7)
    cpu = [torch.from_numpy(x) for x in (sched.meta, sched.tiles, *stores)]
    gpu = [x.cuda() for x in cpu]
    packed = lambda *a: tops.fused_level_supports_packed(*a, tile_g=tile_g)
    for f in (packed, tops.fused_level_supports):
        before = dict(tfl.launches)
        got = f(*gpu)
        torch.cuda.synchronize()
        assert sum(tfl.launches.values()) == sum(before.values()) + 1
        for a, b in zip(got, f(*cpu)):
            assert torch.equal(a.cpu(), b)


def _is_prefix(mask: np.ndarray) -> bool:
    """Every row of the last axis set from slot 0 with no hole."""
    n = mask.sum(-1, keepdims=True)
    return bool((mask == (np.arange(mask.shape[-1]) < n)).all())


@pytest.mark.parametrize("db", ["random_db", "pubchem_like_db"])
def test_stores_keep_set_entries_as_a_prefix(db):
    """The edge-OL, the level-1 store and a materialized child store fill
    every (triple|parent, graph) row from slot 0.  The dense kernel's
    spans are exact on any mask, but its speed rests on this layout."""
    from repro_torch.core import graphdb
    from repro_torch.core.candgen import EdgeAlphabet, generate_candidates
    if db == "random_db":
        graphs = graphdb.random_db(12, n_vertices=6, extra_edge_prob=0.4,
                                   n_vlabels=2, n_elabels=2, seed=5)
    else:
        graphs = graphdb.pubchem_like_db(16, seed=1, avg_edges=12)
    triples = sorted({(int(g.vlabels[u]), int(el), int(g.vlabels[v]))
                      for g in graphs
                      for (a, b), el in zip(g.edges, g.elabels)
                      for u, v in ((a, b), (b, a))})
    eol = temb.build_edge_ol(graphs, triples)
    assert _is_prefix(eol.mask)
    alphabet = EdgeAlphabet(triples)
    codes = [((0, 1, a, e, b),) for a, e, b in alphabet.canonical()]
    lvl = temb.level1_ol(codes, eol, max_embeddings=8)
    assert _is_prefix(lvl.mask.numpy())
    cands = generate_candidates(codes, alphabet)
    meta = temb.candidate_meta(cands, eol)
    src, dst, em = (torch.from_numpy(x) for x in (eol.src, eol.dst,
                                                   eol.mask))
    joined = 0
    for row in meta[:12]:
        _, mask, _ = temb.materialize_one(lvl, src, dst, em,
                                          torch.from_numpy(row),
                                          max_embeddings=16)
        assert _is_prefix(mask.numpy())
        joined += int(mask.sum())
    assert joined > 0, "the check needs child embeddings to look at"


def test_dense_geometry_at_the_extreme_shapes(monkeypatch):
    """The three join kernels (packed, dense and the two-launch join)
    share one geometry: a CTA's shared memory holds the spans of every
    triple for 32 graphs, and per warp 3 x 32 words, while that fits
    beside the walk's static shared memory (T up to 1,791); one triple
    more (and T = 1,914, the seeded DB of ROADMAP queue C, C2) drops the
    table for 4 x 32 words per warp, and launches too.
    More partitions than the grid takes raise.  M, F, K, G and the row
    count do not enter it.  Each wrapper, made to take its card path
    here, launches with that geometry (F = 900 too, past what a
    per-thread staged edge row could take)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_join as tej
    from repro_torch.kernels.bitset import tail_mask
    warps = build.JOIN_WARPS * build.JOIN_WARP_BYTES
    lazy = build.JOIN_WARPS * build.JOIN_LAZY_WARP_BYTES
    t_max = ((build.SMEM_MAX - build.JOIN_STATIC_BYTES - warps)
             // (build.JOIN_CHUNK * 4))
    threads, smem = build.join_geometry(8, t_max)
    assert threads == build.JOIN_WARPS * 32
    assert smem + build.JOIN_STATIC_BYTES <= build.SMEM_MAX
    assert smem == t_max * build.JOIN_CHUNK * 4 + warps
    assert build.join_geometry(1, 1) == (threads,
                                         build.JOIN_CHUNK * 4 + warps)
    assert t_max == 1791
    for T in (t_max + 1, 1914, 100_000):
        assert build.join_geometry(8, T) == (threads, lazy)
    with pytest.raises(ValueError, match="grid"):
        build.join_geometry(65536, 45)
    with pytest.raises(ValueError, match="grid"):
        build.join_geometry(65536, 1914)

    launched = []
    for mod in (tfl, tej):
        monkeypatch.setattr(mod, "on_cpu", lambda x: False)
        monkeypatch.setattr(mod, "launch", lambda name, counts, tensors,
                            dims: launched.append((name, dims[-2:])))
    sched = torch.tensor([[0, 0, 1, 1, 0, 1]], dtype=torch.int32)
    tiles = torch.zeros((1, 2), dtype=torch.int32)
    meta = sched[:, :5].contiguous()
    pol = torch.zeros((1, 2, 1, 4, 3), dtype=torch.int32)
    pmask = torch.ones((1, 2, 1, 4), dtype=torch.bool)
    want = []
    for T, F, geom in ((t_max, 900, (threads, smem)),
                       (t_max + 1, 2, (threads, lazy)),
                       (1914, 2, (threads, lazy))):
        src = torch.zeros((1, T, 1, F), dtype=torch.int32)
        stores = (pol, pmask, src, src.clone(),
                  torch.ones(src.shape, dtype=torch.bool))
        tfl.fused_level_packed(sched, tiles, tail_mask(1), *stores)
        tfl.fused_level(sched, tiles, *stores)
        tej.embedding_join(meta, *stores)
        want += [(name, geom) for name in
                 ("fused_level_packed", "fused_level", "embedding_join")]
    assert launched == want


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1791, 1792, 1914])
def test_cuda_joins_at_any_triple_count(T):
    """The three join kernels equal their plain versions on both sides of
    the span table's limit: T = 1,791 keeps the CTA's table of every
    triple's spans, T = 1,792 (which the table fitted only without the
    walk's static shared memory) and T = 1,914 (the seeded DB of ROADMAP
    queue C, C2) have each warp compute its current triple's spans
    instead; rows name triples at random, so the triple changes on
    nearly every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_join import embedding_join
    shape = dict(C=60, P=5, G=70, M=6, K=3, T=T, F=4, masks="prefix")
    meta, sched, stores = _kernel_inputs(shape, 2, 4, 96, seed=19)
    rng = np.random.default_rng(19)
    sched = _unsort(sched, rng)
    cpu = [torch.from_numpy(x) for x in (sched.meta, sched.tiles, *stores)]
    gpu = [x.cuda() for x in cpu]
    for f in (tops.fused_level_supports_packed, tops.fused_level_supports):
        got = f(*gpu)
        torch.cuda.synchronize()
        for a, b in zip(got, f(*cpu)):
            assert torch.equal(a.cpu(), b)
    rows = [torch.from_numpy(meta), *cpu[2:]]
    got = embedding_join(*[x.cuda() for x in rows])
    torch.cuda.synchronize()
    for a, b in zip(got, ref.embedding_join_ref(*rows)):
        assert torch.equal(a.cpu(), b)


# ROADMAP queue C, C2: a seeded DB with T = 1,914 directed triples
C2_DB = dict(n_graphs=400, n_vertices=8, extra_edge_prob=0.3, n_vlabels=40,
             n_elabels=2, seed=0)




def test_c2_db_and_its_host_oracle_equal_the_reference():
    """The C2 DB of the port is the JAX package's ``random_db`` graph for
    graph, it has T = 1,914 frequent directed triples, and the port's
    ``mine_host`` equals the JAX package's on it.  With the ``cuda`` case
    below, which holds the card's run to the port's ``mine_host``, this
    ties the card's result on the DB to the reference."""
    from repro.core import graphdb as jgraphdb
    from repro.core.host_miner import mine_host as jmine_host
    from repro_torch.core.graphdb import random_db
    from repro_torch.core.host_miner import mine_host
    from repro_torch.core.partition import make_partitions
    graphs = random_db(**C2_DB)
    jgraphs = jgraphdb.random_db(**C2_DB)
    for g, j in zip(graphs, jgraphs, strict=True):
        for a in ("vlabels", "edges", "elabels"):
            assert np.array_equal(getattr(g, a), getattr(j, a))
    alphabet = make_partitions(graphs, 2, 8).alphabet
    assert len({t for c in alphabet.canonical()
                for t in (c, (c[2], c[1], c[0]))}) == 1914
    want = {c: i.support for c, i in
            jmine_host(jgraphs, 2, max_size=3).frequent.items()}
    got = {c: i.support for c, i in
           mine_host(graphs, 2, max_size=3).frequent.items()}
    assert len(want) == 1075
    assert got == want


@pytest.mark.cuda
def test_cuda_mines_past_the_span_table_equal_to_mine_host():
    """The seeded DB of ROADMAP queue C, C2 (T = 1,914 directed triples)
    mines on the card with the fused backend, equal to ``mine_host``
    (held to the JAX package's by
    ``test_c2_db_and_its_host_oracle_equal_the_reference``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: no CUDA device is present")
    from repro_torch.core.graphdb import random_db
    from repro_torch.core.host_miner import mine_host
    from repro_torch.core.mining import Mirage, MirageConfig
    graphs = random_db(**C2_DB)
    res = Mirage(MirageConfig(minsup=2, n_partitions=8, max_size=3,
                              backend="fused")).fit(graphs)
    want = mine_host(graphs, 2, max_size=3)
    assert len(want.frequent) == 1075
    assert res.supports == {c: i.support for c, i in want.frequent.items()}
