"""Multi-worker mining in the port against the JAX package's W-device
mesh and the host oracle.

The port runs one ``torch.distributed`` rank per worker; here they are W
processes of a gloo group on the CPU (``torch_ranks.run``), and the JAX
reference runs in its own process on W simulated devices.  Everything is
an integer, so every comparison is exact: the shuffle's outputs on every
rank, the LPT permutation, the wire codec, each level's fetched wire,
and the frequent sets of the conformance matrix
(``tests/test_multiworker.py``'s, at W = 2 and 4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import level_step as jls
from repro.core import graphdb
from repro.core import mining as jmining
from repro.core.graphdb import random_db
from repro.core.host_miner import mine_host
from repro_torch.core import level_step as tls
from repro_torch.core import mining as tmining
from torch_ranks import run

# tests/test_conformance.py::conformance_db, minsup 5, max_size 3
CONFORMANCE = ("dict(n_graphs=18, n_vertices=6, extra_edge_prob=0.35, "
               "n_vlabels=3, n_elabels=2, seed=42)")
# tests/test_torch_mining.py's molecule-like DB, minsup 5, max_size 4:
# three levels with survivors
PUBCHEM = "dict(n_graphs=20, seed=1, avg_edges=14.0)"


def _oracle():
    graphs = random_db(**eval(CONFORMANCE))
    return sorted((c, i.support) for c, i in
                  mine_host(graphs, 5, max_size=3).frequent.items())


# ---------------------------------------------------------------------------
# the shuffle: reduce_supports on every rank
# ---------------------------------------------------------------------------

# name: (reduce, packed, gather_gsup); C = 72 keys, so each worker's
# shard (36 or 18 keys) ends inside a verdict word
SHUFFLE_CASES = """
CASES = {"psum": ("psum", False, False),
         "rs": ("reduce_scatter", False, False),
         "rs-gather": ("reduce_scatter", False, True),
         "rs-packed": ("reduce_scatter", True, False),
         "rs-packed-gather": ("reduce_scatter", True, True)}
W = int(ARGS[0])
LOCAL = np.random.default_rng(7).integers(0, 9, (W, 72)).astype(np.int32)
MINSUP = 4 * W
"""

SHUFFLE_JAX = SHUFFLE_CASES + """
from jax.sharding import PartitionSpec as P
from repro.core.mapreduce import reduce_supports
from repro.runtime import jax_compat
mesh = jax_compat.make_mesh((W,), ("w",))
for name, (reduce, packed, gather) in CASES.items():
    def program(x, reduce=reduce, packed=packed, gather=gather):
        g, v = reduce_supports(x[0], ("w",), MINSUP, reduce,
                               gather_gsup=gather, packed=packed)
        return g[None], v[None]
    g, v = jax.jit(jax_compat.shard_map(
        program, mesh=mesh, in_specs=P("w"), out_specs=(P("w"), P("w")),
        check_vma=False))(LOCAL)
    RESULT[name] = (np.asarray(g), np.asarray(v))
"""

SHUFFLE_RANKS = SHUFFLE_CASES + """
from repro_torch.core.mapreduce import reduce_supports
for name, (reduce, packed, gather) in CASES.items():
    g, v = reduce_supports(torch.from_numpy(LOCAL[RANK].copy()), MESH,
                           MINSUP, reduce, gather_gsup=gather, packed=packed)
    RESULT[name] = (g.numpy(), v.numpy())
"""


@pytest.mark.parametrize("workers", [2, 4])
def test_reduce_supports_matches_jax_on_every_rank(tmp_path, workers):
    got, want = run(tmp_path, ranks=(SHUFFLE_RANKS, workers),
                    jax=(SHUFFLE_JAX, workers), args=[workers])
    assert set(want) == set(got[0]) and len(want) == 5
    for rank, res in enumerate(got):
        for name, (gsup, verdict) in want.items():
            assert res[name] == (gsup[rank], verdict[rank]), (name, rank)


# ---------------------------------------------------------------------------
# the straggler rebalance's LPT permutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("npart,workers,seed", [
    (8, 2, 0), (16, 4, 1), (4, 2, 2), (12, 3, 3), (16, 2, 4), (8, 8, 5)])
def test_lpt_permutation_matches_jax_and_host_order(npart, workers, seed):
    """The device LPT repack equals the JAX device function, and the
    host ``_lpt_order`` the JAX host one, on costs with ties and
    without.  (The JAX package's two may differ from each other: its
    host order picks among equal bucket loads, the empty buckets at the
    start included, with numpy's default sort, which is not stable;
    its device function takes the first.  Each twin keeps its rule.)"""
    rng = np.random.default_rng(seed)
    for cost in (rng.integers(0, 5, npart).astype(np.float64),
                 rng.random(npart) * 1e4):
        want = np.asarray(jls.lpt_permutation(
            jnp.asarray(cost, jnp.float32), workers))
        got = tls.lpt_permutation(torch.tensor(cost, dtype=torch.float32),
                                  workers)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        host = jmining._lpt_order(cost, workers)
        np.testing.assert_array_equal(tmining._lpt_order(cost, workers),
                                      host)
        for perm in (want, host):
            assert sorted(perm.tolist()) == list(range(npart))


# ---------------------------------------------------------------------------
# the sharded wire codec
# ---------------------------------------------------------------------------

def _make_wire(cp, n_partitions, n_shards, packed, seed=0):
    """A wire as the JAX level program packs it: per shard [gsup slice |
    5 scalars | perm | checksum], scalars and perm replicated."""
    rng = np.random.default_rng(seed)
    gsup = rng.integers(0, 1 << 16 if packed else 1 << 20, cp)
    scalars = np.array([7, 0, 1, 1 << 15, 0], np.int64)
    perm = np.arange(n_partitions)[::-1]
    shards = []
    for s in np.split(gsup, n_shards):
        if packed:
            s = np.concatenate([s, np.zeros(len(s) % 2, np.int64)])
            s = (s[0::2] | (s[1::2] << 16)).astype(np.uint32).view(np.int32)
        body = np.concatenate([s, scalars, perm]).astype(np.int32)
        shards.append(np.concatenate([body, [jls.wire_checksum(body)]]))
    return np.concatenate(shards).astype(np.int32)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_wire_codec_matches_jax(n_shards, packed):
    """``wire_words``, ``reassemble_wire(n_shards=W)`` and
    ``wire_cost_model`` equal the JAX package's, and one flipped bit in
    any shard fails that shard's checksum."""
    cp, npart = 44, 4                       # 11 supports per shard at W=4
    host = _make_wire(cp, npart, n_shards, packed)
    assert tls.wire_words(cp, npart, n_shards, packed) == \
        jls.wire_words(cp, npart, n_shards, packed) == host.shape[0]
    want = jls.reassemble_wire(host, npart, n_shards, packed=packed, cp=cp)
    got = tls.reassemble_wire(host, npart, n_shards, packed=packed, cp=cp)
    np.testing.assert_array_equal(got, want)
    for w in range(0, host.shape[0], 3):
        bad = host.copy()
        bad[w] ^= np.int32(1 << 5)
        assert tls.reassemble_wire(bad, npart, n_shards, packed=packed,
                                   cp=cp) is None, w
    for reduce, sharded in (("psum", None), ("reduce_scatter", None),
                            ("reduce_scatter", False)):
        kw = dict(reduce=reduce, sharded=sharded, packed=packed)
        assert tls.wire_cost_model(cp, npart, n_shards, **kw) == \
            jls.wire_cost_model(cp, npart, n_shards, **kw)


# ---------------------------------------------------------------------------
# each level's fetched wire at W=2
# ---------------------------------------------------------------------------

# sharded × packed, reduce_scatter, the rebalance armed at 1.0 so that it
# fires and the wire carries a real permutation; on the conformance DB
# (whose level 2 keeps nothing) and on a molecule-like DB that mines to
# level 4
WIRE_CONFIGS = f"""
DBS = {{"conformance": ("random_db", {CONFORMANCE}, 5, 3),
        "pubchem_like": ("pubchem_like_db", {PUBCHEM}, 5, 4)}}
CONFIGS = {{(db, s, p): dict(
               minsup=minsup, n_partitions=8, max_size=max_size,
               reduce="reduce_scatter", sharded_wire=s, packed_support=p,
               rebalance_threshold=1.0)
           for db, (_, _, minsup, max_size) in DBS.items()
           for s in (True, False) for p in (None, False)}}
"""

WIRE_JAX = WIRE_CONFIGS + """
from repro.core import graphdb, level_step
from repro.core.mapreduce import MiningMesh
from repro.core.mining import Mirage, MirageConfig
from repro.runtime import jax_compat
mesh = MiningMesh(jax_compat.make_mesh((2,), ("w",)))
orig = level_step._fetch_wire
for key, cfg in CONFIGS.items():
    make, kw, _, _ = DBS[key[0]]
    wires = []
    def fetch(wire_d, *a, **kw):
        wires.append(np.array(wire_d))
        return orig(wire_d, *a, **kw)
    level_step._fetch_wire = fetch
    res = Mirage(MirageConfig(**cfg), mesh).fit(getattr(graphdb, make)(**kw))
    level_step._fetch_wire = orig
    RESULT[key] = (wires, [(s.rebalanced, s.imbalance) for s in res.stats],
                   sorted(res.supports.items()))
"""

WIRE_RANKS = WIRE_CONFIGS + """
from repro_torch.core import graphdb, level_step
from repro_torch.core.mining import Mirage, MirageConfig
orig = level_step._fetch_wire
for key, cfg in CONFIGS.items():
    make, kw, _, _ = DBS[key[0]]
    wires = []
    def fetch(wire_d, *a, **kw):
        wires.append(wire_d.cpu().numpy())
        return orig(wire_d, *a, **kw)
    level_step._fetch_wire = fetch
    res = Mirage(MirageConfig(**cfg), MESH).fit(getattr(graphdb, make)(**kw))
    level_step._fetch_wire = orig
    RESULT[key] = (wires, [(s.rebalanced, s.imbalance) for s in res.stats],
                   sorted(res.supports.items()))
"""


def test_level_wires_match_jax_at_two_workers(tmp_path):
    """Every level's fetched wire — sharded and dense, packed and not —
    is word for word the JAX package's on a 2-device mesh, on both
    ranks; on the deeper DB a rebalance fires and moves the partitions
    before the next level."""
    got, want = run(tmp_path, ranks=(WIRE_RANKS, 2), jax=(WIRE_JAX, 2))
    assert len(want) == 8
    for (db, sharded, packed), (wires, stats, supports) in want.items():
        key = (db, sharded, packed)
        name, kw, minsup, max_size = {
            "conformance": ("random_db", eval(CONFORMANCE), 5, 3),
            "pubchem_like": ("pubchem_like_db", eval(PUBCHEM), 5, 4)}[db]
        oracle = mine_host(getattr(graphdb, name)(**kw), minsup,
                           max_size=max_size)
        assert supports == sorted((c, i.support)
                                  for c, i in oracle.frequent.items()), key
        assert len(wires) == len(stats) >= 1, key
        if db == "pubchem_like":
            assert any(reb for reb, _ in stats[:-1]), key
        for rank, res in enumerate(got):
            assert res[key] == (wires, stats, supports), (key, rank)


# ---------------------------------------------------------------------------
# the conformance matrix and the ragged candidate axis
# ---------------------------------------------------------------------------

MATRIX_RANKS = f"""
import itertools
from repro_torch.core.graphdb import pubchem_like_db, random_db
from repro_torch.core.mining import Mirage, MirageConfig
for db, graphs, max_size in (
        ("conformance", random_db(**{CONFORMANCE}), 3),
        ("pubchem_like", pubchem_like_db(**{PUBCHEM}), 4)):
    base = dict(minsup=5, n_partitions=8, max_size=max_size)
    for sharded, scheme, overlap in itertools.product(
            (True, False), (2, "density"), (True, False)):
        cfg = MirageConfig(scheme=scheme, reduce="reduce_scatter",
                           sharded_wire=sharded, overlap_candgen=overlap,
                           **base)
        res = Mirage(cfg, MESH).fit(graphs)
        RESULT[(db, sharded, scheme, overlap)] = sorted(res.supports.items())
    for extra in ({{"reduce": "psum"}}, {{"backend": "fused"}}):
        res = Mirage(MirageConfig(**base, **extra), MESH).fit(graphs)
        RESULT[(db, *extra.values())] = sorted(res.supports.items())
"""


@pytest.mark.parametrize("workers", [2, 4])
def test_conformance_matrix_matches_host_oracle(tmp_path, workers):
    """sharded wire × partition scheme × overlapped candgen, plus the
    psum shuffle and the fused backend (its plain versions here), equal
    ``mine_host`` on every rank at W = 2 and 4 — on the conformance DB
    and on a molecule-like DB that mines to level 4."""
    got, _ = run(tmp_path, ranks=(MATRIX_RANKS, workers))
    oracles = {"conformance": _oracle(),
               "pubchem_like": sorted(
                   (c, i.support) for c, i in mine_host(
                       graphdb.pubchem_like_db(**eval(PUBCHEM)), 5,
                       max_size=4).frequent.items())}
    for res in got:
        assert len(res) == 20
        for key, supports in res.items():
            assert supports == oracles[key[0]], key


RAGGED_RANKS = f"""
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
graphs = random_db(**{CONFORMANCE})
for pipeline, extra in (("legacy", {{}}),
                        ("single_sync", {{"bucket_shapes": False}})):
    cfg = MirageConfig(minsup=5, n_partitions=8, max_size=3,
                       pipeline=pipeline, reduce="reduce_scatter", **extra)
    res = Mirage(cfg, MESH).fit(graphs)
    RESULT[pipeline] = ([s.n_candidates for s in res.stats],
                        sorted(res.supports.items()))
"""


def test_reduce_scatter_ragged_candidate_axis(tmp_path):
    """An odd candidate count at W=2 is padded to the worker count, for
    the legacy pipeline and the unbucketed single-sync level."""
    got, _ = run(tmp_path, ranks=(RAGGED_RANKS, 2))
    oracle = _oracle()
    for res in got:
        for pipeline, (n_cands, supports) in res.items():
            assert any(c % 2 for c in n_cands), (pipeline, n_cands)
            assert supports == oracle, pipeline
