"""Faults of the port repaired before the robustness layer (ROADMAP queue
C): C1, ``max_occ`` pads the edge occurrence lists and never truncates
them; C3, an exact retry whose survivors' store does not fit the device
raises ``DeviceMemoryError`` before it allocates anything.  (C2, the
join kernels' triple limit, is pinned in ``test_torch_fused_level.py``.)
Both held against the JAX package's host oracle ``mine_host``."""
import pytest

from repro.core import graphdb as jgraphdb
from repro.core.host_miner import mine_host
from repro_torch.core import embedding as temb
from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import mining as tmining
from repro_torch.runtime.errors import DeviceMemoryError
from torch_ranks import run

# ROADMAP queue C, C1: the reference truncates here and finds 4 of the 7
C1_DB = dict(n_graphs=24, seed=3, avg_edges=12.0)
C1_CFG = dict(minsup=0.3, max_size=4, n_partitions=4)


@pytest.fixture(scope="module")
def c1_oracle():
    graphs = jgraphdb.pubchem_like_db(**C1_DB)
    return {c: i.support for c, i in
            mine_host(graphs, 8, max_size=4).frequent.items()}


@pytest.mark.parametrize("max_occ", [1, 2, 4, None])
def test_max_occ_pads_and_never_truncates(c1_oracle, max_occ):
    graphs = tgraphdb.pubchem_like_db(**C1_DB)
    res = tmining.Mirage(tmining.MirageConfig(**C1_CFG, max_occ=max_occ),
                         device="cpu").fit(graphs)
    assert res.minsup == 8
    assert len(c1_oracle) == 7
    assert res.supports == c1_oracle
    assert res.total_overflow == 0


def test_edge_ol_width_is_at_least_max_occ():
    graphs = tgraphdb.pubchem_like_db(**C1_DB)[:6]
    triples = sorted({(int(g.vlabels[u]), int(e), int(g.vlabels[v]))
                      for g in graphs for (u, v), e in zip(g.edges,
                                                           g.elabels)})
    triples = sorted(set(triples) | {(b, e, a) for a, e, b in triples})
    base = temb.build_edge_ol(graphs, triples)
    true_f = base.src.shape[-1]
    assert true_f > 2
    for max_occ in (1, 2, true_f, true_f + 5):
        eol = temb.build_edge_ol(graphs, triples, max_occ=max_occ)
        assert eol.src.shape[-1] == max(max_occ, true_f)
        assert (eol.mask.sum(-1) == base.mask.sum(-1)).all()


# ---------------------------------------------------------------------------
# C3
# ---------------------------------------------------------------------------

C3_DB = dict(n_graphs=24, n_vertices=7, extra_edge_prob=0.3, n_vlabels=3,
             n_elabels=2, seed=11)


def _miner(monkeypatch, free, **kw):
    """A miner on the CPU whose device reports ``free`` bytes: the
    survivor cap clamps to one slot (as on a card with no free memory)
    and the exact retry holds its store against ``free``; every store
    built is counted."""
    built = []
    orig = tmining.map_materialize
    monkeypatch.setattr(tmining, "map_materialize",
                        lambda *a, **k: built.append(1) or orig(*a, **k))
    cfg = tmining.MirageConfig(minsup=5, n_partitions=4, max_size=4,
                               backend="fused", **kw)
    miner = tmining.Mirage(cfg, device="cpu")
    miner._free_device_bytes = lambda: 0
    miner._retry_free_bytes = lambda: free
    return miner, built


@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
def test_retry_that_does_not_fit_raises_before_it_allocates(monkeypatch,
                                                           pipeline):
    graphs = tgraphdb.random_db(**C3_DB)
    miner, built = _miner(monkeypatch, 4096, pipeline=pipeline)
    with pytest.raises(DeviceMemoryError) as ei:
        miner.fit(graphs)
    err = ei.value
    assert err.level == 2 and err.survivors > 1
    assert err.need_bytes > err.free_bytes == 4096
    assert built == []                  # no store was built for it
    assert f"{err.survivors} survivors" in str(err)


def test_retry_that_fits_stays_exact(monkeypatch):
    graphs = tgraphdb.random_db(**C3_DB)
    miner, built = _miner(monkeypatch, 1 << 40)
    res = miner.fit(graphs)
    want = mine_host(jgraphdb.random_db(**C3_DB), 5, max_size=4)
    assert res.supports == {c: i.support for c, i in want.frequent.items()}
    assert all(s.retried == (s.n_frequent > 1) for s in res.stats)
    assert built


def test_retry_free_bytes_is_device_memory_only():
    """On the CPU stores take host memory: nothing to hold them against,
    whatever the survivor cap's clamp was told."""
    miner = tmining.Mirage(tmining.MirageConfig(minsup=5), device="cpu")
    miner._free_device_bytes = lambda: 0
    assert miner._retry_free_bytes() is None


C3_RANKS = """
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
from repro_torch.runtime.errors import DeviceMemoryError
# the survivor cap clamps to one slot on both ranks; only rank 0 is short
# of memory for the exact retry's store
Mirage._free_device_bytes = lambda self: 0
Mirage._retry_free_bytes = lambda self: 4096 if RANK == 0 else 1 << 40
graphs = random_db(24, n_vertices=7, extra_edge_prob=0.3, n_vlabels=3,
                   n_elabels=2, seed=11)
for pipeline in ("single_sync", "legacy"):
    try:
        Mirage(MirageConfig(minsup=5, n_partitions=4, max_size=4,
                            pipeline=pipeline), MESH).fit(graphs)
        RESULT[pipeline] = None
    except DeviceMemoryError as exc:
        RESULT[pipeline] = (exc.level, exc.free_bytes)
"""


def test_retry_memory_error_is_agreed_over_the_ranks(tmp_path):
    """At W=2 only rank 0's share of the device is too small for the
    exact retry's store: both ranks raise ``DeviceMemoryError`` at the
    same level, neither left waiting in a collective."""
    ranks, _ = run(tmp_path, ranks=(C3_RANKS, 2), timeout=180)
    for pipeline in ("single_sync", "legacy"):
        assert [r[pipeline] for r in ranks] == [(2, 4096), (2, 1 << 40)]
