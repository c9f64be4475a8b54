"""The straggler rebalance and elastic resume of the port's multi-worker
miner, against the JAX package on a 2-device mesh and the host oracle.

The port's W workers are W processes of a gloo group on the CPU
(``torch_ranks.run``).  On a skewed database the rebalance must fire, at
the same levels and with the same imbalance as in the JAX package, and
change no result.  Checkpoints hold the canonical store: one written at
W=1 (by either package) resumes at W=2, and one written at W=2 after a
rebalance equals the W=1 run's and resumes at W=1.
"""
import numpy as np
import pytest

from repro.core import graphdb as jgraphdb
from repro.core import mining as jmining
from repro.core.host_miner import mine_host
from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import mining as tmining
from repro_torch.runtime import checkpoint as tckpt
from torch_ranks import run

# tests/test_elastic.py::SKEW_SNIPPET: scheme 1 deals every heavy graph
# to partition 0, overloading worker 0 under the blocked assignment
SKEW = """
def skewed_db(random_db):
    heavy = iter(random_db(6, n_vertices=9, extra_edge_prob=0.6,
                           n_vlabels=2, n_elabels=1, seed=1))
    light = iter(random_db(18, n_vertices=3, extra_edge_prob=0.2,
                           n_vlabels=2, n_elabels=1, seed=2))
    return [next(heavy) if i % 4 == 0 else next(light) for i in range(24)]
PIPELINE = ARGS[0]
BASE = dict(minsup=6, n_partitions=4, scheme=1, max_size=3,
            pipeline=PIPELINE)
CONFIGS = {"rebalance": dict(rebalance=True, rebalance_threshold=1.1),
           "off": dict(rebalance=False)}
if PIPELINE == "single_sync":
    # small bucket floors: padding must not leak into the cost signal
    CONFIGS["small-buckets"] = dict(
        rebalance=True, rebalance_threshold=1.1, bucket_c_floor=8,
        bucket_s_floor=4, bucket_k_floor=4)
"""

SKEW_JAX = SKEW + """
from repro.core.graphdb import random_db
from repro.core.mapreduce import MiningMesh
from repro.core.mining import Mirage, MirageConfig
from repro.runtime import jax_compat
mesh = MiningMesh(jax_compat.make_mesh((2,), ("w",)))
for name, extra in CONFIGS.items():
    res = Mirage(MirageConfig(**BASE, **extra), mesh).fit(
        skewed_db(random_db))
    RESULT[name] = ([(s.rebalanced, s.imbalance) for s in res.stats],
                    sorted(res.supports.items()))
"""

SKEW_RANKS = SKEW + """
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
for name, extra in CONFIGS.items():
    res = Mirage(MirageConfig(**BASE, **extra), MESH).fit(
        skewed_db(random_db))
    RESULT[name] = ([(s.rebalanced, s.imbalance) for s in res.stats],
                    sorted(res.supports.items()))
"""


@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
def test_skewed_db_rebalance_matches_jax(tmp_path, pipeline):
    """A rebalance fires; each level's (rebalanced, imbalance) equals the
    JAX run's on a 2-device mesh; the results equal the run without
    rebalance and ``mine_host``."""
    got, want = run(tmp_path, ranks=(SKEW_RANKS, 2), jax=(SKEW_JAX, 2),
                    args=[pipeline])
    ns = {"ARGS": [pipeline]}
    exec(SKEW, ns)
    graphs = ns["skewed_db"](jgraphdb.random_db)
    oracle = sorted((c, i.support) for c, i in
                    mine_host(graphs, 6, max_size=3).frequent.items())
    assert len(want) == (3 if pipeline == "single_sync" else 2)
    for res in got:
        assert res == want
        assert res["off"][1] == oracle
        for name, (stats, supports) in res.items():
            assert supports == oracle, name
            assert any(r for r, _ in stats) == (name != "off"), (name, stats)


# a molecule-like DB that mines to level 4 (tests/test_torch_mining.py's)
_DB = dict(n_graphs=20, seed=1, avg_edges=14.0)
_CFG = dict(minsup=5, n_partitions=4)

RESUME_RANKS = """
from repro_torch.core.graphdb import pubchem_like_db
from repro_torch.core.mining import Mirage, MirageConfig
cfg = MirageConfig(minsup=5, n_partitions=4, max_size=4,
                   checkpoint_dir=ARGS[0])
res = Mirage(cfg, MESH).fit(
    pubchem_like_db(n_graphs=20, seed=1, avg_edges=14.0), resume=True)
RESULT["levels"] = [s.level for s in res.stats]
RESULT["supports"] = sorted(res.supports.items())
"""


def _oracle():
    return sorted((c, i.support) for c, i in mine_host(
        jgraphdb.pubchem_like_db(**_DB), 5, max_size=4).frequent.items())


@pytest.mark.parametrize("writer", ["repro_torch", "repro"])
def test_resume_at_two_workers_from_one(tmp_path, writer):
    """A checkpoint written at W=1 by either package, after level 2,
    resumes at W=2 (each rank takes its block of the canonical store)
    and gives ``mine_host``'s result."""
    ck = str(tmp_path / "ck")
    if writer == "repro":
        jmining.Mirage(jmining.MirageConfig(
            max_size=2, checkpoint_dir=ck, **_CFG)).fit(
                jgraphdb.pubchem_like_db(**_DB))
    else:
        tmining.Mirage(tmining.MirageConfig(
            max_size=2, checkpoint_dir=ck, **_CFG), device="cpu").fit(
                tgraphdb.pubchem_like_db(**_DB))
    got, _ = run(tmp_path, ranks=(RESUME_RANKS, 2), args=[ck])
    for res in got:
        assert res["levels"][0] == 3, "must resume, not restart"
        assert res["supports"] == _oracle()


SAVE_RANKS = """
from repro_torch.core.graphdb import pubchem_like_db
from repro_torch.core.mining import Mirage, MirageConfig
cfg = MirageConfig(minsup=5, n_partitions=4, max_size=3,
                   rebalance_threshold=1.0, checkpoint_dir=ARGS[0])
res = Mirage(cfg, MESH).fit(
    pubchem_like_db(n_graphs=20, seed=1, avg_edges=14.0))
RESULT["rebalanced"] = [s.rebalanced for s in res.stats]
"""


def test_checkpoint_after_rebalance_is_canonical(tmp_path):
    """At W=2 a rebalance permutes the partitions before each save; the
    checkpoints still hold the canonical store, equal to the W=1 run's,
    and resume at W=1 to ``mine_host``'s result."""
    ck2, ck1 = str(tmp_path / "ck2"), str(tmp_path / "ck1")
    got, _ = run(tmp_path, ranks=(SAVE_RANKS, 2), args=[ck2])
    assert got[0]["rebalanced"] == got[1]["rebalanced"]
    assert got[0]["rebalanced"][0], got[0]["rebalanced"]
    tmining.Mirage(tmining.MirageConfig(
        max_size=3, checkpoint_dir=ck1, **_CFG), device="cpu").fit(
            tgraphdb.pubchem_like_db(**_DB))
    assert tckpt.all_steps(ck2) == tckpt.all_steps(ck1) == [2, 3]
    for step in (2, 3):
        two, _ = tckpt.load_step(ck2, step)
        one, _ = tckpt.load_step(ck1, step)
        for key in ("pol", "pmask", "support_vals", "max_embeddings"):
            np.testing.assert_array_equal(two[key], one[key])
    res = tmining.Mirage(tmining.MirageConfig(
        max_size=4, checkpoint_dir=ck2, **_CFG), device="cpu").fit(
            tgraphdb.pubchem_like_db(**_DB), resume=True)
    assert res.stats[0].level == 4
    assert sorted(res.supports.items()) == _oracle()
