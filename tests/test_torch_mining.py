"""End-to-end: the port's ``Mirage.fit`` on the CPU (plain versions of the
kernels) against the JAX package's ``Mirage.fit`` and the host oracle
``mine_host``; checkpoints resumed across the two packages; the entry
point's device rule; and the port's import boundary."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import graphdb as jgraphdb
from repro.core import mining as jmining
from repro.core.host_miner import mine_host
from repro_torch.core import graphdb as tgraphdb
from repro_torch.core import mining as tmining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DBS = {
    # tests/test_conformance.py::conformance_db
    "conformance": ("random_db", dict(n_graphs=18, n_vertices=6,
                                      extra_edge_prob=0.35, n_vlabels=3,
                                      n_elabels=2, seed=42), 5, 3),
    "paper_toy": ("paper_toy_db", {}, 2, None),
    "pubchem_like": ("pubchem_like_db", dict(n_graphs=20, seed=1,
                                             avg_edges=14.0), 5, 4),
}


def _stats(res):
    return [(s.level, s.n_candidates, s.n_frequent, s.overflow,
             s.escalations, s.retried, s.survivor_cap) for s in res.stats]


@pytest.mark.parametrize("packed", [None, False])
@pytest.mark.parametrize("db", sorted(DBS))
def test_fit_matches_reference_and_host_oracle(db, packed):
    name, kw, minsup, max_size = DBS[db]
    jg, tg = getattr(jgraphdb, name)(**kw), getattr(tgraphdb, name)(**kw)
    cfg = dict(minsup=minsup, max_size=max_size, n_partitions=4,
               packed_support=packed)
    ref = jmining.Mirage(jmining.MirageConfig(**cfg)).fit(jg)
    miner = tmining.Mirage(tmining.MirageConfig(**cfg), device="cpu")
    got = miner.fit(tg)
    oracle = mine_host(jg, minsup, max_size=max_size)
    assert got.supports == {c: i.support for c, i in oracle.frequent.items()}
    assert got.levels == ref.levels
    assert got.supports == ref.supports
    assert (got.minsup, got.total_overflow) == (ref.minsup,
                                                ref.total_overflow)
    assert _stats(got) == _stats(ref)
    assert got.alphabet.canonical() == ref.alphabet.canonical()
    assert miner.auditor is not None and all(r["ok"] for r in
                                             miner.auditor.report)


@pytest.mark.parametrize("bucket", [True, False])
def test_fused_backend_on_cpu_matches_host_oracle(bucket):
    """backend='fused' on CPU tensors runs the kernels' plain versions
    through the whole fused path (schedule, inverse permutation,
    bucketed rows or, unbucketed, stores sliced to the survivors)."""
    graphs = tgraphdb.random_db(24, n_vertices=7, extra_edge_prob=0.3,
                                n_vlabels=3, n_elabels=2, seed=11)
    oracle = mine_host(graphs, 5, max_size=4)
    for packed in (None, False):
        res = tmining.Mirage(tmining.MirageConfig(
            minsup=5, n_partitions=4, max_size=4, backend="fused",
            packed_support=packed, bucket_shapes=bucket),
            device="cpu").fit(graphs)
        assert res.supports == {c: i.support
                                for c, i in oracle.frequent.items()}


@pytest.mark.parametrize("S,free,bucketed,want", [
    (64, 2000, False, 64),      # the store fits: no clamp
    (64, 1000, False, 50),      # unbucketed: the count that fits
    (64, 10, False, 1),         # nothing fits: still one slot
    (256, 2000, True, 64),      # bucketed: largest family member <= 100
    (256, 640, True, 32),       # exactly the family floor fits
    (256, 500, True, 25),       # below the floor: leaves the family
])
def test_memory_survivor_cap(S, free, bucketed, want):
    """The card's survivor-cap clamp (10 bytes per slot, half the free
    memory): S when the store fits, else the most that fits."""
    bk = tmining.BucketSpec(s_floor=32) if bucketed else None
    assert tmining.memory_survivor_cap(S, 10, free, bk) == want


@pytest.mark.parametrize("bucket", [True, False])
def test_memory_clamp_below_survivors_retries_exactly(bucket):
    """A device with no free memory clamps every level's survivor cap to
    one slot, below the true survivor count: each such level takes the
    exact materialize-only retry and the frequent set stays mine_host's."""
    graphs = tgraphdb.random_db(24, n_vertices=7, extra_edge_prob=0.3,
                                n_vlabels=3, n_elabels=2, seed=11)
    oracle = mine_host(graphs, 5, max_size=4)
    cfg = tmining.MirageConfig(minsup=5, n_partitions=4, max_size=4,
                               backend="fused", bucket_shapes=bucket)
    free = tmining.Mirage(cfg, device="cpu").fit(graphs)
    miner = tmining.Mirage(cfg, device="cpu")
    miner._free_device_bytes = lambda: 0
    res = miner.fit(graphs)
    assert res.supports == {c: i.support for c, i in oracle.frequent.items()}
    assert [s.n_frequent for s in res.stats] == [s.n_frequent
                                                  for s in free.stats]
    assert all(s.survivor_cap == 1 for s in res.stats)
    assert all(s.retried == (s.n_frequent > 1) for s in res.stats)
    assert any(s.n_frequent > 1 for s in res.stats)


_CK_DB = dict(n_vertices=8, extra_edge_prob=0.5, n_vlabels=2, n_elabels=1,
              seed=7)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint written by either package at max_size=2 resumes in
    the other to max_size=3, giving the uninterrupted run's frequent
    set."""
    jg = jgraphdb.random_db(20, **_CK_DB)
    tg = tgraphdb.random_db(20, **_CK_DB)
    ck = str(tmp_path / "ck")
    base = dict(minsup=6, n_partitions=4, checkpoint_dir=ck)
    full = jmining.Mirage(jmining.MirageConfig(
        minsup=6, n_partitions=4, max_size=3)).fit(jg)
    if writer == "repro":
        jmining.Mirage(jmining.MirageConfig(max_size=2, **base)).fit(jg)
        res = tmining.Mirage(tmining.MirageConfig(max_size=3, **base),
                             device="cpu").fit(tg, resume=True)
    else:
        tmining.Mirage(tmining.MirageConfig(max_size=2, **base),
                       device="cpu").fit(tg)
        res = jmining.Mirage(jmining.MirageConfig(max_size=3, **base)
                             ).fit(jg, resume=True)
    assert res.stats[0].level == 3, "must resume, not restart"
    assert res.levels == full.levels
    assert res.supports == full.supports


def test_checkpoint_is_the_reference_format(tmp_path):
    from repro.runtime import checkpoint as jckpt
    from repro_torch.runtime import checkpoint as tckpt
    tree = {"pmask": np.ones((4, 8, 33), bool),
            "pol": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "levels": [[np.zeros((2, 5), np.int32)]], "M": 32}
    tckpt.save_step(str(tmp_path), 3, tree, metadata={"kind": "x"})
    got, meta = jckpt.load_step(str(tmp_path))
    assert meta == {"kind": "x", "step": 3}
    np.testing.assert_array_equal(got["pol"], tree["pol"].numpy())
    np.testing.assert_array_equal(got["pmask"], tree["pmask"])
    assert got["M"] == 32
    back, _ = tckpt.load_step(str(tmp_path), 3)
    np.testing.assert_array_equal(back["levels"][0][0], np.zeros((2, 5)))


def test_entry_point_runs_on_the_card_unless_asked_for_cpu():
    cfg = tmining.MirageConfig(minsup=2)
    if torch.cuda.is_available():
        assert tmining.Mirage(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmining.Mirage(cfg)
    assert tmining.Mirage(cfg, device="cpu").backend == "ref"


@pytest.mark.parametrize("kw,item", [
    (dict(pipeline="device_loop", max_size=3), "item 11"),
    (dict(candgen="device"), "item 11"),
])
def test_later_slices_raise(kw, item):
    """The device loop and device candgen (ROADMAP queue A ``item``)
    have landed: they no longer raise, and mine paper-toy equal to
    ``mine_host``.  The JAX package's interpret-mode backends still
    raise: the port runs the kernels' plain versions instead."""
    miner = tmining.Mirage(tmining.MirageConfig(minsup=2, **kw),
                           device="cpu")
    got = miner.fit(tgraphdb.paper_toy_db())
    want = mine_host(jgraphdb.paper_toy_db(), 2, max_size=kw.get("max_size"))
    assert got.supports == {c: i.support for c, i in want.frequent.items()}
    assert (miner.last_device_loop is not None) == ("max_size" in kw), item
    with pytest.raises(ValueError, match="'interpret' is not available"):
        tmining.Mirage(tmining.MirageConfig(minsup=2, backend="interpret"),
                       device="cpu")


def test_cli_mines_on_cpu(tmp_path):
    out = tmp_path / "res.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--dataset",
         "paper-toy", "--minsup", "2", "--partitions", "2", "--device",
         "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr
    assert "frequent patterns: 13" in proc.stdout
    assert out.exists()


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path.insert(0, sys.argv[1])
        sys.path.insert(0, sys.argv[2])
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code, os.path.join(ROOT, "src"), ROOT],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15
