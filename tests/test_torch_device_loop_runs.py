"""The port's device loop against the JAX package's on the CPU, the
runs that need several fits, processes or packages: the escalation
valve, the candgen="device" stepping stone, chunk checkpoints resumed
across the two packages, the CLI, and W = 2 and 4 as gloo ranks against
the JAX package on W simulated devices.  Bit for bit, as in
``tests/test_torch_device_loop.py``, whose helpers and fixtures these
tests share."""
import os
import shutil
import subprocess
import sys

import pytest

from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
from repro_torch.runtime import checkpoint as ckpt
from test_torch_device_loop import (  # noqa: F401 (fixtures)
    DB, DB_KW, ROOT, _assert_same, _cfg, _clean_faults, _one_thread,
    _oracle, _pair, _stats, canon, jx)
from torch_ranks import run


def test_escalation_valve_matches_reference(jx):
    """Run-granular M escalation: overflow at the chunk boundary doubles
    the uniform M and reruns; the result matches the JAX package and the
    exact host miner."""
    dense = dict(n_graphs=8, n_vertices=8, extra_edge_prob=0.9,
                 n_vlabels=1, n_elabels=1, seed=7)
    tm, tres, jm, jres = _pair(jx, graphs_kw=dense, minsup=4, max_size=3,
                               max_embeddings=2, max_embeddings_limit=4096)
    _assert_same(tm, tres, jm, jres)
    assert tm.last_device_loop["completed"]
    assert tm.last_device_loop["escalations"] > 0
    assert tres.total_overflow == 0
    assert sorted(tres.supports.items()) == _oracle(random_db(**dense), 4, 3)


@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
def test_candgen_device_stepping_stone(jx, canon, pipeline):
    """candgen="device" swaps the per-level host generator for the
    device generator inside the host-driven pipelines."""
    kw = dict(pipeline=pipeline, candgen="device")
    tm, tres, jm, jres = _pair(jx, **kw)
    assert tres.levels == jres.levels and tres.supports == jres.supports
    assert [s[:4] for s in _stats(tres)] == [s[:4] for s in _stats(jres)]
    assert sorted(tres.supports.items()) == canon
    assert tm.last_device_loop is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunk_checkpoints_resume_across_packages(jx, canon, tmp_path,
                                                  writer):
    """A ``device_loop_ckpt_every=1`` run checkpoints at every chunk in
    one package; everything past level 2 is lost; the other package
    resumes the device loop mid-run and ends equal to ``mine_host``."""
    ckdir = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_dir=ckdir, device_loop_ckpt_every=1)
    if writer == "port":
        m = Mirage(MirageConfig(**cfg), device="cpu")
        m.fit(DB)
    else:
        m = jx.mining.Mirage(jx.mining.MirageConfig(**cfg))
        m.fit(jx.graphdb.random_db(**DB_KW))
    assert m.last_device_loop["chunks"] == 3
    for s in ckpt.all_steps(ckdir):
        if s > 2:
            shutil.rmtree(os.path.join(ckdir, f"step_{s:010d}"))
    if writer == "port":
        r = jx.mining.Mirage(jx.mining.MirageConfig(**cfg))
        res = r.fit(jx.graphdb.random_db(**DB_KW), resume=True)
    else:
        r = Mirage(MirageConfig(**cfg), device="cpu")
        res = r.fit(DB, resume=True)
    assert r.last_device_loop["completed"]
    assert r.last_device_loop["chunks"] == 2
    assert sorted(res.supports.items()) == canon
    assert res.stats[0].level == 3


def test_cli_mines_the_device_loop_on_cpu():
    """``--pipeline device_loop`` and ``--candgen device`` on paper-toy."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    for extra, says in (
            (["--pipeline", "device_loop", "--max-size", "4"],
             "[mine] device_loop: completed=True chunks=1 escalations=0"),
            (["--candgen", "device"], "pipeline=single_sync")):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.mine", "--dataset",
             "paper-toy", "--minsup", "2", "--partitions", "2", "--device",
             "cpu", *extra], capture_output=True, text=True, timeout=240,
            env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "[mine] frequent patterns: 13" in out.stdout
        assert says in out.stdout


# ---------------------------------------------------------------------------
# several ranks (gloo processes on the CPU) against the JAX package's
# W-device mesh
# ---------------------------------------------------------------------------

RANKS = """
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
graphs = random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                   n_elabels=2, seed=42)
m = Mirage(MirageConfig(minsup=3, n_partitions=4, max_size=4,
                        backend=ARGS[0], pipeline="device_loop"), MESH)
res = m.fit(graphs)
RESULT["levels"] = res.levels
RESULT["supports"] = sorted(res.supports.items())
RESULT["stats"] = [(s.level, s.n_candidates, s.n_frequent, s.overflow,
                    s.survivor_cap, s.imbalance) for s in res.stats]
RESULT["info"] = m.last_device_loop
"""

JAX_RANKS = """
from repro.core.graphdb import random_db
from repro.core.mapreduce import MiningMesh
from repro.core.mining import Mirage, MirageConfig
from repro.runtime import jax_compat
W = len(jax.devices())
graphs = random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                   n_elabels=2, seed=42)
m = Mirage(MirageConfig(minsup=3, n_partitions=4, max_size=4,
                        backend=ARGS[0], pipeline="device_loop"),
           MiningMesh(jax_compat.make_mesh((W,), ("w",))))
res = m.fit(graphs)
RESULT["levels"] = res.levels
RESULT["supports"] = sorted(res.supports.items())
RESULT["stats"] = [(s.level, s.n_candidates, s.n_frequent, s.overflow,
                    s.survivor_cap, s.imbalance) for s in res.stats]
RESULT["info"] = m.last_device_loop
"""


@pytest.mark.parametrize("world", [2, 4])
def test_device_loop_on_several_ranks_matches_reference(tmp_path, canon,
                                                        world):
    """W gloo ranks, each a block of the 4 partitions: every rank builds
    the same replicated run outputs (supports gathered, overflow
    all-reduced, costs all-gathered), equal to the JAX package on W
    devices and to ``mine_host``."""
    ranks, ref = run(tmp_path, ranks=(RANKS, world),
                     jax=(JAX_RANKS, world), args=["ref"], timeout=300)
    assert ref["info"]["completed"]
    assert ref["supports"] == canon
    for got in ranks:
        assert got == ref


