"""Chaos differential suite of the port (DESIGN.md §10, §14), on the
CPU with the plain versions of the kernels: under every scheduled fault
— worker loss at each level, wire bit-flips, cap-miss storms, kernel
faults down the degradation ladder, corrupted checkpoints, seeded random
schedules, stalls caught by the watchdog — supervised mining completes
with the frequent set of the JAX package's host oracle ``mine_host``,
bit for bit, or, when a deadline or the retry budget runs out, returns a
verified prefix of it.  The schedules are ``tests/test_chaos.py``'s,
the device-loop pipeline's included (a run-wire bit-flip storm, kernel
faults and a stalled chunk, which descend its extra ``single_sync``
rung), minus those of donation re-arming, which has no subject in the
port (eager PyTorch never consumes the parent store).  Several ranks
run as gloo processes (``torch_ranks.run``): the W=2→1 and W=4→2
shrinks (and the device loop's W=2→1), and a stall and a run deadline
at W=2, which end on both ranks with no blocked collective."""
import os

import pytest

from repro.core import graphdb as jgraphdb
from repro.core.host_miner import mine_host
from repro_torch.core import level_step as tlevel_step
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig, PartialResult
from repro_torch.core.supervisor import (DEVICE_LOOP_LADDER, LADDER,
                                         MiningSupervisor, SupervisorConfig,
                                         ladder_for)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import faults
from repro_torch.runtime.watchdog import Watchdog
from torch_ranks import run

# tests/test_chaos.py's DB: levels of 3, 5, 10 and 5 frequent patterns
MINSUP, MAX_SIZE, NPARTS = 5, 5, 2
DB_KW = dict(seed=5, n_vertices=9, n_vlabels=2, n_elabels=1)
DB = random_db(10, **DB_KW)
REF = mine_host(jgraphdb.random_db(10, **DB_KW), MINSUP, max_size=MAX_SIZE)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    faults.reset_log()
    yield
    faults.clear()
    faults.reset_log()


def _cfg(**kw):
    kw.setdefault("max_size", MAX_SIZE)
    return MirageConfig(minsup=MINSUP, n_partitions=NPARTS, **kw)


def assert_parity(res):
    """The chaos contract: bit-identical to the fault-free host oracle."""
    assert [set(l) for l in res.levels] == [set(l) for l in REF.levels]
    assert res.supports == {c: i.support for c, i in REF.frequent.items()}


def assert_verified_prefix(res):
    """The anytime contract: a PartialResult is a verified prefix of the
    fault-free host oracle, supports included."""
    assert isinstance(res, PartialResult) and not res.complete
    n = len(res.levels)
    assert n <= len(REF.levels)
    assert [set(l) for l in res.levels] == [set(l) for l in REF.levels[:n]]
    for code, sup in res.supports.items():
        assert sup == REF.frequent[tuple(code)].support


def _supervised(schedule_text, *, ckpt_dir=None, max_retries=8,
                degrade_after=2, watchdog=None, on_exhausted="raise",
                **cfg_kw):
    faults.install(faults.FaultSchedule.parse(schedule_text))
    sup = MiningSupervisor(
        _cfg(checkpoint_dir=ckpt_dir, **cfg_kw),
        SupervisorConfig(max_retries=max_retries,
                         degrade_after=degrade_after,
                         on_exhausted=on_exhausted,
                         sleep_fn=lambda s: None),
        watchdog=watchdog, device="cpu")
    return sup.mine(DB), sup


def test_the_db_has_four_levels():
    assert [len(l) for l in REF.levels] == [3, 5, 10, 5]


# ---------------------------------------------------------------------------
# worker loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
@pytest.mark.parametrize("level", [2, 3, 4])
def test_worker_loss_at_each_level_replays_at_most_one_level(
        tmp_path, level, pipeline):
    res, sup = _supervised(f"worker_loss@{level}", pipeline=pipeline,
                           ckpt_dir=str(tmp_path / "ck"))
    assert_parity(res)
    assert [(e.kind, e.level) for e in sup.events] == [("worker_loss",
                                                         level)]
    if level > 2:                       # level 2 has no checkpoint yet
        assert res.stats[0].level == level


def test_worker_loss_without_checkpoints_restarts_clean():
    res, sup = _supervised("worker_loss@3")
    assert_parity(res)
    assert [e.kind for e in sup.events] == ["worker_loss"]
    assert res.stats[0].level == 2


# ---------------------------------------------------------------------------
# wire integrity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "fused", "pallas"])
def test_wire_bitflip_recovers_via_refetch_in_run(monkeypatch, backend):
    """A flipped bit on the host copy of the wire is caught by the
    checksum and healed by ONE re-fetch, no supervisor involved; every
    clean level still copies its wire once."""
    copies = []
    orig = tlevel_step._copy_to_host
    monkeypatch.setattr(tlevel_step, "_copy_to_host",
                        lambda w: copies.append(1) or orig(w))
    faults.install(faults.FaultSchedule.parse("wire_bitflip@3:bit=19"))
    res = Mirage(_cfg(backend=backend), device="cpu").fit(DB)
    assert_parity(res)
    assert [e["kind"] for e in faults.injection_log()] == ["wire_bitflip"]
    assert len(copies) == len(res.stats) + 1


def test_wire_bitflip_storm_escalates_to_supervisor():
    """Corruption on every fetch attempt exhausts the re-fetch budget,
    surfaces as a transient fault, and the supervisor's retry wins."""
    res, sup = _supervised("wire_bitflip@3*3")
    assert_parity(res)
    assert [e.kind for e in sup.events] == ["transient"]
    assert len(faults.injection_log()) == 3


# ---------------------------------------------------------------------------
# survivor-cap storm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [True, False])
def test_cap_miss_storm_stays_exact_in_run(bucket):
    """A forced cap of 1 at every mid level drives each through the
    materialize-only retry path — supports must not move."""
    faults.install(faults.FaultSchedule.parse(
        "cap_storm@2;cap_storm@3;cap_storm@4"))
    res = Mirage(_cfg(bucket_shapes=bucket), device="cpu").fit(DB)
    assert_parity(res)
    assert [e["kind"] for e in faults.injection_log()] == ["cap_storm"] * 3
    assert [s.retried for s in res.stats[:3]] == [True] * 3
    assert [s.survivor_cap for s in res.stats[:3]] == [1] * 3


# ---------------------------------------------------------------------------
# kernel faults → degradation ladder
# ---------------------------------------------------------------------------

def test_kernel_fault_descends_degradation_ladder(tmp_path):
    """Repeated kernel faults walk fused → pallas → legacy; the legacy
    pipeline dispatches no level program at all, so it is immune to the
    remaining scheduled faults and completes."""
    res, sup = _supervised("kernel_fault@2*6", backend="fused",
                           ckpt_dir=str(tmp_path / "ck"))
    assert_parity(res)
    assert sup.rung == 2
    assert [e.action for e in sup.events] == [
        "retry", "degrade", "retry", "degrade"]
    assert all(e.kind == "kernel" for e in sup.events)
    assert "rung 1 (pallas)" in sup.events[1].detail
    assert (sup.last_miner.cfg.pipeline, sup.last_miner.backend) == (
        "legacy", "ref")


def test_one_kernel_fault_with_degrade_after_one_runs_two_launch():
    """The chip smoke test's schedule on the CPU: one kernel fault at
    level 3 descends at once to the two-launch backend, which restarts
    clean and ends exact, with level 4's flipped wire healed in the
    run."""
    res, sup = _supervised("kernel_fault@3;wire_bitflip@4",
                           backend="fused", degrade_after=1)
    assert_parity(res)
    assert [(e.kind, e.action, e.level) for e in sup.events] == [
        ("kernel", "degrade", 3)]
    assert sup.last_miner.backend == "pallas"
    assert [e["kind"] for e in faults.injection_log()] == [
        "kernel_fault", "wire_bitflip"]


# ---------------------------------------------------------------------------
# checkpoint corruption
# ---------------------------------------------------------------------------

def test_corrupted_latest_checkpoint_falls_back_on_resume(tmp_path):
    root = str(tmp_path / "ck")
    faults.install(faults.FaultSchedule.parse(
        "ckpt_corrupt@3:mode=truncate"))
    Mirage(_cfg(max_size=3, checkpoint_dir=root), device="cpu").fit(DB)
    faults.clear()
    assert ckpt.all_steps(root) == [2, 3]          # 3 is silently rotten
    res = Mirage(_cfg(checkpoint_dir=root), device="cpu").fit(
        DB, resume=True)
    assert_parity(res)
    assert res.stats[0].level == 3
    assert ckpt.all_steps(root)[-1] == 4


def test_all_checkpoints_corrupt_restarts_clean(tmp_path):
    root = str(tmp_path / "ck")
    Mirage(_cfg(max_size=3, checkpoint_dir=root), device="cpu").fit(DB)
    for step in ckpt.all_steps(root):
        faults.damage_checkpoint(
            os.path.join(root, f"step_{step:010d}"), "flip")
    res = Mirage(_cfg(checkpoint_dir=root), device="cpu").fit(
        DB, resume=True)
    assert_parity(res)
    assert res.stats[0].level == 2


def test_supervised_run_heals_a_scheduled_corrupt_checkpoint(tmp_path):
    """A step corrupted as it is written, then a worker loss: the retry
    reaps the rotten step and resumes from the intact one before it."""
    res, sup = _supervised("ckpt_corrupt@3:mode=flip;worker_loss@4",
                           ckpt_dir=str(tmp_path / "ck"))
    assert_parity(res)
    assert [e.kind for e in sup.events] == ["worker_loss"]
    assert res.stats[0].level == 3


# ---------------------------------------------------------------------------
# random mixed schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_schedule_fixed_seeds(tmp_path, seed):
    schedule = faults.FaultSchedule.random(seed, max_level=4, n_faults=2)
    with faults.active(schedule):
        sup = MiningSupervisor(
            _cfg(checkpoint_dir=str(tmp_path / "ck")),
            SupervisorConfig(max_retries=10, degrade_after=2,
                             sleep_fn=lambda s: None), device="cpu")
        res = sup.mine(DB)
    assert_parity(res)


# ---------------------------------------------------------------------------
# stalls (hang) and the anytime contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["single_sync", "legacy"])
def test_hang_replays_from_checkpoint(tmp_path, pipeline):
    """A stalled dispatch trips the armed phase deadline; the supervisor
    replays from the newest checkpoint — no ladder descent."""
    res, sup = _supervised("hang@3:secs=999", pipeline=pipeline,
                           ckpt_dir=str(tmp_path / "ck"),
                           watchdog=Watchdog(phase_default=0.5))
    assert_parity(res)
    assert sup.rung == 0
    assert [(e.kind, e.action) for e in sup.events] == [("hang", "retry")]
    assert res.stats[0].level == 3


# ---------------------------------------------------------------------------
# the device-loop pipeline under the same fault kinds, pinned to the
# oracle through its device_loop→single_sync supervisor rung
# ---------------------------------------------------------------------------

def _dl(**kw):
    kw.setdefault("pipeline", "device_loop")
    kw.setdefault("device_loop_ckpt_every", 1)
    return kw


def test_device_loop_ladder_has_the_single_sync_rung():
    assert ladder_for(_cfg(pipeline="device_loop")) == DEVICE_LOOP_LADDER
    assert ladder_for(_cfg()) == LADDER
    assert DEVICE_LOOP_LADDER[1] == "single_sync"


def test_device_loop_run_wire_bitflip_storm_retries(tmp_path):
    """Corruption on all 3 fetch attempts of one chunk's run wire
    surfaces as a transient fault; the supervisor's retry resumes from
    the chunk-boundary checkpoint and ends bit-identical."""
    res, sup = _supervised("wire_bitflip@3*3",
                           ckpt_dir=str(tmp_path / "ck"), **_dl())
    assert_parity(res)
    assert [e.kind for e in sup.events] == ["transient"]
    assert len(faults.injection_log()) == 3


def test_device_loop_kernel_fault_descends_to_single_sync(tmp_path):
    """Repeated kernel faults inside the run window walk the EXTRA
    device-loop rung first: abandon the whole-run loop for the
    per-level single-sync program."""
    res, sup = _supervised("kernel_fault@3*2",
                           ckpt_dir=str(tmp_path / "ck"), **_dl())
    assert_parity(res)
    assert sup.rung == 1                        # single_sync rung
    assert [(e.kind, e.action) for e in sup.events] == [
        ("kernel", "retry"), ("kernel", "degrade")]
    assert "single_sync" in sup.events[-1].detail
    assert sup.last_miner.cfg.pipeline == "single_sync"


def test_device_loop_kernel_faults_walk_the_whole_ladder(tmp_path):
    """Enough kernel faults walk device_loop → single_sync → pallas."""
    res, sup = _supervised("kernel_fault@2*4", backend="fused",
                           ckpt_dir=str(tmp_path / "ck"), **_dl())
    assert_parity(res)
    rungs = [e.detail for e in sup.events if e.action == "degrade"]
    assert "single_sync" in rungs[0] and "pallas" in rungs[1]
    assert (sup.last_miner.cfg.pipeline, sup.last_miner.backend) == (
        "single_sync", "pallas")


def test_device_loop_stalled_chunk_degrades_to_single_sync(tmp_path):
    """An injected mid-chunk stall trips the armed phase deadline; the
    hang forfeits the whole-run loop for the per-level program, which
    bounds any future stall to one level — and stays exact."""
    res, sup = _supervised(
        "hang@3:secs=999", ckpt_dir=str(tmp_path / "ck"),
        watchdog=Watchdog(phase_default=2.0), **_dl())
    assert_parity(res)
    assert sup.rung >= 1
    assert [(e.kind, e.action) for e in sup.events] == [
        ("hang", "degrade")]
    assert sup.watchdog.trips                   # detection was the trip


def test_unwatched_stall_rides_out():
    faults.install(faults.FaultSchedule.parse("hang@3:secs=0.05"))
    res = Mirage(_cfg(), device="cpu").fit(DB)
    assert_parity(res)
    assert [e["kind"] for e in faults.injection_log()] == ["hang"]


def test_deadline_cuts_partial_at_newest_audited_checkpoint(tmp_path):
    root = str(tmp_path / "ck")
    Mirage(_cfg(checkpoint_dir=root), device="cpu").fit(DB)
    sup = MiningSupervisor(
        _cfg(checkpoint_dir=root),
        SupervisorConfig(on_exhausted="partial", sleep_fn=lambda s: None),
        device="cpu")
    res = sup.mine(DB, deadline_s=1e-6)
    assert_verified_prefix(res)
    assert res.reason == "deadline" and res.audited
    assert res.last_level == 4 and len(res.levels) == 4
    assert [e.kind for e in sup.events] == ["deadline"]


def test_deadline_inside_the_run_stops_at_a_loop_head():
    """Without checkpoints, a run deadline that passes mid-run raises at
    the next loop head; the partial result is the empty prefix."""
    wd = Watchdog(run_deadline_s=0.3)
    faults.install(faults.FaultSchedule.parse("hang@3:secs=0.5"))
    sup = MiningSupervisor(
        _cfg(), SupervisorConfig(on_exhausted="partial",
                                 sleep_fn=lambda s: None),
        watchdog=wd, device="cpu")
    res = sup.mine(DB)
    assert_verified_prefix(res)
    assert res.levels == [] and not res.audited
    assert [e.kind for e in sup.events] in (["deadline"],
                                            ["hang", "deadline"])


def test_budget_exhaustion_returns_audited_prefix(tmp_path):
    res, sup = _supervised("worker_loss@4*99",
                           ckpt_dir=str(tmp_path / "ck"),
                           max_retries=2, on_exhausted="partial")
    assert_verified_prefix(res)
    assert res.reason == "budget-exhausted" and res.audited
    assert res.last_level == 3 and len(res.levels) == 3
    assert sup.events[-1].action == "partial"
    assert res.events


def test_budget_exhaustion_without_checkpoints_is_empty_prefix():
    res, _ = _supervised("worker_loss@2*99", max_retries=1,
                         on_exhausted="partial")
    assert_verified_prefix(res)
    assert res.levels == [] and res.last_level == 0
    assert not res.audited


def test_deadline_exhaustion_raises_by_default(tmp_path):
    root = str(tmp_path / "ck")
    Mirage(_cfg(checkpoint_dir=root), device="cpu").fit(DB)
    sup = MiningSupervisor(_cfg(checkpoint_dir=root),
                           SupervisorConfig(sleep_fn=lambda s: None),
                           device="cpu")
    with pytest.raises(faults.DeadlineExceeded):
        sup.mine(DB, deadline_s=1e-6)


def test_cli_mines_supervised_on_cpu(tmp_path):
    import subprocess
    import sys
    log = tmp_path / "faults.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--dataset",
         "pubchem-like", "--n-graphs", "10", "--minsup", "4",
         "--partitions", "2", "--max-size", "5", "--seed", "5",
         "--device", "cpu", "--fault-schedule",
         "kernel_fault@3*2;wire_bitflip@4", "--fault-log", str(log)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "degrade" in out.stdout and "backend=pallas" in out.stdout
    assert "[mine] frequent patterns: 9" in out.stdout
    lines = log.read_text().splitlines()
    assert '"outcome": "complete"' in lines[-1]


# ---------------------------------------------------------------------------
# several ranks (gloo processes on the CPU)
# ---------------------------------------------------------------------------

RANK_PROLOGUE = """
from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig, PartialResult
from repro_torch.core.supervisor import MiningSupervisor, SupervisorConfig
from repro_torch.runtime import faults
from repro_torch.runtime.watchdog import Watchdog
graphs = random_db(10, seed=5, n_vertices=9, n_vlabels=2, n_elabels=1)
CK = ARGS[0]
"""

SHRINK = RANK_PROLOGUE + """
faults.install(faults.FaultSchedule.parse("worker_loss@3"))
sup = MiningSupervisor(
    MirageConfig(minsup=5, n_partitions=4, max_size=5, checkpoint_dir=CK),
    SupervisorConfig(sleep_fn=lambda s: None), mesh=MESH)
res = sup.mine(graphs)
RESULT["events"] = [(e.kind, e.action, e.level) for e in sup.events]
RESULT["workers"] = sup.mesh.n_workers
if res is not None:
    RESULT["supports"] = sorted(res.supports.items())
    RESULT["first_level"] = res.stats[0].level
"""


def _oracle(minsup=5, max_size=5):
    return sorted((c, i.support) for c, i in mine_host(
        jgraphdb.random_db(10, **DB_KW), minsup,
        max_size=max_size).frequent.items())


@pytest.mark.parametrize("world", [2, 4])
def test_worker_loss_on_several_ranks_shrinks(tmp_path, world):
    """``worker_loss@3`` at W ranks: every rank raises before any
    collective of level 3; the ranks left out of the largest smaller
    pool (W/2, a divisor of the 4 partitions) retire — ``mine`` returns
    None there — and the others resume from the level-2 checkpoint, at
    W=1 on a single-device mesh, at W=2 in a subgroup of the survivors,
    equal to ``mine_host``."""
    ranks, _ = run(tmp_path, ranks=(SHRINK, world), args=[tmp_path / "ck"],
                   timeout=240)
    want = _oracle()
    keep = world // 2
    for r, got in enumerate(ranks):
        if r < keep:
            assert got["events"] == [("worker_loss", "shrink", 3)]
            assert got["workers"] == keep and got["first_level"] == 3
            assert got["supports"] == want
        else:
            assert got["events"] == [("worker_loss", "retire", 3)]
            assert "supports" not in got


DL_SHRINK = RANK_PROLOGUE + """
faults.install(faults.FaultSchedule.parse("worker_loss@3"))
sup = MiningSupervisor(
    MirageConfig(minsup=5, n_partitions=4, max_size=5,
                 pipeline="device_loop", device_loop_ckpt_every=1,
                 checkpoint_dir=CK),
    SupervisorConfig(sleep_fn=lambda s: None), mesh=MESH)
res = sup.mine(graphs)
RESULT["events"] = [(e.kind, e.action, e.level) for e in sup.events]
RESULT["details"] = [e.detail for e in sup.events]
if res is not None:
    RESULT["supports"] = sorted(res.supports.items())
    RESULT["info"] = sup.last_miner.last_device_loop
"""


def test_device_loop_worker_loss_on_two_ranks_shrinks(tmp_path):
    """The whole-run pipeline under worker loss at W=2 (the JAX
    package's ``DL_SHRINK_SNIPPET``): the loss fires at the level-3
    chunk on both ranks, rank 1 retires, and rank 0 resumes the device
    loop alone from the level-2 chunk checkpoint, equal to
    ``mine_host``."""
    ranks, _ = run(tmp_path, ranks=(DL_SHRINK, 2), args=[tmp_path / "ck"],
                   timeout=240)
    r0, r1 = ranks
    assert r0["events"] == [("worker_loss", "shrink", 3)]
    assert "1 worker" in r0["details"][0]
    assert r0["supports"] == _oracle()
    assert r0["info"]["completed"] and r0["info"]["chunks"] == 3
    assert r1["events"] == [("worker_loss", "retire", 3)]
    assert "supports" not in r1


HANG_AND_DEADLINE = RANK_PROLOGUE + """
# a stall that only rank 1's watchdog catches: the ranks agree on it
faults.install(faults.FaultSchedule.parse("hang@3:secs=" + (
    "999" if RANK == 1 else "0.3")))
sup = MiningSupervisor(
    MirageConfig(minsup=5, n_partitions=4, max_size=5,
                 checkpoint_dir=CK + "/hang"),
    SupervisorConfig(sleep_fn=lambda s: None), mesh=MESH,
    watchdog=Watchdog(phase_default=0.2 if RANK == 1 else 60.0))
res = sup.mine(graphs)
RESULT["hang"] = ([(e.kind, e.action, e.level) for e in sup.events],
                  sorted(res.supports.items()), res.stats[0].level)
faults.clear()
# a run deadline that only rank 0 sees pass: every rank stops at the
# same loop head and cuts the same verified prefix — agreed by one
# all-reduce at the loop head, and (with the device reporting its free
# memory, as on CUDA) inside the survivor-cap agreement before dispatch
RESULT["deadline"] = []
for free in (None, 1 << 40):
    Mirage._free_device_bytes = lambda self, free=free: free
    deadline = dict(minsup=5, n_partitions=4,
                    checkpoint_dir=CK + f"/deadline{free}")
    Mirage(MirageConfig(max_size=4, **deadline), MESH).fit(graphs)
    sup = MiningSupervisor(
        MirageConfig(max_size=5, **deadline),
        SupervisorConfig(on_exhausted="partial", sleep_fn=lambda s: None),
        mesh=MESH,
        watchdog=Watchdog(run_deadline_s=1e-6 if RANK == 0 else 3600.0))
    res = sup.mine(graphs, resume=True)
    RESULT["deadline"].append((
        [(e.kind, e.action, e.level) for e in sup.events],
        isinstance(res, PartialResult), res.last_level, res.audited,
        sorted(res.supports.items())))
"""


def test_hang_and_deadline_on_two_ranks_end_on_both(tmp_path):
    """Clock-driven decisions taken on one rank only — a watchdog that
    catches a stall, a run deadline that passes — are agreed over the
    ranks: both ranks replay the stalled level from the checkpoint, and
    both cut the same verified prefix at the deadline (agreed at the
    loop head, and inside the survivor-cap agreement when the device
    reports its free memory), with no rank left blocked in a
    collective."""
    ranks, _ = run(tmp_path, ranks=(HANG_AND_DEADLINE, 2),
                   args=[tmp_path / "ck"], timeout=240)
    want = _oracle()
    prefix = _oracle(max_size=4)
    for r in ranks:
        events, supports, first = r["hang"]
        assert events == [("hang", "retry", 3)]
        assert supports == want and first == 3
        assert len(r["deadline"]) == 2
        for events, partial, last, audited, supports in r["deadline"]:
            assert events == [("deadline", "partial", 5)]
            assert partial and audited and last == 4
            assert supports == prefix
