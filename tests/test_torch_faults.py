"""The port's fault-injection layer and supervisor policy units (DESIGN.md
§10), held to the JAX package's: schedules parse, describe and draw
spec for spec as ``repro.runtime.faults`` does, the wire hook flips the
same bit, checkpoint damage is caught, and the supervisor classifies
only the failure taxonomy — a real kernel error, CUDA's out-of-memory
error and ``DeviceMemoryError`` are re-raised with no descent.  End to
end recovery lives in ``test_torch_chaos.py``."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import mining as jmining
from repro.core import supervisor as jsupervisor
from repro.runtime import faults as jfaults
from repro_torch.core import supervisor as sup_mod
from repro_torch.core.graphdb import (Graph, GraphValidationError,
                                      paper_toy_db)
from repro_torch.core.mining import MirageConfig
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import errors, faults


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, jfaults):
        f.clear()
        f.reset_log()
    yield
    for f in (faults, jfaults):
        f.clear()
        f.reset_log()


def _specs(schedule):
    return [{k: v for k, v in vars(s).items()} for s in schedule.specs]


# ---------------------------------------------------------------------------
# schedules, against the JAX package's
# ---------------------------------------------------------------------------

def test_fault_spec_parse_grammar():
    s = faults.FaultSpec.parse("kernel_fault@3*4")
    assert (s.kind, s.level, s.times) == ("kernel_fault", 3, 4)
    s = faults.FaultSpec.parse("wire_bitflip@2:word=5,bit=12")
    assert (s.level, s.word, s.bit) == (2, 5, 12)
    s = faults.FaultSpec.parse("ckpt_corrupt@2:mode=truncate")
    assert s.mode == "truncate"
    for bad in ("worker_loss", "frobnicate@2", "worker_loss@2:color=3",
                "ckpt_corrupt@2:mode=nope", "hang@0"):
        with pytest.raises(ValueError):
            faults.FaultSpec.parse(bad)
        with pytest.raises(ValueError):
            jfaults.FaultSpec.parse(bad)


@pytest.mark.parametrize("text", [
    "worker_loss@2; kernel_fault@3*2 ;wire_bitflip@4:bit=3",
    "kernel_fault@3;wire_bitflip@4",
    "hang@3*2:secs=2.5;cap_storm@2:cap=4;ckpt_corrupt@3:mode=manifest",
    "wire_bitflip@2:word=5,bit=12;worker_loss@4*99:worker=1",
    "",
])
def test_schedule_parse_and_describe_equal_reference(text):
    port, jax = (faults.FaultSchedule.parse(text),
                 jfaults.FaultSchedule.parse(text))
    assert port.describe() == jax.describe()
    assert _specs(port) == _specs(jax)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_schedule_equals_reference(seed):
    """``FaultSchedule.random`` draws the JAX package's schedule spec for
    spec, so a seeded chaos run faults the same levels in both."""
    for kw in ({}, dict(max_level=5, n_faults=3)):
        port = faults.FaultSchedule.random(seed, **kw)
        jax = jfaults.FaultSchedule.random(seed, **kw)
        assert _specs(port) == _specs(jax)
        assert port.describe() == jax.describe()
        for s in port.specs:
            assert s.kind in faults.KINDS and s.level >= 2
    assert faults.KINDS == jfaults.KINDS


def test_schedule_fires_exactly_times_and_logs():
    with faults.active(faults.FaultSchedule.parse("worker_loss@2*2")):
        for _ in range(2):
            with pytest.raises(faults.WorkerLost):
                faults.maybe_raise("level_start", 2)
        faults.maybe_raise("level_start", 2)            # budget exhausted
        faults.maybe_raise("level_start", 3)            # wrong level
    assert [(e["kind"], e["level"]) for e in faults.injection_log()] == [
        ("worker_loss", 2), ("worker_loss", 2)]
    sched = faults.FaultSchedule.parse("worker_loss@2")
    for _ in range(2):                                  # install re-arms
        with faults.active(sched):
            with pytest.raises(faults.WorkerLost):
                faults.maybe_raise("level_start", 2)
    assert faults.installed() is None


def test_hooks_are_noops_without_schedule(tmp_path):
    faults.maybe_raise("level_start", 2)
    faults.maybe_raise("kernel", 2)
    w = np.arange(8, dtype=np.int32)
    assert faults.corrupt_wire(w, 2) is w
    assert faults.override_cap(17, 2) == 17
    assert faults.maybe_hang("dispatch", 2) is False
    ckpt.save_step(str(tmp_path), 2, {"v": np.ones(3)})
    ckpt.load_step(str(tmp_path), 2)
    assert faults.injection_log() == []


@pytest.mark.parametrize("spec", ["wire_bitflip@2:word=5,bit=3",
                                  "wire_bitflip@2:word=99",
                                  "wire_bitflip@2:word=0,bit=37",
                                  "wire_bitflip@2"])
def test_corrupt_wire_flips_the_reference_bit_in_a_copy(spec):
    wire = np.random.default_rng(0).integers(
        -2 ** 31, 2 ** 31, 16, dtype=np.int64).astype(np.int32)
    with faults.active(faults.FaultSchedule.parse(spec)):
        out = faults.corrupt_wire(wire, 2)
    with jfaults.active(jfaults.FaultSchedule.parse(spec)):
        want = jfaults.corrupt_wire(wire, 2)
    assert out is not wire and not np.array_equal(out, wire)
    np.testing.assert_array_equal(out, want)
    assert np.count_nonzero(out != wire) == 1


def test_override_cap_and_kernel_hook():
    with faults.active(faults.FaultSchedule.parse(
            "cap_storm@3:cap=4;kernel_fault@2")):
        assert faults.override_cap(64, 2) == 64
        assert faults.override_cap(64, 3) == 4
        with pytest.raises(faults.KernelFault) as ei:
            faults.maybe_raise("kernel", 2)
    assert ei.value.level == 2 and ei.value.kind == "kernel_fault"


# ---------------------------------------------------------------------------
# checkpoint damage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
def test_damaged_checkpoint_raises_integrity_error(tmp_path, mode):
    p = str(tmp_path / "ck")
    ckpt.save_pytree(p, {"a": np.arange(600, dtype=np.int32),
                         "b": [np.ones(4, np.float32), 7]})
    faults.damage_checkpoint(p, mode)
    with pytest.raises(errors.CheckpointIntegrityError):
        ckpt.load_pytree(p)


def test_scheduled_ckpt_corruption_hits_matching_step_only(tmp_path):
    root = str(tmp_path)
    with faults.active(faults.FaultSchedule.parse(
            "ckpt_corrupt@2:mode=flip")):
        ckpt.save_step(root, 1, {"v": np.zeros(200)})
        ckpt.save_step(root, 2, {"v": np.ones(200)})
    ckpt.load_step(root, 1)
    with pytest.raises(errors.CheckpointIntegrityError):
        ckpt.load_step(root, 2)
    assert [e["kind"] for e in faults.injection_log()] == ["ckpt_corrupt"]


def test_errors_module_reexports_the_taxonomy():
    for name in ("IntegrityError", "WireIntegrityError",
                 "CheckpointIntegrityError", "AuditError"):
        assert getattr(errors, name) is getattr(faults, name)
    assert issubclass(errors.WireIntegrityError, errors.IntegrityError)
    assert ckpt.CheckpointIntegrityError is faults.CheckpointIntegrityError


# ---------------------------------------------------------------------------
# supervisor policy units
# ---------------------------------------------------------------------------

def test_classify_maps_only_the_taxonomy():
    assert sup_mod.classify(faults.WorkerLost(2, 1)) == "worker_loss"
    assert sup_mod.classify(faults.KernelFault(3)) == "kernel"
    assert sup_mod.classify(faults.WireIntegrityError("x")) == "transient"
    assert sup_mod.classify(faults.CheckpointIntegrityError("x")) == "state"
    assert sup_mod.classify(faults.HangTimeout(3, 0.5)) == "hang"
    assert sup_mod.classify(faults.AuditError(2, "bad word")) == "state"
    # real failures stay fatal: a CUDA launch error, CUDA's out-of-memory
    # error, the retry's memory error, an input bug
    for exc in (RuntimeError("fused_level_packed kernel launch failed: "
                             "cudaError 1"),
                torch.OutOfMemoryError("CUDA out of memory"),
                errors.DeviceMemoryError(3, 100, 10 ** 9, 10 ** 6),
                ValueError("real bug"), faults.DeadlineExceeded(2, 1, 1)):
        assert sup_mod.classify(exc) is None


def test_classify_and_shrink_equal_reference():
    pairs = [(faults.WorkerLost(2), jfaults.WorkerLost(2)),
             (faults.KernelFault(3), jfaults.KernelFault(3)),
             (faults.HangTimeout(3), jfaults.HangTimeout(3)),
             (faults.WireIntegrityError("x"), jfaults.WireIntegrityError("x")),
             (faults.AuditError(2, "y"), jfaults.AuditError(2, "y")),
             (RuntimeError("z"), RuntimeError("z"))]
    for port, jax in pairs:
        assert sup_mod.classify(port) == jsupervisor.classify(jax)
    for w in range(1, 9):
        for n in (1, 4, 7, 8, 12):
            for lo in (1, 2, 3):
                assert sup_mod.elastic_shrink(w, n, lo) == \
                    jsupervisor.elastic_shrink(w, n, lo)
    assert sup_mod.LADDER == jsupervisor.LADDER
    assert sup_mod.DEVICE_LOOP_LADDER == jsupervisor.DEVICE_LOOP_LADDER


def test_degradation_rungs():
    cfg = MirageConfig(minsup=2, backend="fused", packed_support=True)
    cpu = torch.device("cpu")
    assert sup_mod._degrade(cfg, "as-configured", cpu) is cfg
    pallas = sup_mod._degrade(cfg, "pallas", cpu)
    assert (pallas.pipeline, pallas.backend, pallas.packed_support) == (
        "single_sync", "pallas", True)
    legacy = sup_mod._degrade(cfg, "legacy", cpu)
    assert (legacy.pipeline, legacy.backend, legacy.packed_support) == (
        "legacy", "ref", None)
    # the device loop's extra rung: the per-level program, same kernels;
    # its "pallas" rung leaves the device loop too, as the JAX package's
    dl = MirageConfig(minsup=2, max_size=4, backend="fused",
                      pipeline="device_loop")
    single = sup_mod._degrade(dl, "single_sync", cpu)
    assert (single.pipeline, single.backend) == ("single_sync", "fused")
    assert (sup_mod._degrade(dl, "pallas", cpu).pipeline,
            jsupervisor._degrade(jmining.MirageConfig(
                minsup=2, max_size=4, backend="fused",
                pipeline="device_loop"), "pallas").pipeline) == (
        "single_sync", "single_sync")
    with pytest.raises(ValueError, match="unknown ladder rung"):
        sup_mod._degrade(cfg, "quantum", cpu)


@pytest.mark.parametrize("backend", ["fused", "fused_packed", "pallas"])
def test_card_ladder_never_leaves_the_kernels(backend):
    """On the card no rung picks the plain "ref" backend: the legacy rung
    keeps the two-launch kernels B3 + B4.  Only the config is built, so
    no card is needed."""
    cfg = MirageConfig(minsup=2, backend=backend)
    cuda = torch.device("cuda", 0)
    for rung in sup_mod.LADDER:
        out = sup_mod._degrade(cfg, rung, cuda)
        assert out.backend != "ref", (rung, out.backend)
    legacy = sup_mod._degrade(cfg, "legacy", cuda)
    assert (legacy.pipeline, legacy.backend, legacy.packed_support) == (
        "legacy", "pallas", None)


def test_supervisor_reraises_exhausted_budget_with_jsonl_log(tmp_path):
    log = tmp_path / "faults.jsonl"
    sup = sup_mod.MiningSupervisor(
        MirageConfig(minsup=2, n_partitions=2, max_size=3),
        sup_mod.SupervisorConfig(max_retries=2, sleep_fn=lambda s: None,
                                 fault_log_path=str(log)), device="cpu")
    with faults.active(faults.FaultSchedule.parse("worker_loss@2*99")):
        with pytest.raises(faults.WorkerLost):
            sup.mine(paper_toy_db())
    assert [e.action for e in sup.events] == ["retry", "retry", "give_up"]
    lines = [json.loads(l) for l in log.read_text().splitlines()]
    events = [l for l in lines if "summary" not in l]
    assert events == [e.as_dict() for e in sup.events]
    assert lines[-1]["summary"]["outcome"] == "exhausted"
    assert lines[-1]["summary"]["by_kind"] == {"worker_loss": 2}


def test_supervisor_passes_input_bugs_through():
    sup = sup_mod.MiningSupervisor(
        MirageConfig(minsup=2, n_partitions=2, max_size=3),
        sup_mod.SupervisorConfig(sleep_fn=lambda s: None), device="cpu")
    bad = Graph(np.asarray([0, 1]), np.asarray([[0, 7]]), np.asarray([0]))
    with pytest.raises(GraphValidationError, match="dangling"):
        sup.mine(paper_toy_db() + [bad])
    assert [e.kind for e in sup.events] == ["fatal"]


@pytest.mark.parametrize("exc", [
    RuntimeError("fused_level_packed kernel launch failed: cudaError 1"),
    errors.DeviceMemoryError(2, 7, 10 ** 9, 10 ** 6)])
def test_real_kernel_and_memory_errors_are_not_degraded(monkeypatch, exc):
    """A kernel that really fails is re-raised at once: no retry, no
    descent of the ladder that would hide it behind another backend."""
    import repro_torch.core.mining as tmining

    def broken(*a, **kw):
        raise exc

    monkeypatch.setattr(tmining, "dispatch_level", broken)
    sup = sup_mod.MiningSupervisor(
        MirageConfig(minsup=2, n_partitions=2, max_size=3, backend="fused"),
        sup_mod.SupervisorConfig(sleep_fn=lambda s: None, degrade_after=1),
        device="cpu")
    with pytest.raises(type(exc)):
        sup.mine(paper_toy_db())
    assert sup.rung == 0
    assert [(e.kind, e.action) for e in sup.events] == [("fatal", "give_up")]
    assert sup.last_miner.cfg.backend == "fused"


def test_supervisor_needs_a_device_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    sup = sup_mod.MiningSupervisor(MirageConfig(minsup=2, n_partitions=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sup.mine(paper_toy_db())


def test_fault_event_fields_equal_reference():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(sup_mod.FaultEvent) == names(jsupervisor.FaultEvent)
    port = {f.name: f.default for f in dataclasses.fields(
        sup_mod.SupervisorConfig) if f.name != "sleep_fn"}
    jax = {f.name: f.default for f in dataclasses.fields(
        jsupervisor.SupervisorConfig) if f.name != "sleep_fn"}
    assert port == jax
