"""Supervised recovery driver around :meth:`Mirage.mine` (DESIGN.md §10,
§14) — the port of ``repro.core.supervisor``.

MIRAGE inherits MapReduce's contract: iterations are restartable because
level state hits durable storage between them, so the *job* survives
what kills a *task*.  This module is that job-level supervisor.  It
classifies every failure the mining loop can surface and applies one of
five recoveries:

  worker_loss  → elastically shrink the worker pool (largest divisor of
                 n_partitions below the current W, floored at
                 ``min_workers``) and resume from the latest intact
                 checkpoint.  With a process group, the ranks left out
                 retire (``mine`` returns None there) and the others go
                 on in a subgroup (:func:`shrink_mesh`).  When no
                 smaller pool exists the level is replayed as it was.
  kernel       → retry; after ``degrade_after`` kernel faults descend
                 the degradation ladder ``fused → pallas → legacy``
                 (rung 1 swaps the fused single-launch kernel for the
                 two-launch backend; rung 2 abandons the single-sync
                 level for the legacy host-driven pipeline, which on the
                 card keeps the two-launch kernels and on the CPU runs
                 the plain "ref" backend).  A device-loop run descends
                 one extra rung first: ``single_sync``, the per-level
                 program with the same kernels (:func:`ladder_for`).
  transient    → (wire checksum failures) retry with exponential
                 backoff, same configuration.
  state        → (checkpoint integrity, audit failures) retry: the
                 store has already reaped the corrupt step, so the next
                 attempt resumes from the newest *intact* one — or
                 restarts clean.
  hang         → (a watchdog-detected stalled phase) replay from the
                 newest checkpoint; a stalled device-loop chunk descends
                 to the ``single_sync`` rung, which syncs every level.

Anything unclassified is **fatal** and re-raised untouched: a real CUDA
build or launch error, CUDA's out-of-memory error, and
``DeviceMemoryError`` among them.  A descent of the ladder happens only
after a classified fault, and each is a logged :class:`FaultEvent`.

Every recovery class draws from ONE jittered-exponential-backoff
:class:`RetryBudget`.  Budget exhaustion — like a run deadline
(:class:`~repro_torch.runtime.faults.DeadlineExceeded`, never retried)
— routes into the **anytime contract**: with
``on_exhausted="partial"`` the supervisor returns a
:class:`~repro_torch.core.mining.PartialResult` cut at the newest intact
*audited* checkpoint; ``"raise"`` (the default) re-raises.

With several ranks every rank runs the supervisor on the same inputs:
an injected fault fires on every rank at the same hook, the backoff is
seeded, and the driver agrees on its clock-driven decisions, so the
ranks take the same decisions in the same order.

Every decision is recorded as a structured :class:`FaultEvent` and —
crash-safely — appended to ``fault_log_path`` as one JSON line per
event the moment it happens; an end-of-run summary line closes the
file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import checkpoint as ckpt
from ..runtime import faults
from ..runtime.watchdog import Watchdog
from .auditor import audit_frequent_set
from .graphdb import Graph
from .mapreduce import MiningMesh
from .mining import (DistMiningResult, Mirage, MirageConfig,
                     PartialResult, decode_saved_levels)

__all__ = ["SupervisorConfig", "FaultEvent", "MiningSupervisor",
           "RetryBudget", "classify", "elastic_shrink", "shrink_mesh",
           "ladder_for", "LADDER", "DEVICE_LOOP_LADDER"]

#: degradation-ladder rungs, most- to least-accelerated.  Each entry is
#: the config override applied at that rung; rung 0 is "as configured".
LADDER = ("as-configured", "pallas", "legacy")

#: the device-loop pipeline descends one extra rung first: give up the
#: whole-run loop for the per-level single-sync program (same kernels,
#: but a host sync — and a fresh chance — every level)
DEVICE_LOOP_LADDER = ("as-configured", "single_sync", "pallas", "legacy")


def ladder_for(cfg: MirageConfig) -> tuple[str, ...]:
    """The degradation ladder the ORIGINAL config starts from."""
    return (DEVICE_LOOP_LADDER if cfg.pipeline == "device_loop"
            else LADDER)


def classify(exc: BaseException) -> Optional[str]:
    """Map an exception to a recovery class, or None for fatal.  Only
    the failure taxonomy is classified: a real CUDA build or launch
    error, a CUDA out-of-memory error and ``DeviceMemoryError`` are
    not, so no descent of the ladder ever hides a kernel that fails."""
    if isinstance(exc, faults.WorkerLost):
        return "worker_loss"
    if isinstance(exc, faults.KernelFault):
        return "kernel"
    if isinstance(exc, faults.HangTimeout):
        return "hang"
    if isinstance(exc, faults.WireIntegrityError):
        return "transient"
    if isinstance(exc, (faults.CheckpointIntegrityError,
                        faults.AuditError)):
        return "state"
    return None


def elastic_shrink(workers: int, n_partitions: int,
                   min_workers: int = 1) -> Optional[int]:
    """Largest viable worker count below ``workers``: the partition
    count must stay divisible (blocked dim-0 sharding), so this is the
    largest divisor of ``n_partitions`` in [min_workers, workers)."""
    for w in range(workers - 1, min_workers - 1, -1):
        if n_partitions % w == 0:
            return w
    return None


@dataclasses.dataclass
class RetryBudget:
    """One unified retry budget shared by every recovery class.

    ``spend(kind)`` charges one attempt and returns the jittered
    exponential backoff to sleep — or None when the budget is
    exhausted, which is exactly what routes the supervisor into the
    partial-result path.  Jitter is seeded (deterministic chaos runs):
    ``backoff = min(base·factor^(n-1), cap) · (1 + jitter·u)``,
    u ~ U[0, 1)."""

    max_attempts: int = 5
    base: float = 0.05
    factor: float = 2.0
    cap: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        self.attempt = 0
        self.by_kind: dict = {}
        self._rng = np.random.default_rng(self.seed)

    @property
    def exhausted(self) -> bool:
        return self.attempt >= self.max_attempts

    def spend(self, kind: str) -> Optional[float]:
        if self.exhausted:
            return None
        self.attempt += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        backoff = min(self.base * self.factor ** (self.attempt - 1),
                      self.cap)
        if backoff > 0 and self.jitter > 0:
            backoff *= 1.0 + self.jitter * float(self._rng.random())
        return backoff


@dataclasses.dataclass
class SupervisorConfig:
    max_retries: int = 5                # unified retry budget
    backoff_base: float = 0.05          # seconds before attempt 2
    backoff_factor: float = 2.0
    backoff_max: float = 2.0
    backoff_jitter: float = 0.25        # jitter fraction on each backoff
    seed: int = 0                       # jitter rng seed (determinism)
    degrade_after: int = 2              # kernel faults per ladder rung
    min_workers: int = 1                # elastic-shrink floor
    deadline_s: Optional[float] = None  # whole-run wall-clock budget
    on_exhausted: str = "raise"         # "raise" | "partial" (DESIGN §14)
    sleep_fn: Callable[[float], None] = time.sleep
    fault_log_path: Optional[str] = None

    def __post_init__(self):
        if self.on_exhausted not in ("raise", "partial"):
            raise ValueError(
                f"on_exhausted must be 'raise' or 'partial', "
                f"got {self.on_exhausted!r}")


@dataclasses.dataclass
class FaultEvent:
    """One supervisor decision, structured for the fault log."""

    attempt: int
    kind: str                           # recovery class (or "fatal")
    error: str                          # repr of the triggering exception
    level: Optional[int]                # mining level, when known
    action: str                         # retry | shrink | degrade |
    detail: str                         #   partial | give_up
    backoff: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def shrink_mesh(mesh: MiningMesh, n_workers: int) -> Optional[MiningMesh]:
    """The mesh of the first ``n_workers`` ranks of ``mesh``'s process
    group, or None on a rank at or above ``n_workers``, which retires.
    One survivor keeps a single-device mesh on its device (no group, no
    collective); more build a subgroup of the survivors, which only the
    survivors enter.  The rank's device is unchanged."""
    if mesh.rank >= n_workers:
        return None
    if n_workers == 1:
        return MiningMesh(device=mesh.device)
    ranks = dist.get_process_group_ranks(mesh.group)[:n_workers]
    group = dist.new_group(ranks=ranks, use_local_synchronization=True)
    return MiningMesh.from_process_group(group, mesh.device)


class MiningSupervisor:
    """Run :meth:`Mirage.mine` to completion through faults.

    ``mesh`` seeds the worker pool (default single-device) and
    ``device`` is passed to :class:`Mirage`; with a multi-worker mesh
    every rank runs this supervisor on the same inputs and schedule, so
    that every rank takes the same decisions.  ``mesh_factory(n)``
    builds the shrunken mesh on worker loss, or returns None on a rank
    that the shrink retires — then ``mine`` returns None there; the
    default is :func:`shrink_mesh` of the current mesh.  Recovery is
    only cheap with ``config.checkpoint_dir`` set (resume replays at
    most one level); without it every retry restarts from scratch,
    which is still correct, just slower.  ``watchdog`` injects a
    pre-built :class:`Watchdog` (tests pin ``phase_default`` for
    deterministic hang detection); by default one is built from
    ``deadline_s`` + the config's phase-deadline knobs and spans every
    retry — the run deadline is wall-clock, not per-attempt.
    """

    def __init__(self, config: MirageConfig,
                 sup: Optional[SupervisorConfig] = None,
                 mesh: Optional[MiningMesh] = None,
                 mesh_factory: Optional[
                     Callable[[int], Optional[MiningMesh]]] = None,
                 watchdog: Optional[Watchdog] = None,
                 device: Optional[torch.device | str] = None):
        self.config = config
        self.sup = sup or SupervisorConfig()
        self.mesh = mesh or MiningMesh.single_device()
        self.mesh_factory = mesh_factory or (
            lambda n: shrink_mesh(self.mesh, n))
        self.device = device
        self.events: list[FaultEvent] = []
        self.audit_report: list[dict] = []
        self.rung = 0
        self.watchdog = watchdog
        self.budget: Optional[RetryBudget] = None
        self.last_miner: Optional[Mirage] = None
        self._log_open = False

    # ------------------------------------------------------------------
    def mine(self, graphs: Sequence[Graph], *, resume: bool = False,
             deadline_s: Optional[float] = None
             ) -> Union[DistMiningResult, PartialResult, None]:
        sup = self.sup
        cfg = self.config
        deadline = deadline_s if deadline_s is not None else sup.deadline_s
        wd = self.watchdog
        if wd is None:
            wd = Watchdog(run_deadline_s=deadline,
                          phase_floor=cfg.level_deadline_floor,
                          phase_slack=cfg.level_deadline_slack,
                          on_trip=self._log_line)
        elif wd.on_trip is None:
            wd.on_trip = self._log_line
        self.watchdog = wd
        wd.start()
        budget = self.budget = RetryBudget(
            max_attempts=sup.max_retries, base=sup.backoff_base,
            factor=sup.backoff_factor, cap=sup.backoff_max,
            jitter=sup.backoff_jitter, seed=sup.seed)
        kernel_faults = 0
        ladder = ladder_for(cfg)
        try:
            while True:
                miner = Mirage(cfg, self.mesh, self.device)
                self.last_miner = miner
                try:
                    result = miner.mine(
                        graphs, resume=resume or budget.attempt > 0,
                        watchdog=wd)
                    self._finish_log("complete")
                    return result
                except faults.DeadlineExceeded as exc:
                    # never retried: the clock cannot be argued with
                    partial = sup.on_exhausted == "partial"
                    self._record(budget.attempt, "deadline", exc,
                                 "partial" if partial else "give_up",
                                 "run deadline exceeded — cutting at the "
                                 "newest audited checkpoint"
                                 if partial else
                                 "run deadline exceeded", 0.0)
                    if partial:
                        return self._partial(cfg, "deadline")
                    self._finish_log("deadline")
                    raise
                except Exception as exc:                  # noqa: BLE001
                    kind = classify(exc)
                    if kind is None:
                        self._record(budget.attempt, "fatal", exc,
                                     "give_up",
                                     "unclassified failure — re-raised",
                                     0.0)
                        self._finish_log("fatal")
                        raise
                    backoff = budget.spend(kind)
                    if backoff is None:
                        partial = sup.on_exhausted == "partial"
                        self._record(
                            budget.attempt, kind, exc,
                            "partial" if partial else "give_up",
                            f"retry budget ({sup.max_retries}) "
                            f"exhausted", 0.0)
                        if partial:
                            return self._partial(cfg, "budget-exhausted")
                        self._finish_log("exhausted")
                        raise
                    action, detail = "retry", "same configuration"

                    if kind == "worker_loss":
                        w = elastic_shrink(self.mesh.n_workers,
                                           cfg.n_partitions,
                                           sup.min_workers)
                        if w is not None:
                            mesh = self.mesh_factory(w)
                            if mesh is None:
                                # this rank is left out of the smaller
                                # pool: it retires, and its peers go on
                                self._record(
                                    budget.attempt, kind, exc, "retire",
                                    f"elastic shrink to {w} worker(s) "
                                    f"leaves this rank out", 0.0)
                                self._finish_log("retired")
                                return None
                            self.mesh = mesh
                            action = "shrink"
                            detail = (f"elastic shrink to {w} worker(s), "
                                      f"resume from checkpoint")
                        else:
                            detail = (f"no viable mesh below "
                                      f"{self.mesh.n_workers} worker(s) "
                                      f"— replay on the same mesh")
                    elif kind == "kernel":
                        kernel_faults += 1
                        if (kernel_faults % sup.degrade_after == 0
                                and self.rung < len(ladder) - 1):
                            self.rung += 1
                            cfg = _degrade(cfg, ladder[self.rung],
                                           miner.device)
                            action = "degrade"
                            detail = (f"descend ladder to rung "
                                      f"{self.rung} "
                                      f"({ladder[self.rung]})")
                    elif kind == "hang":
                        waited = getattr(exc, "waited_s", 0.0)
                        if (cfg.pipeline == "device_loop"
                                and self.rung < len(ladder) - 1):
                            # a stalled chunk forfeits the whole-run
                            # loop: the single-sync rung re-syncs every
                            # level, bounding any future stall
                            self.rung = max(self.rung, 1)
                            cfg = _degrade(cfg, ladder[self.rung],
                                           miner.device)
                            action = "degrade"
                            detail = (f"stalled device_loop chunk "
                                      f"(detected after {waited:.2f}s) — "
                                      f"descend to "
                                      f"{ladder[self.rung]}")
                        else:
                            detail = (f"stalled phase detected after "
                                      f"{waited:.2f}s — replay from "
                                      f"newest checkpoint")
                    elif kind == "state":
                        detail = ("corrupt or audit-failed state — "
                                  "resume from newest intact audited "
                                  "step (or restart clean)")

                    self._record(budget.attempt, kind, exc, action,
                                 detail, backoff)
                    # the failed attempt's level ends here: its phase
                    # deadline must not trip during the next one's prep
                    wd.disarm()
                    rem = wd.run_remaining()
                    if rem is not None and rem <= 0:
                        continue          # let the deadline path fire
                    if backoff > 0:
                        if rem is not None:
                            backoff = min(backoff, max(rem, 0.0))
                        sup.sleep_fn(backoff)
        finally:
            if self.last_miner is not None and self.last_miner.auditor:
                self.audit_report.extend(self.last_miner.auditor.report)

    # ------------------------------------------------------------------
    def _partial(self, cfg: MirageConfig, reason: str) -> PartialResult:
        """Cut a verified partial result at the newest intact *audited*
        checkpoint: load (digest-verified), decode, and re-audit the
        whole frequent-set prefix before trusting it.  With no surviving
        checkpoint the result is the (trivially valid) empty prefix.
        With several ranks, rank 0 reads first and the others after it,
        as on resume (``runtime/checkpoint.py``)."""
        if self.mesh.rank == 0:
            found = self._newest_audited(cfg)
        self.mesh.barrier()
        if self.mesh.rank != 0:
            found = self._newest_audited(cfg)
        levels, supports, last_level, audited, minsup = found
        result = PartialResult(
            levels=levels, supports=supports, minsup=minsup,
            last_level=last_level, reason=reason, audited=audited,
            events=[e.as_dict() for e in self.events])
        self._finish_log(f"partial:{reason}")
        return result

    @staticmethod
    def _newest_audited(cfg: MirageConfig):
        """(levels, supports, last level, audited, minsup) of the newest
        checkpoint that loads intact, was written by an auditing run and
        passes the re-audit; the empty prefix when there is none."""
        if cfg.checkpoint_dir:
            for step in sorted(ckpt.all_steps(cfg.checkpoint_dir),
                               reverse=True):
                path = os.path.join(cfg.checkpoint_dir,
                                    f"step_{step:010d}")
                try:
                    state, meta = ckpt.load_pytree(path)
                except Exception:
                    continue              # corrupt/unreadable: skip down
                if not meta.get("audited"):
                    continue              # only ever cut at audited levels
                try:
                    lv, sp = decode_saved_levels(state)
                    ms = meta.get("minsup")
                    audit_frequent_set(lv, sp, ms,
                                       n_graphs=meta.get("n_graphs", -1))
                except Exception:
                    continue              # failed re-audit: keep walking
                return lv, sp, int(step), True, ms
        return [], {}, 0, False, None

    # ------------------------------------------------------------------
    def _record(self, attempt: int, kind: str, exc: BaseException,
                action: str, detail: str, backoff: float) -> None:
        ev = FaultEvent(
            attempt=attempt, kind=kind, error=repr(exc),
            level=getattr(exc, "level", None),
            action=action, detail=detail, backoff=backoff)
        self.events.append(ev)
        self._log_line(ev.as_dict())

    def _log_line(self, payload: dict) -> None:
        """Crash-safe structured log: one JSON line, flushed on write.
        The first line of a run truncates any stale file."""
        if not self.sup.fault_log_path:
            return
        mode = "a" if self._log_open else "w"
        self._log_open = True
        try:
            with open(self.sup.fault_log_path, mode) as f:
                f.write(json.dumps(payload) + "\n")
                f.flush()
        except OSError:
            pass                          # logging must never kill mining

    def _finish_log(self, outcome: str) -> None:
        self._log_line({"summary": {
            "outcome": outcome, "rung": self.rung,
            "n_events": len(self.events),
            "by_kind": dict(self.budget.by_kind) if self.budget else {},
            "watchdog_trips": len(self.watchdog.trips)
            if self.watchdog else 0}})


def _degrade(cfg: MirageConfig, rung: str,
             device: torch.device) -> MirageConfig:
    """Config override for a degradation-ladder rung, by rung NAME, for
    a miner on ``device``.

    "single_sync" abandons the whole-run device loop for the per-level
    program (same kernels and shapes, one sync per level).  "pallas"
    keeps the current pipeline (single-sync in place of the device
    loop) but drops the fused single-launch kernel for the two-launch
    backend: on the card the hand-written join and reduction kernels, on
    the CPU their plain versions.  "legacy" falls back to the
    host-driven pipeline, dense as the differential oracle: on the card
    it keeps the two-launch kernels, so no descent leaves the card's
    kernels for plain PyTorch; on the CPU it runs the "ref" backend, as
    the JAX package does.
    """
    if rung == "as-configured":
        return cfg
    if rung == "single_sync":
        return dataclasses.replace(cfg, pipeline="single_sync")
    if rung == "pallas":
        pipeline = ("single_sync" if cfg.pipeline == "device_loop"
                    else cfg.pipeline)
        return dataclasses.replace(cfg, pipeline=pipeline, backend="pallas")
    if rung == "legacy":
        backend = "pallas" if torch.device(device).type == "cuda" else "ref"
        return dataclasses.replace(cfg, pipeline="legacy", backend=backend,
                                   packed_support=None)
    raise ValueError(f"unknown ladder rung {rung!r}")
