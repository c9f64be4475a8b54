"""MIRAGE iterative mining driver (paper §IV-B/C, Figs. 9-10), single-sync
and legacy pipelines over one or more workers.

Phases:
  1. data partition  — filter infrequent edges, split into NP partitions
                       (NP ≫ workers, paper Fig. 20), pad uniformly;
  2. preparation     — per-partition static structures (edge-OL) + the
                       level-1 pattern OLs, moved to the device once;
  3. mining          — the host enumerates canonical candidates from F_k
                       (tiny metadata); the device runs the whole level as
                       ONE stretch of queued work (`core/level_step.py`):
                       fused join, shuffle, on-device survivor compaction,
                       audit word and child-OL materialization — the host
                       syncs exactly once per level, on the wire.  Repeat
                       until no frequent patterns.

Three pipelines (MirageConfig.pipeline), as in ``repro.core.mining``:
  "single_sync" — the level program above, one wire fetch per level
                  (default);
  "device_loop" — the ENTIRE run queued on the device with no host read
                  between levels (``core/device_loop.py``, DESIGN.md
                  §13): device candidate generation, schedule and level
                  compute, one wire fetch per run; bails to single_sync
                  when a static budget overflows;
  "legacy"      — the two-program pipeline, the differential oracle.
``candgen="device"`` swaps the per-level host generator of the other
pipelines for the device generator (the stepping stone to the loop).

With a multi-worker ``MiningMesh`` every
rank of its process group runs this driver on the same inputs: the host
work (partitioning, candgen, schedule, bucket choices) is deterministic,
so every rank takes the same decisions, and each rank holds its block
of the partition axis (``runtime/sharding.py``).  Everything that shapes
a collective comes from deterministic host code or from the wire, which
every rank reads whole; the one other input, the free device memory
behind the survivor cap, is agreed over the ranks.  The straggler
rebalance permutes the partitions across the workers; a cumulative
``order`` keeps checkpoints canonical.  The legacy pipeline runs the paper's
two programs: a support round (``mapreduce.map_reduce_supports``) and a
materialize round with host round trips between them, dense, psum
by default, no shape buckets and no device audit word — the JAX
package's differential oracle, kept as it is.  ``MirageConfig`` keeps
every field of the JAX package.

The robustness layer (DESIGN.md §10, §14) hooks the driver as in the
JAX package: a worker-loss hook at each level start, survivor-cap
storms, an injected stall after each dispatch (``runtime/faults.py``),
and a ``Watchdog`` whose run deadline is checked at each loop head and
whose phase deadline is armed around each level.  With several ranks
the two clock-driven decisions are agreed over the ranks, so that no
rank raises while a peer enters a collective: the run deadline rides
the survivor-cap agreement (CUDA, single-sync) or one small all-reduce,
and a fired stall's outcome is all-reduced.  ``core/supervisor.py``
wraps ``mine`` (= ``fit``).

Donation: PyTorch's eager ops never consume an input buffer, so the
parent store stays valid for every retry and ``donate`` /
``donation_rearm_levels`` change nothing here — the JAX package's
rebuild-from-checkpoint path after an armed-donation retry is not needed.

Checkpoints use the JAX package's format (``runtime/checkpoint.py``), so
a run checkpointed by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import (Backend, check_backend, default_backend,
                           is_fused_backend)
from ..runtime import checkpoint as ckpt
from ..runtime import faults, trace
from ..runtime.errors import DeviceMemoryError
from ..runtime.sharding import partition_block
from ..runtime.watchdog import Watchdog
from . import device_loop as dloop
from .auditor import Auditor
from .buckets import BucketSpec, bucket_size, round_up_multiple
from .candgen import (Candidate, EdgeAlphabet, candidates_from_arrays,
                      device_candgen, filter_speculative,
                      generate_candidates, schedule_candidates)
from .dfscode import Code, array_to_code, code_to_array
from .embedding import build_edge_ol, candidate_meta, level1_ol
from .graphdb import Graph
from .level_step import (_IMBAL_FX, dispatch_level, fetch_wire,
                         permute_stores, upload)
from .mapreduce import MiningMesh, map_materialize, map_reduce_supports
from .partition import make_partitions

__all__ = ["MirageConfig", "LevelStats", "DistMiningResult", "Mirage",
           "PartialResult", "decode_saved_levels", "memory_survivor_cap"]

PIPELINES = ("single_sync", "device_loop", "legacy")
CANDGENS = ("host", "device")

# share of the card's free memory one level's child OL store may take:
# the rest holds the parent store and pass-2's per-slot temporaries
_STORE_MEMORY_SHARE = 0.5


@dataclasses.dataclass
class MirageConfig:
    minsup: float | int                 # fraction of |G| or absolute count
    n_partitions: int = 8
    scheme: int | str = 2               # partition scheme (1|2|"density")
    max_size: Optional[int] = None      # max pattern edges (None = to fixpoint)
    max_embeddings: int = 32            # M cap (exactness valve escalates)
    max_embeddings_limit: int = 512     # escalation ceiling
    max_occ: Optional[int] = None       # F pad (None = derive from data)
    backend: Optional[Backend] = None   # kernels backend (None = auto)
    # shuffle collective; None resolves per pipeline in __post_init__:
    # "reduce_scatter" for single_sync (fig19: faster AND lighter on the
    # wire), "psum" for legacy (the paper-faithful differential oracle)
    reduce: Optional[str] = None        # "psum" | "reduce_scatter" | None
    # sharded wire layout (DESIGN.md §11): each worker transfers only its
    # C/W support slice.  None = auto (on whenever the reduce_scatter
    # shuffle runs under single_sync — the slice already lives there)
    sharded_wire: Optional[bool] = None
    # bit-packed support path (DESIGN.md §12): per-graph verdict words
    # from the kernel with AND+popcount support counting, bit-lane verdict gathers, and
    # a 2x-uint16 gsup wire slice.  None = auto (on for single_sync);
    # the legacy pipeline stays dense — it is the differential oracle.
    # Regardless of the flag, packing engages only when every support
    # fits uint16 (total graph count < 2^16)
    packed_support: Optional[bool] = None
    # double-buffer host candidate generation for level k+1 in the
    # shadow of level k's in-flight device program (DESIGN.md §11)
    overlap_candgen: bool = True
    # speculation cost gate: the speculative candgen runs over the FULL
    # candidate superset, |C_k|/|F_k| times the survivor-only work — at
    # sparse survival that dwarfs the device time it hides behind.  The
    # driver estimates its cost from a running per-parent candgen rate
    # and skips the speculation for any level where the estimate
    # exceeds the hiding window max(previous level's device seconds,
    # this floor)
    overlap_spec_window: float = 0.05
    checkpoint_dir: Optional[str] = None
    escalate_on_overflow: bool = True
    rebalance_threshold: float = 1.25   # max/mean partition cost trigger
    rebalance: bool = True
    pipeline: str = "single_sync"   # "single_sync"|"device_loop"|"legacy"
    # candidate generation: "host" (the python generator) or "device"
    # (candgen.device_candidates dispatched per level — the benchable
    # stepping stone toward device_loop, which always generates on
    # device INSIDE its while_loop).  Device candgen statically disables
    # the speculative-overlap machinery; a per-level budget/state
    # overflow falls back to the host generator for that level only.
    candgen: str = "host"
    # ---- device_loop static budgets (DESIGN.md §13) ------------------
    # canonical candidate budget CB per loop iteration (None = auto:
    # 4x the host-generated start-level candidate count, bucketed —
    # candgen typically peaks one or two levels past the start); the raw
    # structural-slot budget before canonicality filtering (None = auto:
    # 4x CB); the canonicality machine's bounded state count.  Any
    # overflow trips a bail flag and the run falls back to single_sync.
    device_c_budget: Optional[int] = None
    device_raw_budget: Optional[int] = None
    device_max_states: int = 64
    # checkpoint cadence: re-invoke the (single) compiled run program
    # every k levels, fetching wire + OL store at each boundary for the
    # canonical checkpoint (None = no mid-run checkpoints — exactly one
    # device→host transfer for the whole run)
    device_loop_ckpt_every: Optional[int] = None
    # > 0: replace the while_loop with this many cond-gated body
    # applications per program invocation (the unrolled stepping stone)
    device_loop_unroll: int = 0
    donate: bool = True                 # donate OL buffers when retry-free
    # re-arm donation after this many consecutive clean levels even when
    # a retry is possible, rebuilding parents from checkpoint if the
    # gamble loses (0 disables; needs checkpoint_dir to ever engage)
    donation_rearm_levels: int = 3
    predict_survivors: bool = True      # shrink the survivor cap from history
    survivor_slack: float = 2.0         # cap = slack * predicted survivors
    # ---- shape bucketing (single_sync pipeline; DESIGN.md §9) --------
    # round the per-level shapes (Cp, S, P, M, K, fused-schedule rows)
    # up to the geometric family floor·2^i (the JAX package's families:
    # the wire's length depends on Cp; see core/buckets.py).  Padded
    # slots are masked end-to-end.
    bucket_shapes: bool = True
    bucket_c_floor: int = 64            # candidate axis Cp (+ sched rows)
    bucket_s_floor: int = 32            # survivor cap S / parent axis P
    bucket_k_floor: int = 8             # OL vertex-slot axis K
    # ---- continuous invariant auditor + deadlines (DESIGN.md §14) ----
    # device audit word folded into the wire (monotonicity, compaction,
    # range, survivor-count) + sampled host spot checks each level
    # (downward closure, DFS-code canonicality); violations raise
    # AuditError, a state-class fault the supervisor heals by replay
    audit: bool = True
    audit_samples: int = 2              # host spot checks per level
    # watchdog phase-deadline policy: deadline = max(floor, slack·EWMA)
    # of recent level wall-times; floor=0 with no EWMA sample = unarmed
    # (the first level usually contains compilation)
    level_deadline_floor: float = 0.0
    level_deadline_slack: float = 8.0

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(f"pipeline={self.pipeline!r} must be one of "
                             f"{PIPELINES}")
        if self.candgen not in CANDGENS:
            raise ValueError(f"candgen={self.candgen!r} must be one of "
                             f"{CANDGENS}")
        if self.n_partitions < 1:
            raise ValueError(
                f"n_partitions={self.n_partitions} must be >= 1")
        if self.reduce is None:
            self.reduce = ("psum" if self.pipeline == "legacy"
                           else "reduce_scatter")
        if self.reduce not in ("psum", "reduce_scatter"):
            raise ValueError(f"reduce={self.reduce!r} must be 'psum' or "
                             f"'reduce_scatter'")
        if self.packed_support and self.pipeline == "legacy":
            raise ValueError(
                "packed_support=True is unavailable on pipeline='legacy' — "
                "the legacy pipeline stays dense as the differential oracle")
        if self.pipeline == "device_loop":
            if self.max_size is None:
                raise ValueError(
                    "pipeline='device_loop' needs a finite max_size — the "
                    "while_loop carry (codes, OL store, run outputs) is "
                    "shaped by the run's maximum pattern size")
            if not self.bucket_shapes:
                raise ValueError(
                    "pipeline='device_loop' requires bucket_shapes=True — "
                    "its static budgets are sized in the bucket families")
            if not self.escalate_on_overflow:
                raise ValueError(
                    "pipeline='device_loop' requires escalate_on_overflow "
                    "— the loop mines at one uniform M and reruns doubled "
                    "on overflow, matching only the exact (escalated) "
                    "host semantics")
        if self.level_deadline_slack < 1.0:
            raise ValueError(
                f"level_deadline_slack={self.level_deadline_slack} must "
                f"be >= 1 — a sub-unit slack trips on every level")
        if self.pipeline == "device_loop" or self.candgen == "device":
            # device candgen makes host speculation structurally
            # impossible mid-loop — disable it statically (satellite:
            # the cost gate is bypassed, no PendingLevel speculation)
            self.overlap_candgen = False


@dataclasses.dataclass
class LevelStats:
    level: int
    n_candidates: int
    n_frequent: int
    overflow: int
    seconds: float
    map_seconds: float
    rebalanced: bool
    imbalance: float                    # max/mean partition embed-count
    escalations: int = 0                # M-cap doublings the valve performed
    # host candgen seconds for the NEXT level, spent in the shadow of
    # this level's in-flight device program (0.0 when not overlapped)
    candgen_seconds: float = 0.0
    survivor_cap: int = 0               # S the level program compacted into
    retried: bool = False               # level took a materialize-only retry
    audit: int = 0                      # device audit word (0 = checks held)


@dataclasses.dataclass
class DistMiningResult:
    levels: list[list[Code]]
    supports: dict[Code, int]
    stats: list[LevelStats]
    alphabet: EdgeAlphabet
    minsup: int
    total_overflow: int

    @property
    def frequent(self) -> dict[Code, int]:
        return self.supports

    def counts(self) -> list[int]:
        return [len(l) for l in self.levels]


@dataclasses.dataclass
class PartialResult:
    """A verified *prefix* of the full answer (anytime contract, §14).

    MIRAGE's level-synchronous loop makes every completed level a
    complete, valid answer to "all frequent subgraphs up to size k" —
    so when the supervisor's retry budget or the run deadline is
    exhausted, it cuts here: the frequent set through the newest intact
    *audited* checkpoint, re-verified by
    :func:`~repro_torch.core.auditor.audit_frequent_set` before it is
    trusted.  ``complete`` is always False (the marker callers branch
    on); ``audited`` is False only for the trivially valid empty prefix
    (no surviving checkpoint)."""

    levels: list[list[Code]]
    supports: dict[Code, int]
    minsup: Optional[int]
    last_level: int                     # deepest audited complete level
    reason: str                         # "deadline" | "budget-exhausted"
    audited: bool
    complete: bool = False
    events: list[dict] = dataclasses.field(default_factory=list)

    @property
    def frequent(self) -> dict[Code, int]:
        return self.supports

    def counts(self) -> list[int]:
        return [len(l) for l in self.levels]


def decode_saved_levels(state: dict) -> tuple[list[list[Code]],
                                              dict[Code, int]]:
    """Decode a checkpoint's (levels, supports) arrays back into codes —
    shared by resume and the supervisor's partial-result cut."""
    levels = [[array_to_code(a) for a in lvl] for lvl in state["levels"]]
    supports = {array_to_code(a): int(s) for a, s in
                zip(state["support_codes"], state["support_vals"])}
    return levels, supports




@dataclasses.dataclass
class _LevelOutcome:
    """What one mined level hands back to the driver loop."""

    gsup: np.ndarray            # (C,) global supports, canonical order
    keep: np.ndarray            # survivor candidate indices
    pol: torch.Tensor           # next-level OL store (compact survivors)
    pmask: torch.Tensor
    src: torch.Tensor           # edge store (permuted when rebalanced)
    dst: torch.Tensor
    emask: torch.Tensor
    overflow: int
    max_embeddings: int         # M after any escalation
    rebalanced: bool
    imbalance: float
    perm: Optional[np.ndarray]  # applied partition permutation (or None)
    map_seconds: float
    escalations: int
    retried: bool = False       # level took a materialize-only retry
    survivor_cap: int = 0       # S the level program was dispatched with
    # candidates for the NEXT level, speculatively generated from ALL of
    # this level's candidates while the device work was in flight (None =
    # not speculated — regenerate from F_{k+1} as usual)
    spec_cands: Optional[list[Candidate]] = None
    candgen_seconds: float = 0.0
    audit: int = 0              # device audit word from the wire


class Mirage:
    """The miner.  ``device=None`` runs on the mesh's device, else on the
    CUDA device, and raises when there is none; ``device="cpu"`` runs
    the plain PyTorch versions of the kernels (the tests do).
    ``mesh=None`` is the one-worker mesh; a multi-worker mesh
    (``MiningMesh.from_process_group``) runs one worker per rank, every
    rank calling ``fit`` on the same graphs and config."""

    def __init__(self, config: MirageConfig,
                 mesh: Optional[MiningMesh] = None,
                 device: Optional[torch.device | str] = None):
        check_backend(config.backend)
        self.mesh = mesh or MiningMesh.single_device()
        if self.mesh.device is not None:
            if device is not None and torch.device(device) != self.mesh.device:
                raise ValueError(f"device {device} differs from the mesh's "
                                 f"device {self.mesh.device}")
            device = self.mesh.device
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "repro_torch.Mirage runs on a CUDA device and none is "
                    "available; pass device='cpu' to run the plain PyTorch "
                    "versions of the kernels on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA "
                               f"is not available")
        self.cfg = config
        self.backend: Backend = config.backend or default_backend(self.device)
        # introspection for the last device-loop run: {"completed": bool,
        # "fallback": Optional[str], ...}; None until a device_loop fit
        # has executed
        self.last_device_loop: Optional[dict] = None
        # per-run invariant auditor (§14); rebuilt by each fit()
        self.auditor: Optional[Auditor] = None
        self._watchdog: Optional[Watchdog] = None
        self._ckpt_meta: dict = {}
        if config.n_partitions % self.mesh.n_workers:
            raise ValueError(
                f"n_partitions={config.n_partitions} must be a multiple of "
                f"the worker count {self.mesh.n_workers}")

    # ------------------------------------------------------------------
    def _effective_partitions(self, n_graphs: int) -> int:
        """Clamp n_partitions to the database size (a partition with no
        graphs would silently pad) while staying a multiple of the
        worker count."""
        cfg, W = self.cfg, self.mesh.n_workers
        if n_graphs == 0 or cfg.n_partitions <= n_graphs:
            return cfg.n_partitions
        clamped = max(W, n_graphs - n_graphs % W)
        if clamped > n_graphs:
            raise ValueError(
                f"database has {n_graphs} graphs but the mesh has {W} "
                f"workers — need at least one graph per worker")
        return clamped

    # ------------------------------------------------------------------
    def fit(self, graphs: Sequence[Graph], *, resume: bool = False,
            watchdog: Optional[Watchdog] = None,
            deadline_s: Optional[float] = None) -> DistMiningResult:
        """Mine ``graphs``.  ``watchdog`` (or one built from
        ``deadline_s`` and the config's phase-deadline knobs) bounds the
        run: its run deadline raises ``DeadlineExceeded`` at a loop head,
        and a phase deadline is armed around every level.  With several
        ranks, either every rank's watchdog has a run deadline or none
        has: the ranks agree on its expiry in a collective.  With tracing
        on (``runtime/trace.py``) the call is the span ``fit``."""
        with trace.span("fit"):
            return self._fit(graphs, resume, watchdog, deadline_s)

    def _fit(self, graphs: Sequence[Graph], resume: bool,
             watchdog: Optional[Watchdog],
             deadline_s: Optional[float]) -> DistMiningResult:
        cfg = self.cfg

        # peek the checkpoint first: the partition count is baked into
        # the saved OL store
        resume_state = resume_meta = None
        if resume and cfg.checkpoint_dir:
            resume_state, resume_meta = self._load_checkpoint()

        # ---- phase 1: partition (host) --------------------------------
        if resume_state is not None:
            n_parts = int(resume_state["pol"].shape[0])
            if n_parts % self.mesh.n_workers:
                raise ValueError(
                    f"checkpoint holds {n_parts} partitions, not a "
                    f"multiple of the current worker count "
                    f"{self.mesh.n_workers} — resume on a compatible mesh")
        else:
            n_parts = self._effective_partitions(len(graphs))
        part = make_partitions(graphs, cfg.minsup, n_parts,
                               scheme=cfg.scheme)
        alphabet, minsup = part.alphabet, part.minsup
        triples = sorted({t for c in alphabet.canonical()
                          for t in (c, (c[2], c[1], c[0]))})
        if not triples:
            return DistMiningResult([], {}, [], alphabet, minsup, 0)

        # ---- §14 run plumbing: auditor + deadline watchdog -------------
        n_graphs = part.n_graphs
        self.auditor = (Auditor(minsup=minsup, n_graphs=n_graphs,
                                samples=cfg.audit_samples)
                        if cfg.audit else None)
        wd = watchdog
        if wd is None and deadline_s is not None:
            wd = Watchdog(deadline_s,
                          phase_floor=cfg.level_deadline_floor,
                          phase_slack=cfg.level_deadline_slack)
        self._watchdog = wd
        if wd is not None:
            wd.start()
        # the run deadline of a multi-rank single-sync run rides the
        # survivor-cap agreement that precedes each dispatch wherever the
        # device reports its free memory (CUDA)
        fold_deadline = (self.mesh.n_workers > 1
                         and cfg.pipeline != "legacy"
                         and self._free_device_bytes() is not None)
        self._ckpt_meta = {"audited": bool(cfg.audit),
                           "minsup": int(minsup),
                           "n_graphs": int(n_graphs)}

        # ---- phase 2: preparation (host, once) -------------------------
        G = max((len(p) for p in part.partitions), default=1)
        with trace.span("prep.edge_ol"):
            eols = [build_edge_ol(p, triples, pad_graphs=G,
                                  max_occ=cfg.max_occ)
                    for p in part.partitions]
            with trace.span("prep.edge_ol.stack"):
                F = max(e.src.shape[-1] for e in eols)
                # (NP, T, G, F)
                src = np.stack([_pad_f(e.src, F, -1) for e in eols])
                dst = np.stack([_pad_f(e.dst, F, -1) for e in eols])
                emask = np.stack([_pad_f(e.mask, F, False) for e in eols])
        eol0 = eols[0]   # triple_index identical across partitions

        codes = [((0, 1, a, e, b),) for (a, e, b) in alphabet.canonical()]
        # level-1 embeddings/graph are bounded by F (the edge-OL width), so
        # M1 = F is exact by construction — no silent truncation at level 1.
        bk = self._buckets()
        M1 = max(cfg.max_embeddings, F)
        if bk is not None:
            M1 = bk.embeddings(M1, cfg.max_embeddings)
        with trace.span("prep.level1"):
            lvl1 = [level1_ol(codes, e, max_embeddings=M1) for e in eols]
            # (NP, P, G, M, 2)
            pol = np.stack([l.ol.numpy() for l in lvl1])
            pmask = np.stack([l.mask.numpy() for l in lvl1])
            del lvl1
            if bk is not None:
                # bucket the level-1 store into the (P, K) family the
                # child stores live in
                pol, pmask = _pad_store(
                    pol, pmask, p_to=bucket_size(len(codes), bk.s_floor),
                    k_to=bk.vertex_slots(2))

            supports: dict[Code, int] = {}
            with trace.span("prep.level1.supports"):
                for c in codes:
                    ti = eol0.triple_index[c[0][2:]]
                    supports[c] = int(emask[:, ti].any(axis=-1).sum())
        levels: list[list[Code]] = [list(codes)]
        stats: list[LevelStats] = []
        total_overflow = 0
        start_level = 1
        M = cfg.max_embeddings

        # ---- resume -----------------------------------------------------
        if resume_state is not None:
            state = resume_state
            levels, supports = decode_saved_levels(state)
            pol, pmask = state["pol"], state["pmask"]
            start_level = int(resume_meta["step"])
            M = int(state["max_embeddings"])
            total_overflow = int(state["total_overflow"])
            # checkpoints store the CANONICAL (unpadded) survivor store;
            # re-bucket it into the CURRENT config's family
            pol, pmask = self._repad_saved(pol, pmask)

        # this rank's block of the canonical partition order
        blk = partition_block(n_parts, self.mesh.rank, self.mesh.n_workers)
        with trace.span("prep.upload"):
            pol, pmask, src_d, dst_d, emask_d = (
                torch.from_numpy(np.ascontiguousarray(x[blk])).to(self.device)
                for x in (pol, pmask, src, dst, emask))
        del src, dst
        # cumulative partition permutation from straggler rebalancing;
        # checkpoints hold the store in CANONICAL order, so a resumed run
        # (which rebuilds the edge store canonically) stays aligned
        order = np.arange(n_parts)

        # per-level (n_parents, n_candidates, n_keep) history drives the
        # next level's compaction cap from the measured per-parent fanout
        history: list[tuple[int, int, int]] = []
        # bit-packed support path: the 2x-uint16 wire slice needs every
        # global support to fit uint16 — supports are bounded by |G|
        packed = self._packed_support(part.n_graphs)
        # fused tile_c, pinned ONCE per run from the level-2 candidate
        # grouping
        tile_pin: Optional[int] = None

        # ---- device-resident whole-run loop (DESIGN.md §13) ------------
        if cfg.pipeline == "device_loop" and start_level < cfg.max_size:
            try:
                return self._mine_device_loop(
                    alphabet, minsup, triples, eol0, levels, supports,
                    pol, pmask, src_d, dst_d, emask_d, packed=packed,
                    start_k=start_level, total_overflow=total_overflow,
                    order=order)
            except dloop.DeviceLoopFallback as bail:
                # a static budget tripped (or the M valve hit its
                # ceiling): replay the run through the per-level
                # pipeline below — it has no static budgets and mines
                # the identical frequent set
                self.last_device_loop = {"completed": False,
                                         "fallback": str(bail),
                                         "chunks": 0, "escalations": 0}

        # ---- phase 3: iterative mining ---------------------------------
        k = start_level
        # overlapped candgen (DESIGN.md §11): each level speculatively
        # generates the NEXT level's candidates while its device work is
        # in flight; the narrowed result carries over here
        cands: Optional[list[Candidate]] = None
        # speculation cost gate inputs: EWMA per-parent candgen rate and
        # the last level's device-only seconds
        cand_rate: Optional[float] = None
        prev_dev = 0.0
        while cfg.max_size is None or k < cfg.max_size:
            with trace.span("level", k=k + 1) as lv:
                t0 = time.perf_counter()
                expired = False
                if wd is not None and wd.run_deadline_s is not None:
                    # cooperative run-deadline check at the loop head — the
                    # only place a DeadlineExceeded can safely unwind from
                    if fold_deadline:
                        expired = wd.run_expired
                    else:
                        self._check_deadline(k + 1, wd.run_expired)
                if cands is None and cfg.candgen == "device":
                    # the stepping-stone device candgen: one
                    # device_candidates run instead of the host generator
                    # (None = a per-level budget overflow → the host
                    # generator for this level)
                    cands = self._device_candgen(levels[-1], triples)
                if cands is None:
                    with trace.span("level.candgen"):
                        cands = generate_candidates(levels[-1], alphabet)
                    if levels[-1]:
                        r = (time.perf_counter() - t0) / len(levels[-1])
                        cand_rate = (r if cand_rate is None
                                     else 0.5 * (cand_rate + r))
                if not cands:
                    lv.set(C=0)
                    break
                # chaos hook: a scheduled worker death at this level
                faults.maybe_raise("level_start", k + 1)
                n_parents = len(levels[-1])
                with trace.span("level.meta"):
                    meta = candidate_meta(cands, eol0)
                    C = meta.shape[0]
                    Cp = (bk.candidates(C, self.mesh.n_workers)
                          if bk is not None
                          else round_up_multiple(C, self.mesh.n_workers))
                    meta_p = np.concatenate(
                        [meta, np.tile([[0, 0, 0, 1, 0]], (Cp - C, 1))]
                    ).astype(np.int32)

                # parent supports for the device audit word (§14), one int32
                # per parent pattern (-1 = unknown)
                # (the legacy pipeline computes no audit word)
                psup = None
                if cfg.audit and cfg.pipeline != "legacy":
                    psup = np.array(
                        [supports.get(p, -1) for p in levels[-1]], np.int32)
                if wd is not None:
                    # arm the phase deadline around the device work — the
                    # stretch a hang would otherwise block unobserved
                    wd.arm(level=k + 1)

                if cfg.pipeline == "legacy":
                    out = self._level_legacy(
                        meta_p, meta, C, pol, pmask, src_d, dst_d, emask_d,
                        minsup, M, n_parts, level=k + 1)
                else:
                    # child patterns (size k+1) have at most k+2 vertices;
                    # the bucketed width reuses the parent store's while
                    # it fits
                    child_width = (bk.vertex_slots(k + 2,
                                                   int(pol.shape[-1]))
                                   if bk is not None else None)
                    if (tile_pin is None and bk is not None
                            and is_fused_backend(self.backend)):
                        # level 2 is the widest, most parent-diverse
                        # grouping the run will see; later levels reuse
                        # its tile width
                        tile_pin = schedule_candidates(meta).tile_c
                    out = self._level_single_sync(
                        meta_p, meta, C, pol, pmask, src_d, dst_d, emask_d,
                        minsup, M, history, child_width, level=k + 1,
                        packed=packed, tile_c=tile_pin, cands=cands,
                        alphabet=alphabet, cand_rate=cand_rate,
                        spec_window=max(prev_dev, cfg.overlap_spec_window),
                        psup=psup, n_graphs=n_graphs, expired=expired)
                lv.set(C=C, S=out.survivor_cap, n_keep=len(out.keep),
                       retried=out.retried, escalations=out.escalations)
                if wd is not None:
                    # feed the level's wall-time into the EWMA the next
                    # phase deadline is derived from
                    wd.disarm(observe_s=time.perf_counter() - t0)
                if self.auditor is not None:
                    with trace.span("level.audit"):
                        self.auditor.check_wire(k + 1, out.audit)
                        if len(out.keep):
                            self.auditor.check_level(
                                k + 1, cands=cands, keep=out.keep,
                                gsup=out.gsup, parents=levels[-1],
                                supports=supports)
                prev_dev = max(out.map_seconds - out.candgen_seconds, 0.0)
                if out.spec_cands is not None and cands:
                    r = out.candgen_seconds / len(cands)
                    cand_rate = (r if cand_rate is None
                                 else 0.5 * (cand_rate + r))
                M = out.max_embeddings
                total_overflow += out.overflow

                if len(out.keep) == 0:
                    stats.append(LevelStats(k + 1, C, 0, out.overflow,
                                            time.perf_counter() - t0,
                                            out.map_seconds, False,
                                            out.imbalance, out.escalations,
                                            out.candgen_seconds,
                                            survivor_cap=out.survivor_cap,
                                            retried=out.retried,
                                            audit=out.audit))
                    break

                pol, pmask = out.pol, out.pmask
                src_d, dst_d, emask_d = out.src, out.dst, out.emask
                levels.append([cands[i].code for i in out.keep])
                for i in out.keep:
                    supports[cands[i].code] = int(out.gsup[i])
                if out.perm is not None:
                    order = order[out.perm]
                history.append((n_parents, C, len(out.keep)))

                stats.append(LevelStats(k + 1, C, len(out.keep),
                                        out.overflow,
                                        time.perf_counter() - t0,
                                        out.map_seconds, out.rebalanced,
                                        out.imbalance, out.escalations,
                                        out.candgen_seconds,
                                        survivor_cap=out.survivor_cap,
                                        retried=out.retried, audit=out.audit))

                if cfg.checkpoint_dir:
                    self._save(cfg.checkpoint_dir, k + 1, levels, supports,
                               pol, pmask, M, total_overflow, order)
                # narrow this level's speculative superset to the surviving
                # parents — provably equal to generate_candidates(F_{k+1})
                cands = (filter_speculative(out.spec_cands, out.keep)
                         if out.spec_cands is not None else None)
                k += 1

        return DistMiningResult(levels, supports, stats, alphabet, minsup,
                                total_overflow)

    # the paper's verb; the supervisor wraps this entrypoint
    mine = fit

    # ------------------------------------------------------------------
    def _check_deadline(self, level: int, expired: bool) -> None:
        """Raise ``DeadlineExceeded`` when the run deadline has passed —
        on one rank, its own reading; with several, the ranks agree with
        one small all-reduce (any expired rank stops them all), so every
        rank raises at the same loop head."""
        if self.mesh.n_workers > 1:
            flag = torch.tensor([int(expired)], dtype=torch.int64,
                                device=self.device)
            expired = bool(int(self.mesh.all_reduce(flag,
                                                    dist.ReduceOp.MAX)))
        if expired:
            raise self._deadline_error(level)

    def _deadline_error(self, level: int) -> faults.DeadlineExceeded:
        wd = self._watchdog
        return faults.DeadlineExceeded(level, wd.elapsed(),
                                       float(wd.run_deadline_s))

    def _stall_hook(self, level: Optional[int],
                    point: str = "dispatch") -> None:
        """The chaos hook of an injected stall while the level's (or,
        ``point="chunk"``, the device loop's chunk's) device work is in
        flight; the watchdog's armed phase deadline is what bounds it.
        A stall fires on every rank at once, but whether the
        watchdog caught it is a clock reading: the ranks that stalled
        agree on it with one all-reduce, so that they all raise
        ``HangTimeout`` or all go on.  A level with no stall pays
        nothing."""
        err = None
        try:
            fired = faults.maybe_hang(point, level, self._watchdog)
        except faults.HangTimeout as exc:
            fired, err = True, exc
        if fired and self.mesh.n_workers > 1:
            flag = torch.tensor([int(err is not None)], dtype=torch.int64,
                                device=self.device)
            if int(self.mesh.all_reduce(flag, dist.ReduceOp.MAX)) and (
                    err is None):
                err = faults.HangTimeout(level, 0.0)
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    def _load_checkpoint(self):
        """The newest intact checkpoint as ``(state, metadata)``, or
        ``(None, None)``.  Rank 0 reads first (reaping any corrupt or
        unfinished step it meets), then the other ranks read what it
        left, so that every rank resumes from the same step."""
        root = self.cfg.checkpoint_dir

        def read():
            if not ckpt.latest_step(root):
                return None, None
            try:
                return ckpt.load_step(root)
            except FileNotFoundError:
                # every on-disk step failed integrity verification and
                # was reaped — a fresh start is the only sound option
                return None, None

        if self.mesh.rank == 0:
            found = read()
        self.mesh.barrier()
        if self.mesh.rank != 0:
            found = read()
        return found

    # ------------------------------------------------------------------
    def _repad_saved(self, pol, pmask):
        """Re-bucket a checkpoint's canonical (padding-stripped) survivor
        store into the CURRENT config's shape family.  No-op without
        bucketing."""
        bk = self._buckets()
        if bk is None:
            return pol, pmask
        return _pad_store(
            pol, pmask,
            p_to=bucket_size(pol.shape[1], bk.s_floor),
            m_to=bk.embeddings(pol.shape[3], self.cfg.max_embeddings),
            k_to=bk.vertex_slots(pol.shape[-1]))

    # ------------------------------------------------------------------
    def _sharded_wire(self) -> bool:
        """The sharded-wire tri-state: explicit config wins; auto means on
        whenever the reduce_scatter shuffle runs (at one worker the
        sharded layout is the dense one).  The device-loop pipeline never
        shards: its wire is the one replicated run wire, and a fallback
        run through the level program uses the dense layout."""
        cfg = self.cfg
        if cfg.pipeline != "single_sync":
            return False
        if cfg.sharded_wire is not None:
            return cfg.sharded_wire
        return cfg.reduce == "reduce_scatter"

    # ------------------------------------------------------------------
    def _packed_support(self, n_graphs: int) -> bool:
        """The packed-support tri-state: explicit config wins; auto means
        on for the single-sync and device-loop pipelines (the legacy
        pipeline stays dense).  Either way packing additionally requires
        every global support to fit uint16 (the wire ships 2 supports per
        32-bit word) — supports are bounded by the database's graph
        count."""
        cfg = self.cfg
        if cfg.pipeline not in ("single_sync", "device_loop"):
            return False
        on = (cfg.packed_support if cfg.packed_support is not None
              else True)
        return bool(on) and n_graphs < (1 << 16)

    # ------------------------------------------------------------------
    def _buckets(self) -> Optional[BucketSpec]:
        """The run's shape-bucket family, or None when bucketing is off.
        The legacy pipeline never buckets: it is the differential oracle
        and stays as the JAX package runs it."""
        cfg = self.cfg
        if (not cfg.bucket_shapes
                or cfg.pipeline not in ("single_sync", "device_loop")):
            return None
        return BucketSpec(cfg.bucket_c_floor, cfg.bucket_s_floor,
                          cfg.bucket_k_floor)

    # ------------------------------------------------------------------
    def _survivor_cap(self, C: int, Cp: int,
                      history: list[tuple[int, int, int]]) -> int:
        """Static survivor cap for the level program's compaction stage
        (the JAX package's policy): predict the next survivor count from
        the previous level's measured per-parent fanout — ``keep_prev /
        parents_prev`` survivors per parent times the ``keep_prev``
        parents this level mines from, scaled by the configured slack —
        or a quarter of the candidate space when there is no history
        yet.  Bucketed, the prediction is rounded to the S family and
        clamped at the (bucketed) Cp ceiling.  A miss costs one
        materialize-only retry."""
        bk = self._buckets()
        if not self.cfg.predict_survivors:
            # no prediction = no cap miss allowed: S must cover every
            # real candidate
            return Cp if bk is None else bk.survivors(C, Cp)
        if not history:
            s = min(Cp, max(32, -(-Cp // 4)))
        else:
            parents_prev, _cands_prev, keep_prev = history[-1]
            fanout = keep_prev / max(parents_prev, 1)
            pred = self.cfg.survivor_slack * fanout * max(keep_prev, 1)
            # n_keep <= C always, so C is a sound extra clamp
            s = min(Cp, C, max(1, int(np.ceil(pred)) + 16))
        if bk is not None:
            s = bk.survivors(s, Cp)
        return s

    # ------------------------------------------------------------------
    def _free_device_bytes(self) -> Optional[int]:
        """Bytes a new store may take on the device now: the driver's
        free memory plus the caching allocator's unused blocks.  None on
        the CPU, where stores are not clamped."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + (torch.cuda.memory_reserved(self.device)
                       - torch.cuda.memory_allocated(self.device))

    def _memory_cap(self, S: int, pol: torch.Tensor, max_embeddings: int,
                    child_width: Optional[int], *, level: int = -1,
                    expired: bool = False) -> int:
        """The survivor cap, clamped by :func:`memory_survivor_cap` to
        what the device holds now (no clamp on the CPU).  The ranks that
        share a device split what it has free, and the ranks take the
        smallest clamp of any of them: a cap that differed between ranks
        would give their level programs different shapes.  ``expired``
        (this rank's run-deadline reading) rides the same all-reduce:
        when any rank's deadline has passed, every rank raises
        ``DeadlineExceeded`` here, before the dispatch."""
        free = self._free_device_bytes()
        if free is None:
            return S
        NP, _, G, _, K = pol.shape
        width = child_width if child_width is not None else K + 1
        S = memory_survivor_cap(
            S, NP * G * max_embeddings * (4 * width + 1),
            free // self.mesh.ranks_per_device, self._buckets())
        if self.mesh.n_workers > 1:
            agreed = torch.tensor([S, int(not expired)], dtype=torch.int64,
                                  device=self.device)
            S, live = self.mesh.all_reduce(agreed,
                                           dist.ReduceOp.MIN).tolist()
            if not live:
                raise self._deadline_error(level)
        return S

    def _retry_free_bytes(self) -> Optional[int]:
        """Bytes this rank's share of the device has free for the store
        of an exact retry, read after the discarded store was released;
        None on the CPU, where stores take host memory."""
        if self.device.type != "cuda":
            return None
        return self._free_device_bytes() // self.mesh.ranks_per_device

    # ------------------------------------------------------------------
    def _device_candgen(self, parents: list[Code],
                        triples: list[tuple[int, int, int]]
                        ) -> Optional[list[Candidate]]:
        """Per-level device candidate generation (candgen="device"): one
        ``device_candidates`` run on the miner's device replaces the
        host generator, returning the SAME candidates in the SAME order.
        Budgets default to the exact structural bound — overflow is then
        impossible unless the config pins them tighter; any tripped flag
        returns None and the caller regenerates on host for this level
        only.  This stepping stone reads its results back per level."""
        cfg = self.cfg
        SP = len(parents)
        if SP == 0:
            return []
        Lk = len(parents[0]) + 1            # child edge count
        NV = Lk + 1                         # child vertex bound
        T = len(triples)
        raw_b = cfg.device_raw_budget or SP * (2 * NV - 1) * T
        budget = cfg.device_c_budget or raw_b
        generate = device_candgen(Lk, NV, raw_b, budget,
                                  cfg.device_max_states)
        codes = np.full((SP, Lk, 5), -1, np.int32)
        for i, c in enumerate(parents):
            codes[i] = code_to_array(c, Lk)
        meta, child, n_cand, flags = generate(
            upload(codes, self.device), SP,
            upload(np.asarray(triples, np.int32), self.device))
        if bool(flags.any()):
            return None
        return candidates_from_arrays(meta.cpu().numpy(),
                                      child.cpu().numpy(), int(n_cand),
                                      triples)

    # ------------------------------------------------------------------
    def _decode_device_run(self, rw: "dloop.RunWire", levels0, supports0,
                           start_k: int):
        """Decode a run wire into (levels, supports, stat rows) with the
        host loop's exact stopping semantics: an empty candidate set
        stops BEFORE its stats row (the host breaks at the loop head),
        an empty frequent set stops AFTER it."""
        levels = [list(l) for l in levels0]
        sups = dict(supports0)
        rows: list[tuple[int, int, int, int, float]] = []
        for s in range(start_k - 1, rw.k_final - 1):
            n_cand, n_keep, ovf, imb_fx = (int(x) for x in rw.stats[s, :4])
            if n_cand == 0:
                break
            rows.append((s + 2, n_cand, n_keep, ovf, imb_fx / _IMBAL_FX))
            if n_keep == 0:
                break
            lvl = [array_to_code(rw.codes[s, i]) for i in range(n_keep)]
            levels.append(lvl)
            for i, c in enumerate(lvl):
                sups[c] = int(rw.sups[s, i])
        return levels, sups, rows

    # ------------------------------------------------------------------
    def _device_loop_slots(self, spp: int, n_par0: int, pol: torch.Tensor,
                           max_embeddings: int, n_vertex_slots: int, *,
                           level: int) -> int:
        """The device loop's parent/survivor slot count: ``spp`` (the
        JAX package's) clamped so that the parent and child carry stores,
        (PP, SPP, G, M, NV) each, take at most ``_STORE_MEMORY_SHARE`` of
        the memory this rank's share of the device has free (no clamp on
        the CPU).  The ranks take the smallest clamp of any of them, so
        that their programs keep one shape.  When not even the start
        level's ``n_par0`` parents fit, ``DeviceMemoryError`` is raised
        before anything is allocated."""
        free = self._free_device_bytes()
        if free is None:
            return spp
        free //= self.mesh.ranks_per_device
        PP, _, G = pol.shape[:3]
        pair = 2 * PP * G * max_embeddings * (4 * n_vertex_slots + 1)
        S = memory_survivor_cap(spp, pair, free, None)
        if self.mesh.n_workers > 1:
            agreed = torch.tensor([S], dtype=torch.int64, device=self.device)
            S = int(self.mesh.all_reduce(agreed, dist.ReduceOp.MIN))
        if S < n_par0:
            raise DeviceMemoryError(level, n_par0, pair * n_par0, free)
        return S

    # ------------------------------------------------------------------
    def _mine_device_loop(self, alphabet, minsup, triples, eol0, levels0,
                          supports0, pol, pmask, src, dst, emask, *,
                          packed: bool, start_k: int, total_overflow: int,
                          order: np.ndarray) -> DistMiningResult:
        """The whole run queued on the device (``core/device_loop.py``,
        DESIGN.md §13).

        Candidate generation, schedule, support counting, survivor
        compaction and child materialization all stay on device for
        every level; the host reads exactly ONE run wire per chunk (plus
        the store at the optional checkpoint-chunk boundaries).  Static
        budgets are sized once from a single host candidate generation at
        the start level — the ONLY host candgen of a completed run; a
        budget overflow mid-run trips a bail flag and this method raises
        :class:`~.device_loop.DeviceLoopFallback` so the caller replays
        through the per-level pipeline.

        The exactness valve works at run granularity: the loop mines at
        one uniform embedding cap M (the carry shape); an overflowing
        run doubles M and reruns the whole program from the base store —
        pre-overflow levels are bit-identical at the larger M, so the
        rerun converges to the exact escalated host semantics.  On the
        card the slot count SPP is clamped to the free memory after each
        doubling (``_device_loop_slots``)."""
        cfg = self.cfg
        bk = self._buckets()
        W = self.mesh.n_workers
        backend = self.backend
        t0 = time.perf_counter()
        L = cfg.max_size
        NL = L - 1
        NV = bk.vertex_slots(L + 1)

        # ---- static budgets from one host generation ------------------
        base = generate_candidates(levels0[-1], alphabet)
        if not base:
            return DistMiningResult(levels0, supports0, [], alphabet,
                                    minsup, total_overflow)
        meta0 = candidate_meta(base, eol0)
        C0 = meta0.shape[0]
        CB = round_up_multiple(cfg.device_c_budget
                               or bk.candidates(4 * C0, W), W)
        CBR = cfg.device_raw_budget or 4 * CB
        n_par0 = len(levels0[-1])
        spp_full = max(bucket_size(n_par0, bk.s_floor), CB)
        tile_c, ROWS = 1, CB
        if is_fused_backend(backend):
            sched0 = schedule_candidates(meta0)
            tile_c = sched0.tile_c
            ROWS = round_up_multiple(
                bucket_size(max(2 * sched0.meta.shape[0], CB), bk.c_floor),
                tile_c)

        prog = dloop._run_program(
            self.mesh, minsup, backend, cfg.reduce, packed, L, NV, CB,
            CBR, cfg.device_max_states, NL, tile_c, ROWS, len(triples))
        trip = upload(np.asarray(triples, np.int32), self.device)
        M_run = int(pol.shape[3])
        cadence = ckpt.ChunkCadence(start_k, L,
                                    cfg.device_loop_ckpt_every)
        step = cfg.device_loop_unroll
        escalations = chunks = 0
        wd = self._watchdog
        while True:                 # run-granular escalation valve
            SPP = self._device_loop_slots(spp_full, n_par0, pol, M_run, NV,
                                          level=start_k + 1)
            codes_h = np.full((SPP, L, 5), -1, np.int32)
            for i, c in enumerate(levels0[-1]):
                codes_h[i] = code_to_array(c, L)
            pol0, pmask0 = _pad_store(
                pol[:, :SPP].contiguous(), pmask[:, :SPP].contiguous(),
                p_to=SPP, m_to=M_run, k_to=NV)
            carry = dloop.init_carry(start_k, codes_h, pol0, pmask0, NL)
            del pol0, pmask0
            k_cur, escalate = start_k, False
            for k_stop in cadence.boundaries():
                if wd is not None:
                    # each chunk doubles as a heartbeat: the run deadline
                    # is checked here, and the phase deadline re-arms
                    # over the coming chunk
                    if wd.run_deadline_s is not None:
                        self._check_deadline(k_stop, wd.run_expired)
                    wd.arm(level=k_stop)
                t_chunk = time.perf_counter()
                for lv in range(k_cur + 1, k_stop + 1):
                    # chaos hooks, fired host-side per window level so
                    # fault schedules hit device-loop runs too
                    faults.maybe_raise("level_start", lv)
                    faults.maybe_raise("kernel", lv)
                per_call = step if step > 0 else k_stop - k_cur
                for k0 in range(k_cur, k_stop, per_call):
                    wire_d, carry = prog(carry, k0,
                                         min(per_call, k_stop - k0), trip,
                                         src, dst, emask)
                chunks += 1
                # chaos hook: a stalled chunk — the armed phase deadline
                # (and the device_loop→single_sync rung) bounds it
                self._stall_hook(k_stop, "chunk")
                # the chunk boundary's (only) host contact
                rw = dloop.decode_run_wire(fetch_wire(wire_d, level=k_stop),
                                           NL, SPP, L)
                del wire_d
                k_cur = k_stop
                if wd is not None:
                    wd.disarm(observe_s=time.perf_counter() - t_chunk)
                if not rw.ok or rw.n_par == 0:
                    break
                if (rw.total_overflow > 0
                        and M_run < cfg.max_embeddings_limit):
                    escalate = True
                    break
                if cfg.checkpoint_dir and k_cur < L:
                    levels, sups, _ = self._decode_device_run(
                        rw, levels0, supports0, start_k)
                    if self.auditor is not None:
                        # a boundary save is a potential partial-result
                        # cut point: audit the whole decoded prefix
                        # BEFORE it reaches disk as "audited"
                        self.auditor.check_levels(levels, sups)
                    self._save(cfg.checkpoint_dir, k_cur, levels, sups,
                               carry.pol, carry.pmask, M_run,
                               total_overflow + rw.total_overflow, order)
            if not escalate:
                break
            # release the run's stores before the next clamp reads the
            # free memory
            del carry
            M_run = min(M_run * 2, cfg.max_embeddings_limit)
            escalations += 1

        if not rw.ok:
            bad = int(np.bitwise_or.reduce(
                rw.stats[:, 4].astype(np.int64)))
            raise dloop.DeviceLoopFallback(
                f"device loop bailed at level {rw.k_final} "
                f"(flags=0b{bad:04b}: CB={CB} CBR={CBR} "
                f"states={cfg.device_max_states} rows={ROWS})"
                + (f"; survivors past the {SPP} memory-clamped slots"
                   if bad & dloop.FLAG_SLOT_OVF else ""))
        if rw.total_overflow > 0:
            raise dloop.DeviceLoopFallback(
                f"M-cap overflow {rw.total_overflow} persists at the "
                f"max_embeddings_limit={cfg.max_embeddings_limit} ceiling")

        levels, sups, rows = self._decode_device_run(
            rw, levels0, supports0, start_k)
        if self.auditor is not None:
            self.auditor.check_levels(levels, sups)
        tovf = total_overflow + rw.total_overflow
        elapsed = time.perf_counter() - t0
        per = elapsed / max(len(rows), 1)
        stats = [LevelStats(lv, nc, nk, ov, per, per, False, imb,
                            escalations if i == 0 else 0,
                            survivor_cap=SPP)
                 for i, (lv, nc, nk, ov, imb) in enumerate(rows)]
        if cfg.checkpoint_dir and rw.n_par > 0:
            # the carry store row-aligns with levels[-1] only when the
            # run ended WITH survivors; a zero-survivor tail keeps the
            # last boundary save instead
            self._save(cfg.checkpoint_dir, len(levels), levels, sups,
                       carry.pol, carry.pmask, M_run, tovf, order)
        self.last_device_loop = {
            "completed": True, "fallback": None, "chunks": chunks,
            "escalations": escalations, "c_budget": CB,
            "raw_budget": CBR, "sched_rows": ROWS, "spp": SPP,
            "max_embeddings": M_run, "n_levels": NL, "tile_c": tile_c,
        }
        return DistMiningResult(levels, sups, stats, alphabet, minsup,
                                tovf)

    # ------------------------------------------------------------------
    def _level_single_sync(self, meta_p, meta, C, pol, pmask, src, dst,
                           emask, minsup, M, history,
                           child_width: Optional[int] = None, *,
                           level: Optional[int] = None,
                           cands: Optional[list[Candidate]] = None,
                           alphabet: Optional[EdgeAlphabet] = None,
                           cand_rate: Optional[float] = None,
                           spec_window: Optional[float] = None,
                           packed: bool = False,
                           tile_c: Optional[int] = None,
                           psup: Optional[np.ndarray] = None,
                           n_graphs: int = -1,
                           expired: bool = False
                           ) -> _LevelOutcome:
        """One level: the device work is queued without a sync, the host
        speculates the next level's candidates while it runs (when the
        cost gate lets it: ``cand_rate`` seconds/parent × the superset
        size must fit ``spec_window``), then blocks once on the wire.

        Exceptional paths re-use the still-valid pass-1 supports and
        re-materialize from the preserved parents: a survivor-cap miss
        re-materializes the full survivor set, and the escalation valve
        re-materializes at a doubled M.  When the wire reports a
        rebalance, the child and edge stores move to their new ranks
        (``permute_stores``)."""
        cfg = self.cfg
        bk = self._buckets()
        Cp = meta_p.shape[0]
        S = self._survivor_cap(C, Cp, history)
        # chaos hook: a cap-miss storm forces a pathological cap, driving
        # every hit level through the materialize-only retry path
        S = faults.override_cap(S, level)
        S = self._memory_cap(S, pol, M, child_width, level=level,
                             expired=expired)
        t_map = time.perf_counter()
        with trace.span("level.dispatch"):
            pending = dispatch_level(
                self.mesh, meta_p, C, pol, pmask, src, dst, emask,
                minsup=minsup, backend=self.backend, reduce=cfg.reduce,
                max_embeddings=M, survivor_cap=S, rebalance=cfg.rebalance,
                threshold=cfg.rebalance_threshold, child_width=child_width,
                sched_floor=bk.c_floor if bk is not None else None,
                level=level, sharded=self._sharded_wire(),
                packed=packed, tile_c=tile_c, psup=psup, n_graphs=n_graphs)
        self._stall_hook(level)
        # the overlap window: the device work is in flight, the host is
        # free — speculate the next level's candidates now
        spec_cands = None
        cand_secs = 0.0
        if cfg.overlap_candgen and cands is not None and alphabet is not None:
            window = (cfg.overlap_spec_window if spec_window is None
                      else spec_window)
            est = (cand_rate or 0.0) * len(cands)
            trace.annotate("level", spec_est_s=est, spec_window_s=window,
                           spec_admitted=est <= window)
            if est <= window:
                t_cand = time.perf_counter()
                with trace.span("level.spec_candgen"):
                    spec_cands = generate_candidates(
                        [c.code for c in cands], alphabet)
                cand_secs = time.perf_counter() - t_cand
        with trace.span("level.wait"):
            out = pending.finish()
        w = out.wire
        map_secs = time.perf_counter() - t_map

        keep = np.flatnonzero(w.gsup >= minsup)
        n = int(w.n_keep)
        overflow = w.overflow
        escalations = 0
        if bk is None:
            # the kernels take contiguous stores
            new_pol = out.pol[:, :max(n, 1)].contiguous()
            new_pmask = out.pmask[:, :max(n, 1)].contiguous()
        else:
            # keep the full S-bucket arena so the next level's shapes
            # stay in the family
            new_pol, new_pmask = out.pol, out.pmask

        escalatable = (cfg.escalate_on_overflow
                       and M < cfg.max_embeddings_limit)
        retried = bool(n > 0 and (n > S or (overflow > 0 and escalatable)))
        # pass 2's slots that hold a survivor the next level keeps, and
        # those at or past the survivor count, which the kernel skipped
        trace.annotate("level.pass2", useful=0 if retried else min(n, S),
                       skipped=S - min(n, S))
        if retried:
            del out, new_pol, new_pmask     # release the discarded store
            with trace.span("level.retry") as sp:
                if overflow > 0 and escalatable:
                    # the level just proved M too small: skip the
                    # known-bad M before re-materializing
                    M = min(M * 2, cfg.max_embeddings_limit)
                    escalations += 1
                new_pol, new_pmask, overflow, M, esc = (
                    self._materialize_exact(
                        meta[keep], pol, pmask, src, dst, emask, M,
                        out_width=child_width, level=level))
                escalations += esc
                if bk is not None:
                    # re-bucket the retried store so the next level stays
                    # in the family
                    new_pol, new_pmask = _pad_store(
                        new_pol, new_pmask,
                        p_to=bk.survivors(len(keep), Cp))
                sp.set(materializations=esc + 1, M=M)

        rebalanced = w.rebalanced and n > 0
        if rebalanced:
            new_pol, new_pmask, src, dst, emask = permute_stores(
                self.mesh, w.perm, new_pol, new_pmask, src, dst, emask)

        return _LevelOutcome(
            gsup=w.gsup, keep=keep, pol=new_pol, pmask=new_pmask, src=src,
            dst=dst, emask=emask, overflow=overflow, max_embeddings=M,
            rebalanced=rebalanced, imbalance=w.imbalance,
            perm=w.perm if rebalanced else None, map_seconds=map_secs,
            escalations=escalations, retried=retried, survivor_cap=S,
            spec_cands=spec_cands, candgen_seconds=cand_secs,
            audit=int(w.audit))

    # ------------------------------------------------------------------
    def _level_legacy(self, meta_p, meta, C, pol, pmask, src, dst, emask,
                      minsup, M, n_parts, *,
                      level: Optional[int] = None) -> _LevelOutcome:
        """The legacy pipeline: separate support and materialize programs
        with host round trips between them (the keep list, the escalation
        loop, the straggler rebalance decided on the host from the
        gathered embed counts).  Kept as the differential oracle."""
        cfg = self.cfg
        t_map = time.perf_counter()
        gsup, verdict, emb_pp = map_reduce_supports(
            self.mesh, meta_p, pol, pmask, src, dst, emask, minsup=minsup,
            backend=self.backend, reduce=cfg.reduce)
        self._stall_hook(level)
        map_secs = time.perf_counter() - t_map

        keep = np.flatnonzero(verdict[:C] != 0)
        if len(keep) == 0:
            return _LevelOutcome(
                gsup=gsup[:C], keep=keep, pol=pol, pmask=pmask, src=src,
                dst=dst, emask=emask, overflow=0, max_embeddings=M,
                rebalanced=False, imbalance=1.0, perm=None,
                map_seconds=map_secs, escalations=0)
        new_pol, new_pmask, overflow, M, escalations = (
            self._materialize_exact(meta[keep], pol, pmask, src, dst,
                                    emask, M, level=level))

        # ---- straggler rebalance (cost signal: embed counts) -----------
        cost = emb_pp.reshape(n_parts, -1).sum(-1).astype(np.float64)
        W = self.mesh.n_workers
        imbal = _imbalance(cost, W)
        perm = None
        if cfg.rebalance and W > 1 and imbal > cfg.rebalance_threshold:
            perm = _lpt_order(cost, W)
            new_pol, new_pmask, src, dst, emask = permute_stores(
                self.mesh, perm, new_pol, new_pmask, src, dst, emask)
        return _LevelOutcome(
            gsup=gsup[:C], keep=keep, pol=new_pol, pmask=new_pmask,
            src=src, dst=dst, emask=emask, overflow=overflow,
            max_embeddings=M, rebalanced=perm is not None,
            imbalance=imbal, perm=perm, map_seconds=map_secs,
            escalations=escalations)

    # ------------------------------------------------------------------
    def _materialize_exact(self, keep_meta, pol, pmask, src, dst, emask, M,
                           out_width: Optional[int] = None, *,
                           level: Optional[int] = None):
        """Materialize survivors; escalate M until no overflow (exactness
        valve — keeps device supports == paper semantics).  Before each
        store is built, its bytes are held against the free device
        memory: a store that cannot fit raises ``DeviceMemoryError``
        before anything is allocated, not CUDA's out-of-memory error
        midway.  With several ranks the ranks agree on it (any rank short
        of memory stops them all), so that no rank is left waiting in
        the materialization's collective."""
        cfg = self.cfg
        escalations = 0
        NP, _, G, _, K = pol.shape
        width = out_width if out_width is not None else K + 1
        n = int(keep_meta.shape[0])
        while True:
            free = self._retry_free_bytes()
            need = NP * n * G * M * (4 * width + 1)
            if free is not None:
                short = need > free
                if self.mesh.n_workers > 1:
                    flag = torch.tensor([int(short)], dtype=torch.int64,
                                        device=self.device)
                    short = bool(int(self.mesh.all_reduce(
                        flag, dist.ReduceOp.MAX)))
                if short:
                    raise DeviceMemoryError(
                        level if level is not None else -1, n, need, free)
            new_pol, new_pmask, overflow = map_materialize(
                self.mesh, keep_meta, pol, pmask, src, dst, emask,
                max_embeddings=M, out_width=out_width)
            if (overflow == 0 or not cfg.escalate_on_overflow
                    or M >= cfg.max_embeddings_limit):
                return new_pol, new_pmask, overflow, M, escalations
            del new_pol, new_pmask
            M = min(M * 2, cfg.max_embeddings_limit)
            escalations += 1

    def _save(self, root, level, levels, supports, pol, pmask, M, overflow,
              order):
        """Checkpoint in the JAX package's format: the CANONICAL store
        (the cumulative rebalance permutation ``order`` inverted; bucket
        padding stripped — pattern axis to the true survivor count,
        vertex axis to the widest real pattern), so a resume on another
        worker count, under other bucket floors, or in the other package
        re-lays it out.  The ranks' blocks are gathered to rank 0, which
        alone writes; the other ranks wait for it."""
        max_edges = max(len(c) for l in levels for c in l)
        n_real = max(len(levels[-1]), 1)
        pol_np = self._gather_store(pol[:, :n_real])
        pmask_np = self._gather_store(pmask[:, :n_real])
        if self.mesh.rank == 0:
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            pol_np, pmask_np = pol_np[inv], pmask_np[inv]
            if self._buckets() is not None:
                kw = 1 + max(max(i, j) for c in levels[-1]
                             for (i, j, _a, _e, _b) in c)
                pol_np = pol_np[..., :kw]
            state = {
                "levels": [[code_to_array(c, max_edges) for c in l]
                           for l in levels],
                "support_codes": [code_to_array(c, max_edges)
                                  for c in supports],
                "support_vals": np.asarray(list(supports.values()),
                                           np.int64),
                "pol": pol_np,
                "pmask": pmask_np,
                "max_embeddings": M,
                "total_overflow": overflow,
            }
            ckpt.save_step(root, level, state,
                           metadata={"kind": "mirage-mining",
                                     **self._ckpt_meta})
        self.mesh.barrier()

    def _gather_store(self, x: torch.Tensor) -> Optional[np.ndarray]:
        """The whole store (NP, ...) in the live partition order on rank 0
        (None elsewhere), gathered one local partition at a time so that
        no rank holds more than W partitions of it on the device."""
        W, PP = self.mesh.n_workers, x.shape[0]
        if self.mesh.group is None:
            return x.cpu().numpy()
        out = None
        for i in range(PP):
            parts = self.mesh.all_gather(x[i:i + 1].contiguous()).cpu()
            if self.mesh.rank == 0:
                if out is None:
                    out = np.empty((W * PP, *x.shape[1:]),
                                   parts.numpy().dtype)
                out[i::PP] = parts.numpy()
        return out


def memory_survivor_cap(S: int, slot_bytes: int, free_bytes: int,
                        bk: Optional[BucketSpec]) -> int:
    """Clamp the survivor cap ``S`` so the (NP, S, G, M, W) child store,
    ``slot_bytes`` per survivor slot, takes at most
    ``_STORE_MEMORY_SHARE`` of ``free_bytes``.  The JAX package has no
    such clamp.  Bucketed, the clamp is the largest S-family member that
    fits; when not even the family floor fits, the store leaves the
    family and takes the count that fits (at least 1).  A cap below the
    level's true survivor count takes the exact materialize-only retry,
    which builds the store of every survivor: a level whose survivors
    alone do not fit the card raises ``DeviceMemoryError`` before that
    store is allocated (``Mirage._materialize_exact``)."""
    fit = int(free_bytes * _STORE_MEMORY_SHARE) // slot_bytes
    if fit >= S:
        return S
    if bk is None or fit < bk.s_floor:
        return max(1, fit)
    s = bk.s_floor
    while s * 2 <= fit:
        s *= 2
    return s


def _pad_store(pol, pmask, *, p_to: Optional[int] = None,
               m_to: Optional[int] = None, k_to: Optional[int] = None):
    """Grow an OL store (NP, P, G, M, K)/(NP, P, G, M) into its bucket:
    PAD(-1) vertex entries, all-False masks.  Padded slots are inert —
    no candidate references a padded parent, masked embeddings never
    join, PAD vertex slots never match.  numpy arrays or torch tensors."""

    def grow(a, fill, targets):
        shape = list(a.shape)
        for axis, to in targets:
            if to is not None and to > shape[axis]:
                shape[axis] = to
        if list(a.shape) == shape:
            return a
        if isinstance(a, np.ndarray):
            out = np.full(shape, fill, a.dtype)
        else:
            out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    pol = grow(pol, -1, ((1, p_to), (3, m_to), (4, k_to)))
    pmask = grow(pmask, False, ((1, p_to), (3, m_to)))
    return pol, pmask


def _pad_f(a: np.ndarray, F: int, fill) -> np.ndarray:
    pad = F - a.shape[-1]
    if pad == 0:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, constant_values=fill)


def _imbalance(cost: np.ndarray, w: int) -> float:
    """max/mean of per-worker cost under the current blocked assignment."""
    per_worker = cost.reshape(w, -1).sum(-1)
    mean = per_worker.mean()
    return float(per_worker.max() / mean) if mean > 0 else 1.0


def _lpt_order(cost: np.ndarray, w: int) -> np.ndarray:
    """Re-pack partitions into w balanced blocks (LPT), then emit the
    permutation that lays blocks contiguously (matching the blocked
    partition→worker rule); the host twin of
    ``level_step.lpt_permutation``."""
    np_total = len(cost)
    per = np_total // w
    buckets: list[list[int]] = [[] for _ in range(w)]
    load = np.zeros(w)
    for i in np.argsort(-cost):
        # lightest bucket with room
        for b in np.argsort(load):
            if len(buckets[b]) < per:
                buckets[b].append(int(i))
                load[b] += cost[i]
                break
    return np.asarray([i for b in buckets for i in b], np.int32)
