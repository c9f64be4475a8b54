"""Continuous mining-invariant auditor (DESIGN.md §14), the port of
``repro.core.auditor``.

**On device** (``level_step``): each level folds a bit-flag *audit word*
into the checksummed wire — support monotonicity against the parent
supports, compaction integrity, support range against the DB graph
count, and the survivor count bound.  Zero word = the level certified
itself.

**On host** (this module): :class:`Auditor` spot-checks what the device
cannot see — downward closure (a sampled survivor's rightmost-removed
(k-1)-prefix must be the recorded frequent parent) and DFS-code
canonicality through the exact host checker (no device traffic, so the
one-transfer-per-level contract holds) — plus host-side re-checks of
the wire's verdict consistency.  Violations raise
:class:`~repro_torch.runtime.errors.AuditError`, a *state*-class fault
the supervisor heals by checkpoint replay.

:func:`audit_frequent_set` re-verifies a whole frequent set (levels +
supports) — the final gate a checkpoint passes before the supervisor
cuts a :class:`~repro_torch.core.mining.PartialResult` at it.  It
cross-checks canonicality on the bounded array machine of the device
loop (``dfscode.min_dfs_canonical_array``), as the JAX package does.

:func:`audit_overhead_model` is the deterministic cost proxy of the
audit's share of a level's host↔device traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime.errors import AuditError
from . import dfscode

__all__ = ["Auditor", "audit_frequent_set", "audit_overhead_model",
           "describe_audit_word"]

_FLAG_NAMES = {1: "monotonicity", 2: "compaction", 4: "support-range",
               8: "survivor-count"}


def describe_audit_word(word: int) -> str:
    names = [n for b, n in _FLAG_NAMES.items() if word & b]
    return "+".join(names) if names else "clean"


# state budget for the array canonicality machine; overflow falls back
# to the exact host checker
_CANON_MAX_STATES = 64


def _is_canonical(code, device: bool = False) -> Optional[bool]:
    """Spot-check one code's canonicality.

    ``device=False`` (the in-loop default) runs the exact host checker
    — zero device traffic, preserving the pipeline's one-sync-per-level
    contract.  ``device=True`` (the offline partial-result gate) runs
    the bounded ``min_dfs_canonical_array`` machine instead, cross-
    validating the device loop's implementation — on CPU tensors: one
    code is far too little work to send to a card; None = inconclusive
    (state overflow, or a code past the machine's 31 edges)."""
    L = len(code)
    if L < 2:
        return True
    if not device:
        return bool(dfscode.is_canonical(tuple(code)))
    if L >= 32:
        return None
    arr = torch.from_numpy(dfscode.code_to_array(tuple(code), L))[None]
    canonical, overflow = dfscode.min_dfs_canonical_array(
        arr, n_vertex_slots=L + 1, max_states=_CANON_MAX_STATES)
    if bool(overflow[0]):
        return None
    return bool(canonical[0])


@dataclasses.dataclass
class Auditor:
    """Per-run host auditor: cheap sampled checks each level, a report
    row per call, :class:`AuditError` on any violation."""

    minsup: int
    n_graphs: int = -1
    samples: int = 2
    seed: int = 0
    # True routes canonicality spot checks through the device array
    # machine (offline gates only — in-loop audits stay host-pure to
    # preserve the one-sync-per-level contract)
    device_canon: bool = False
    report: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def check_wire(self, level: int, audit_word: int) -> None:
        """A nonzero device audit word is a violated invariant."""
        if audit_word:
            raise AuditError(
                level, f"device audit word {audit_word:#x} "
                       f"({describe_audit_word(audit_word)})")

    def check_level(self, level: int, *, cands: Sequence,
                    keep: np.ndarray, gsup: np.ndarray,
                    parents: Sequence, supports: dict) -> None:
        """Host spot checks over one completed level's survivors.

        ``cands``: the level's Candidate list (canonical order);
        ``keep``: survivor indices into it; ``gsup``: their (C,) global
        supports; ``parents``: level k-1's frequent codes;
        ``supports``: the global code->support map (parents included).
        """
        keep = np.asarray(keep)
        gsup = np.asarray(gsup)
        checked = {"verdict": 0, "closure": 0, "canonical": 0}
        # verdict consistency: every survivor >= minsup, host-side again
        # (the device word already certified its own copy — this guards
        # the decoded host values end to end)
        if keep.size:
            bad = np.flatnonzero(gsup[keep] < self.minsup)
            if bad.size:
                i = int(keep[bad[0]])
                raise AuditError(
                    level, f"survivor {i} support {int(gsup[i])} "
                           f"< minsup {self.minsup}")
            checked["verdict"] = int(keep.size)
        if self.n_graphs >= 0 and keep.size:
            hi = np.flatnonzero(gsup[keep] > self.n_graphs)
            if hi.size:
                i = int(keep[hi[0]])
                raise AuditError(
                    level, f"survivor {i} support {int(gsup[i])} exceeds "
                           f"the DB graph count {self.n_graphs}")
        # sampled downward-closure + monotonicity + canonicality
        if keep.size:
            n = min(self.samples, keep.size)
            picks = self._rng.choice(keep, size=n, replace=False)
            for i in picks:
                c = cands[int(i)]
                parent = parents[c.parent] if 0 <= c.parent < len(
                    parents) else None
                if parent is None or tuple(c.code[:-1]) != tuple(parent):
                    raise AuditError(
                        level, f"candidate {int(i)}: rightmost-removed "
                               f"prefix is not the recorded frequent "
                               f"parent (downward closure)")
                psup = supports.get(tuple(parent))
                if psup is not None and int(gsup[int(i)]) > int(psup):
                    raise AuditError(
                        level, f"candidate {int(i)}: support "
                               f"{int(gsup[int(i)])} > parent support "
                               f"{int(psup)} (monotonicity)")
                checked["closure"] += 1
                ok = _is_canonical(tuple(c.code), self.device_canon)
                if ok is False:
                    raise AuditError(
                        level, f"candidate {int(i)}: survivor DFS code "
                               f"is not canonical")
                if ok:
                    checked["canonical"] += 1
        self.report.append({"level": level, "checked": checked,
                            "n_survivors": int(keep.size), "ok": True})

    # -- whole-prefix (checkpoint cuts) --------------------------------

    def check_levels(self, levels: Sequence[Sequence], supports: dict,
                     *, start_level: int = 2) -> None:
        """Audit decoded levels ``start_level..`` of a frequent-set
        prefix: supports in range, monotone against the rightmost-
        removed parent, parent present (downward closure), sampled
        canonicality."""
        for li in range(start_level - 1, len(levels)):
            lvl = levels[li]
            level_no = li + 1
            prev = {tuple(c) for c in levels[li - 1]} if li else set()
            n_canon = 0
            codes = list(lvl)
            n = min(self.samples, len(codes))
            picks = (self._rng.choice(len(codes), size=n, replace=False)
                     if codes else [])
            picks = set(int(p) for p in np.atleast_1d(picks)) if n else set()
            for ci, code in enumerate(codes):
                code = tuple(code)
                s = supports.get(code)
                if s is None or s < self.minsup:
                    raise AuditError(
                        level_no, f"frequent code missing a support >= "
                                  f"minsup (got {s})")
                if self.n_graphs >= 0 and s > self.n_graphs:
                    raise AuditError(
                        level_no, f"support {s} exceeds the DB graph "
                                  f"count {self.n_graphs}")
                if li >= 1 and len(code) > 1:
                    parent = tuple(code[:-1])
                    if parent not in prev:
                        raise AuditError(
                            level_no, "rightmost-removed parent absent "
                                      "from the previous level "
                                      "(downward closure)")
                    ps = supports.get(parent)
                    if ps is not None and s > ps:
                        raise AuditError(
                            level_no, f"support {s} > parent support "
                                      f"{ps} (monotonicity)")
                if ci in picks:
                    if _is_canonical(code, self.device_canon) is False:
                        raise AuditError(
                            level_no, "frequent DFS code is not "
                                      "canonical")
                    n_canon += 1
            self.report.append({"level": level_no, "n_codes": len(codes),
                                "checked": {"canonical": n_canon},
                                "ok": True})


def audit_frequent_set(levels: Sequence[Sequence], supports: dict,
                       minsup: Optional[int], *, n_graphs: int = -1,
                       samples: int = 2, seed: int = 0) -> list:
    """Re-verify a whole frequent set (e.g. a loaded checkpoint) before
    trusting it as a partial result.  Returns the audit report; raises
    :class:`AuditError` on any violation.  ``minsup=None`` skips the
    threshold check (checkpoints without a recorded minsup)."""
    a = Auditor(minsup=0 if minsup is None else int(minsup),
                n_graphs=n_graphs, samples=samples, seed=seed,
                device_canon=True)
    a.check_levels(levels, supports, start_level=1 if minsup else 2)
    return a.report


def audit_overhead_model(cp: int, n_partitions: int, n_workers: int, *,
                         parents: Optional[int] = None,
                         reduce: str = "reduce_scatter",
                         sharded: Optional[bool] = None,
                         packed: bool = False,
                         samples: int = 2) -> dict:
    """Deterministic model of the audit's share of a level's critical
    path (bytes moved; the JAX package's model).

    Audit costs per level: ONE extra int32 wire word per shard on the
    host transfer, a summed pair of int32 violation counters in the
    collective phase (sharded only), the PARENT-indexed support upload
    (one int32 per parent slot, gathered on device through the meta
    parent column; ``parents`` defaults to cp/4, the typical
    rightmost-extension fanout), and ``samples`` host spot checks (off
    the device critical path).  The path those bytes are charged
    against is the level's full host<->device traffic: the modeled wire
    cost (``level_step.wire_cost_model``) plus the (cp, 5) int32
    candidate meta upload."""
    from .level_step import wire_cost_model
    base = wire_cost_model(cp, n_partitions, n_workers, reduce=reduce,
                           sharded=sharded, packed=packed)
    if sharded is None:
        sharded = reduce == "reduce_scatter"
    if parents is None:
        parents = max(1, cp // 4)
    shards = n_workers if sharded else 1
    audit_host = shards * 4                 # one audit word per shard
    audit_coll = (2 * 4 * (n_workers - 1) / n_workers) if sharded else 0.0
    audit_upload = parents * 4              # parent-indexed psup upload
    audit_bytes = audit_host + audit_coll + audit_upload
    path_bytes = base["total_bytes"] + cp * 5 * 4
    return {"audit_bytes": audit_bytes, "path_bytes": path_bytes,
            "overhead": audit_bytes / max(path_bytes, 1.0),
            "samples": samples, "parents": parents}
