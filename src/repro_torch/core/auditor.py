"""Continuous mining-invariant auditor, host half (DESIGN.md §14).

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
:class:`~repro_torch.runtime.errors.AuditError`.

The offline whole-set gate (``audit_frequent_set``) and the cost model
of ``repro.core.auditor`` belong to the supervisor slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..runtime.errors import AuditError
from . import dfscode

__all__ = ["Auditor", "describe_audit_word"]

_FLAG_NAMES = {1: "monotonicity", 2: "compaction", 4: "support-range",
               8: "survivor-count"}


def describe_audit_word(word: int) -> str:
    names = [n for b, n in _FLAG_NAMES.items() if word & b]
    return "+".join(names) if names else "clean"


@dataclasses.dataclass
class Auditor:
    """Per-run host auditor: cheap sampled checks each level, a report
    row per call, :class:`AuditError` on any violation."""

    minsup: int
    n_graphs: int = -1
    samples: int = 2
    seed: int = 0
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
                if not dfscode.is_canonical(tuple(c.code)):
                    raise AuditError(
                        level, f"candidate {int(i)}: survivor DFS code "
                               f"is not canonical")
                checked["canonical"] += 1
        self.report.append({"level": level, "checked": checked,
                            "n_survivors": int(keep.size), "ok": True})
