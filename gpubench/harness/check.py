"""How ``correct`` is decided: every fit of the window against the plain
reference, over the whole frequent set.

Each number compared counts faults over all fits of the run, and each
has the limit 0 (an exact comparison):

* ``missing``: (level, code) pairs of the reference that a fit lacks;
* ``extra``: (level, code) pairs that a fit has and the reference lacks;
* ``support``: patterns in both whose supports differ;
* ``audit``: levels whose device audit word is not 0;
* ``minsup``: fits whose absolute threshold differs from the reference's;
* ``failed``: fits that raised.
"""
from __future__ import annotations

from typing import Sequence

from .program import FitRecord
from .reference import FrequentSet

__all__ = ["LIMITS", "compare", "is_correct", "format_checks"]

LIMITS = {"missing": 0, "extra": 0, "support": 0, "audit": 0, "minsup": 0,
          "failed": 0}


def _pairs(levels: Sequence[Sequence[tuple]]) -> set:
    return {(k, c) for k, lvl in enumerate(levels) for c in lvl}


def compare(fits: Sequence[FitRecord], ref: FrequentSet,
            failed: int = 0) -> dict[str, int]:
    """The numbers compared, summed over ``fits``."""
    want = _pairs(ref.levels)
    out = dict.fromkeys(LIMITS, 0)
    out["failed"] = int(failed)
    for f in fits:
        got = _pairs(f.levels)
        out["missing"] += len(want - got)
        out["extra"] += len(got - want)
        out["support"] += sum(1 for c, s in ref.supports.items()
                              if c in f.supports and f.supports[c] != s)
        out["audit"] += sum(1 for s in f.stats if s["audit"] != 0)
        out["minsup"] += int(f.minsup != ref.minsup)
    return out


def is_correct(numbers: dict[str, int], n_fits: int) -> bool:
    return n_fits > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)


def format_checks(numbers: dict[str, int]) -> dict[str, dict]:
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
