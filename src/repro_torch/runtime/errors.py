"""Integrity errors of the mining runtime (the subset of
``repro.runtime.faults`` this slice needs; fault injection, the
watchdog and the supervisor are later slices)."""
from __future__ import annotations

__all__ = ["IntegrityError", "WireIntegrityError",
           "CheckpointIntegrityError", "AuditError"]


class IntegrityError(RuntimeError):
    """Detected corruption of mining state."""


class WireIntegrityError(IntegrityError):
    """A level wire failed its checksum on every re-fetch."""


class CheckpointIntegrityError(IntegrityError):
    """A checkpoint is unreadable, truncated or fails its digests."""


class AuditError(IntegrityError):
    """A mining invariant was violated (device audit word or host spot
    check: monotonicity, compaction, support range, survivor count,
    downward closure, canonicality, verdict consistency)."""

    def __init__(self, level: int, detail: str):
        self.level = level
        self.detail = detail
        super().__init__(f"audit failed at level {level}: {detail}")
