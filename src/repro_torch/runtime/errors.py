"""Errors of the mining runtime: the integrity errors of the failure
taxonomy (defined in ``runtime/faults.py``, re-exported here) and the
device-memory error of the exact retry."""
from __future__ import annotations

from .faults import (AuditError, CheckpointIntegrityError, IntegrityError,
                     WireIntegrityError)

__all__ = ["IntegrityError", "WireIntegrityError",
           "CheckpointIntegrityError", "AuditError", "DeviceMemoryError"]


class DeviceMemoryError(MemoryError):
    """The store of a level's survivors does not fit the device.

    Raised before the exact retry (or the legacy pipeline's
    materialization) allocates it: ``survivors`` slots of the child
    store need ``need_bytes``, and the device has ``free_bytes`` free
    for this rank.  Not a classified fault, so the supervisor re-raises
    it: no rung of its ladder needs less memory for the same survivors."""

    def __init__(self, level: int, survivors: int, need_bytes: int,
                 free_bytes: int):
        self.level = level
        self.survivors = survivors
        self.need_bytes = need_bytes
        self.free_bytes = free_bytes
        super().__init__(
            f"level {level}: the store of its {survivors} survivors needs "
            f"{need_bytes} bytes, the device has {free_bytes} free")
