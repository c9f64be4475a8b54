"""Deterministic fault injection + the mining failure taxonomy
(DESIGN.md §10) — the port of ``repro.runtime.faults``.

MIRAGE's credibility as a MapReduce reproduction rests on surviving the
failures MapReduce was built for — worker loss, corrupted spills, flaky
links.  This module makes those failures *first-class, reproducible
inputs*:

  * a declarative, seedable **schedule** of :class:`FaultSpec` entries
    (``FaultSchedule.parse`` for the CLI, ``FaultSchedule.random`` for
    property tests), spec for spec the JAX package's;
  * an **injection engine** (``install``/``active``) consulted by hooks
    in the production code paths — the level loop in
    ``core/mining.py`` (worker loss, survivor-cap storms, stalls), the
    level dispatch and wire fetch in ``core/level_step.py`` (kernel
    faults, wire bit-flips on the host copy), and the save path in
    ``runtime/checkpoint.py`` (on-disk corruption).  Injection perturbs
    the real runtime; nothing is mocked;
  * the shared **failure taxonomy** the supervisor
    (``core/supervisor.py``) classifies: injected faults
    (:class:`WorkerLost`, :class:`KernelFault`), detected stalls
    (:class:`HangTimeout`), the run deadline (:class:`DeadlineExceeded`)
    and detected integrity violations (the :class:`IntegrityError`
    family, re-exported by ``runtime/errors.py``).

With several ranks, every rank installs the same schedule and reaches
the same hook at the same level, so an injected fault fires on every
rank before any collective of its level.  Every firing is appended to
``injection_log()``.  With no schedule installed every hook is a no-op
costing one attribute read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np

__all__ = [
    "KINDS",
    "InjectedFault", "WorkerLost", "KernelFault", "HangTimeout",
    "IntegrityError", "WireIntegrityError", "CheckpointIntegrityError",
    "AuditError", "DeadlineExceeded",
    "FaultSpec", "FaultSchedule",
    "install", "clear", "active", "installed",
    "injection_log", "reset_log",
    "maybe_raise", "maybe_hang", "corrupt_wire", "override_cap",
    "corrupt_checkpoint", "damage_checkpoint",
]

KINDS = ("worker_loss", "kernel_fault", "wire_bitflip", "ckpt_corrupt",
         "cap_storm", "hang")

_CKPT_MODES = ("flip", "truncate", "manifest")


# ---------------------------------------------------------------------------
# failure taxonomy
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A scheduled fault fired.  Carries where and what for the
    supervisor's classifier and the structured fault log."""

    kind = "injected"

    def __init__(self, level: int, detail: str = ""):
        self.level = level
        self.detail = detail
        super().__init__(
            f"injected {self.kind} at level {level}"
            + (f" ({detail})" if detail else ""))


class WorkerLost(InjectedFault):
    """A worker died mid-level (the MapReduce headline failure)."""

    kind = "worker_loss"

    def __init__(self, level: int, worker: int = 0):
        self.worker = worker
        super().__init__(level, f"worker {worker}")


class KernelFault(InjectedFault):
    """The level's kernel dispatch blew up (a launch or device-side
    error, injected)."""

    kind = "kernel_fault"


class HangTimeout(RuntimeError):
    """A stalled device phase crossed its watchdog deadline.  Raised
    from the cooperative hang hook (:func:`maybe_hang`) when an injected
    stall is caught by an armed
    :class:`~repro_torch.runtime.watchdog.Watchdog`
    — the detection path a real hang would take if the dispatch ever
    returned.  ``waited_s`` is the observed detection latency."""

    kind = "hang"

    def __init__(self, level: int, waited_s: float = 0.0):
        self.level = level
        self.waited_s = waited_s
        super().__init__(
            f"stalled device phase at level {level} "
            f"(watchdog tripped after {waited_s:.2f}s)")


class DeadlineExceeded(RuntimeError):
    """The whole-run deadline passed.  Not a retryable fault: the
    supervisor routes it straight to the partial-result path (or
    re-raises under ``on_exhausted='raise'``)."""

    kind = "deadline"

    def __init__(self, level: Optional[int], elapsed_s: float,
                 deadline_s: float):
        self.level = level
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        at = f" at level {level}" if level is not None else ""
        super().__init__(
            f"run deadline {deadline_s:.2f}s exceeded{at} "
            f"(elapsed {elapsed_s:.2f}s)")


class IntegrityError(RuntimeError):
    """Base for *detected* state corruption (checksums, digests)."""


class WireIntegrityError(IntegrityError):
    """A level wire failed its checksum on every re-fetch."""


class CheckpointIntegrityError(IntegrityError):
    """A checkpoint failed its manifest digests (or cannot be read)."""


class AuditError(IntegrityError):
    """The continuous invariant auditor caught a violated mining
    invariant (support monotonicity, downward closure, canonicality,
    verdict consistency).  State-class: the mined state can no longer be
    trusted, so the supervisor heals by checkpoint replay."""

    def __init__(self, level: int, detail: str):
        self.level = level
        self.detail = detail
        super().__init__(f"audit failed at level {level}: {detail}")


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: ``kind`` at mining ``level``, firing up to
    ``times`` consecutive matches.  Extra knobs are per-kind: ``worker``
    (worker_loss), ``word``/``bit`` (wire_bitflip; word -1 = middle of
    the wire), ``mode`` (ckpt_corrupt: flip|truncate|manifest), ``cap``
    (cap_storm's forced survivor cap), ``secs`` (hang: how long the
    stall lasts before clearing on its own when no watchdog catches
    it)."""

    kind: str
    level: int
    times: int = 1
    worker: int = 0
    word: int = -1
    bit: int = 7
    mode: str = "flip"
    cap: int = 1
    secs: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.mode not in _CKPT_MODES:
            raise ValueError(f"unknown ckpt_corrupt mode {self.mode!r} "
                             f"(one of {_CKPT_MODES})")
        if self.level < 1 or self.times < 1:
            raise ValueError(f"level/times must be >= 1: {self}")
        self._remaining = self.times

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        """``kind@level[*times][:key=val,...]`` — e.g.
        ``kernel_fault@3*4`` or ``wire_bitflip@2:word=5,bit=12``."""
        text = text.strip()
        head, _, opts = text.partition(":")
        kind, _, at = head.partition("@")
        if not at:
            raise ValueError(f"fault spec {text!r} needs '@level'")
        lvl, _, times = at.partition("*")
        kw: dict = {"kind": kind.strip(), "level": int(lvl),
                    "times": int(times) if times else 1}
        for item in filter(None, (o.strip() for o in opts.split(","))):
            key, _, val = item.partition("=")
            if key not in ("worker", "word", "bit", "mode", "cap", "secs"):
                raise ValueError(f"unknown fault option {key!r} in {text!r}")
            if key == "mode":
                kw[key] = val
            elif key == "secs":
                kw[key] = float(val)
            else:
                kw[key] = int(val)
        return FaultSpec(**kw)


class FaultSchedule:
    """An ordered set of :class:`FaultSpec`; ``install`` arms it (resets
    per-spec firing budgets) so one schedule object replays
    deterministically across runs."""

    def __init__(self, specs: Iterable[FaultSpec]):
        self.specs = list(specs)

    @classmethod
    def parse(cls, text: str) -> "FaultSchedule":
        """Semicolon-separated spec list (commas are taken by per-spec
        options): ``"worker_loss@2;wire_bitflip@3:bit=12"``."""
        return cls(FaultSpec.parse(p) for p in text.split(";") if p.strip())

    @classmethod
    def random(cls, seed: int, *, max_level: int = 4,
               n_faults: int = 2,
               kinds: tuple = KINDS) -> "FaultSchedule":
        """Seed-deterministic schedule for the chaos property suite."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            specs.append(FaultSpec(
                kind=kind,
                level=int(rng.integers(2, max(3, max_level + 1))),
                times=int(rng.integers(1, 3)),
                worker=int(rng.integers(0, 2)),
                word=-1 if rng.random() < 0.5 else int(rng.integers(0, 64)),
                bit=int(rng.integers(0, 30)),
                mode=_CKPT_MODES[int(rng.integers(len(_CKPT_MODES)))],
                cap=1,
                secs=0.05,       # unwatched stalls self-clear fast
            ))
        return cls(specs)

    def arm(self) -> "FaultSchedule":
        for s in self.specs:
            s._remaining = s.times
        return self

    def describe(self) -> str:
        return "; ".join(
            f"{s.kind}@{s.level}" + (f"*{s.times}" if s.times > 1 else "")
            for s in self.specs) or "<empty>"


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

_active_schedule: Optional[FaultSchedule] = None
_log: list[dict] = []


def install(schedule: FaultSchedule) -> None:
    global _active_schedule
    _active_schedule = schedule.arm()


def clear() -> None:
    global _active_schedule
    _active_schedule = None


def installed() -> Optional[FaultSchedule]:
    return _active_schedule


@contextlib.contextmanager
def active(schedule: FaultSchedule):
    install(schedule)
    try:
        yield schedule
    finally:
        clear()


def injection_log() -> list[dict]:
    """Structured record of every fault that actually fired."""
    return list(_log)


def reset_log() -> None:
    _log.clear()


def _take(kind: str, level: Optional[int]) -> Optional[FaultSpec]:
    """Consume one firing of the first armed spec matching (kind, level)."""
    sched = _active_schedule
    if sched is None or level is None:
        return None
    for spec in sched.specs:
        if spec.kind == kind and spec.level == level and spec._remaining > 0:
            spec._remaining -= 1
            _log.append({"kind": kind, "level": level,
                         "remaining": spec._remaining})
            return spec
    return None


# ---------------------------------------------------------------------------
# hooks (called from production code paths)
# ---------------------------------------------------------------------------

def maybe_raise(point: str, level: Optional[int]) -> None:
    """Raise the scheduled fault for this (point, level), if any.

    ``level_start`` (mining driver loop)  → :class:`WorkerLost`
    ``kernel``      (level-program dispatch) → :class:`KernelFault`
    """
    if _active_schedule is None:
        return
    if point == "level_start":
        spec = _take("worker_loss", level)
        if spec is not None:
            raise WorkerLost(level, spec.worker)
    elif point == "kernel":
        spec = _take("kernel_fault", level)
        if spec is not None:
            raise KernelFault(level, "injected dispatch failure")


def maybe_hang(point: str, level: Optional[int], watchdog=None) -> bool:
    """Simulate a stalled device phase at (point, level), if scheduled.

    The stall blocks in small slices polling the watchdog.  When an
    armed watchdog trips (phase deadline or run deadline), the stall is
    *detected*: :class:`HangTimeout` carries the observed latency.  With
    no watchdog (or one that never trips) the stall clears on its own
    after ``spec.secs`` — a transient slowdown the run rides out.
    Returns whether a stall fired (the driver of a multi-rank run then
    agrees on the outcome with its peers).
    """
    if _active_schedule is None:
        return False
    spec = _take("hang", level)
    if spec is None:
        return False
    t0 = time.monotonic()
    while True:
        waited = time.monotonic() - t0
        if watchdog is not None and (watchdog.tripped
                                     or watchdog.run_expired):
            raise HangTimeout(level, waited)
        if waited >= spec.secs:
            return True                   # stall cleared below deadline
        time.sleep(min(0.005, max(0.0, spec.secs - waited)))


def corrupt_wire(wire: np.ndarray, level: Optional[int]) -> np.ndarray:
    """Flip one bit of the packed int32 wire (a host-link/DMA upset).
    Returns a corrupted *copy* — the device buffer stays pristine, so a
    re-fetch recovers."""
    if _active_schedule is None:
        return wire
    spec = _take("wire_bitflip", level)
    if spec is None:
        return wire
    out = wire.copy()
    word = spec.word if 0 <= spec.word < out.shape[0] else out.shape[0] // 2
    out[word] ^= np.int32(1 << (spec.bit % 31))
    return out


def override_cap(cap: int, level: Optional[int]) -> int:
    """Force a pathological survivor cap (a cap-miss storm: every level
    hit must take the materialize-only retry path)."""
    if _active_schedule is None:
        return cap
    spec = _take("cap_storm", level)
    return cap if spec is None else max(1, spec.cap)


def corrupt_checkpoint(path: str, step: int) -> None:
    """Scheduled on-disk corruption of a just-written checkpoint step."""
    if _active_schedule is None:
        return
    spec = _take("ckpt_corrupt", step)
    if spec is not None:
        damage_checkpoint(path, spec.mode)


def damage_checkpoint(path: str, mode: str = "flip") -> None:
    """Corrupt a checkpoint directory in place (also used directly by
    the chaos tests): ``flip`` a byte of the largest leaf's *compressed
    payload* inside ``data.npz`` (flipping blindly mid-file can land in
    inert zip header metadata — a flip that corrupts nothing), ``truncate``
    the payload, or replace ``manifest.json`` with junk."""
    if mode == "manifest":
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write('{"skeleton": ')          # unparseable on purpose
        return
    data = os.path.join(path, "data.npz")
    size = os.path.getsize(data)
    if mode == "truncate":
        with open(data, "r+b") as f:
            f.truncate(max(1, size // 2))
        return
    target = size // 2                        # mode == "flip"
    try:
        import struct
        import zipfile
        with zipfile.ZipFile(data) as z:
            info = max(z.infolist(), key=lambda i: i.compress_size)
        with open(data, "rb") as f:
            f.seek(info.header_offset + 26)
            nlen, elen = struct.unpack("<HH", f.read(4))
        payload = info.header_offset + 30 + nlen + elen
        target = payload + info.compress_size // 2
    except Exception:                         # already-mangled archive:
        pass                                  # fall back to mid-file
    with open(data, "r+b") as f:
        f.seek(target)
        byte = f.read(1)
        f.seek(target)
        f.write(bytes([byte[0] ^ 0xFF]))
