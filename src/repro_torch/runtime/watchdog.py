"""Deadline watchdog for the mining runtime (DESIGN.md §14) — the port
of ``repro.runtime.watchdog``, pure Python.

A hung device dispatch has no natural bound: the host thread blocks in
a transfer with nothing watching it.  :class:`Watchdog` restores a bound
in two layers:

  * a **run deadline** (wall-clock budget for the whole ``mine`` call,
    spanning supervisor retries) checked cooperatively at loop heads via
    :meth:`check_run`, raising
    :class:`~repro_torch.runtime.faults.DeadlineExceeded`, and
  * **phase deadlines** — one per level.  The driver arms a phase
    before dispatch and disarms it after the sync; the deadline is
    ``max(floor, slack x EWMA)`` of recent phase wall-times, so it
    self-calibrates to the workload.

A monitor thread (daemon, started lazily on first arm) wakes when an
armed phase overruns and records a **trip**.  Trips never interrupt the
blocked host thread — a genuinely hung transfer cannot be unwound from
Python — they are a *detection signal*: persisted immediately via the
``on_trip`` callback (the supervisor appends a JSONL line, so a
hard-killed run still leaves evidence) and observed at the next
cooperative point.  The injected-hang hook
(:func:`repro_torch.runtime.faults.maybe_hang`) polls :attr:`tripped`
and raises :class:`~repro_torch.runtime.faults.HangTimeout`, which the
supervisor classifies as the ``hang`` recovery class (a replay from the
newest checkpoint).  A hang inside a CUDA kernel or a collective is not
polled: the process group's timeout bounds a collective.

The first phase of a run is never armed from EWMA (there is no sample
yet); ``phase_default`` pins a fixed deadline for every phase instead —
used by tests and the CLI to make detection latency deterministic.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import faults

__all__ = ["Watchdog"]


class Watchdog:
    """Run-deadline + phase-deadline tracker with a monitor thread.

    Parameters
    ----------
    run_deadline_s:
        Wall-clock budget for the whole run (None = unbounded).
    phase_floor:
        Minimum armed phase deadline in seconds; also the deadline used
        before any EWMA sample exists when > 0.
    phase_slack:
        Multiplier on the EWMA of recent phase wall-times.
    phase_default:
        Fixed phase deadline overriding the EWMA policy entirely
        (deterministic detection for tests / CI).
    on_trip:
        Callback ``on_trip(info: dict)`` invoked from the monitor
        thread when an armed phase overruns.
    """

    def __init__(self, run_deadline_s: Optional[float] = None, *,
                 phase_floor: float = 0.0, phase_slack: float = 8.0,
                 phase_default: Optional[float] = None,
                 ewma_alpha: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: Optional[Callable[[dict], None]] = None):
        if phase_slack < 1.0:
            raise ValueError(f"phase_slack must be >= 1: {phase_slack}")
        self.run_deadline_s = run_deadline_s
        self.phase_floor = float(phase_floor)
        self.phase_slack = float(phase_slack)
        self.phase_default = phase_default
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self.on_trip = on_trip
        self.trips: list[dict] = []
        self._ewma: Optional[float] = None
        self._t0: Optional[float] = None
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # armed-phase state, guarded by _cv
        self._gen = 0
        self._deadline: Optional[float] = None
        self._armed_at: Optional[float] = None
        self._level: Optional[int] = None
        self._tripped_gen = -1

    # -- run deadline -------------------------------------------------

    def start(self) -> "Watchdog":
        """Start the run clock (idempotent; retries share one clock)."""
        if self._t0 is None:
            self._t0 = self._clock()
        return self

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else self._clock() - self._t0

    def run_remaining(self) -> Optional[float]:
        """Seconds left on the run deadline (None = unbounded)."""
        if self.run_deadline_s is None:
            return None
        self.start()
        return self.run_deadline_s - self.elapsed()

    @property
    def run_expired(self) -> bool:
        rem = self.run_remaining()
        return rem is not None and rem <= 0

    def check_run(self, level: Optional[int] = None) -> None:
        """Cooperative run-deadline check: raise at loop heads."""
        if self.run_expired:
            raise faults.DeadlineExceeded(level, self.elapsed(),
                                          float(self.run_deadline_s))

    # -- phase deadlines ----------------------------------------------

    def phase_deadline(self) -> Optional[float]:
        """Deadline the next armed phase would get (None = unarmed)."""
        if self.phase_default is not None:
            d = float(self.phase_default)
        elif self._ewma is not None:
            d = max(self.phase_floor, self.phase_slack * self._ewma)
        elif self.phase_floor > 0:
            d = self.phase_floor
        else:
            return None
        rem = self.run_remaining()
        if rem is not None:
            d = min(d, max(rem, 0.0))
        return d

    def arm(self, level: Optional[int] = None,
            deadline_s: Optional[float] = None) -> Optional[float]:
        """Arm a phase (re-arming replaces the current phase).  Returns
        the armed deadline, or None if policy yields no deadline."""
        self.start()
        d = deadline_s if deadline_s is not None else self.phase_deadline()
        with self._cv:
            self._gen += 1
            self._deadline = d
            self._armed_at = self._clock() if d is not None else None
            self._level = level
            self._cv.notify_all()
            if d is not None and self._thread is None:
                self._thread = threading.Thread(
                    target=self._monitor, name="mirage-watchdog",
                    daemon=True)
                self._thread.start()
        return d

    def beat(self, level: Optional[int] = None) -> None:
        """Heartbeat: reset the armed phase timer (chunk progress)."""
        with self._cv:
            if self._deadline is not None:
                self._gen += 1
                self._armed_at = self._clock()
                if level is not None:
                    self._level = level
                self._cv.notify_all()

    def disarm(self, observe_s: Optional[float] = None) -> None:
        """End the phase; optionally feed its wall-time into the EWMA."""
        with self._cv:
            self._gen += 1
            self._deadline = None
            self._armed_at = None
            self._level = None
            self._cv.notify_all()
        if observe_s is not None:
            a = self.ewma_alpha
            self._ewma = (observe_s if self._ewma is None
                          else a * observe_s + (1 - a) * self._ewma)

    @property
    def tripped(self) -> bool:
        """Has the *current* phase crossed its deadline?  Combines the
        monitor thread's flag with a lazy clock check, so detection does
        not depend on thread scheduling."""
        with self._cv:
            if self._deadline is None:
                return False
            if self._tripped_gen == self._gen:
                return True
            return self._clock() - self._armed_at > self._deadline

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._deadline = None
            self._cv.notify_all()

    # -- monitor thread -----------------------------------------------

    def _monitor(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                gen, deadline = self._gen, self._deadline
                armed_at, level = self._armed_at, self._level
                if deadline is None or self._tripped_gen == gen:
                    self._cv.wait(timeout=0.25)
                    continue
                remaining = deadline - (self._clock() - armed_at)
                if remaining > 0:
                    self._cv.wait(timeout=remaining)
                    continue
                self._tripped_gen = gen
                info = {"event": "watchdog_trip", "level": level,
                        "deadline_s": deadline,
                        "elapsed_s": self._clock() - armed_at,
                        "run_elapsed_s": self.elapsed()}
                self.trips.append(info)
            if self.on_trip is not None:      # outside the lock
                try:
                    self.on_trip(info)
                except Exception:
                    pass                      # logging must never kill us
