"""The port's watchdog and unified retry budget (DESIGN.md §14), held to
the JAX package's units (``tests/test_watchdog.py``) and, where both
packages compute a value, to the JAX package's own.

The watchdog's trips are *detection signals*, never control flow: the
injected-hang hook (``faults.maybe_hang``) is the only place a
:class:`HangTimeout` is raised, and the cooperative ``check_run`` the
only place a :class:`DeadlineExceeded` is.  These units pin the phase
deadline policy (default > slack x EWMA > floor), the lazy-clock trip
detection (no thread scheduling required), the monitor thread's
persisted trips, and the jittered-exponential retry budget the
supervisor draws every recovery class from.
"""
import time

import pytest

from repro.core import supervisor as jsupervisor
from repro_torch.core.supervisor import RetryBudget
from repro_torch.runtime import faults
from repro_torch.runtime.watchdog import Watchdog


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    faults.reset_log()
    yield
    faults.clear()
    faults.reset_log()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# run deadline
# ---------------------------------------------------------------------------

def test_run_deadline_checked_cooperatively():
    clk = FakeClock()
    wd = Watchdog(run_deadline_s=10.0, clock=clk).start()
    wd.check_run(level=2)                       # within budget: no raise
    assert wd.run_remaining() == 10.0
    clk.advance(11.0)
    assert wd.run_expired
    with pytest.raises(faults.DeadlineExceeded) as ei:
        wd.check_run(level=3)
    assert ei.value.level == 3
    assert ei.value.deadline_s == 10.0


def test_unbounded_run_never_expires():
    wd = Watchdog().start()
    assert wd.run_remaining() is None
    assert not wd.run_expired
    wd.check_run(level=99)


def test_start_is_idempotent_across_retries():
    clk = FakeClock()
    wd = Watchdog(run_deadline_s=10.0, clock=clk).start()
    clk.advance(4.0)
    wd.start()                                  # a retry does NOT reset
    assert wd.elapsed() == 4.0


# ---------------------------------------------------------------------------
# phase deadline policy
# ---------------------------------------------------------------------------

def test_phase_policy_default_beats_ewma_beats_floor():
    clk = FakeClock()
    wd = Watchdog(phase_floor=1.0, phase_slack=4.0, clock=clk)
    assert wd.phase_deadline() == 1.0           # floor before any sample
    wd.arm(2)
    wd.disarm(observe_s=2.0)
    assert wd.phase_deadline() == 8.0           # slack x EWMA
    wd.disarm(observe_s=1.0)                    # ewma -> 1.5
    assert wd.phase_deadline() == 6.0
    assert Watchdog(phase_default=0.25).phase_deadline() == 0.25


def test_no_policy_means_unarmed():
    wd = Watchdog()                             # no floor, default, sample
    assert wd.phase_deadline() is None
    assert wd.arm(2) is None
    assert not wd.tripped
    wd.close()


def test_phase_deadline_clamped_to_run_remaining():
    clk = FakeClock()
    wd = Watchdog(run_deadline_s=5.0, phase_default=60.0, clock=clk).start()
    clk.advance(3.0)
    assert wd.phase_deadline() == 2.0


def test_sub_unit_slack_rejected():
    with pytest.raises(ValueError, match="phase_slack"):
        Watchdog(phase_slack=0.5)


# ---------------------------------------------------------------------------
# trip detection
# ---------------------------------------------------------------------------

def test_tripped_via_lazy_clock_and_heartbeat_reset():
    clk = FakeClock()
    wd = Watchdog(phase_default=1.0, clock=clk)
    wd.arm(3)
    assert not wd.tripped
    clk.advance(1.5)
    assert wd.tripped                           # no thread needed
    wd.beat(3)                                  # chunk-progress heartbeat
    assert not wd.tripped
    wd.disarm()
    clk.advance(99.0)
    assert not wd.tripped                       # disarmed phase never trips
    wd.close()


def test_monitor_thread_records_and_persists_trips():
    seen = []
    wd = Watchdog(phase_default=0.05, on_trip=seen.append)
    wd.arm(4)
    deadline = time.monotonic() + 5.0
    while not wd.trips and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.close()
    assert wd.trips, "monitor thread never tripped"
    trip = wd.trips[0]
    assert trip["event"] == "watchdog_trip" and trip["level"] == 4
    assert trip["elapsed_s"] >= 0.05
    assert seen == wd.trips                     # persisted as it happened


def test_trip_callback_errors_are_swallowed():
    def boom(info):
        raise RuntimeError("logging must never kill mining")

    wd = Watchdog(phase_default=0.01, on_trip=boom)
    wd.arm(2)
    deadline = time.monotonic() + 5.0
    while not wd.trips and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.close()
    assert wd.trips                             # tripped despite the raise


# ---------------------------------------------------------------------------
# injected hangs (faults.maybe_hang)
# ---------------------------------------------------------------------------

def test_hang_spec_parses_secs():
    spec = faults.FaultSpec.parse("hang@3*2:secs=2.5")
    assert (spec.kind, spec.level, spec.times, spec.secs) == \
        ("hang", 3, 2, 2.5)


def test_maybe_hang_noop_without_schedule():
    t0 = time.monotonic()
    assert faults.maybe_hang("dispatch", 2, None) is False
    assert time.monotonic() - t0 < 0.5


def test_maybe_hang_self_clears_without_watchdog():
    faults.install(faults.FaultSchedule.parse("hang@2:secs=0.02"))
    t0 = time.monotonic()
    assert faults.maybe_hang("dispatch", 3, None) is False   # not its level
    assert faults.maybe_hang("dispatch", 2, None) is True    # rides it out
    assert 0.02 <= time.monotonic() - t0 < 5.0


def test_maybe_hang_raises_when_watchdog_trips():
    faults.install(faults.FaultSchedule.parse("hang@3:secs=999"))
    wd = Watchdog(phase_default=0.05)
    wd.arm(3)
    t0 = time.monotonic()
    with pytest.raises(faults.HangTimeout) as ei:
        faults.maybe_hang("dispatch", 3, wd)
    wd.close()
    detect = time.monotonic() - t0
    assert detect < 5.0                         # bounded, not 999s
    assert ei.value.level == 3 and ei.value.waited_s <= detect + 0.1
    assert ei.value.kind == "hang"


def test_maybe_hang_raises_on_expired_run_deadline():
    clk_real = time.monotonic
    faults.install(faults.FaultSchedule.parse("hang@2:secs=999"))
    wd = Watchdog(run_deadline_s=1e-9, clock=clk_real).start()
    with pytest.raises(faults.HangTimeout):
        faults.maybe_hang("chunk", 2, wd)


# ---------------------------------------------------------------------------
# unified retry budget
# ---------------------------------------------------------------------------

def test_retry_budget_exponential_backoff_and_exhaustion():
    b = RetryBudget(max_attempts=3, base=0.1, factor=2.0, cap=10.0,
                    jitter=0.0)
    assert b.spend("kernel") == pytest.approx(0.1)
    assert b.spend("hang") == pytest.approx(0.2)
    assert b.spend("kernel") == pytest.approx(0.4)
    assert b.exhausted
    assert b.spend("state") is None             # exhausted: no charge
    assert b.by_kind == {"kernel": 2, "hang": 1}


def test_retry_budget_backoff_capped():
    b = RetryBudget(max_attempts=10, base=1.0, factor=10.0, cap=2.0,
                    jitter=0.0)
    b.spend("a")
    assert b.spend("a") == pytest.approx(2.0)


def test_retry_budget_jitter_is_seeded_and_bounded():
    vals1 = [RetryBudget(seed=7).spend("x") for _ in range(1)]
    vals2 = [RetryBudget(seed=7).spend("x") for _ in range(1)]
    assert vals1 == vals2                       # deterministic chaos runs
    b = RetryBudget(max_attempts=50, base=0.1, factor=1.0, cap=1.0,
                    jitter=0.25, seed=3)
    for _ in range(50):
        v = b.spend("mixed")
        assert 0.1 <= v <= 0.1 * 1.25 + 1e-12


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_retry_budget_backoff_sequence_equals_reference(seed):
    """The seeded jittered backoff is the JAX package's, draw for draw,
    so a chaos run sleeps the same in both packages."""
    kw = dict(max_attempts=6, base=0.05, factor=2.0, cap=0.5, jitter=0.25,
              seed=seed)
    port, jax = RetryBudget(**kw), jsupervisor.RetryBudget(**kw)
    kinds = ["kernel", "hang", "state", "kernel", "transient", "x", "y"]
    assert [port.spend(k) for k in kinds] == [jax.spend(k) for k in kinds]
    assert port.by_kind == jax.by_kind and port.exhausted
