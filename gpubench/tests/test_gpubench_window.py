"""The window's accounting: whole fits, fit_s = window / fits."""
import pytest

from harness.program import FitRecord
from harness.runner import MIN_FITS, run_window
from harness.spec import load_metric


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_fit(clock, seconds):
    def fit():
        clock.t += seconds
        return FitRecord(seconds, [], [], {}, 1)
    return fit


@pytest.mark.parametrize("fit_seconds, window, n_fits, window_s", [
    (40.0, 10, 2, 80.0),       # long fits: the window is MIN_FITS of them
    (4.0, 10, 3, 12.0),        # starts at 0, 4, 8; the third ends at 12
    (5.0, 10, 2, 10.0),        # starts at 0 and 5; 10 is not under 10
    (3.0, 0, 2, 6.0),          # MIN_FITS fits whatever the length
    (40.0, 51, 2, 80.0),       # at least two fits, however long
    (30.0, 51, 2, 60.0),       # the second starts at 30, under 51
    (20.0, 51, 3, 60.0),       # the third starts at 40, under 51
    (13.0, 51, 4, 52.0),       # the fourth starts at 39; 52 is past 51
])
def test_whole_fits(fit_seconds, window, n_fits, window_s):
    assert MIN_FITS == 2
    clock = Clock()
    w, fits, failed = run_window(fake_fit(clock, fit_seconds), window,
                                 clock)
    assert (w, len(fits), failed) == (window_s, n_fits, 0)
    record = {"window_s": w, "fits": fits}
    assert load_metric("fit_s").read(record) == window_s / n_fits


def test_failed_fit_ends_the_window():
    clock = Clock()
    calls = []

    def fit():
        calls.append(1)
        clock.t += 1.0
        if len(calls) == 2:
            raise RuntimeError("planted")
        return FitRecord(1.0, [], [], {}, 1)

    w, fits, failed = run_window(fit, 10, clock)
    assert (len(fits), failed, w) == (1, 1, 2.0)


def test_level_readers():
    stats = [dict(seconds=3.0, map_seconds=2.0, retried=True, escalations=1),
             dict(seconds=1.0, map_seconds=0.5, retried=False, escalations=0)]
    fits = [FitRecord(10.0, stats, [], {}, 1),
            FitRecord(12.0, stats, [], {}, 1)]
    rec = {"fits": fits}
    assert load_metric("prep_s").read(rec) == pytest.approx(7.0)
    assert load_metric("level_host_s").read(rec) == pytest.approx(1.5)
    assert load_metric("level_program_s").read(rec) == pytest.approx(2.5)
    assert load_metric("level_retries").read(rec) == 2
    assert load_metric("device_idle_pct").read({"trace": None}) is None
    assert load_metric("device_idle_pct").read(
        {"trace": {"busy_s": 1.0, "window_s": 4.0}}) == 75.0
    assert load_metric("b1_roofline_pct").read({"hooks": {}}) is None
