"""The port's span recorder (``repro_torch.runtime.trace``): off by
default and free when off; on, the spans of a CPU fit nest, carry their
counts, account for each level's program time and change no result."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.graphdb import random_db
from repro_torch.core.mining import Mirage, MirageConfig
from repro_torch.runtime import faults, trace

MINSUP, NPARTS = 5, 2
DB = random_db(10, seed=5, n_vertices=9, n_vlabels=2, n_elabels=1)

NAMES = {"fit", "prep.partition.validate", "prep.partition.filter",
         "prep.partition.split", "prep.edge_ol", "prep.edge_ol.stack",
         "prep.level1", "prep.level1.supports", "prep.upload", "level",
         "level.candgen", "level.meta", "level.dispatch", "level.pass1",
         "level.pass2", "level.spec_candgen", "level.wait", "level.retry",
         "level.audit"}


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    faults.reset_log()
    yield
    faults.clear()
    faults.reset_log()
    trace.sink = None


def _fit(**kw):
    return Mirage(MirageConfig(minsup=MINSUP, n_partitions=NPARTS, **kw),
                  device="cpu").fit(DB)


def _traced_fit(schedule=None, **kw):
    spans: list[tuple] = []
    trace.sink = spans.append
    try:
        if schedule is None:
            res = _fit(**kw)
        else:
            with faults.active(faults.FaultSchedule.parse(schedule)):
                res = _fit(**kw)
    finally:
        trace.sink = None
    return res, spans


def _within(inner, outer) -> bool:
    return (inner[4] == outer[4] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def _children(spans, outer, name):
    return [s for s in spans if s[0] == name and s[3] == outer[0]
            and _within(s, outer)]


def _level_span(spans, k):
    (lv,) = [s for s in spans if s[0] == "level" and s[5]["k"] == k]
    return lv


def test_off_is_one_shared_object_with_no_clock_event_or_sink(monkeypatch):
    calls = []

    def clock():
        calls.append(1)
        return 0

    def event(*args, **kwargs):
        raise AssertionError("a CUDA event while tracing is off")

    monkeypatch.setattr(trace, "_clock", clock)
    monkeypatch.setattr(torch.cuda, "Event", event)
    assert trace.sink is None
    off = trace.span("fit")
    assert trace.span("level", k=2) is off
    assert trace.device_span("level.pass2", torch.device("cuda")) is off
    with trace.device_span("level.pass1", torch.device("cuda")) as sp:
        sp.set(slots=4)
    trace.annotate("level", C=1)
    res = _fit()
    assert calls == [] and res.levels


# tracemalloc counts every thread's allocations, so the count runs in a
# fresh interpreter, where no other thread allocates while it runs
_ALLOC = """
import itertools, json, tracemalloc, types
from repro_torch.runtime import trace


class Plain:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def count(body):
    for _ in range(10):
        body()
    tracemalloc.start()
    before, _ = tracemalloc.get_traced_memory()
    tracemalloc.reset_peak()
    for _ in itertools.repeat(None, 10_000):
        body()
    after, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    return after - before, peak - before


cuda, plain = types.SimpleNamespace(type="cuda"), Plain()


def spans():
    with trace.span("x", k=2), trace.device_span("y", cuda, slots=3):
        pass


def baseline():
    with plain, plain:
        pass


print(json.dumps([count(spans), count(baseline)]))
"""


def test_off_allocates_nothing_per_span():
    src = Path(trace.__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", _ALLOC], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr[-2000:]
    (held, peak), (_, base_peak) = json.loads(out.stdout)
    assert held == 0
    # the interpreter's own cost of two nested with-statements, and no
    # more: an object made for a span and held while it is open would
    # show on top of it
    assert peak <= base_peak


def test_traced_fits_nest_under_one_root_each():
    spans: list[tuple] = []
    trace.sink = spans.append
    with faults.active(faults.FaultSchedule.parse("cap_storm@3")):
        _fit()
    _fit()
    trace.sink = None
    roots = [s for s in spans if s[3] is None]
    assert [s[0] for s in roots] == ["fit", "fit"]
    assert len({s[4] for s in roots}) == 2
    assert {s[4] for s in spans} == {s[4] for s in roots}
    for s in spans:
        if s[3] is None:
            continue
        assert any(p[0] == s[3] and _within(s, p) for p in spans), s
    assert {s[0] for s in spans} == NAMES
    assert all(s[1] <= s[2] for s in spans)


def test_tracing_changes_no_result():
    off = _fit()
    on, spans = _traced_fit()
    assert spans
    assert on.levels == off.levels and on.supports == off.supports
    assert [s.n_frequent for s in on.stats] == [s.n_frequent
                                                for s in off.stats]


def test_level_spans_cover_map_seconds():
    res, spans = _traced_fit()
    assert res.stats
    for st in res.stats:
        lv = _level_span(spans, st.level)
        assert lv[5]["C"] == st.n_candidates
        assert lv[5]["n_keep"] == st.n_frequent
        assert lv[5]["S"] == st.survivor_cap
        parts = sum(s[2] - s[1] for name in ("level.dispatch",
                                             "level.spec_candgen",
                                             "level.wait")
                    for s in _children(spans, lv, name)) / 1e9
        assert abs(parts - st.map_seconds) <= max(0.05 * st.map_seconds,
                                                  0.005), (st, parts)
        (wait,) = _children(spans, lv, "level.wait")
        assert wait[5] == {"refetches": 0}
        admitted = lv[5]["spec_admitted"]
        assert len(_children(spans, lv, "level.spec_candgen")) == admitted
        assert admitted == (lv[5]["spec_est_s"] <= lv[5]["spec_window_s"])


def test_pass2_slot_use_and_the_retry():
    res, spans = _traced_fit("cap_storm@2;cap_storm@3")
    assert [s.retried for s in res.stats[:2]] == [True, True]
    for st in res.stats:
        lv = _level_span(spans, st.level)
        (disp,) = _children(spans, lv, "level.dispatch")
        (p2,) = _children(spans, disp, "level.pass2")
        assert len(_children(spans, disp, "level.pass1")) == 1
        assert "device_s" not in p2[5]          # no CUDA events on the CPU
        assert p2[5]["slots"] == st.survivor_cap
        assert 0 <= p2[5]["useful"] <= p2[5]["slots"]
        retries = _children(spans, lv, "level.retry")
        assert lv[5]["retried"] == st.retried
        if st.retried:
            assert p2[5]["useful"] == 0
            (r,) = retries
            # no M escalation on this database: one materialization at
            # the default M
            assert st.escalations == 0
            assert r[5] == {"materializations": 1, "M": 32}
        else:
            assert p2[5]["useful"] == min(st.n_frequent, st.survivor_cap)
            assert retries == []


def test_restoring_the_hook_turns_tracing_off(monkeypatch):
    spans: list[tuple] = []
    off = trace.span("x")
    monkeypatch.setattr(trace, "sink", spans.append)
    with trace.span("x") as sp:
        assert sp is not off
    assert [s[0] for s in spans] == ["x"]
    monkeypatch.undo()
    assert trace.sink is None and trace.span("x") is off
    _fit()
    assert [s[0] for s in spans] == ["x"]
