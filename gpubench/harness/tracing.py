"""What a traced run (``--trace 1``) records, from the benchmark's side
only: the program is not edited.

* Spans: wrappers around the calls into each layer of the program, kept
  in memory as ``(label, start_ns, end_ns)`` on the host's clock
  (``time.time_ns``, the clock the profiler's events carry).
* Hooks: a metric's reader may wrap a program function of its own
  (``Hooks.patch``) and keep what it records in ``Hooks.data``.
* The device trace: ``torch.profiler`` (CUPTI) over the window, device
  activities only; from it the seconds in which a kernel, copy or set
  ran on the card, the operations that took most time, and the idle
  time between them, each gap labelled by the span open on the host.
"""
from __future__ import annotations

import functools
import importlib
import time
from typing import Callable

__all__ = ["SPANS", "Hooks", "install_spans", "summarize_trace"]

# (module, attribute, label): the span each call into a layer opens.
# "Class.method" wraps a method.
SPANS = [
    ("repro_torch.core.mining", "make_partitions", "prep.partition"),
    ("repro_torch.core.mining", "build_edge_ol", "prep.edge_ol"),
    ("repro_torch.core.mining", "level1_ol", "prep.level1"),
    ("repro_torch.core.mining", "generate_candidates", "candgen"),
    ("repro_torch.core.mining", "candidate_meta", "candgen.meta"),
    ("repro_torch.core.level_step", "schedule_candidates", "schedule"),
    ("repro_torch.core.level_step", "level_program", "level_program"),
    ("repro_torch.core.level_step", "_fetch_wire", "wire_fetch"),
    ("repro_torch.core.mining", "map_materialize", "retry"),
    ("repro_torch.core.auditor", "Auditor.check_level", "audit"),
]


class Hooks:
    """Patches of program attributes, undone by ``restore``, and the data
    that the patched functions record (cleared when the window opens)."""

    def __init__(self):
        self.data: dict = {}
        self._undo: list[tuple[object, str, object]] = []

    def patch(self, owner, name: str, make: Callable[[Callable], Callable]):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def restore(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)


def _span(hooks: Hooks, label: str):
    def make(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                hooks.data.setdefault("spans", []).append(
                    (label, t0, time.time_ns()))
        return wrapped
    return make


def install_spans(hooks: Hooks) -> None:
    for module, attr, label in SPANS:
        owner = importlib.import_module(module)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        hooks.patch(owner, name, _span(hooks, label))


_DEVICE_KINDS = ("kernel", "memcpy", "memset")


def _device_events(events):
    """(name, start_ns, end_ns) of the kernels, copies and sets."""
    out = []
    for e in events:
        if "CUDA" not in str(e.device_type()):
            continue
        kind = str(getattr(e, "activity_type", lambda: "kernel")()).lower()
        if not any(k in kind for k in _DEVICE_KINDS):
            continue
        start = e.start_ns()
        dur = e.duration_ns()
        if dur > 0:
            out.append((e.name(), start, start + dur))
    return out


def _merge(intervals):
    merged: list[list[int]] = []
    for a, b in sorted((a, b) for _, a, b in intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _segments(spans):
    """The host's timeline cut where any span opens or closes, each piece
    labelled by the innermost span open over it (the latest to open):
    sorted, non-overlapping ``(start, end, label)``."""
    cuts = sorted({t for _, a, b in spans for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for label, sa, sb in spans:
            if sa <= a and b <= sb and (best is None or sa > best[1]):
                best = (label, sa)
        if best is not None:
            out.append((a, b, best[0]))
    return out


def _idle_by_span(gaps, spans) -> dict[str, int]:
    """Idle nanoseconds of ``gaps`` (sorted, disjoint) by the span open
    on the host over each part of them; "other" where none was."""
    segs = _segments(spans)
    idle: dict[str, int] = {}
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            sa, sb, label = segs[k]
            part = min(b, sb) - max(a, sa)
            if part > 0:
                idle[label] = idle.get(label, 0) + part
                covered += part
            k += 1
        if b - a > covered:
            idle["other"] = idle.get("other", 0) + (b - a - covered)
    return idle


def summarize_trace(events, t0: int, t1: int, spans) -> dict:
    """From the profiler's events and the window ``[t0, t1]`` (ns):
    ``busy_s``, ``window_s``, the ten device operations that took most
    time, and the idle seconds by the host's span, the ten largest."""
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b in _device_events(events)]
    outside = sum(1 for _, a, b in dev if b <= a)
    dev = [d for d in dev if d[2] > d[1]]
    busy = _merge(dev)
    busy_ns = sum(b - a for a, b in busy)
    by_op: dict[str, int] = {}
    for n, a, b in dev:
        by_op[n] = by_op.get(n, 0) + (b - a)
    gaps = []
    edge = t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle = _idle_by_span(gaps, spans)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": [[n[:120], v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps_top],
            "device_events": len(dev), "outside_window": outside}
