"""Spans inside ``Mirage.fit``: where a fit spends its time, on the host's
clock and, for the level program's two passes, on the device's.

Tracing is off by default and on, process-wide, while ``sink`` is set to
a callable.  Each closed span goes to it as one tuple::

    (name, start_ns, end_ns, parent, fit, attrs)

``start_ns``/``end_ns`` are ``time.time_ns()`` (the clock
``torch.profiler`` stamps its device events with), ``parent`` is the name
of the span open around it (None at a root), ``fit`` the id shared by
every span of one ``fit`` call (None outside one) and ``attrs`` a dict of
the counts made at the span's boundary.  ``sink = spans.append`` keeps
them in a list; setting ``sink`` back to None turns tracing off.

Off, ``span`` and ``device_span`` return one shared object that does
nothing: no allocation, no clock read, no CUDA call.

A device span (``device_span``) on a CUDA device also records a pair of
``torch.cuda.Event`` on the current stream.  The recorder never
synchronizes: a device span is sent when the ``fit`` around it closes
(after the fit's last wire fetch has waited for the device), with
``attrs["device_s"]`` where its end event has completed by then.  Until
it is sent, ``annotate`` may still add to its attributes.

The spans of a fit (``core/partition.py``, ``core/mining.py``,
``core/level_step.py``; README.md lists what each covers): ``fit``;
``prep.partition.validate``/``.filter``/``.split``; ``prep.edge_ol`` and
``prep.edge_ol.stack``; ``prep.level1`` and ``prep.level1.supports``;
``prep.upload``; and per level ``level``, ``level.candgen``,
``level.meta``, ``level.dispatch``, the device spans ``level.pass1`` and
``level.pass2``, ``level.spec_candgen``, ``level.wait``, ``level.retry``
and ``level.audit``.
"""
from __future__ import annotations

import itertools
import threading
from time import time_ns as _clock
from typing import Callable, Optional

__all__ = ["sink", "span", "device_span", "annotate"]

# the callable each closed span is sent to; None = tracing off
sink: Optional[Callable[[tuple], object]] = None

_fit_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of tracing off: a context manager that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _state():
    st = getattr(_local, "state", None)
    if st is None:
        # (open spans, innermost last; closed device spans not yet sent)
        st = _local.state = ([], [])
    return st


class _Span:
    __slots__ = ("name", "attrs", "parent", "fit", "start_ns", "end_ns",
                 "events", "device", "sink")

    def __init__(self, name: str, attrs: dict, device: bool, events):
        self.name, self.attrs = name, attrs
        self.device, self.events = device, events
        self.sink = sink

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack, _ = _state()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        self.fit = (next(_fit_ids) if self.name == "fit"
                    else outer.fit if outer is not None else None)
        stack.append(self)
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self.events is not None:
            self.events[1].record(self.events[2])
        stack, pending = _state()
        stack.remove(self)
        if self.device:
            pending.append(self)
        else:
            self._send()
        if pending and (self.name == "fit" or not stack):
            for s in pending:
                s._resolve()
                s._send()
            pending.clear()
        return False

    def _resolve(self) -> None:
        if self.events is not None and self.events[1].query():
            self.attrs["device_s"] = (
                self.events[0].elapsed_time(self.events[1]) / 1e3)

    def _send(self) -> None:
        if self.sink is not None:
            self.sink((self.name, self.start_ns, self.end_ns, self.parent,
                       self.fit, self.attrs))


def span(name: str, **attrs):
    """A host span: ``with span("level", k=2) as s: ...; s.set(C=40)``."""
    if sink is None:
        return _OFF
    return _Span(name, attrs, False, None)


def device_span(name: str, device, **attrs):
    """A span of work queued on ``device``: a host span that is sent when
    its fit closes, timed on the device too when ``device`` is CUDA."""
    if sink is None:
        return _OFF
    events = None
    if device.type == "cuda":
        import torch
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True),
                  torch.cuda.current_stream(device))
    return _Span(name, attrs, True, events)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the newest span ``name`` not yet sent: an open
    one, else a closed device span of the fit still open.  Does nothing
    when there is none, or tracing is off."""
    if sink is None:
        return
    stack, pending = _state()
    for s in itertools.chain(reversed(stack), reversed(pending)):
        if s.name == name:
            s.attrs.update(attrs)
            return
