"""The program's own spans in a traced run (``--trace 1``): the span
recorder of ``repro_torch.runtime.trace``, turned on by setting its sink
through ``Hooks.patch`` (``hooks.restore()`` turns it off again).

The sink keeps each closed span, ``(name, start_ns, end_ns, parent, fit,
attrs)``, in ``hooks.data["program_spans"]``, and each span's host
interval in ``hooks.data["spans"]`` beside the benchmark's wrappers, so
that ``summarize_trace`` names each idle stretch of the card by the
innermost span open on the host.  A program without the recorder leaves
nothing to read: each reader then returns None.
"""
from __future__ import annotations

from typing import Callable, Optional

__all__ = ["install", "spans", "per_fit", "host_s"]

KEY = "program_spans"


def install(hooks) -> None:
    """Set the recorder's sink to keep the program's spans in ``hooks``
    (once, however many metrics call this)."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return
    if getattr(trace.sink, "hooks", None) is hooks:
        return

    def sink(rec: tuple) -> None:
        hooks.data.setdefault(KEY, []).append(rec)
        hooks.data.setdefault("spans", []).append(rec[:3])

    sink.hooks = hooks
    hooks.patch(trace, "sink", lambda _old: sink)


def spans(record) -> list[tuple]:
    """The program's spans of the window."""
    return record["hooks"].get(KEY, [])


def per_fit(record, value: Callable[[tuple], Optional[float]]
            ) -> Optional[float]:
    """Σ ``value(span)`` over the window's spans, per ``fit`` span; spans
    for which it gives None are left out.  None when the window has no
    ``fit`` span (the program records none) or every value is None."""
    recs = spans(record)
    fits = sum(1 for r in recs if r[0] == "fit")
    vals = [v for v in map(value, recs) if v is not None]
    if not fits or not vals:
        return None
    return sum(vals) / fits


def host_s(name: str, prefix: bool = False):
    """``value`` for ``per_fit``: the host seconds of spans named
    ``name`` (or under it, ``name.*``, with ``prefix``), 0 for others."""
    def value(r: tuple) -> float:
        hit = r[0].startswith(name + ".") if prefix else r[0] == name
        return (r[2] - r[1]) / 1e9 if hit else 0.0
    return value
