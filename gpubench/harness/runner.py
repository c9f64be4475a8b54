"""One run of one cell: set-up, the measured window of whole fits, the
check against the plain reference, and the result line.

The window: each fit is a fresh ``Mirage(MirageConfig(...)).fit`` on
the graphs made in set-up.  A fit starts while the window's clock is
under ``seconds`` or fewer than ``MIN_FITS`` have run, and the window
ends when the last fit ends, so it always holds whole fits.
"""
from __future__ import annotations

import sys
import time
import traceback
from typing import Callable, Optional

from . import check, program
from .generator import make_db
from .reference import mine
from .spec import Cell, load_metric
from .tracing import Hooks, install_spans, summarize_trace

__all__ = ["NoDevice", "FORBIDDEN", "MIN_FITS", "run_window", "run_cell",
           "forbidden_modules"]

# top-level module names that no run may load: JAX, its libraries and
# the JAX package the program was ported from (compared whole:
# "repro_torch" is not "repro")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# fits a window holds at least, however long they take.  On one H100 a
# 40K fit runs 45-57 s, about one --seconds of 51, and the speculative
# candgen's cost gate at level 4 adds 6-9 s to some fits and not to
# others: windows of one fit or two, as the first fit ended before or
# after --seconds, spread fit_s by 10-18 %; two fits always, by 5-9 %.
# So a window of such fits runs about 100 s.
MIN_FITS = 2


class NoDevice(RuntimeError):
    """The cell needs more CUDA cards than this machine shows."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_window(fit: Callable[[], program.FitRecord], seconds: float,
               clock: Callable[[], float] = time.perf_counter):
    """Fit back to back: a fit starts while fewer than ``MIN_FITS`` have
    run or the clock is under ``seconds``.  Returns ``(window_s, fits,
    failed)``.  A fit that raises ends the window and counts as failed
    (its traceback goes to standard error)."""
    fits: list[program.FitRecord] = []
    failed = 0
    t0 = clock()
    while len(fits) < MIN_FITS or clock() - t0 < seconds:
        try:
            fits.append(fit())
        except Exception:
            traceback.print_exc()
            failed += 1
            break
    return clock() - t0, fits, failed


def _say(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run ``cell`` once and return its result line as a dict:
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, a
    traced run's ``breakdown``, and ``checks`` last.  ``device="cpu"``
    runs the program's plain versions of the kernels (the CPU tests);
    ``overrides`` changes the program's configuration (the control
    runs alone)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    if cuda:
        count = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if count < cell.chips:
            raise NoDevice(f"cell {cell.name} needs {cell.chips} CUDA "
                           f"card(s); this machine shows {count}")
    sync = torch.cuda.synchronize if cuda else None

    # ---- set-up --------------------------------------------------------
    if cuda:
        # a checkout's first run builds the library (nvcc): part of its
        # set-up, and on a line of its own
        t = time.perf_counter()
        built = program.build_kernels()
        _say(f"kernel library: {time.perf_counter() - t:.3f} s "
             f"({'built' if built else 'cached'})")
    db = make_db(cell.config, seed)
    graphs = program.to_graphs(db)
    hooks = Hooks()
    if trace:
        install_spans(hooks)
        for name in cell.per_layer:
            metric = load_metric(name)
            if hasattr(metric, "install"):
                metric.install(hooks)
    warm = graphs[:int(cell.traffic["warmup_graphs"])]
    warm_failed = 0
    try:
        program.fit_once(warm, cell.config, cell.traffic, device, overrides,
                         sync)
    except Exception:
        # a program that fails here fails in the window too: the run goes
        # on, so that its result says so
        traceback.print_exc()
        warm_failed = 1
    hooks.data.clear()
    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # ---- the window ----------------------------------------------------
    t0_ns = time.time_ns()
    window_s, fits, failed = run_window(
        lambda: program.fit_once(graphs, cell.config, cell.traffic, device,
                                 overrides, sync), seconds)
    t1_ns = time.time_ns()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for f in fits:
        _say(f"fit {f.seconds:.3f} s: levels (s, map s, candgen s, S, "
             f"retried, escalations) " + ", ".join(
                 f"({s['seconds']:.3f}, {s['map_seconds']:.3f}, "
                 f"{s['candgen_seconds']:.3f}, {s['survivor_cap']}, "
                 f"{int(s['retried'])}, {s['escalations']})"
                 for s in f.stats))
    summary = None
    if prof is not None:
        prof.stop()
        summary = summarize_trace(prof.profiler.kineto_results.events(),
                                  t0_ns, t1_ns,
                                  hooks.data.get("spans", []))
        _say(f"trace: {summary['device_events']} device events, "
             f"{summary['outside_window']} outside the window")
    hooks.restore()

    # ---- metrics -------------------------------------------------------
    record = {"setup_s": setup_s, "window_s": window_s, "fits": fits,
              "peak_bytes": peak, "hooks": hooks.data, "trace": summary}
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        metric = load_metric(name)
        value = metric.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": metric.UNIT}
    hooks.data.clear()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check against the plain reference -------------------------
    t_ref = time.perf_counter()
    ref = mine(db, cell.traffic["minsup"], max_size=cell.traffic["max_size"])
    _say(f"reference: {time.perf_counter() - t_ref:.3f} s, levels "
         f"{[len(l) for l in ref.levels]}; fits "
         f"{[round(f.seconds, 3) for f in fits]} s, levels "
         f"{[[len(l) for l in f.levels] for f in fits]}")
    failed += warm_failed
    numbers = check.compare(fits, ref, failed)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": check.is_correct(numbers, len(fits)),
              "attempted": len(fits) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = check.format_checks(numbers)
    return result
