#!/usr/bin/env python3
"""What the program's span recorder (``repro_torch.runtime.trace``) costs
and how much of a fit its spans account for, on one cell of the
benchmark (``BENCHMARK.json``), without the device profiler.

    python3 tools/trace_check.py --workload nci40k.ms15 --seed 7 \
        --out build/trace_check.json

From the root of a checkout, on a machine with a CUDA card.  After the
benchmark's set-up (the database from the seed, a warm-up fit on its
slice) it fits the whole database four times, the recorder off, on, on,
off (cost: each fit's seconds and its levels' seconds), then once more
with the benchmark's wrapper spans (``gpubench/harness/tracing.py``)
beside the recorder (accounting): the program's ``prep.partition.*``
against the wrapper's ``prep.partition``; each level's
``level.dispatch`` + ``level.spec_candgen`` + ``level.wait`` against its
``LevelStats.map_seconds``; and the parts of ``prep_s`` (the fit's
seconds less its levels' seconds).  Last, the host cost of one span,
on and off.  Prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "gpubench"), str(ROOT / "src")]

from harness import program, program_trace  # noqa: E402
from harness.generator import make_db  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from harness.tracing import Hooks, install_spans  # noqa: E402


def _fit(graphs, cell, device, sync):
    return program.fit_once(graphs, cell.config, cell.traffic, device, None,
                            sync)


def _dur(r) -> float:
    return (r[2] - r[1]) / 1e9


def _within(inner, outer) -> bool:
    return (inner[4] == outer[4] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def accounting(rec, prog: list, wrappers: list) -> dict:
    """The program's spans of one fit against the wrappers' and against
    ``LevelStats``."""
    part = sum(_dur(r) for r in prog if r[0].startswith("prep.partition."))
    wpart = sum((b - a) / 1e9 for n, a, b in wrappers
                if n == "prep.partition")
    levels = []
    by_k = {r[5]["k"]: r for r in prog if r[0] == "level"}
    for s in rec.stats:
        lv = by_k[s["level"]]
        parts = {n: sum(_dur(r) for r in prog if r[0] == n
                        and r[3] == "level" and _within(r, lv))
                 for n in ("level.dispatch", "level.spec_candgen",
                           "level.wait", "level.candgen", "level.meta",
                           "level.retry", "level.audit")}
        covered = (parts["level.dispatch"] + parts["level.spec_candgen"]
                   + parts["level.wait"])
        levels.append(dict(
            k=s["level"], seconds=s["seconds"], map_seconds=s["map_seconds"],
            covered_s=covered, gap_s=covered - s["map_seconds"],
            level_span_s=_dur(lv), attrs=lv[5], **{
                n.split(".", 1)[1] + "_s": v for n, v in parts.items()}))
    (fit,) = [r for r in prog if r[0] == "fit"]
    top = Counter()
    for r in prog:
        if r[3] == "fit":
            top[r[0]] += _dur(r)
    stat_k = {s["level"] for s in rec.stats}
    terminal = sum(_dur(r) for k, r in by_k.items() if k not in stat_k)
    prep_s = rec.seconds - sum(s["seconds"] for s in rec.stats)
    in_fit = _dur(fit) - sum(top.values())
    return {
        "prep_partition_s": part, "wrapper_prep_partition_s": wpart,
        "partition_ratio": part / wpart if wpart else None,
        "levels": levels,
        "prep_s": prep_s,
        "prep_s_parts": {
            **{n: v for n, v in top.items() if n != "level"},
            "terminal_level": terminal,
            # inside the fit span, under no child span: the auditor's and
            # the config's set-up, the triples, the level loop's own
            # bookkeeping between levels
            "fit_self": in_fit,
            # fit_once's clock around the fit span: Mirage() and the
            # device sync after it
            "outside_fit": rec.seconds - _dur(fit),
            # each level's seconds are on perf_counter, the span's on
            # time_ns: the level span less its LevelStats seconds
            "level_span_less_stats": sum(
                _dur(r) for k, r in by_k.items() if k in stat_k)
            - sum(s["seconds"] for s in rec.stats)}}


def host_cost(n: int = 200_000) -> dict:
    """Host microseconds of one ``with span(...)`` block, off and on (the
    sink a list's ``append``)."""
    from repro_torch.runtime import trace
    out = {}
    for mode in ("off", "on"):
        kept: list = []
        trace.sink = kept.append if mode == "on" else None
        try:
            t = time.perf_counter()
            for _ in range(n):
                with trace.span("x", k=1):
                    pass
            out[f"{mode}_us"] = (time.perf_counter() - t) / n * 1e6
        finally:
            trace.sink = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.runtime import trace
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else None
    cell = load_cell(args.workload)
    if cuda:
        program.build_kernels()
    graphs = program.to_graphs(make_db(cell.config, args.seed))
    _fit(graphs[:int(cell.traffic["warmup_graphs"])], cell, args.device,
         sync)

    cost = []
    for mode in ("off", "on", "on", "off"):
        kept: list = []
        trace.sink = kept.append if mode == "on" else None
        try:
            rec = _fit(graphs, cell, args.device, sync)
        finally:
            trace.sink = None
        cost.append({"mode": mode, "fit_s": rec.seconds, "spans": len(kept),
                     "levels": [[s["level"], s["seconds"], s["map_seconds"]]
                                for s in rec.stats]})

    hooks = Hooks()
    install_spans(hooks)
    program_trace.install(hooks)
    try:
        rec = _fit(graphs, cell, args.device, sync)
    finally:
        hooks.restore()
    prog = hooks.data.get(program_trace.KEY, [])
    wrappers = list((Counter(hooks.data.get("spans", []))
                     - Counter(r[:3] for r in prog)).elements())
    out = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name() if cuda else "cpu",
           "cost": cost, "accounting": accounting(rec, prog, wrappers),
           "host_cost_per_span": host_cost()}
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
