#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card (an
H100: the kernels are built for sm_90a).  It imports only the port
(``src/repro_torch``), never JAX or the ``repro`` package, and exits
non-zero, printing no result, when a phase fails, when no CUDA device
is present, or when the port is not next to it.  Phases:

  1. device  — the card's name and power limit, then the kernels' build
               (nvcc into build/repro_torch_kernels/, timed);
  2. parity  — both kernels against their plain PyTorch versions on the
               misaligned small shapes of the tests, exact;
  3. small   — ``Mirage.fit`` on the card against the port's own host
               oracle ``mine_host`` on two small databases, exact;
  4. packed  — the main path: one PubChem anticancer screen's scale
               (40,000 molecule-like graphs, ~28 edges) at minsup 15%,
               8 partitions, patterns up to 4 edges, every other
               ``MirageConfig`` field at its default — packed support,
               so the packed kernel runs;
  5. dense   — the Yeast screen's scale (80,000 graphs, >= 2^16, so
               packing switches itself off and the dense kernel runs).

Phases 4 and 5 count kernel launches (set to 0 just before the run,
read just after), run every level dispatch under
``torch.cuda.set_sync_debug_mode("error")`` so that the wire fetch is
the level's only device→host transfer, require every level's audit
word to be 0, and check the frequent set against ``mine_host``.  Then a
second fit of the same database, cut to level 2 and not counted, hands
its level-2 kernel inputs to the kernel and its plain version, which
must agree and are both timed (CUDA events).  The line before the last
is the kernels' JSON record; the last line is the run's JSON verdict.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
REPLACES = {
    "fused_level_packed": "src/repro/kernels/fused_level.py:263",
    "fused_level": "src/repro/kernels/fused_level.py:194",
}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_level.cu"


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def random_level(rng, C=7, P=5, G=20, M=8, K=4, T=6, F=8, PP=1):
    """Random-but-consistent join inputs (ids in [0, 32), PAD -1)."""
    import numpy as np
    pol = rng.integers(0, 32, (PP, P, G, M, K)).astype(np.int32)
    pmask = rng.random((PP, P, G, M)) < 0.7
    pol = np.where(rng.random((PP, P, G, M, K)) < 0.15, -1, pol)
    src = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    dst = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    emask = rng.random((PP, T, G, F)) < 0.7
    src = np.where(emask, src, -1)
    dst = np.where(emask, dst, -1)
    meta = np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)
    return meta, pol, pmask, src, dst, emask


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def time_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median milliseconds of ``runs`` calls, each timed with its own
    pair of CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def level_bound(args, packed: bool, outputs) -> tuple[float, str, dict]:
    """Least time the card could take for one call: the larger of the
    bytes this call's data needs moved over the memory rate, and the
    (m, f) pair compares it needs over the 32-bit rate.

    Bytes: the schedule and tile table (and the valid-graph words) in
    full; for each parent that a tile with a valid row references, its
    mask rows in full plus the K slots of every embedding whose mask is
    set; for each such triple, its mask rows in full plus src and dst of
    every occurrence whose mask is set; each output written once.
    Compares: per valid row, every set parent embedding against every
    set edge occurrence of the same graph."""
    import torch
    if packed:
        sched_meta, tiles, gmask, pol, pmask, src, dst, emask = args
    else:
        sched_meta, tiles, pol, pmask, src, dst, emask = args
        gmask = None
    NT = tiles.shape[0]
    tc = sched_meta.shape[0] // NT
    valid_rows = (sched_meta[:, 5] != 0).reshape(NT, tc).sum(1).cpu()
    tiles_h = tiles.cpu()
    live = valid_rows > 0
    parents = sorted({int(p) for p in tiles_h[live, 0]})
    triples = sorted({int(t) for t in tiles_h[live, 1]})
    PP, _, G, M, K = pol.shape
    F = src.shape[-1]
    nm = pmask.to(torch.int64).sum(-1)           # (PP, P, G) set embeddings
    nf = emask.to(torch.int64).sum(-1)           # (PP, T, G) set occurrences
    nbytes = sched_meta.numel() * 4 + tiles.numel() * 4
    if gmask is not None:
        nbytes += gmask.numel() * 4
    nbytes += len(parents) * PP * G * M * pmask.element_size()
    nbytes += int(nm[:, parents].sum()) * K * 4
    nbytes += len(triples) * PP * G * F * emask.element_size()
    nbytes += int(nf[:, triples].sum()) * (4 + 4)
    nbytes += sum(o.numel() * o.element_size() for o in outputs)
    ops = 0
    for ct in range(NT):
        if valid_rows[ct]:
            p, t = int(tiles_h[ct, 0]), int(tiles_h[ct, 1])
            ops += int(valid_rows[ct]) * int((nm[:, p] * nf[:, t]).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", {"bytes": nbytes, "ops": ops})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    from repro_torch.kernels import fused_level as fl
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    say(f"phase 1 device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path, log = fl.build_kernels()
    say(f"phase 1 build: {KERNEL_SOURCE} -> {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    return card


def phase_parity_small():
    import numpy as np
    import torch
    from repro_torch.core.candgen import pad_schedule, schedule_candidates
    from repro_torch.kernels.ops import (fused_level_supports,
                                         fused_level_supports_packed)
    cases = [  # (shape, tile_c, bucket rows) — the tests' misaligned sweeps
        (dict(C=7, G=20), 8, None),
        (dict(C=9, G=37), 8, None),
        (dict(C=9, G=37), 2, 64),
        (dict(C=9, G=37), 1, None),
        (dict(C=12, G=100, PP=3, M=16, F=20), 4, 64),
        (dict(C=12, P=3, G=16, M=6, K=3, T=3, F=6), 4, None),
        (dict(C=5, G=33, M=3, K=2, F=200), 8, None),
    ]
    worst = 0
    for i, (shape, tc, rows) in enumerate(cases):
        rng = np.random.default_rng(100 + i)
        meta, pol, pmask, src, dst, emask = random_level(rng, **shape)
        if i == 5:            # duplicate parents: heavy (parent, triple) skew
            meta[:, 0] = [1] * 9 + [2] * 3
            meta[:, 4] = [0] * 6 + [2] * 6
        sched = schedule_candidates(meta, tc)
        if rows:
            sched = pad_schedule(sched, rows_to=rows, inv_to=len(meta) + 3)
        cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in
               (sched.meta, sched.tiles, pol, pmask, src, dst, emask)]
        gpu = [x.cuda() for x in cpu]
        for f in (fused_level_supports_packed, fused_level_supports):
            got = f(*gpu)
            torch.cuda.synchronize()
            err = max_abs_err([x.cpu() for x in got], f(*cpu))
            check(err == 0, f"{f.__name__} disagrees with its plain version "
                            f"on case {i} (max abs err {err})")
            worst = max(worst, err)
    say(f"phase 2 parity: {len(cases)} misaligned cases x 2 kernels equal "
        f"their plain versions exactly (max abs err {worst})")


def phase_small():
    from repro_torch.core.graphdb import paper_toy_db, random_db
    from repro_torch.core.host_miner import mine_host
    from repro_torch.core.mining import Mirage, MirageConfig
    dbs = [("paper_toy_db", paper_toy_db(), 2, None),
           ("random_db(18, seed=42)",
            random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                      n_elabels=2, seed=42), 5, 3)]
    for name, graphs, minsup, max_size in dbs:
        want = sorted((c, i.support) for c, i in
                      mine_host(graphs, minsup, max_size=max_size)
                      .frequent.items())
        for packed in (None, False):
            res = Mirage(MirageConfig(minsup=minsup, max_size=max_size,
                                      n_partitions=2, backend="fused",
                                      packed_support=packed)).fit(graphs)
            check(sorted(res.supports.items()) == want,
                  f"{name} packed_support={packed}: the card's frequent set "
                  f"differs from mine_host")
        say(f"phase 3 small: {name} minsup={minsup} max_size={max_size}: "
            f"{len(want)} frequent subgraphs, equal to mine_host (packed "
            f"and dense)")


def main_run(label: str, n_graphs: int, seed: int, packed: bool):
    """Drive Mirage.fit at full scale and check it; returns (result,
    launches, seconds, graphs).  Nothing of the run is held past a
    level, so the peak memory and the survivor caps are the miner's
    own."""
    import numpy as np
    import torch
    import repro_torch.core.level_step as level_step
    import repro_torch.core.mining as mining
    from repro_torch.core.graphdb import pubchem_like_db
    from repro_torch.core.host_miner import mine_host
    from repro_torch.kernels import fused_level as fl

    t0 = time.perf_counter()
    graphs = pubchem_like_db(n_graphs, seed=seed, avg_edges=28)
    n_edges = [g.n_edges for g in graphs]
    say(f"phase {label}: pubchem_like_db({n_graphs}, seed={seed}, "
        f"avg_edges=28): mean {np.mean(n_edges):.2f} edges, max "
        f"{max(n_edges)} ({time.perf_counter() - t0:.1f}s to generate)")
    cfg = mining.MirageConfig(minsup=0.15, n_partitions=8, max_size=4)
    miner = mining.Mirage(cfg)
    check(miner._packed_support(n_graphs) == packed,
          f"packed support should be {'on' if packed else 'off'} at "
          f"{n_graphs} graphs")

    orig_dispatch = mining.dispatch_level
    orig_finish = level_step.PendingLevel.finish
    counts = {"dispatch": 0, "fetch": 0}

    def guarded_dispatch(*args, **kw):
        torch.cuda.synchronize()
        counts["dispatch"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_dispatch(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def counted_finish(self):
        counts["fetch"] += 1
        return orig_finish(self)

    mining.dispatch_level = guarded_dispatch
    level_step.PendingLevel.finish = counted_finish
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.reset_launches()
        t1 = time.perf_counter()
        res = miner.fit(graphs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = dict(fl.launches)
    finally:
        mining.dispatch_level = orig_dispatch
        level_step.PendingLevel.finish = orig_finish
    peak = torch.cuda.max_memory_allocated()

    n_levels = len(res.stats)
    audits = [st.audit for st in res.stats]
    check(n_levels >= 1, "the main run mined no level past 1")
    check(counts["dispatch"] == n_levels == counts["fetch"],
          f"{counts['dispatch']} dispatches / {counts['fetch']} wire "
          f"fetches for {n_levels} levels")
    check(all(w == 0 for w in audits),
          f"audit words {audits} (0 = every device check passed)")
    say(f"phase {label}: fit {secs:.2f}s, frequent per level "
        f"{res.counts()}, {sum(res.counts())} in all, minsup "
        f"{res.minsup}, peak device memory {peak} bytes")
    for st in res.stats:
        say(f"  level {st.level}: candidates={st.n_candidates} "
            f"frequent={st.n_frequent} {st.seconds:.3f}s "
            f"(device+wire {st.map_seconds:.3f}s, hidden candgen "
            f"{st.candgen_seconds:.3f}s) survivor_cap={st.survivor_cap} "
            f"retried={st.retried} escalations={st.escalations} "
            f"overflow={st.overflow}")
    say(f"phase {label}: {counts['dispatch']} level dispatches ran under "
        f"sync debug mode 'error' with 1 wire fetch each; audit words "
        f"{audits}")

    t2 = time.perf_counter()
    want = mine_host(graphs, res.minsup, max_size=cfg.max_size)
    got = sorted(res.supports.items())
    check(got == sorted((c, i.support) for c, i in want.frequent.items()),
          "the frequent set differs from mine_host")
    say(f"phase {label}: frequent set and supports equal mine_host "
        f"({time.perf_counter() - t2:.1f}s for the oracle)")
    return res, launches, secs, graphs


def level2_inputs(graphs, packed: bool):
    """The kernel's arguments at level 2 of the main run's database,
    from a second fit cut to level 2 after the measured one (its
    launches are not counted)."""
    import repro_torch.core.mining as mining
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels import fused_level as fl
    wrapped = "fused_level_packed" if packed else "fused_level"
    orig_kernel = getattr(ops, wrapped)
    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append(args)
        return orig_kernel(*args, **kw)

    before = dict(fl.launches)
    setattr(ops, wrapped, capture)
    try:
        mining.Mirage(mining.MirageConfig(minsup=0.15, n_partitions=8,
                                          max_size=2)).fit(graphs)
    finally:
        setattr(ops, wrapped, orig_kernel)
        fl.launches.update(before)
    check(bool(captured), f"{wrapped}: level 2 never reached the kernel")
    return captured[0]


def kernel_record(name: str, args, packed: bool, launches: int) -> dict:
    """Hold the kernel against its plain version on the main run's
    level-2 inputs, time both, and compute the bound."""
    import torch
    from repro_torch.kernels import fused_level as fl
    kargs = args
    if packed:
        kernel, plain = fl.fused_level_packed, fl.fused_level_packed_ref
    else:
        kernel, plain = fl.fused_level, fl.fused_level_ref
    before = dict(fl.launches)
    got = kernel(*kargs)
    torch.cuda.synchronize()
    want = plain(*kargs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"{name} disagrees with its plain version on the main "
                    f"run's level-2 inputs (max abs err {err})")
    emb_max = int(got[1].max())
    ms = time_ms(lambda: kernel(*kargs), runs=10)
    plain_ms = time_ms(lambda: plain(*kargs), runs=3, warmup=1)
    fl.launches.update(before)      # comparison launches do not count
    bound_ms, bound_by, work = level_bound(kargs, packed, got)
    pol, src = kargs[-5], kargs[-3]
    PP, P, G, M, K = pol.shape
    F = src.shape[-1]
    check(PP * G * M * F < 2 ** 31,
          f"{name}: emb could overflow int32 at these shapes")
    say(f"{name}: level-2 inputs sched {tuple(kargs[0].shape)} tiles "
        f"{tuple(kargs[1].shape)} pol {tuple(pol.shape)} src "
        f"{tuple(src.shape)}; exact vs plain; kernel {ms:.3f} ms "
        f"(median of 10), plain {plain_ms:.3f} ms (median of 3), bound "
        f"{bound_ms:.4f} ms by {bound_by} ({work['bytes']} bytes, "
        f"{work['ops']} pair compares); largest emb {emb_max}, int32 "
        f"headroom bound PP*G*M*F={PP * G * M * F}; launches per level 1")
    return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main() -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device is available")
        return 2
    if not (SRC / "repro_torch").is_dir():
        say(f"FAIL: the port is not next to this script ({SRC})")
        return 2
    sys.path.insert(0, str(SRC))
    try:
        card = phase_device()
        phase_parity_small()
        phase_small()
        _, launches4, _, graphs = main_run("4 packed", 40_000, 0, True)
        check(launches4["fused_level_packed"] > 0,
              "the packed kernel never launched on the main path")
        args4 = level2_inputs(graphs, True)
        rec_packed = kernel_record("fused_level_packed", args4, True,
                                   launches4["fused_level_packed"])
        del args4, graphs
        torch.cuda.empty_cache()
        _, launches5, _, graphs = main_run("5 dense", 80_000, 1, False)
        check(launches5["fused_level"] > 0,
              "the dense kernel never launched on the main path")
        args5 = level2_inputs(graphs, False)
        rec_dense = kernel_record("fused_level", args5, False,
                                  launches5["fused_level"])
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": [rec_packed, rec_dense]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
