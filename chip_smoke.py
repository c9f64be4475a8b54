#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card (an
H100: the kernels are built for sm_90a).  It imports only the port
(``src/repro_torch``), never JAX or the ``repro`` package, and exits
non-zero, printing no result, when a phase fails, when no CUDA device
is present, or when the port is not next to it.  Phases:

  1. device  — the card's name and power limit, then the kernels' build
               (every csrc/*.cu, one nvcc each, in parallel, into
               build/repro_torch_kernels/, timed);
  2. parity  — the four kernels against their plain PyTorch versions on
               misaligned small shapes (long mask spans, masks with holes,
               stub/to outside [0, K), unsorted tiles, verdict words past
               G, a candidate table padded with copies of one row, runs
               of equal rows, offset data pointers, more rows than the
               reduction's grid, 1,791 triples — the last count whose
               span table fits in shared memory — and 1,792 and 1,914
               past it), exact, with outputs that start as garbage; the
               two-launch join's zeros for a run of rows outside the
               stores;
  3. small   — ``Mirage.fit`` on the card against the port's own host
               oracle ``mine_host`` on two small databases, exact, with
               the fused backend (packed and dense), the two-launch
               backend "pallas", and the legacy pipeline; and, with the
               fused backend, a 400-graph DB of 1,914 directed edge
               triples, past the span table;
  4. packed  — the main path: one PubChem anticancer screen's scale
               (40,000 molecule-like graphs, ~28 edges) at minsup 15%,
               8 partitions, patterns up to 4 edges, every other
               ``MirageConfig`` field at its default — packed support,
               so the packed kernel runs;
  5. dense   — the Yeast screen's scale (80,000 graphs, >= 2^16, so
               packing switches itself off and the dense kernel runs);
  6. two-launch — phase 4's database and config with backend "pallas":
               the two-launch kernels (join, then reduction) under a
               packed shuffle and wire, as in the JAX package;
  7. legacy  — the same database with ``pipeline="legacy"`` and backend
               "pallas": the two-program pipeline, several host round
               trips per level by design;
  8. multi-worker — two ranks of a gloo group, each a spawned process on
               the one card (NCCL refuses two ranks on one GPU): the
               conformance matrix (sharded wire x partition scheme x
               overlapped candgen, plus psum) on the conformance DB and
               a 20-graph molecule-like DB, the skewed DB of
               ``tests/test_elastic.py`` under single-sync and the legacy
               two-launch pipeline (a rebalance must fire), then phase
               4's 40,000-graph run at W=2, 4 partitions a rank; every
               rank against ``mine_host`` (phase 4's result for 40K),
               each rank's launches and wire fetches per level printed;
               Then a worker loss at level 3 on two ranks: rank 1
               retires, rank 0 resumes alone from the level-2 checkpoint;
  9. nccl    — a one-rank NCCL group (``MiningMesh.from_process_group``)
               mining the small DBs with the fused and two-launch
               backends: the level program's collectives on the
               production backend, every dispatch under sync debug mode
               'error', one wire fetch per level;
 10. supervised — phase 4's database and config under
               ``MiningSupervisor`` with the schedule
               ``kernel_fault@3;wire_bitflip@4`` and one kernel fault per
               rung: level 2 runs the packed kernel, the fault at level
               3 descends the ladder to the two-launch kernels, which
               mine levels 2-4 afresh, level 4's flipped wire heals with
               one re-fetch, and the result equals phase 4's oracle.
 11. device-loop — run right after phase 4: ``pipeline="device_loop"``,
               the whole run queued on the card with no host read
               between levels (device candgen, canonicality machine and
               schedule, then B1 / B2 / B3 + B4 and pass 2's kernel in
               each level body), on
               the 18-graph DB of ``tests/test_device_loop.py`` with the
               packed and dense fused kernels and the two-launch kernels
               (and ``candgen="device"`` once), then phase 4's database
               and config; each run completes without falling back to
               single-sync, equals ``mine_host`` (and phase 4's levels,
               in order), makes one wire copy per run under sync debug
               mode 'error' held from its first body, and launches its
               kernels once per body.  Every kernel call of the small
               runs, and the first call of a 40K run (a second fit
               ended there), is held against its plain version on the
               same inputs (device-built schedule, pad rows and tiles,
               SPP-slot stores; max abs err 0).  The 40K run's bodies
               are timed with CUDA events (with pass 2's launch in each
               body of the last run), and one more body
               with no parents left, on its final carry, times a level
               past the fixpoint.
 12. examples — ``examples/quickstart_torch.py`` on the card (the toy
               DB's 13 patterns and a 60-graph molecule-like DB against
               ``mine_host``, kernel launches counted from 0), then
               ``examples/mine_distributed_torch.py --workers 2``: two
               gloo ranks on cuda:0 under ``torch.distributed.run``, a
               run cut at level 2 and a resumed run whose levels equal
               ``mine_host``'s;
 13. serving — the LM serving path (no kernel of the miner: its
               attention and matmuls are PyTorch ops, as they are
               ``jnp`` code in the JAX package), in a process of its
               own: ``examples/serve_lm_torch.py --full`` serves
               qwen2.5-14b at its published width and depth (48 layers,
               bf16, random weights from a seeded generator) to 4
               requests of 16 prompt and 24 generated tokens, twice,
               with identical tokens, timed with CUDA events (prefill,
               decode per token) beside its weight bytes and peak
               memory; cached decode against a re-forward of the prefix
               at full width cut to 2 layers in float32 (tolerance 2e-4
               of max(1, max |logit|)); the four dense smoke configs on
               the card against the CPU on the same weights, float32
               (tolerance 1e-4).
 14. serving-moe — the mixture-of-experts family (routing, both
               dispatches, the experts' products and MLA are PyTorch
               ops, as they are ``jnp`` in the JAX package), in a process
               of its own: deepseek-v2-lite at its published width and
               depth (27 layers, MLA, 64 routed experts top-6 + 2 shared,
               bf16, float32 routers) through ``serve_lm_torch.py
               --full``, and phi3.5-moe at full width with its depth cut
               to 4 of 32 layers (its 83.75 GB of bf16 weights do not fit
               the card; 4, not 8, for the run's time), each serving 4 requests of 16 prompt and 24
               generated tokens twice, with identical tokens, timed as in
               phase 13; deepseek's decode under ``torch.profiler``;
               cached decode against a re-forward at deepseek's full
               width cut to 2 layers (1 dense + 1 MoE), float32, at
               capacity factor E/k so that no pair is dropped (tolerance
               2e-4); both MoE smoke configs with each ``moe_impl`` on
               the card against the CPU, float32 (tolerance 1e-4).
 15. serving-ssm — the recurrent families (Mamba2's chunked SSD,
               mLSTM, sLSTM, zamba2's shared attention: PyTorch ops), in
               a process of its own: zamba2-2.7b and xlstm-1.3b at full
               width and depth, each serving 4 requests twice with
               identical tokens, weight bytes and parameters held
               against ``repro``'s, a profiled decode, one 1,024-token
               prefill with each block kind's share; cached decode
               against a re-forward (full width cut to one unit,
               float32, across chunk boundaries) and both smoke configs
               on the card against the CPU.
 16. serving-encdec-vlm — the encoder-decoder and VLM families (the
               encoder, cross-attention and M-RoPE are PyTorch ops, as
               they are ``jnp`` in the JAX package), in a process of its
               own: whisper-base at full width and depth (1,500 stub
               frames, 30 s of audio) and qwen2-vl-72b at full width cut
               to 8 of 80 layers (a 16 × 16 stub image and 16 text
               tokens), bf16, each serving 4 requests of 16 prompt and 24
               generated tokens twice with identical tokens, timed as in
               phase 13, with a profiled decode; parameter counts held
               against ``repro``'s at full width; cached decode against
               a re-forward in float32 (whisper at full width and depth,
               its cross caches still 1,500 frames long after the
               decode; qwen2-vl at full width cut to 2 layers, its M-RoPE
               positions continuing through the re-forward; tolerance
               2e-4) and both smoke configs on the card against the
               CPU, float32 (tolerance 1e-4).
 17. training — the LM training path (the loss, autograd through
               remat, AdamW, the loop, the compressed data-parallel
               step: PyTorch ops, as they are ``jnp`` in the JAX
               package), in a process of its own: minicpm-2b at full
               width and depth (40 layers, d 2,304, vocab 122,753,
               tied, remat "block"; 2,724,880,896 float32 masters that
               take gradients, bf16 compute) trained 10 steps of 8 x 64
               tokens through ``repro_torch.launch.train`` at the CLI's
               AdamW defaults (step-0 loss within 0.5 of ln V, every
               loss and grad norm finite, peak and masters' bytes), and
               its first 3 steps again from the same seed through
               ``train_loop`` with the CLI's config (losses within
               1e-6); 3 more
               steps split by CUDA events into forward + backward and
               AdamW, one under ``torch.profiler``; one step at lr 1e-5
               lowers its batch's loss; 3 compressed (int8 error
               feedback) data-parallel steps in a one-rank NCCL group at
               full width; at full width cut to 2 layers, remat on =
               off (bf16, 1e-5) and 2 microbatches = 1 (float32, 1e-5);
               a float32 train step of each of the ten smoke configs on
               the card against the CPU (loss 1e-5, gradients and
               updated masters 1e-4); a smoke run cut at step 6 and
               resumed from its checkpoint equals the uncut run (1e-6);
               last, ``train_loop(mesh=)`` on a 1×1 ("data", "model")
               mesh over a one-rank NCCL group: minicpm-2b at full width
               and depth, 2 steps with the CLI run's pipeline and AdamW,
               losses equal to the CLI run's first 2 (1e-6), its peak —
               the mesh path (DTensor masters, use-site gathers, shard
               hints, sharded loss and optimizer) at full depth on the
               production backend, degenerate as a mesh (every placement
               ``Replicate``); then minicpm-2b at full width and depth
               with bf16 weights held for serving, 4 requests x 16
               prompt + 8 decoded tokens unsharded and again placed on
               the 1×1 mesh through the same prefill/decode: tokens and
               every step's logits bit for bit, decode ms a token and
               the decode's peak.
 18. mesh    — FSDP + tensor parallelism: 4 gloo ranks on cuda:0 (NCCL
               refuses several ranks on one card) as a 2×2 ("data",
               "model") mesh, minicpm-2b at full width cut to 2 layers,
               float32, 1 step of 8 x 64 tokens through
               ``train_loop(mesh=)`` at lr 1e-5, against the same step
               unsharded on every rank (losses and gradient norms 1e-5
               relative; each rank's shards of the clipped gradients
               1e-4 of the tensor's largest unsharded gradient, and of
               the final masters 0.5 lr, from the unsharded run's
               blocks); each rank's master bytes
               (held to the specs' share), peak and step seconds, the
               placements of one unit's ``wq``, ``w_up`` and the tied
               embedding; then the same 2-layer model (float32 weights)
               served on the mesh, 4 requests x 16 prompt + 4 decoded
               tokens, with its weights placed by their FSDP specs and by
               their compute specs (replicated over "data"), against the
               unsharded serve on every rank (logits 1e-5, tokens
               identical; each rank's cache bytes = ``cache_specs``'
               share).  Gloo stages every gather and reduce-scatter
               through host memory: the step and decode times are a
               correctness check's, not a speed.
 19. dry run — in a CPU process started with phase 12 (beside phases
               12–18): ``launch.dryrun`` for minicpm-2b ``decode_32k`` on
               the (16, 16) production mesh (rank 0 of a fake group of
               256), ``launch.dryrun_mining`` single / reduce_scatter,
               and the dry run of phase 17's served shape; printed with
               their roofline terms; the mining support round at its
               per-rank shapes run on the card with B3 + B4 from seeded
               stores (equal to the plain join; ms beside the analytic
               t_memory); phase 17's decode ms a token beside
               ``analyze``'s bound and its peak beside the dry run's
               prediction.

A run clock bounds the whole: no phase starts after ``RUN_DEADLINE``
(1,100 s from the start; it fails "FAIL: phase N not started, ..."),
every spawned phase and rank group's timeout is cut to what is left
less ``RUN_MARGIN``, each phase prints "phase N: X s (run Y s)", and
all phases' seconds are printed as one JSON line before the kernels'.

Each rank of phases 8, 9 and 18 carries its group's collective timeout and
is killed when its phase outlasts it, so a rank that raises fails the
phase instead of hanging it; gloo stages phase 8's collectives through
host memory.

Every main run counts kernel launches (set to 0 just before the run,
read just after; pass 2's kernel once a dispatched level and once a
materialization of the retry path or the legacy pipeline) and checks
the frequent set against ``mine_host``
(phases 6, 7 and 10 against phase 4's oracle result); the two main
databases and their oracles are made in a pool of processes started
with the script, beside the card's work.  The single-sync runs
(4, 5, 6) run every level dispatch under
``torch.cuda.set_sync_debug_mode("error")`` so that the wire fetch is
the level's only device→host transfer, and require every level's audit
word to be 0.  Every fit of one database in the script's process
shares one host prep (partitions, edge OLs, level-1 OLs, kept by
``prep_memo``): the 40K DB's, made by phase 4's fit, from phase 4 to
phase 10 (run in the order 4, 11, 6, 7, 10); the 80K DB's, made in a
thread beside phase 8's ranks, in phase 5, which runs after phase 8.
A fit's seconds after the first are the card's levels and the fit's
own host work.  After phases 4, 5 and 6 a
second fit of the same database, cut to level 2 and not counted,
hands its level-2 kernel
inputs to the kernels and their plain versions, which must agree and
are both timed (CUDA events; a kernel over batches of 10 back-to-back
launches, so that the wrapper's host work hides behind the device's),
with the one PyTorch call that computes the same function where there
is one (for the reduction, ``torch.sum`` x2 in turns with the kernel).
Phase 4 also hands level 3's pass-2 inputs, from a third fit ended at
that call, to pass 2's kernel and its plain version (the per-slot loop),
exact and both timed.
The three join kernels' work counts at those inputs are printed too
(rows joined, (row, partition, graph) triples inside both mask spans,
slot pairs inside the spans, set (m, f) pairs); for the two-launch join
over every meta row and over the heads of its runs of equal rows, the
rows it joins.  The line before the last is the kernels' JSON record;
the last line is the run's JSON verdict.
"""
from __future__ import annotations

import contextlib
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
    "embedding_join": "src/repro/kernels/embedding_join.py:98",
    "support_count": "src/repro/kernels/support_count.py:41",
    # no Pallas kernel: the JAX level step's per-slot lax.cond
    "materialize_level": "src/repro/core/level_step.py:496",
}
SOURCES = {
    "fused_level_packed": "src/repro_torch/kernels/csrc/fused_level.cu",
    "fused_level": "src/repro_torch/kernels/csrc/fused_level.cu",
    "embedding_join": "src/repro_torch/kernels/csrc/two_launch.cu",
    "support_count": "src/repro_torch/kernels/csrc/two_launch.cu",
    "materialize_level": "src/repro_torch/kernels/csrc/materialize.cu",
}
# the 40K main run's configuration (phases 4, 6 and 7)
MAIN_CFG = dict(minsup=0.15, n_partitions=8, max_size=4)


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


RUN_DEADLINE = 1100.0   # seconds from the script's start for every phase
RUN_MARGIN = 20.0       # what a clipped timeout leaves for the phase's end


class RunClock:
    """The run's clock: a phase starts only before ``RUN_DEADLINE``, every
    spawned phase and rank group gets at most what is left of it less
    ``RUN_MARGIN``, and each phase's seconds are printed and kept, so
    that an overrun fails with the phase's name instead of outliving
    the run's limit."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def used(self) -> float:
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def phase(self, name: str):
        used = self.used()
        check(used < RUN_DEADLINE,
              f"{name} not started, {used:.1f} s of the run used")
        t = time.perf_counter()
        yield
        secs = time.perf_counter() - t
        self.seconds[name] = round(self.seconds.get(name, 0.0) + secs, 3)
        say(f"{name}: {secs:.1f} s (run {self.used():.1f} s)")

    def clip(self, label: str, timeout: float) -> float:
        """``timeout`` cut to what is left of the run less the margin."""
        left = RUN_DEADLINE - self.used() - RUN_MARGIN
        check(left > 0, f"{label} not started, {self.used():.1f} s of the "
                        f"run used")
        return min(timeout, left)


CLOCK = RunClock()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def random_level(rng, C=7, P=5, G=20, M=8, K=4, T=6, F=8, PP=1,
                 masks="random", slots=False):
    """Random-but-consistent join inputs (ids in [0, 32), PAD -1).
    ``masks``: "random" (dense, with holes), "holes" (sparse) or "prefix"
    (each row set from slot 0, as the stores are, to a length uniform in
    [0, width]); ``slots``: stub/to outside [0, K) on some rows."""
    import numpy as np

    def mask(shape):
        if masks == "prefix":
            n = rng.integers(0, shape[-1] + 1, shape[:-1])
            return np.arange(shape[-1]) < n[..., None]
        return rng.random(shape) < (0.1 if masks == "holes" else 0.7)

    pol = rng.integers(0, 32, (PP, P, G, M, K)).astype(np.int32)
    pmask = mask((PP, P, G, M))
    pol = np.where(rng.random((PP, P, G, M, K)) < 0.15, -1, pol)
    src = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    dst = rng.integers(0, 32, (PP, T, G, F)).astype(np.int32)
    emask = mask((PP, T, G, F))
    src = np.where(emask, src, -1)
    dst = np.where(emask, dst, -1)
    meta = np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)
    if slots:
        meta[::2, 1] = K + 1
        meta[1::3, 2] = -1
        meta[2::3, 2] = K
    return meta, pol, pmask, src, dst, emask


def unsort(sched, rng):
    """The same schedule with its tiles (and their rows) in a random
    order, so that runs of one parent are broken up."""
    import numpy as np
    from repro_torch.core.candgen import CandidateSchedule
    tc = sched.tile_c
    perm = rng.permutation(sched.n_tiles)
    rows = (perm[:, None] * tc + np.arange(tc)).reshape(-1)
    where = np.empty_like(rows)
    where[rows] = np.arange(rows.size)
    return CandidateSchedule(sched.meta[rows], sched.tiles[perm],
                             where[sched.inv].astype(np.int32), tc)


def poison(*shapes) -> None:
    """Free blocks of these int32 shapes filled with -7, so that outputs
    a kernel's wrapper allocates with torch.empty right after start as
    garbage: an element the kernel fails to write then shows."""
    import torch
    junk = [torch.full(s, -7, dtype=torch.int32, device="cuda")
            for s in shapes]
    torch.cuda.synchronize()
    del junk


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def time_samples(fn, runs: int, warmup: int = 2,
                 batch: int = 1) -> list[float]:
    """Milliseconds per call of ``runs`` batches of ``batch`` calls, each
    batch timed with its own pair of CUDA events, after ``warmup`` calls.
    A batch keeps the stream busy, so the host's cost of a call is hidden
    behind the device's work wherever it is the smaller of the two."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return times


def time_ms(fn, runs: int, warmup: int = 2, batch: int = 1) -> float:
    """Median milliseconds per call (see ``time_samples``)."""
    return statistics.median(time_samples(fn, runs, warmup, batch))


def time_in_turns(a, b, runs: int, batch: int) -> tuple[float, float]:
    """Medians of ``a`` and ``b`` timed in turns (a, b, b, a), ``runs``
    batches of ``batch`` calls each turn, so that both see the same card
    state."""
    ta = time_samples(a, runs, batch=batch)
    tb = time_samples(b, runs, batch=batch)
    tb += time_samples(b, runs, batch=batch)
    ta += time_samples(a, runs, batch=batch)
    return statistics.median(ta), statistics.median(tb)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The larger of the memory time and the operation time, in ms, and
    which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    return (*bound(nbytes, ops), {"bytes": nbytes, "ops": ops})


def sched_rows(sched_meta, tiles):
    """(parent, triple) of the valid rows of a fused kernel's schedule:
    the rows it joins."""
    import torch
    tc = sched_meta.shape[0] // tiles.shape[0]
    valid = (sched_meta[:, 5] != 0).cpu()
    tile_of = torch.arange(sched_meta.shape[0]) // tc
    return tiles.cpu()[tile_of[valid]].long()


def meta_rows(meta, heads: bool):
    """(parent, triple) of the two-launch join's meta rows: all of them,
    or (``heads``) those that differ from the row before them — the rows
    the kernel joins."""
    import torch
    m = meta.cpu().long()
    if heads:
        keep = torch.ones(m.shape[0], dtype=torch.bool)
        keep[1:] = (m[1:] != m[:-1]).any(1)
        m = m[keep]
    return m[:, [0, 4]]


def join_work(rows, pmask, emask) -> dict:
    """What a join kernel's rows (``rows`` (n, 2): parent, triple) ask of
    it at these stores: the rows, the (row, partition, graph) triples
    whose parent and edge mask rows both have a non-zero span (last set
    index + 1), the slot pairs inside those spans, and the set (m, f)
    pairs (the bound's compares)."""
    import torch

    def spans(mask):
        w = mask.shape[-1]
        pos = torch.arange(1, w + 1, device=mask.device, dtype=torch.int32)
        return (mask.to(torch.int32) * pos).amax(-1).to(torch.int64)

    ps, ts = spans(pmask), spans(emask)               # (PP,P,G), (PP,T,G)
    both = torch.einsum("apg,atg->pt", (ps > 0).double(),
                        (ts > 0).double()).cpu()
    slots = torch.einsum("apg,atg->pt", ps.double(), ts.double()).cpu()
    nm = pmask.to(torch.int64).sum(-1).double()
    nf = emask.to(torch.int64).sum(-1).double()
    pairs = torch.einsum("apg,atg->pt", nm, nf).cpu()
    sel = (rows[:, 0], rows[:, 1])
    return {"rows": int(rows.shape[0]),
            "row_graphs_in_span": int(both[sel].sum()),
            "span_slot_pairs": int(slots[sel].sum()),
            "pair_compares": int(pairs[sel].sum())}


def join_bound(args, outputs) -> tuple[float, str, dict]:
    """Least time of one two-launch join call, by B1's rule: the meta
    rows in full; for each parent a candidate references, its mask rows
    in full plus the K slots of every set embedding; for each such
    triple, its mask rows in full plus src and dst of every set
    occurrence; each output written once.  Compares: per distinct
    candidate row (equal rows have equal outputs), every set parent
    embedding against every set edge occurrence of the same graph."""
    import torch
    meta, pol, pmask, src, dst, emask = args
    rows = meta.cpu()
    parents = sorted({int(p) for p in rows[:, 0]})
    triples = sorted({int(t) for t in rows[:, 4]})
    PP, _, G, M, K = pol.shape
    F = src.shape[-1]
    nm = pmask.to(torch.int64).sum(-1)           # (PP, P, G) set embeddings
    nf = emask.to(torch.int64).sum(-1)           # (PP, T, G) set occurrences
    nbytes = meta.numel() * 4
    nbytes += len(parents) * PP * G * M * pmask.element_size()
    nbytes += int(nm[:, parents].sum()) * K * 4
    nbytes += len(triples) * PP * G * F * emask.element_size()
    nbytes += int(nf[:, triples].sum()) * (4 + 4)
    nbytes += sum(o.numel() * o.element_size() for o in outputs)
    pairs = (nm[:, :, None, :] * nf[:, None, :, :]).sum((0, 3))  # (P, T)
    distinct = torch.unique(rows.long(), dim=0)
    ops = int(pairs[distinct[:, 0], distinct[:, 4]].sum())
    return (*bound(nbytes, ops), {"bytes": nbytes, "ops": ops})


def materialize_bound(args, outputs) -> tuple[float, str, dict]:
    """Least time of one pass-2 call: the candidate rows and the survivor
    count read; for each live slot (below the survivor count), its
    parent's and its triple's mask rows in full, the K slots of every set
    parent embedding and src and dst of every set edge occurrence; the
    child store, its mask and the overflow written once.  Compares: per
    live slot, every set parent embedding against every set edge
    occurrence of the same graph."""
    import torch
    cmeta, n_keep, pol, pmask, src, dst, emask = args
    K, F = pol.shape[-1], src.shape[-1]
    live = cmeta[:min(int(n_keep), cmeta.shape[0])].long().cpu()
    nm = pmask.to(torch.int64).sum(-1)           # (PP, P, G) set embeddings
    nf = emask.to(torch.int64).sum(-1)           # (PP, T, G) set occurrences
    par, tri = live[:, 0].to(pol.device), live[:, 4].to(pol.device)
    nm_s, nf_s = nm[:, par], nf[:, tri]          # (PP, n_live, G)
    nbytes = cmeta.numel() * 4 + 4
    nbytes += nm_s.numel() * (pmask.shape[-1] * pmask.element_size()
                              + F * emask.element_size())
    nbytes += int(nm_s.sum()) * K * 4 + int(nf_s.sum()) * (4 + 4)
    nbytes += sum(o.numel() * o.element_size() for o in outputs)
    ops = int((nm_s * nf_s).sum())
    return (*bound(nbytes, ops), {"bytes": nbytes, "ops": ops,
                                  "live": int(live.shape[0])})


def reduce_bound(matched, outputs) -> tuple[float, str, dict]:
    """Least time of one reduction call: both (PP, C, G) inputs read
    once, both (PP, C) outputs written once; one add per input
    element."""
    nbytes = 2 * matched.numel() * 4
    nbytes += sum(o.numel() * o.element_size() for o in outputs)
    ops = 2 * matched.numel()
    return (*bound(nbytes, ops), {"bytes": nbytes, "ops": ops})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def counter_modules():
    """The kernel wrapper modules, each with its ``launches`` counts."""
    from repro_torch.kernels import (embedding_join, fused_level,
                                     materialize, support_count)
    return fused_level, embedding_join, support_count, materialize


def launch_counts() -> dict:
    return {k: v for mod in counter_modules() for k, v in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in counter_modules():
        mod.reset_launches()


def restore_launch_counts(before: dict) -> None:
    for mod in counter_modules():
        mod.launches.update({k: before[k] for k in mod.launches})


def phase_device():
    import torch
    from repro_torch.kernels import build
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
    path, log = build.build_kernels()
    say(f"phase 1 build: {', '.join(sorted(set(SOURCES.values())))} -> "
        f"{path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            say(f"  ptxas: {line.strip()}")
    return card


def phase_parity_small():
    import numpy as np
    import torch
    from repro_torch.core.candgen import pad_schedule, schedule_candidates
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_join import embedding_join
    from repro_torch.kernels.ops import (fused_level_supports,
                                         fused_level_supports_packed)
    from repro_torch.kernels.support_count import support_count
    cases = [  # (shape, tile_c, bucket rows) — the tests' misaligned sweeps
        (dict(C=7, G=20), 8, None),
        (dict(C=9, G=37), 8, None),
        (dict(C=9, G=37), 2, 64),
        (dict(C=9, G=37), 1, None),
        (dict(C=12, G=100, PP=3, M=16, F=20), 4, 64),
        (dict(C=12, P=3, G=16, M=6, K=3, T=3, F=6), 4, None),
        (dict(C=5, G=33, M=3, K=2, F=200), 8, None),
        # long spans, holes, out-of-range slots, many tiles, unsorted tiles
        (dict(C=9, G=37, M=300, F=6, masks="prefix"), 8, None),
        (dict(C=8, G=70, M=40, F=60, masks="prefix"), 4, None),
        (dict(C=9, G=37, M=48, F=20, masks="holes"), 2, 32),
        (dict(C=9, G=37, slots=True), 4, None),
        (dict(C=80, P=4, G=33, T=3), 1, 96),
        (dict(C=80, P=4, G=33, T=3), 1, 96),          # unsorted below
        (dict(C=40, P=3, G=150, M=64, F=10, PP=3, masks="prefix"), 2, None),
        (dict(C=20, P=3, G=200, M=512, K=8, T=4, F=40, masks="prefix"), 1,
         32),
        # G = 130 at the 128-graph tile: 8 verdict words, 3 past G
        (dict(C=9, G=130, M=6, F=6), 4, 16),
        # the triple span table's edge: the last T it holds, then each
        # warp's own spans (T = 1,914 is the seeded DB of phase 3)
        (dict(C=60, G=70, M=6, K=3, T=1791, F=4, masks="prefix"), 4, 96),
        (dict(C=60, G=70, M=6, K=3, T=1792, F=4, masks="prefix"), 4, 96),
        (dict(C=60, G=70, M=6, K=3, T=1914, F=4, masks="prefix", PP=2), 4,
         96),
        (dict(C=60, G=70, M=6, K=3, T=1914, F=4, masks="prefix"), 1, 64),
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
        if i == 12 or shape.get("T", 0) > 1791:
            sched = unsort(sched, rng)
        cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in
               (sched.meta, sched.tiles, pol, pmask, src, dst, emask)]
        gpu = [x.cuda() for x in cpu]
        G, PP = shape["G"], pol.shape[0]
        tg = min(128, -(-G // 32) * 32)            # the packed graph tile
        for f in (fused_level_supports_packed, fused_level_supports):
            poison((PP, len(sched.meta), -(-G // tg) * tg // 32))
            got = f(*gpu)
            torch.cuda.synchronize()
            err = max_abs_err([x.cpu() for x in got], f(*cpu))
            check(err == 0, f"{f.__name__} disagrees with its plain version "
                            f"on case {i} (max abs err {err})")
            worst = max(worst, err)
    say(f"phase 2 parity: {len(cases)} misaligned cases x 2 fused kernels "
        f"equal their plain versions exactly (max abs err {worst})")

    two = [  # (shape, what the case forces)
        (dict(C=9, G=37), None),                      # G % 32 != 0, G < 128
        (dict(C=1, G=45), None),                      # one candidate
        (dict(C=8, G=33, K=3), "backward"),           # every row backward
        (dict(C=8, G=33, K=3), "forward"),            # every row forward
        (dict(C=6, G=24, T=3), "no-masks"),           # all-zero masks
        (dict(C=6, P=3, G=70, M=4, K=3, T=3, F=5, PP=3), None),
        (dict(C=7, G=20, M=3, K=2, F=200), None),     # narrow block (F)
        (dict(C=70, G=300, PP=2), None),              # G past one block
        (dict(C=6, G=43, M=40, F=12, masks="prefix"), None),   # G % 4 == 3
        (dict(C=5, G=21, M=300, K=3, F=6, masks="prefix"), None),
        (dict(C=7, G=35, M=48, F=20, masks="holes"), None),
        (dict(C=8, G=27, PP=2, slots=True), None),
        (dict(C=12, G=37), "padded-tail"),            # bucket padding rows
        (dict(C=14, G=29, PP=2), "runs"),             # runs of equal rows
        (dict(C=70, G=300, PP=2), "padded-tail"),
        (dict(C=60, G=70, M=6, K=3, T=1791, F=4, masks="prefix"), None),
        (dict(C=60, G=70, M=6, K=3, T=1914, F=4, masks="prefix", PP=2),
         None),
    ]
    worst = 0
    for i, (shape, force) in enumerate(two):
        rng = np.random.default_rng(200 + i)
        meta, pol, pmask, src, dst, emask = random_level(rng, **shape)
        if force == "backward":
            meta[:, 3] = 0
        elif force == "forward":
            meta[:, 3] = 1
        elif force == "no-masks":
            pmask[:] = False
            emask[:] = False
        elif force == "padded-tail":    # copies of [0, 0, 0, 1, 0]
            meta[-len(meta) // 3:] = [0, 0, 0, 1, 0]
        elif force == "runs":           # runs, and equal rows apart
            meta[2:5] = meta[1]
            meta[8] = meta[1]
            meta[10:12] = meta[9]
            meta[13] = meta[9]
        cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in
               (meta, pol, pmask, src, dst, emask)]
        gpu = [x.cuda() for x in cpu]
        poison(*[(pol.shape[0], len(meta), shape["G"])] * 2)
        joined = embedding_join(*gpu)
        reduced = support_count(*joined)
        torch.cuda.synchronize()
        want_j = ref.embedding_join_ref(*cpu)
        want_r = ref.support_count_ref(*want_j)
        err = max(max_abs_err([x.cpu() for x in joined], want_j),
                  max_abs_err([x.cpu() for x in reduced], want_r))
        check(err == 0, f"the two-launch kernels disagree with their plain "
                        f"versions on case {i} (max abs err {err})")
        worst = max(worst, err)
    say(f"phase 2 parity: {len(two)} misaligned cases x 2 two-launch "
        f"kernels equal their plain versions exactly (max abs err {worst})")

    # a run of meta rows outside the stores (and single ones) gives zeros
    rng = np.random.default_rng(250)
    meta, pol, pmask, src, dst, emask = random_level(rng, C=8, G=45, PP=2)
    P, T = pol.shape[1], src.shape[1]
    outside = np.array([[P, 0, 1, 1, 0]] * 3 + [[0, 0, 1, 0, T]] * 2
                       + [[-1, 0, 0, 1, 0]], np.int32)
    rows = np.concatenate([meta[:4], outside, meta[4:]])
    cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in
           (rows, pol, pmask, src, dst, emask)]
    poison(*[(2, len(rows), 45)] * 2)
    got = [x.cpu() for x in embedding_join(*[x.cuda() for x in cpu])]
    inside = np.r_[0:4, 10:len(rows)]
    want = ref.embedding_join_ref(torch.from_numpy(meta), *cpu[1:])
    err = max_abs_err([x[:, inside] for x in got], want)
    err = max(err, max_abs_err([x[:, 4:10] for x in got],
                               [torch.zeros_like(x[:, 4:10]) for x in got]))
    check(err == 0, f"embedding_join: rows outside the stores do not give "
                    f"zeros, or their neighbours differ (max abs err {err})")
    say("phase 2 parity: embedding_join writes zeros for a run of meta rows "
        "outside the stores and equals its plain version on the rest")

    # the reduction on rows that start off 16-byte alignment (G % 4, data
    # pointers offset by 4-12 bytes) and on more rows than its grid
    reduce_cases = [(1, 5, 43, 0), (2, 7, 1001, 1), (1, 3, 2, 3),
                    (4, 5000, 3, 1), (2, 9, 5000, 2)]
    worst = 0
    for i, (PP, C, G, off) in enumerate(reduce_cases):
        rng = np.random.default_rng(300 + i)
        n = PP * C * G
        flat = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, 2 * (n + off), dtype=np.int64).astype(np.int32))
        m_buf, c_buf = flat.cuda().split(n + off)
        matched, count = (b[off:].view(PP, C, G) for b in (m_buf, c_buf))
        got = support_count(matched, count)
        torch.cuda.synchronize()
        err = max_abs_err([x.cpu() for x in got],
                          ref.support_count_ref(matched.cpu(), count.cpu()))
        check(err == 0, f"support_count disagrees with its plain version on "
                        f"misaligned case {i} (max abs err {err})")
        worst = max(worst, err)
    say(f"phase 2 parity: {len(reduce_cases)} misaligned/strided cases of "
        f"the reduction equal its plain version exactly (max abs err "
        f"{worst})")


def phase_small():
    from repro_torch.core import (Mirage, MirageConfig, mine_host,
                                  paper_toy_db, random_db)
    dbs = [("paper_toy_db", paper_toy_db(), 2, None),
           ("random_db(18, seed=42)",
            random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                      n_elabels=2, seed=42), 5, 3)]
    runs = [dict(backend="fused"), dict(backend="fused", packed_support=False),
            dict(backend="pallas"),
            dict(backend="pallas", pipeline="legacy")]
    for name, graphs, minsup, max_size in dbs:
        want = sorted((c, i.support) for c, i in
                      mine_host(graphs, minsup, max_size=max_size)
                      .frequent.items())
        for kw in runs:
            res = Mirage(MirageConfig(minsup=minsup, max_size=max_size,
                                      n_partitions=2, **kw)).fit(graphs)
            check(sorted(res.supports.items()) == want,
                  f"{name} {kw}: the card's frequent set differs from "
                  f"mine_host")
        say(f"phase 3 small: {name} minsup={minsup} max_size={max_size}: "
            f"{len(want)} frequent subgraphs, equal to mine_host (fused "
            f"packed and dense, two-launch, legacy two-launch)")


def phase_many_triples(want) -> None:
    """Phase 3 (c): the seeded DB of ROADMAP queue C, C2, whose 1,914
    directed edge triples are past the join kernels' span table, mined
    with the fused backend against ``mine_host`` (``want``: the future of
    the oracle process computing it beside the card's work)."""
    import torch
    from repro_torch.core.mining import Mirage, MirageConfig
    from repro_torch.core.partition import make_partitions
    from repro_torch.kernels import build
    graphs = make_graphs(C2_DB)
    part = make_partitions(graphs, C2_MINSUP, 8)
    T = len({t for c in part.alphabet.canonical()
             for t in (c, (c[2], c[1], c[0]))})
    threads, smem = build.join_geometry(1, T)
    check(smem == build.JOIN_WARPS * build.JOIN_LAZY_WARP_BYTES,
          f"T={T}: the join kernels should run without the span table")
    reset_launch_counts()
    t0 = time.perf_counter()
    res = Mirage(MirageConfig(minsup=C2_MINSUP, n_partitions=8,
                              max_size=C2_MAX_SIZE,
                              backend="fused")).fit(graphs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    check(launches["fused_level_packed"] == len(res.stats),
          f"phase 3 C2 DB: launches {launches} over {len(res.stats)} levels")
    check(sorted(res.supports.items()) == want.result(),
          "phase 3 C2 DB: the card's frequent set differs from mine_host")
    say(f"phase 3 many triples: random_db(400, n_vlabels=40) minsup="
        f"{C2_MINSUP} max_size={C2_MAX_SIZE}: T={T} directed triples, "
        f"join geometry {threads} threads x {smem} shared bytes (no span "
        f"table); fit {secs:.2f}s, frequent per level {res.counts()}, "
        f"candidates per level {[st.n_candidates for st in res.stats]}, "
        f"kernel launches {launches}; equal to mine_host")


def generate_db(n_graphs: int, seed: int):
    """``pubchem_like_db(n_graphs, seed)`` and the seconds it took (run in
    the process pool, beside the card's work)."""
    use_src()
    from repro_torch.core import pubchem_like_db
    t0 = time.perf_counter()
    graphs = pubchem_like_db(n_graphs, seed=seed, avg_edges=28)
    return graphs, time.perf_counter() - t0


def make_db(label: str, future):
    """The graphs ``generate_db`` made in the pool (``future``), once
    ready; says their size."""
    import numpy as np
    t0 = time.perf_counter()
    graphs, secs = future.result()
    n_edges = [g.n_edges for g in graphs]
    say(f"phase {label}: pubchem_like_db({len(graphs)}, avg_edges=28): "
        f"mean {np.mean(n_edges):.2f} edges, max {max(n_edges)} ({secs:.1f}s "
        f"to generate in the pool, {time.perf_counter() - t0:.1f}s to wait "
        f"and load)")
    return graphs


@contextlib.contextmanager
def prep_memo():
    """``Mirage.fit``'s host prep (partitions, edge OLs, level-1 OLs:
    ``make_partitions``, ``build_edge_ol``, ``level1_ol``) kept by the
    identity and values of its inputs while the context is open, and
    reused when the same inputs come again.  The first fit of a DB fills
    it; every later fit of the same DB and config in the context (the
    second fit cut to level 2, the device loop, the two-launch, legacy
    and supervised runs) reuses the same host arrays instead of
    computing them again (tens of seconds of host work a fit at 40K).
    The fits only read them.  Emptied on leaving."""
    import repro_torch.core.mining as mining
    # which positional argument is an object, keyed (and kept alive) by
    # identity; the others are small values, keyed by their repr
    by_id = {"make_partitions": 0, "build_edge_ol": 0, "level1_ol": 1}
    orig = {n: getattr(mining, n) for n in by_id}
    kept = {}

    def memo(name):
        def call(*args, **kw):
            obj = args[by_id[name]]
            rest = [a for i, a in enumerate(args) if i != by_id[name]]
            key = (name, id(obj), repr(rest), repr(sorted(kw.items())))
            if key not in kept:
                kept[key] = (obj, orig[name](*args, **kw))
            return kept[key][1]
        return call

    for n in by_id:
        setattr(mining, n, memo(n))
    try:
        yield
    finally:
        for n in by_id:
            setattr(mining, n, orig[n])
        kept.clear()


class PrepBeside:
    """``Mirage.fit``'s host prep of ``graphs`` under ``MAIN_CFG`` made in
    a thread of this process, into the open ``prep_memo``, while the
    card's work of other processes runs (phase 8's ranks): a fit on the
    CPU cut at level 1 builds the partitions, edge OLs and level-1 OLs
    with the arguments a full fit passes, and mines nothing.  ``join``
    waits for it and raises what it raised."""

    def __init__(self, graphs):
        import threading
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(graphs,),
                                       daemon=True)
        self.thread.start()

    def _run(self, graphs) -> None:
        import repro_torch.core.mining as mining
        try:
            mining.Mirage(mining.MirageConfig(**{**MAIN_CFG, "max_size": 1}),
                          device="cpu").fit(graphs)
        except BaseException as exc:     # re-raised by join
            self.error = exc

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


@contextlib.contextmanager
def level_guard(sync_debug: bool):
    """Count the single-sync level dispatches, each level's wire
    fetches, every device→host copy of the wire including re-fetches,
    and the materializations of the retry path and the legacy pipeline
    that have survivors (yielded as ``{"dispatch": n, "fetch": {level:
    n}, "materialize": n, "log": [...]}``, the log holding ("dispatch",
    level) and ("fetch", level) in order);
    with ``sync_debug`` every dispatch runs under sync debug mode
    'error', so that a device→host read inside it raises."""
    import torch
    import repro_torch.core.level_step as level_step
    import repro_torch.core.mining as mining
    orig_dispatch = mining.dispatch_level
    orig_fetch = level_step._fetch_wire
    orig_copy = level_step._copy_to_host
    orig_materialize = mining.map_materialize
    counts = {"dispatch": 0, "fetch": {}, "materialize": 0, "log": []}
    fetching = [None]

    def guarded_dispatch(*args, **kw):
        counts["dispatch"] += 1
        counts["log"].append(("dispatch", kw.get("level")))
        if not sync_debug:
            return orig_dispatch(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_dispatch(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def counted_fetch(wire_d, level, *args, **kw):
        fetching[0] = level
        return orig_fetch(wire_d, level, *args, **kw)

    def counted_copy(wire_d):
        level = fetching[0]
        counts["fetch"][level] = counts["fetch"].get(level, 0) + 1
        counts["log"].append(("fetch", level))
        return orig_copy(wire_d)

    def counted_materialize(mesh, keep_meta, *args, **kw):
        counts["materialize"] += len(keep_meta) > 0
        return orig_materialize(mesh, keep_meta, *args, **kw)

    mining.dispatch_level = guarded_dispatch
    level_step._fetch_wire = counted_fetch
    level_step._copy_to_host = counted_copy
    mining.map_materialize = counted_materialize
    try:
        yield counts
    finally:
        mining.dispatch_level = orig_dispatch
        level_step._fetch_wire = orig_fetch
        level_step._copy_to_host = orig_copy
        mining.map_materialize = orig_materialize


def main_run(label: str, graphs, packed: bool, want, **cfg_kw):
    """Drive Mirage.fit at full scale (``MAIN_CFG`` plus ``cfg_kw``) and
    check it against ``mine_host`` (``want``: the result, or the future
    of the oracle process computing it beside the fit); returns (result,
    launches, seconds, want, peak bytes).  Nothing of the run is
    held past a level on the card, so the peak memory and the survivor
    caps are the miner's own (its host prep is kept while a
    ``prep_memo`` is open).  A single-sync run has every level dispatch under
    sync debug mode 'error' and must make one wire fetch per level."""
    import torch
    import repro_torch.core.mining as mining

    n_graphs = len(graphs)
    cfg = mining.MirageConfig(**MAIN_CFG, **cfg_kw)
    miner = mining.Mirage(cfg)
    check(miner._packed_support(n_graphs) == packed,
          f"packed support should be {'on' if packed else 'off'} at "
          f"{n_graphs} graphs")
    single_sync = cfg.pipeline == "single_sync"

    with level_guard(sync_debug=True) as counts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t1 = time.perf_counter()
        res = miner.fit(graphs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_levels = len(res.stats)
    audits = [st.audit for st in res.stats]
    check(n_levels >= 1, "the main run mined no level past 1")
    if single_sync:
        fetches = sum(counts["fetch"].values())
        check(counts["dispatch"] == n_levels == fetches,
              f"{counts['dispatch']} dispatches / {fetches} wire "
              f"fetches for {n_levels} levels")
    check(all(w == 0 for w in audits),
          f"audit words {audits} (0 = every device check passed)")
    # pass 2: one launch a dispatched level, one a materialization of
    # the retry path (the legacy pipeline's every level)
    check(launches["materialize_level"]
          == counts["dispatch"] + counts["materialize"],
          f"materialize_level launched {launches['materialize_level']} "
          f"times for {counts['dispatch']} dispatches and "
          f"{counts['materialize']} retry materializations")
    say(f"phase {label}: {cfg.pipeline} backend={miner.backend} fit "
        f"{secs:.2f}s, frequent per level {res.counts()}, "
        f"{sum(res.counts())} in all, minsup {res.minsup}, peak device "
        f"memory {peak} bytes, kernel launches {launches}")
    for st in res.stats:
        say(f"  level {st.level}: candidates={st.n_candidates} "
            f"frequent={st.n_frequent} {st.seconds:.3f}s "
            f"(device+wire {st.map_seconds:.3f}s, hidden candgen "
            f"{st.candgen_seconds:.3f}s) survivor_cap={st.survivor_cap} "
            f"retried={st.retried} escalations={st.escalations} "
            f"overflow={st.overflow}")
    if single_sync:
        say(f"phase {label}: {counts['dispatch']} level dispatches ran "
            f"under sync debug mode 'error' with 1 wire fetch each; audit "
            f"words {audits}")

    check(res.minsup == main_minsup(n_graphs),
          f"minsup {res.minsup}, the oracle's is {main_minsup(n_graphs)}")
    if not isinstance(want, list):
        t2 = time.perf_counter()
        want = want.result()
        say(f"phase {label}: mine_host, run beside the card's work, was "
            f"ready {time.perf_counter() - t2:.1f}s after the fit")
    check(sorted(res.supports.items()) == want,
          "the frequent set differs from mine_host")
    say(f"phase {label}: frequent set and supports equal mine_host; pass "
        f"2 launched {launches['materialize_level']} times ("
        f"{counts['dispatch']} dispatches, {counts['materialize']} retry "
        f"materializations)")
    return res, launches, secs, want, peak


@contextlib.contextmanager
def run_guard():
    """Count the device loop's program calls, level bodies and wire
    copies (yielded as ``{"calls": n, "bodies": n, "copies": n, "spp":
    [SPP of each run], "last": (program, carry, last k, inputs)}``).
    Every program call runs under sync debug mode 'error' from its first
    body, and the mode is lifted only for the wire copy, so that any
    other device→host read of the run raises.  The last program call's
    carry is kept for :func:`dead_body_seconds`, and dropped before the
    next run's slot clamp reads the free memory."""
    import torch
    import repro_torch.core.device_loop as device_loop
    import repro_torch.core.level_step as level_step
    from repro_torch.core.mining import Mirage
    orig_prog = device_loop._run_program
    orig_copy = level_step._copy_to_host
    orig_slots = Mirage._device_loop_slots
    counts = {"calls": 0, "bodies": 0, "copies": 0, "spp": [], "last": None}

    def program(*key):
        prog = orig_prog(*key)

        def guarded(carry, k_first, n_bodies, *args):
            counts["calls"] += 1
            counts["bodies"] += n_bodies
            counts["last"] = (prog, carry, k_first + n_bodies - 1, args)
            if torch.cuda.get_sync_debug_mode() == 0:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            return prog(carry, k_first, n_bodies, *args)
        return guarded

    def copy(wire_d):
        torch.cuda.set_sync_debug_mode(0)
        counts["copies"] += 1
        return orig_copy(wire_d)

    def slots(self, *args, **kw):
        counts["last"] = None
        counts["spp"].append(orig_slots(self, *args, **kw))
        return counts["spp"][-1]

    device_loop._run_program = program
    level_step._copy_to_host = copy
    Mirage._device_loop_slots = slots
    try:
        yield counts
    finally:
        torch.cuda.set_sync_debug_mode(0)
        device_loop._run_program = orig_prog
        level_step._copy_to_host = orig_copy
        Mirage._device_loop_slots = orig_slots


class Captured(Exception):
    """Raised by :func:`kernel_calls` to end a fit at its first kernel
    call."""


@contextlib.contextmanager
def kernel_calls(stop_at_first: bool = False):
    """Record the arguments of every call that the ops layer makes to
    the join kernels B1, B2 and B3, and that the device loop makes to
    pass 2's kernel (yielded as a list of (name, args, keywords)); with
    ``stop_at_first``, raise :class:`Captured` at the first call, before
    it launches, so that the fit holds no store past it."""
    import repro_torch.core.device_loop as dl
    import repro_torch.kernels.ops as ops
    names = ("fused_level_packed", "fused_level", "embedding_join")
    orig = {(ops, n): getattr(ops, n) for n in names}
    orig[dl, "materialize_level"] = dl.materialize_level
    calls = []

    def wrap(mod, name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            if stop_at_first:
                raise Captured(name)
            return orig[mod, name](*args, **kw)
        return call

    for mod, n in orig:
        setattr(mod, n, wrap(mod, n))
    try:
        yield calls
    finally:
        for (mod, n), fn in orig.items():
            setattr(mod, n, fn)


def hold_calls_against_plain(label: str, calls) -> dict:
    """Run each captured kernel call, and its plain PyTorch version, on
    the same inputs (B4 on B3's outputs); every output must agree
    exactly.  Returns the calls held per kernel.  Comparison launches
    are not counted."""
    import torch
    from repro_torch.kernels import fused_level as fl
    from repro_torch.kernels import materialize as mat
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_join import embedding_join
    from repro_torch.kernels.support_count import support_count
    pairs = {"fused_level_packed": (fl.fused_level_packed,
                                    fl.fused_level_packed_ref),
             "fused_level": (fl.fused_level, fl.fused_level_ref),
             "embedding_join": (embedding_join, ref.embedding_join_ref),
             "materialize_level": (mat.materialize_level,
                                   mat.materialize_level_ref)}
    before = launch_counts()
    held = {}
    for name, args, kw in calls:
        kernel, plain = pairs[name]
        outs = [(name, kernel(*args, **kw), plain(*args, **kw))]
        if name == "embedding_join":
            joined = outs[0][1]
            outs.append(("support_count", support_count(*joined),
                         ref.support_count_ref(*joined)))
        torch.cuda.synchronize()
        for n, got, want in outs:
            err = max_abs_err(got, want)
            check(err == 0, f"{label}: {n} disagrees with its plain version "
                            f"on the device loop's inputs (max abs err "
                            f"{err})")
            held[n] = held.get(n, 0) + 1
    restore_launch_counts(before)
    return held


def schedule_shape(calls) -> str:
    """The device-built schedules and stores of captured B1/B2 calls:
    rows, pad rows (valid = 0), tiles, and the stores' (SPP, M)."""
    out = []
    for name, args, _ in calls:
        if name == "materialize_level":
            continue
        if name == "embedding_join":
            meta, pol = args[0], args[1]
            out.append(f"meta {meta.shape[0]} rows, store SPP "
                       f"{pol.shape[1]} M {pol.shape[3]}")
            continue
        sched, tiles = args[0], args[1]
        pol = args[3] if name == "fused_level_packed" else args[2]
        out.append(f"{sched.shape[0]} rows ({int((sched[:, 5] == 0).sum())}"
                   f" pad), {tiles.shape[0]} tiles, store SPP "
                   f"{pol.shape[1]} M {pol.shape[3]}")
    return "; ".join(out)


@contextlib.contextmanager
def body_events():
    """Stamp each level body of the device loop with CUDA events (no
    host read): at its start (its candgen), around its pass-2 launch and
    at the run wire that ends a program call, with the host's clock at
    the same points.  Yields the list of bodies, each ``{"start": event,
    "host": seconds, "pass2": (event, event), "end": event, "host_end":
    seconds}``."""
    import torch
    import repro_torch.core.device_loop as dl
    orig = {n: getattr(dl, n)
            for n in ("device_candidates", "materialize_level", "run_wire")}
    bodies = []

    def stamp():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def candidates(*args, **kw):
        ev = stamp()
        if bodies and "end" not in bodies[-1]:
            bodies[-1]["end"] = ev
            bodies[-1]["host_end"] = time.perf_counter()
        bodies.append({"start": ev, "host": time.perf_counter()})
        return orig["device_candidates"](*args, **kw)

    def materialize(*args, **kw):
        e0 = stamp()
        out = orig["materialize_level"](*args, **kw)
        bodies[-1]["pass2"] = (e0, stamp())
        return out

    def wire(carry):
        bodies[-1]["end"] = stamp()
        bodies[-1]["host_end"] = time.perf_counter()
        return orig["run_wire"](carry)

    dl.device_candidates = candidates
    dl.materialize_level = materialize
    dl.run_wire = wire
    try:
        yield bodies
    finally:
        for n, fn in orig.items():
            setattr(dl, n, fn)


# the launches of one level body, per device-loop backend
BODY_KERNELS = {"fused_packed": ("fused_level_packed", "materialize_level"),
                "fused": ("fused_level", "materialize_level"),
                "pallas": ("embedding_join", "support_count",
                           "materialize_level")}


def device_loop_fit(graphs, hooks=(), **cfg_kw):
    """One ``pipeline="device_loop"`` fit under :func:`run_guard` and the
    context managers ``hooks`` (their values are returned in order),
    kernel launches counted from 0; a fallback to single-sync fails.
    Returns (miner, result, launches, guard counts, seconds, peak bytes,
    hook values)."""
    import torch
    import repro_torch.core.mining as mining
    miner = mining.Mirage(mining.MirageConfig(pipeline="device_loop",
                                              **cfg_kw))
    with run_guard() as counts, contextlib.ExitStack() as stack:
        got = [stack.enter_context(h) for h in hooks]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = miner.fit(graphs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
    info = miner.last_device_loop
    check(info is not None and info["completed"],
          f"the device loop fell back to single-sync: {info}")
    runs = info["escalations"] + 1
    check(counts["copies"] == runs,
          f"{counts['copies']} wire copies for {runs} run(s)")
    check(counts["bodies"] == runs * info["n_levels"],
          f"{counts['bodies']} bodies for {runs} run(s) of "
          f"{info['n_levels']} level slots")
    peak = torch.cuda.max_memory_allocated()
    return miner, res, launches, counts, secs, peak, got


def dead_body_seconds(counts) -> float:
    """Seconds (host clock, synchronized) of one more level body on the
    last run's final carry with no parents left (``n_par = 0``): the cost
    of each level past the fixpoint.  Its launches are not counted."""
    import torch
    prog, carry, k_last, args = counts.pop("last")
    carry.n_par.zero_()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog(carry, k_last, 1, *args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    restore_launch_counts(before)
    return secs


def body_split(bodies, n_levels: int):
    """Per-body milliseconds (device clock, start to next start), the
    host's milliseconds to queue it, and for the last run's bodies the
    milliseconds of pass 2's launch."""
    ms = [round(b["start"].elapsed_time(b["end"]), 1) for b in bodies]
    host = [round(1e3 * (b["host_end"] - b["host"]), 1) for b in bodies]
    pass2 = [round(b["pass2"][0].elapsed_time(b["pass2"][1]), 3)
             for b in bodies[-n_levels:]]
    return ms, host, pass2


def check_body_launches(label, backend, launches, counts):
    want = BODY_KERNELS[backend]
    for name in want:
        check(launches[name] == counts["bodies"],
              f"{label}: {name} launched {launches[name]} times over "
              f"{counts['bodies']} bodies")
    check(all(n == 0 for k, n in launches.items() if k not in want),
          f"{label}: another kernel ran ({launches})")


def phase_device_loop(graphs40, want40, single_sync, card: str) -> None:
    """The device-loop phase: ``pipeline="device_loop"`` on the 18-graph
    DB of ``tests/test_device_loop.py`` with the packed and dense fused
    kernels and the two-launch kernels (and ``candgen="device"`` once),
    then phase 4's database and config mined as one device-resident run
    beside phase 4's single-sync numbers (``single_sync``: its result,
    fit seconds and peak bytes).  Every run must complete without
    falling back, equal ``mine_host``, make one wire copy per run under
    sync debug mode 'error', and launch its kernels once per body; the
    kernels' inputs in the loop are held against their plain versions
    (every call on the small DB, the first call of a 40K run)."""
    phase_device_loop_small()
    phase_device_loop_main(graphs40, want40, single_sync, card)


def phase_device_loop_small() -> None:
    """Phase 11 (a): the 18-graph DB on each level body's kernels, every
    kernel call of each run held against its plain version."""
    from repro_torch.core.graphdb import random_db
    from repro_torch.core.host_miner import mine_host
    from repro_torch.core.mining import Mirage, MirageConfig
    graphs = random_db(18, n_vertices=6, extra_edge_prob=0.35, n_vlabels=3,
                       n_elabels=2, seed=42)
    small = dict(minsup=3, n_partitions=2, max_size=4)
    want = sorted((c, i.support) for c, i in
                  mine_host(graphs, 3, max_size=4).frequent.items())
    for backend in ("fused_packed", "fused", "pallas"):
        miner, res, launches, counts, secs, _, (calls,) = device_loop_fit(
            graphs, hooks=[kernel_calls()], backend=backend,
            packed_support=backend == "fused_packed", **small)
        check(sorted(res.supports.items()) == want,
              f"device loop {backend}: the frequent set differs from "
              f"mine_host")
        check_body_launches(f"device loop {backend}", backend, launches,
                            counts)
        per_name = {}
        for name, _, _ in calls:
            per_name[name] = per_name.get(name, 0) + 1
        check(per_name == {name: counts["bodies"] for name in
                           BODY_KERNELS[backend] if name != "support_count"},
              f"device loop {backend}: kernel calls captured {per_name} "
              f"over {counts['bodies']} bodies")
        held = hold_calls_against_plain(f"device loop {backend}", calls)
        say(f"phase 11 device-loop: random_db(18, seed=42) backend="
            f"{backend}: fit {secs:.2f}s, frequent per level "
            f"{res.counts()}, {counts['bodies']} bodies in "
            f"{counts['calls']} call(s), {counts['copies']} wire copy, "
            f"launches {launches}; equal to mine_host")
        say(f"phase 11 device-loop: {backend} kernel inputs per body "
            f"[{schedule_shape(calls)}]; every call exact against the "
            f"plain version (max abs err 0; calls held {held})")
    res = Mirage(MirageConfig(candgen="device", **small)).fit(graphs)
    check(sorted(res.supports.items()) == want,
          "candgen='device': the frequent set differs from mine_host")
    say("phase 11 device-loop: random_db(18, seed=42) single-sync with "
        "candgen='device' equal to mine_host")


def first_device_loop_call(graphs, **cfg_kw):
    """The arguments of the first kernel call of a device-loop fit, from
    a second fit ended at that call (no launch of it is counted)."""
    import repro_torch.core.mining as mining
    before = launch_counts()
    with kernel_calls(stop_at_first=True) as calls:
        try:
            mining.Mirage(mining.MirageConfig(pipeline="device_loop",
                                              **cfg_kw)).fit(graphs)
        except Captured:
            pass
    restore_launch_counts(before)
    check(len(calls) == 1, "the device loop never reached a kernel")
    return calls


def phase_device_loop_main(graphs40, want40, single_sync, card: str) -> None:
    """Phase 11 (b): phase 4's database and config as one device-resident
    run, beside phase 4's single-sync numbers; then the cost of one body
    past the fixpoint, and the first kernel call of such a run held
    against its plain version."""
    import torch
    from repro_torch.core.buckets import bucket_size
    res4, secs4, peak4 = single_sync
    miner, res, launches, counts, secs, peak, (bodies,) = device_loop_fit(
        graphs40, hooks=[body_events()], **MAIN_CFG)
    info = miner.last_device_loop
    check(sorted(res.supports.items()) == want40,
          "device loop 40K: the frequent set differs from mine_host")
    check(res.levels == res4.levels,
          "device loop 40K: the levels differ from phase 4's, in order")
    check_body_launches("device loop 40K", "fused_packed", launches, counts)
    spp_full = max(bucket_size(len(res.levels[0]), 32), info["c_budget"])
    level_s = sum(st.seconds for st in res4.stats)
    runs = info["escalations"] + 1
    m_runs = [info["max_embeddings"] >> (runs - 1 - i) for i in range(runs)]
    n_levels = info["n_levels"]
    ms, host, pass2 = body_split(bodies, n_levels)
    n_keep = (res.counts()[1:] + [0] * n_levels)[:n_levels]
    say(f"phase 11 device-loop 40K ({card}): fit {secs:.2f}s, levels "
        f"{sum(st.seconds for st in res.stats):.2f}s (one run program), "
        f"peak device memory {peak} bytes, "
        f"{counts['bodies']} bodies, {counts['copies']} wire copies, B1 "
        f"launches {launches['fused_level_packed']}; CB "
        f"{info['c_budget']}, CBR {info['raw_budget']}, ROWS "
        f"{info['sched_rows']}, tile_c {info['tile_c']}, SPP per run "
        f"{counts['spp']} at M {m_runs} (unclamped {spp_full}), M_run "
        f"{info['max_embeddings']}, escalations {info['escalations']}")
    say(f"phase 11 device-loop 40K bodies ({card}; CUDA events, a body "
        f"from its candgen to the next body's or the run wire): ms "
        f"{ms}, host ms to queue each {host}; last run: pass 2 ms "
        f"{pass2} (one launch a body; survivors per body {n_keep} of "
        f"SPP {counts['spp'][-1]}, the slots past them skipped)")
    say(f"phase 11 device-loop 40K beside phase 4's single-sync: fit "
        f"{secs:.2f}s (on phase 4's host prep) vs {secs4:.2f}s, Σ level s "
        f"{sum(st.seconds for st in res.stats):.2f} vs {level_s:.2f}, "
        f"peak {peak} vs {peak4} bytes, candidates per level "
        f"{[st.n_candidates for st in res.stats]}, frequent "
        f"{res.counts()}; equal to mine_host")
    dead = dead_body_seconds(counts)
    say(f"phase 11 device-loop 40K ({card}): one body past the fixpoint "
        f"(n_par 0) at SPP {info['spp']}, M {info['max_embeddings']} "
        f"takes {dead:.3f}s")
    del miner, res, counts, bodies
    torch.cuda.empty_cache()
    calls = first_device_loop_call(graphs40, **MAIN_CFG)
    sched = calls[0][1][0]
    check(sched.shape[0] == info["sched_rows"],
          f"device loop 40K: the first call's schedule has "
          f"{sched.shape[0]} rows, the run {info['sched_rows']}")
    t0 = time.perf_counter()
    held = hold_calls_against_plain("device loop 40K", calls)
    say(f"phase 11 device-loop 40K: the first body's B1 inputs "
        f"[{schedule_shape(calls)}] exact against the plain version (max "
        f"abs err 0; {held}; {time.perf_counter() - t0:.1f}s)")
    del calls, sched
    torch.cuda.empty_cache()


def level2_inputs(graphs, wrapped: str, **cfg_kw):
    """The arguments of the ``kernels.ops`` function ``wrapped`` at level 2
    of the main run's database, from a second fit cut to level 2 after
    the measured one (its launches are not counted; its host prep is the
    main run's where a ``prep_memo`` is open)."""
    import repro_torch.core.mining as mining
    import repro_torch.kernels.ops as ops
    orig_kernel = getattr(ops, wrapped)
    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append(args)
        return orig_kernel(*args, **kw)

    before = launch_counts()
    setattr(ops, wrapped, capture)
    try:
        mining.Mirage(mining.MirageConfig(
            **{**MAIN_CFG, "max_size": 2}, **cfg_kw)).fit(graphs)
    finally:
        setattr(ops, wrapped, orig_kernel)
        restore_launch_counts(before)
    check(bool(captured), f"{wrapped}: level 2 never reached the kernel")
    return captured[0]


def level3_pass2_inputs(graphs):
    """The arguments and keywords of level 3's pass-2 call in the main
    run's level program (``MAIN_CFG``), from a second fit ended at that
    call, before it launches (its launches are not counted; its host
    prep is the main run's where a ``prep_memo`` is open)."""
    import repro_torch.core.level_step as level_step
    import repro_torch.core.mining as mining
    orig = level_step.materialize_level
    captured = []

    def capture(*args, **kw):
        captured.append((args, kw))
        if len(captured) == 2:          # levels 2, 3
            raise Captured("materialize_level")
        return orig(*args, **kw)

    before = launch_counts()
    level_step.materialize_level = capture
    try:
        mining.Mirage(mining.MirageConfig(**MAIN_CFG)).fit(graphs)
    except Captured:
        pass
    finally:
        level_step.materialize_level = orig
        restore_launch_counts(before)
    check(len(captured) == 2, "level 3 never reached pass 2")
    return captured[1]


def materialize_record(args, kw, launches: int) -> dict:
    """Hold pass 2's kernel against its plain version (the per-slot
    ``materialize_one`` loop) on the main run's level-3 inputs, exactly,
    time both and compute the bound.  The plain version runs once (it
    takes seconds at these shapes); the two outputs are dropped before
    the kernel is timed, so that the card holds one child store at a
    time."""
    import torch
    from repro_torch.kernels import materialize as mat
    cmeta, n_keep, pol, pmask, src, dst, emask = args
    before = launch_counts()
    got = mat.materialize_level(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = mat.materialize_level_ref(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # slot by slot: an int64 copy of the whole child store would not fit
    err = 0
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        err = max(max_abs_err([a[:, s] for a in got[:2]],
                              [b[:, s] for b in want[:2]])
                  for s in range(cmeta.shape[0]))
        err = max(err, max_abs_err(got[2:], want[2:]))
    check(err == 0, f"materialize_level disagrees with its plain version "
                    f"on the main run's level-3 inputs (max abs err {err})")
    bound_ms, bound_by, work = materialize_bound(args, got)
    ol_shape, over = tuple(got[0].shape), int(got[2].sum())
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: mat.materialize_level(*args, **kw), runs=5,
                 batch=10)
    restore_launch_counts(before)      # comparison launches do not count
    say(f"materialize_level: level-3 inputs cmeta {tuple(cmeta.shape)} "
        f"n_keep {int(n_keep)} pol {tuple(pol.shape)} src "
        f"{tuple(src.shape)} -> ol {ol_shape}, overflow {over}; exact vs "
        f"plain; kernel {ms:.4f} ms (median of 5 batches of 10), plain "
        f"{plain_ms:.3f} ms (one call), bound {bound_ms:.4f} ms by "
        f"{bound_by} ({work['bytes']} bytes, {work['ops']} pair compares, "
        f"{work['live']} live slots); launches in the main run {launches}")
    return record("materialize_level", launches, err, ms, plain_ms,
                  bound_ms, bound_by)


def record(name: str, launches: int, err: int, ms: float, plain_ms: float,
           bound_ms: float, bound_by: str, library_ms=None) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kernel_record(name: str, args, packed: bool, launches: int) -> dict:
    """Hold a fused kernel against its plain version on the main run's
    level-2 inputs, time both, and compute the bound."""
    import torch
    from repro_torch.kernels import fused_level as fl
    kargs = args
    if packed:
        kernel, plain = fl.fused_level_packed, fl.fused_level_packed_ref
    else:
        kernel, plain = fl.fused_level, fl.fused_level_ref
    before = launch_counts()
    got = kernel(*kargs)
    torch.cuda.synchronize()
    want = plain(*kargs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"{name} disagrees with its plain version on the main "
                    f"run's level-2 inputs (max abs err {err})")
    emb_max = int(got[1].max())
    ms = time_ms(lambda: kernel(*kargs), runs=5, batch=10)
    plain_ms = time_ms(lambda: plain(*kargs), runs=3, warmup=1)
    restore_launch_counts(before)      # comparison launches do not count
    bound_ms, bound_by, work = level_bound(kargs, packed, got)
    pol, src = kargs[-5], kargs[-3]
    PP, P, G, M, K = pol.shape
    F = src.shape[-1]
    check(PP * G * M * F < 2 ** 31,
          f"{name}: emb could overflow int32 at these shapes")
    say(f"{name}: level-2 inputs sched {tuple(kargs[0].shape)} tiles "
        f"{tuple(kargs[1].shape)} pol {tuple(pol.shape)} src "
        f"{tuple(src.shape)}; exact vs plain; kernel {ms:.4f} ms "
        f"(median of 5 batches of 10), plain {plain_ms:.3f} ms (median of 3), bound "
        f"{bound_ms:.4f} ms by {bound_by} ({work['bytes']} bytes, "
        f"{work['ops']} pair compares); largest emb {emb_max}, int32 "
        f"headroom bound PP*G*M*F={PP * G * M * F}; launches per level 1")
    say(f"{name}: work at these inputs "
        f"{join_work(sched_rows(kargs[0], kargs[1]), kargs[-4], kargs[-1])}"
        f", bytes per the bound {work['bytes']}")
    return record(name, launches, err, ms, plain_ms, bound_ms, bound_by)


def two_launch_records(args, launches: dict) -> list[dict]:
    """Hold the join and the reduction kernels against their plain
    versions on the main run's level-2 inputs (the reduction on the
    join's outputs), time them, the plain versions and, for the
    reduction, the one PyTorch call that computes it."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_join import embedding_join
    from repro_torch.kernels.support_count import support_count
    meta, pol, pmask, src, dst, emask = args
    PP, P, G, M, K = pol.shape
    F = src.shape[-1]
    before = launch_counts()
    joined = embedding_join(*args)
    torch.cuda.synchronize()
    err_j = max_abs_err(joined, ref.embedding_join_ref(*args))
    check(err_j == 0, f"embedding_join disagrees with its plain version on "
                      f"the main run's level-2 inputs (max abs err {err_j})")
    reduced = support_count(*joined)
    torch.cuda.synchronize()
    err_r = max_abs_err(reduced, ref.support_count_ref(*joined))
    check(err_r == 0, f"support_count disagrees with its plain version on "
                      f"the main run's level-2 inputs (max abs err {err_r})")
    check(PP * G * M * F < 2 ** 31,
          "embedding_join: a count could overflow int32 at these shapes")
    ms_j = time_ms(lambda: embedding_join(*args), runs=5, batch=10)
    plain_j = time_ms(lambda: ref.embedding_join_ref(*args), runs=3,
                      warmup=1)
    matched, count = joined
    ms_r, lib_r = time_in_turns(
        lambda: support_count(*joined),
        lambda: (torch.sum(matched, dim=-1, dtype=torch.int32),
                 torch.sum(count, dim=-1, dtype=torch.int32)),
        runs=10, batch=10)
    plain_r = time_ms(lambda: ref.support_count_ref(*joined), runs=3,
                      warmup=1)
    restore_launch_counts(before)      # comparison launches do not count
    bj_ms, bj_by, wj = join_bound(args, joined)
    br_ms, br_by, wr = reduce_bound(matched, reduced)
    say(f"embedding_join: level-2 inputs meta {tuple(meta.shape)} pol "
        f"{tuple(pol.shape)} src {tuple(src.shape)} -> matched/count "
        f"{tuple(matched.shape)}; exact vs plain; kernel {ms_j:.4f} ms "
        f"(median of 5 batches of 10), plain {plain_j:.3f} ms (median of 3), bound "
        f"{bj_ms:.4f} ms by {bj_by} ({wj['bytes']} bytes, {wj['ops']} pair "
        f"compares); largest count {int(count.max())}; launches "
        f"{launches['embedding_join']}")
    say(f"embedding_join: work at these inputs, every meta row "
        f"{join_work(meta_rows(meta, False), pmask, emask)}; the heads of "
        f"runs of equal rows (joined) "
        f"{join_work(meta_rows(meta, True), pmask, emask)}")
    say(f"support_count: exact vs plain; kernel {ms_r:.4f} ms and torch.sum "
        f"x2 {lib_r:.4f} ms (medians of 20 batches of 10, timed in turns "
        f"kernel, sum, sum, kernel), plain {plain_r:.3f} ms (median of 3), bound "
        f"{br_ms:.4f} ms by {br_by} ({wr['bytes']} bytes, {wr['ops']} "
        f"adds); launches {launches['support_count']}")
    return [record("embedding_join", launches["embedding_join"], err_j,
                   ms_j, plain_j, bj_ms, bj_by),
            record("support_count", launches["support_count"], err_r, ms_r,
                   plain_r, br_ms, br_by, lib_r)]


# ---------------------------------------------------------------------------
# multi-worker phases: one rank per worker, each in a process of its own
# ---------------------------------------------------------------------------

RANK_DIR = ROOT / "build" / "chip_smoke_ranks"
CONFORMANCE_DB = ("random_db", (("n_graphs", 18), ("n_vertices", 6),
                                ("extra_edge_prob", 0.35), ("n_vlabels", 3),
                                ("n_elabels", 2), ("seed", 42)))
PUBCHEM20_DB = ("pubchem_like_db", (("n_graphs", 20), ("seed", 1),
                                    ("avg_edges", 14.0)))
TOY_DB = ("paper_toy_db", ())
SKEW_DB = ("skewed_db", ())
MAIN40_DB = ("pubchem_like_db", (("n_graphs", 40_000), ("seed", 0),
                                 ("avg_edges", 28)))
MAIN80_DB = ("pubchem_like_db", (("n_graphs", 80_000), ("seed", 1),
                                 ("avg_edges", 28)))
# ROADMAP queue C, C2: 1,914 directed edge triples at minsup 2
C2_DB = ("random_db", (("n_graphs", 400), ("n_vertices", 8),
                       ("extra_edge_prob", 0.3), ("n_vlabels", 40),
                       ("n_elabels", 2), ("seed", 0)))
C2_MINSUP, C2_MAX_SIZE = 2, 3
# tests/test_chaos.py's DB (levels of 3, 5, 10 and 5 frequent patterns)
CHAOS_DB = ("random_db", (("n_graphs", 10), ("seed", 5), ("n_vertices", 9),
                          ("n_vlabels", 2), ("n_elabels", 1)))
# phase 10's schedule: a kernel fault at level 3, a flipped wire bit at 4
SUPERVISED_SCHEDULE = "kernel_fault@3;wire_bitflip@4"


def main_minsup(n_graphs: int) -> int:
    """``MAIN_CFG``'s fractional minsup as the absolute count the miner
    derives from it."""
    import math
    return math.ceil(MAIN_CFG["minsup"] * n_graphs)


def use_src() -> None:
    """Import the port from this checkout (in a spawned process too)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def make_graphs(spec):
    """The graphs of a DB spec ``(generator name, kwargs pairs)``; the
    skewed DB is ``tests/test_elastic.py``'s (scheme 1 deals every heavy
    graph to partition 0)."""
    from repro_torch.core import graphdb
    name, kw = spec
    if name == "skewed_db":
        heavy = iter(graphdb.random_db(6, n_vertices=9, extra_edge_prob=0.6,
                                       n_vlabels=2, n_elabels=1, seed=1))
        light = iter(graphdb.random_db(18, n_vertices=3,
                                       extra_edge_prob=0.2, n_vlabels=2,
                                       n_elabels=1, seed=2))
        return [next(heavy) if i % 4 == 0 else next(light)
                for i in range(24)]
    return getattr(graphdb, name)(**dict(kw))


def mine_on_rank(mesh, graphs, cfg_kw: dict, sync_debug: bool) -> dict:
    """One fit on this rank, kernel launches counted from 0, each level's
    wire fetches counted, every dispatch under sync debug mode 'error'
    when ``sync_debug``; a device-loop fit runs under :func:`run_guard`
    (its run wire copies counted)."""
    import torch
    import repro_torch.core.mining as mining
    with level_guard(sync_debug) as counts, run_guard() as run_counts:
        miner = mining.Mirage(mining.MirageConfig(**cfg_kw), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = miner.fit(graphs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
    return {"supports": sorted(res.supports.items()), "seconds": secs,
            "launches": launches, "fetches": counts["fetch"],
            "peak": torch.cuda.max_memory_allocated(),
            "backend": miner.backend, "counts": res.counts(),
            "device_loop": miner.last_device_loop,
            "run_copies": run_counts["copies"],
            "stats": [(st.level, st.n_candidates, st.n_frequent,
                       st.rebalanced, st.imbalance, st.seconds,
                       st.map_seconds, st.survivor_cap, st.retried,
                       st.audit) for st in res.stats]}


def supervise_on_rank(mesh, graphs, cfg_kw: dict) -> dict:
    """One supervised run on this rank under ``cfg_kw["schedule"]``
    (every rank installs the same) and, with ``cfg_kw["deadlines"]``,
    this rank's run deadline from that list (a partial result is then
    returned); kernel launches counted from 0.  Returns the supervisor's
    events, the mesh it ends on, and the result (None on a rank that
    retired)."""
    import repro_torch.core.mining as mining
    from repro_torch.core.supervisor import MiningSupervisor, SupervisorConfig
    from repro_torch.runtime import faults
    from repro_torch.runtime.watchdog import Watchdog
    cfg_kw = dict(cfg_kw)
    faults.install(faults.FaultSchedule.parse(cfg_kw.pop("schedule")))
    deadlines = cfg_kw.pop("deadlines", None)
    watchdog = (Watchdog(run_deadline_s=deadlines[mesh.rank])
                if deadlines else None)
    try:
        with level_guard(sync_debug=False) as counts:
            sup = MiningSupervisor(
                mining.MirageConfig(**cfg_kw),
                SupervisorConfig(on_exhausted="partial" if deadlines
                                 else "raise"),
                mesh=mesh, watchdog=watchdog)
            reset_launch_counts()
            res = sup.mine(graphs)
            launches = launch_counts()
    finally:
        faults.clear()
    return {"events": [(e.kind, e.action, e.level) for e in sup.events],
            "workers": sup.mesh.n_workers, "launches": launches,
            "log": counts["log"], "partial": isinstance(res,
                                                        mining.PartialResult),
            "supports": None if res is None else sorted(res.supports.items()),
            "levels": (None if res is None or deadlines
                       else [st.level for st in res.stats])}


def rank_main(rank: int, world: int, backend: str, store: str, runs,
              out: str, group_timeout: float) -> None:
    """A worker rank: joins the process group (``backend`` over a
    FileStore, every collective bounded by ``group_timeout`` seconds) on
    cuda:0, mines each of ``runs`` — ``(name, DB spec, config)`` — and
    writes its results to ``out``."""
    use_src()
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.core.mapreduce import MiningMesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=group_timeout), **kw)
    try:
        mesh = MiningMesh.from_process_group(dist.group.WORLD, device)
        graphs, results = {}, {}
        for name, db, cfg_kw in runs:
            if db not in graphs:
                graphs[db] = make_graphs(db)
            if "schedule" in cfg_kw:
                results[name] = supervise_on_rank(mesh, graphs[db], cfg_kw)
            else:
                results[name] = mine_on_rank(mesh, graphs[db], cfg_kw,
                                             sync_debug=backend == "nccl")
        with open(out, "wb") as f:
            pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(label: str, world: int, backend: str, runs,
                timeout: float, target=None) -> list[dict]:
    """Run ``runs`` on ``world`` ranks of a ``backend`` group, each rank a
    spawned process on cuda:0; every collective of the group gives up
    after ``timeout`` seconds and every rank is killed when the phase
    takes longer than that, so that a rank that raises fails the phase
    instead of hanging it.  ``target`` (``rank_main``, the miner's rank,
    by default) is each rank's function.  Returns each rank's
    results."""
    import multiprocessing
    import pickle
    timeout = CLOCK.clip(label, timeout)
    RANK_DIR.mkdir(parents=True, exist_ok=True)
    store = RANK_DIR / f"{label}.store"
    outs = [RANK_DIR / f"{label}.rank{r}.pkl" for r in range(world)]
    for path in (store, *outs):
        path.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or rank_main, args=(
        r, world, backend, str(store), runs, str(outs[r]), timeout))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    check(not hung, f"{label}: ranks {hung} still running after {timeout}s")
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"{label}: rank exit codes {codes}")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def oracle(spec, minsup, max_size):
    """``mine_host``'s frequent set of the DB ``spec`` as sorted (code,
    support) pairs."""
    use_src()
    from repro_torch.core.host_miner import mine_host
    return sorted((c, i.support) for c, i in mine_host(
        make_graphs(spec), minsup, max_size=max_size).frequent.items())


def check_ranks(label: str, results: list[dict], want: dict) -> None:
    """Every rank of every run equals its oracle (``want[name]``), with
    one wire fetch per level and audit words 0 on a single-sync run."""
    for r, res in enumerate(results):
        for name, got in res.items():
            check(got["supports"] == want[name],
                  f"{label} {name} rank {r}: the frequent set differs from "
                  f"mine_host")
            info = got["device_loop"]
            if info is not None:
                check(info["completed"] and got["run_copies"]
                      == info["escalations"] + 1,
                      f"{label} {name} rank {r}: device loop {info}, "
                      f"{got['run_copies']} run wire copies")
            elif got["fetches"]:
                check(set(got["fetches"].values()) == {1}
                      and len(got["fetches"]) == len(got["stats"]),
                      f"{label} {name} rank {r}: wire fetches per level "
                      f"{got['fetches']} over {len(got['stats'])} levels")
            check(all(st[-1] == 0 for st in got["stats"]),
                  f"{label} {name} rank {r}: audit words "
                  f"{[st[-1] for st in got['stats']]}")


def phase_multiworker_small() -> None:
    """Phase 8 (a, b): two gloo ranks on the one card mine the conformance
    matrix and the skewed DB."""
    import itertools
    runs, want = [], {}
    for db, minsup, max_size in ((CONFORMANCE_DB, 5, 3),
                                 (PUBCHEM20_DB, 5, 4)):
        ref = oracle(db, minsup, max_size)
        base = dict(minsup=minsup, n_partitions=8, max_size=max_size)
        for sharded, scheme, overlap in itertools.product(
                (True, False), (2, "density"), (True, False)):
            name = f"{db[0]} sharded={sharded} scheme={scheme} " \
                   f"overlap={overlap}"
            runs.append((name, db, dict(
                base, reduce="reduce_scatter", sharded_wire=sharded,
                scheme=scheme, overlap_candgen=overlap)))
            want[name] = ref
        runs.append((f"{db[0]} psum", db, dict(base, reduce="psum")))
        want[f"{db[0]} psum"] = ref
    skew_ref = oracle(SKEW_DB, 6, 3)
    skew = dict(minsup=6, n_partitions=4, scheme=1, max_size=3,
                rebalance=True, rebalance_threshold=1.1)
    for name, kw in (("skew single_sync", {}),
                     ("skew legacy pallas", dict(pipeline="legacy",
                                                 backend="pallas"))):
        runs.append((name, SKEW_DB, dict(skew, **kw)))
        want[name] = skew_ref
    t0 = time.perf_counter()
    results = spawn_ranks("phase8-small", 2, "gloo", runs, timeout=300)
    check_ranks("phase 8", results, want)
    for r, res in enumerate(results):
        for name in ("skew single_sync", "skew legacy pallas"):
            got = res[name]
            check(any(st[3] for st in got["stats"]),
                  f"phase 8 {name} rank {r}: no rebalance fired "
                  f"(imbalance {[st[4] for st in got['stats']]})")
            say(f"phase 8 rank {r} {name}: (level, rebalanced, imbalance) "
                f"{[(st[0], st[3], st[4]) for st in got['stats']]}, "
                f"launches {got['launches']}, wire fetches per level "
                f"{got['fetches']}")
        b1 = sum(v["launches"]["fused_level_packed"] for v in res.values())
        check(b1 > 0, f"phase 8 rank {r}: the packed kernel never launched")
    say(f"phase 8 small: 2 gloo ranks on cuda:0, {len(runs)} fits each "
        f"(conformance and pubchem-like 20 matrix: sharded x scheme x "
        f"overlap + psum; skewed DB single-sync and legacy two-launch), "
        f"every rank equal to mine_host, a rebalance on the skewed DB "
        f"under both pipelines, 1 wire fetch per level "
        f"({time.perf_counter() - t0:.1f}s)")


def phase_multiworker_shrink() -> None:
    """Phase 8 (d): supervised runs on two gloo ranks on the one card
    (the chaos DB, 4 partitions, checkpoints).  A run deadline that only
    rank 0 sees pass: the ranks agree on it in the survivor-cap
    all-reduce before level 2's dispatch and both return the empty
    prefix.  Then ``worker_loss@3``: both ranks raise before any
    collective of level 3, rank 1 retires and rank 0 resumes alone from
    the level-2 checkpoint, equal to ``mine_host``."""
    import shutil
    cks = [RANK_DIR / f"phase8-{name}-ck" for name in ("deadline", "shrink")]
    for ck in cks:
        shutil.rmtree(ck, ignore_errors=True)
    want = oracle(CHAOS_DB, 5, 5)
    t0 = time.perf_counter()
    base = dict(minsup=5, n_partitions=4, max_size=5)
    runs = [("deadline", CHAOS_DB, dict(base, checkpoint_dir=str(cks[0]),
                                        schedule="",
                                        deadlines=[1e-6, 3600.0])),
            ("shrink", CHAOS_DB, dict(base, checkpoint_dir=str(cks[1]),
                                      schedule="worker_loss@3"))]
    results = spawn_ranks("phase8-shrink", 2, "gloo", runs, timeout=300)
    for r, res in enumerate(results):
        got = res["deadline"]
        check(got["events"] == [("deadline", "partial", 2)]
              and got["partial"] and got["supports"] == [],
              f"phase 8 deadline rank {r}: events {got['events']}, partial "
              f"{got['partial']}")
    say(f"phase 8 deadline: a run deadline passed on rank 0 only; both "
        f"ranks stopped before level 2's dispatch with "
        f"{results[0]['deadline']['events']} and the empty prefix")
    r0, r1 = (res["shrink"] for res in results)
    check(r0["events"] == [("worker_loss", "shrink", 3)]
          and r1["events"] == [("worker_loss", "retire", 3)],
          f"phase 8 shrink: events {r0['events']} / {r1['events']}")
    check(r1["supports"] is None, "phase 8 shrink: rank 1 did not retire")
    check(r0["workers"] == 1 and r0["levels"][0] == 3,
          f"phase 8 shrink: rank 0 on {r0['workers']} worker(s), levels "
          f"{r0['levels']} (should resume at level 3)")
    check(r0["supports"] == want,
          "phase 8 shrink: rank 0's frequent set differs from mine_host")
    check(r0["launches"]["fused_level_packed"] > 0,
          f"phase 8 shrink: launches {r0['launches']}")
    say(f"phase 8 shrink: worker_loss@3 at W=2 -> rank 0 {r0['events']}, "
        f"rank 1 {r1['events']}; rank 0 resumed alone at level 3, levels "
        f"{r0['levels']}, {len(want)} frequent equal to mine_host, kernel "
        f"launches {r0['launches']} ({time.perf_counter() - t0:.1f}s)")


def fetches_per_attempt(log) -> list[dict]:
    """Each attempt's wire copies per level, from a level_guard log: an
    attempt starts where a level is dispatched that is not past the last
    one dispatched."""
    attempts, last = [], None
    for kind, level in log:
        if kind == "dispatch":
            if last is None or level <= last:
                attempts.append({})
            last = level
        else:
            attempts[-1][level] = attempts[-1].get(level, 0) + 1
    return attempts


def phase_supervised(graphs40, want40) -> None:
    """Phase 10: phase 4's database and config under ``MiningSupervisor``
    with ``SUPERVISED_SCHEDULE``, one kernel fault per rung and no
    checkpoints (a retry restarts clean, still exact): the packed kernel
    runs level 2, the kernel fault at level 3 descends to the two-launch
    kernels, which mine levels 2-4 afresh, and level 4's flipped wire
    heals with one re-fetch inside the run."""
    import torch
    import repro_torch.core.mining as mining
    from repro_torch.core.supervisor import MiningSupervisor, SupervisorConfig
    from repro_torch.runtime import faults
    log_path = ROOT / "build" / "chip_smoke_faults.jsonl"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    sup = MiningSupervisor(
        mining.MirageConfig(**MAIN_CFG),
        SupervisorConfig(fault_log_path=str(log_path), degrade_after=1))
    faults.install(faults.FaultSchedule.parse(SUPERVISED_SCHEDULE))
    try:
        with level_guard(sync_debug=True) as counts:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = sup.mine(graphs40)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = launch_counts()
        fired = [(e["kind"], e["level"]) for e in faults.injection_log()]
    finally:
        faults.clear()
        faults.reset_log()
    events = [(e.kind, e.action, e.level) for e in sup.events]
    attempts = fetches_per_attempt(counts["log"])
    lines = [json.loads(l) for l in log_path.read_text().splitlines()]
    say(f"phase 10 supervised: schedule {SUPERVISED_SCHEDULE}, fit "
        f"{secs:.2f}s over {len(attempts)} attempts, frequent per level "
        f"{res.counts()}, kernel launches {launches}, injected {fired}")
    for line in lines:
        say(f"  fault log: {json.dumps(line)}")
    for i, per_level in enumerate(attempts):
        say(f"  attempt {i + 1}: wire copies per level {per_level}")
    for st in res.stats:
        say(f"  level {st.level}: candidates={st.n_candidates} "
            f"frequent={st.n_frequent} {st.seconds:.3f}s (device+wire "
            f"{st.map_seconds:.3f}s, hidden candgen "
            f"{st.candgen_seconds:.3f}s) survivor_cap={st.survivor_cap} "
            f"retried={st.retried} audit={st.audit}")
    check(events == [("kernel", "degrade", 3)],
          f"phase 10: supervisor events {events}")
    check(fired == [("kernel_fault", 3), ("wire_bitflip", 4)],
          f"phase 10: faults fired {fired}")
    check(sup.last_miner.backend == "pallas",
          f"phase 10: the last attempt ran backend {sup.last_miner.backend}")
    # pass 2: attempt 1's level 2 and its retry (level 3 faults before
    # its work), attempt 2's three levels and the retries of 2 and 3
    check(launches == {"fused_level_packed": 1, "fused_level": 0,
                       "embedding_join": 3, "support_count": 3,
                       "materialize_level": 7},
          f"phase 10: kernel launches {launches}")
    check(attempts == [{2: 1}, {2: 1, 3: 1, 4: 2}],
          f"phase 10: wire copies per attempt and level {attempts}")
    check(all(st.audit == 0 for st in res.stats), "phase 10: audit words")
    check(lines[-1]["summary"]["outcome"] == "complete"
          and lines[-1]["summary"]["rung"] == 1,
          f"phase 10: fault log summary {lines[-1]}")
    check(sorted(res.supports.items()) == want40,
          "phase 10: the frequent set differs from mine_host")
    say("phase 10 supervised: B1 ran level 2, the kernel fault at level 3 "
        "descended to 'pallas', B3 + B4 ran levels 2-4, level 4's wire "
        "healed with 2 copies, every other level 1; equal to mine_host")


def phase_multiworker_main(want40) -> None:
    """Phase 8 (c): the packed 40K main run at W=2, 4 partitions a rank,
    two gloo ranks sharing the one card."""
    t0 = time.perf_counter()
    results = spawn_ranks("phase8-main", 2, "gloo",
                          [("40K", MAIN40_DB, dict(MAIN_CFG))], timeout=900)
    check_ranks("phase 8 main", results, {"40K": want40})
    for r, res in enumerate(results):
        got = res["40K"]
        n = len(got["stats"])
        check(got["launches"]["fused_level_packed"] == n,
              f"phase 8 rank {r}: {got['launches']} launches over {n} "
              f"levels (the packed kernel once a level)")
        say(f"phase 8 main rank {r}: backend={got['backend']} fit "
            f"{got['seconds']:.2f}s, frequent per level {got['counts']}, "
            f"peak device memory {got['peak']} bytes, kernel launches "
            f"{got['launches']}, wire fetches per level {got['fetches']}")
        for (lv, nc, nf, reb, imb, secs, msecs, cap, retried,
             audit) in got["stats"]:
            say(f"  rank {r} level {lv}: candidates={nc} frequent={nf} "
                f"{secs:.3f}s (device+wire {msecs:.3f}s) "
                f"survivor_cap={cap} retried={retried} rebalanced={reb} "
                f"imbalance={imb:.4f} audit={audit}")
    say(f"phase 8 main: pubchem_like_db(40000) at W=2 on one card equals "
        f"mine_host on both ranks ({time.perf_counter() - t0:.1f}s with "
        f"the ranks' start, DB and prep)")


def phase_nccl() -> None:
    """Phase 9: a one-rank NCCL group on the card mines the small DBs,
    every level dispatch under sync debug mode 'error', and (the DBs
    with a ``max_size``) as one device-loop run, its collectives inside
    the level bodies, under sync debug mode 'error' to its wire copy."""
    runs, want = [], {}
    for db, minsup, max_size in ((TOY_DB, 2, None), (CONFORMANCE_DB, 5, 3),
                                 (PUBCHEM20_DB, 5, 4)):
        kinds = [(f"{db[0]} fused", {}),
                 (f"{db[0]} pallas", dict(backend="pallas"))]
        if max_size is not None:
            kinds.append((f"{db[0]} device_loop",
                          dict(pipeline="device_loop")))
        for name, kw in kinds:
            runs.append((name, db, dict(minsup=minsup, max_size=max_size,
                                        n_partitions=2, **kw)))
            want[name] = oracle(db, minsup, max_size)
    t0 = time.perf_counter()
    results = spawn_ranks("phase9", 1, "nccl", runs, timeout=300)
    check_ranks("phase 9", results, want)
    res = results[0]
    levels = sum(len(v["stats"]) for v in res.values())
    launches = {k: sum(v["launches"][k] for v in res.values())
                for k in next(iter(res.values()))["launches"]}
    check(launches["fused_level_packed"] > 0
          and launches["embedding_join"] > 0,
          f"phase 9: kernel launches {launches}")
    say(f"phase 9 nccl: a one-rank NCCL group on cuda:0, {len(runs)} fits "
        f"(3 DBs x fused, two-launch; 2 as device-loop runs) equal to "
        f"mine_host; {levels} levels ran their collectives under sync "
        f"debug mode 'error' with 1 wire fetch each (a device-loop run: "
        f"1 per run); kernel launches {launches} "
        f"({time.perf_counter() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# the examples and the LM serving path
# ---------------------------------------------------------------------------

EXAMPLE_CKPT = ROOT / "build" / "chip_smoke_example_ckpt"
# the mine_distributed example's DB and config (examples/*_torch.py)
EXAMPLE_DB = ("pubchem_like_db", (("n_graphs", 64), ("seed", 11),
                                  ("avg_edges", 14)))
EXAMPLE_MINSUP, EXAMPLE_MAX_SIZE = 8, 5     # ceil(0.12 * 64)
DENSE_ARCHS = ("qwen2.5-14b", "granite-20b", "minicpm-2b", "gemma2-2b")
SERVE_ARCH = "qwen2.5-14b"
SERVE_TIMEOUT = 600
MOE_ARCH = "deepseek-v2-lite-16b"          # full width and depth
MOE_CUT_ARCH = "phi3.5-moe-42b-a6.6b"      # full width, depth cut
MOE_CUT_LAYERS = 4
MOE_TIMEOUT = 300
SSM_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")   # full width and depth
# the held weights' bytes and the parameters of each (repro's init_lm
# shapes; float32 where repro uses a tensor uncast, bf16 elsewhere)
SSM_WEIGHTS = {"zamba2-2.7b": (5_940_259_456, 2_969_653_408),
               "xlstm-1.3b": (2_323_718_816, 1_135_757_480)}
# decode against a re-forward: full width, depth cut to one unit (6
# Mamba2 + the shared block; 7 mLSTM + 1 sLSTM), chunks of 8
SSM_CUT_LAYERS = {"zamba2-2.7b": 6, "xlstm-1.3b": 8}
SSM_LONG_PROMPT = 1024
SSM_TIMEOUT = 420
ENCDEC_ARCH = "whisper-base"               # full width and depth
VLM_ARCH = "qwen2-vl-72b"                  # full width, depth cut
VLM_CUT_LAYERS = 8
# repro's parameter counts at the published widths (init_encdec, init_lm)
ENCDEC_VLM_PARAMS = {ENCDEC_ARCH: 70_611_456, VLM_ARCH: 72_706_203_648}
ENCDEC_VLM_TIMEOUT = 420
TRAIN_ARCH = "minicpm-2b"                  # full width and depth
TRAIN_PARAMS = 2_724_880_896               # repro's count_params at full width
TRAIN_STEPS = 10
TRAIN_AGAIN_STEPS = 3                      # the same seed again
TRAIN_BATCH = (8, 64)                      # global batch x sequence length
TRAIN_CUT_LAYERS = 2                       # remat / microbatch checks
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train_ckpt"
TRAIN_TIMEOUT = 300
MESH1_STEPS = 2                            # phase 17's 1x1 mesh run
MESH_SHAPE = (2, 2)                        # phase 18: ("data", "model")
MESH_LAYERS = 2                            # full width, depth cut
MESH_STEPS = 1
MESH_LR = 1e-5                             # constant; see mesh_train
MESH_TIMEOUT = 180
SERVE_MESH = (4, 16, 8)          # phase 17: requests, prompt, decoded
MESH_SERVE_STEPS = 4             # phase 18's decoded tokens (gloo: ~1.5 s each)
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT = 420             # phase 19's dry runs, beside phases 12-18


def load_example(name: str):
    """The module of ``examples/<name>.py``."""
    import importlib.util
    use_src()
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> None:
    """Phase 12: ``quickstart_torch.py`` on the card (its own asserts,
    kernel launches counted from 0), then ``mine_distributed_torch.py``
    with two ranks on the one card (gloo): run 1 cut at level 2, run 2
    resumed from its checkpoint, equal to ``mine_host``."""
    import os
    quickstart = load_example("quickstart_torch")
    t0 = time.perf_counter()
    reset_launch_counts()
    res = quickstart.main(["--device", "cuda"])
    launches = launch_counts()
    secs = time.perf_counter() - t0
    check(launches["fused_level_packed"] > 0,
          f"phase 12 quickstart: kernel launches {launches}")
    say(f"phase 12 quickstart: the toy DB's 13 patterns and the 60-graph "
        f"DB ({res.counts()}) on the card equal mine_host; kernel launches "
        f"{launches} ({secs:.1f}s)")

    from repro_torch.core.host_miner import mine_host
    want = [len(l) for l in mine_host(make_graphs(EXAMPLE_DB),
                                      EXAMPLE_MINSUP,
                                      max_size=EXAMPLE_MAX_SIZE).levels]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "mine_distributed_torch.py"),
         "--workers", "2", "--device", "cuda", "--ckpt-dir",
         str(EXAMPLE_CKPT), "--timeout", "240", "--group-timeout", "120"],
        capture_output=True, text=True,
        timeout=CLOCK.clip("phase 12 mine_distributed", 600),
        env={**os.environ, "PYTHONPATH": str(SRC)})
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        say(f"phase 12 mine_distributed | {line}")
    check(proc.returncode == 0,
          f"phase 12 mine_distributed exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    check(proc.stdout.count("backend gloo, device cuda:0") == 4,
          "phase 12 mine_distributed: not 2 gloo ranks on cuda:0 per run")
    levels = [l for l in proc.stdout.splitlines() if l.startswith("LEVELS:")]
    check(len(levels) == 2 and levels[-1] == f"LEVELS: {want}"
          and "resumed run equals mine_host" in proc.stdout,
          f"phase 12 mine_distributed: levels {levels}, mine_host {want}")
    say(f"phase 12 mine_distributed: 2 gloo ranks on cuda:0, run 1 cut at "
        f"level 2 ({levels[0][8:]}), run 2 resumed to {levels[1][8:]} = "
        f"mine_host ({secs:.1f}s)")


def _rel_err(want, got) -> float:
    """max |got - want| / max(1, max |want|), in float32."""
    want, got = want.float().cpu(), got.float().cpu()
    return float((got - want).abs().max() / max(1.0, float(
        want.abs().max())))


def profile_decode(cfg, steps: int = 8) -> dict:
    """Where a decode step's time goes: ``steps`` greedy decode steps of
    ``cfg`` (4 requests, after the prefill of 16 tokens with the
    family's stub media, and 2 warm-up steps) under ``torch.profiler``,
    against the host's clock around them (the device synchronized at
    both ends).  Returns the wall ms, the summed
    device time of the kernels the profiler saw and their count, both
    per step (the kernels of one stream do not overlap)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    fns = reg.build(cfg, device="cuda")
    model = fns["init"](torch.Generator("cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 16)), device="cuda")
    batch, T = serve.prompt_batch(cfg, model, toks)
    logits, cache = fns["prefill"](model, batch, max_len=T + 2 + steps)
    tok = logits[:, -1].argmax(-1)

    def step(pos):
        nonlocal logits, cache, tok
        logits, cache = fns["decode"](
            model, cache, serve.step_batch(cfg, tok[:, None], pos), pos)
        tok = logits[:, -1].argmax(-1)

    for pos in (T, T + 1):
        step(pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pos in range(T + 2, T + 2 + steps):
            step(pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    return {"steps": steps, "wall_ms": wall_ms / steps,
            "device_ms": busy_us / 1e3 / steps,
            "kernels": len(kernels) / steps}


def decode_vs_forward(cfg, seed: int = 1, P: int = 16,
                      G: int = 8) -> tuple[list[float], dict]:
    """Cached decode against a re-forward of the whole prefix on the
    card: 4 requests, ``P`` prompt tokens (with the family's stub media),
    then ``G`` steps each fed the next token of a seeded sequence
    (``cfg``'s own dtype, random weights from ``seed``).  Returns each
    step's relative error and, after the last step, the lengths of the
    attention caches by block kind."""
    import numpy as np
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    fns = reg.build(cfg, device="cuda")
    model = fns["init"](torch.Generator("cuda").manual_seed(seed))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab, (4, P + G)), device="cuda")
    batch, T = serve.prompt_batch(cfg, model, toks[:, :P])
    _, cache = fns["prefill"](model, batch, max_len=T + G)
    errs = []
    for t in range(G):
        dec, cache = fns["decode"](
            model, cache,
            serve.step_batch(cfg, toks[:, P + t:P + t + 1], T + t), T + t)
        ref, _ = fns["prefill"](
            model, serve.prompt_batch(cfg, model, toks[:, :P + t + 1])[0])
        errs.append(_rel_err(ref[:, -1], dec[:, 0]))
    lengths = {}
    for blk, c in zip(model.layers, cache):
        if blk.kind in ("attn", "cross_attn"):
            lengths.setdefault(blk.kind, set()).add(c["k"].shape[1])
    del model, cache
    torch.cuda.empty_cache()
    return errs, lengths


def card_vs_cpu(cfg, P: int = 16, G: int = 8) -> tuple[float, int, int]:
    """The same weights and inputs on the card and on the CPU: prefill
    of 4 requests of ``P`` tokens (with the family's stub media) and
    ``G`` greedy decode steps fed the CPU's tokens.  Returns the largest
    relative error of the last logits, and at how many of the ``G + 1``
    steps the greedy tokens agreed."""
    import numpy as np
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    cpu, gpu = reg.build(cfg, device="cpu"), reg.build(cfg, device="cuda")
    host = cpu["init"](torch.Generator().manual_seed(2))
    card = reg.model_class(cfg)(cfg, device="meta").to_empty(device="cuda")
    card.load_state_dict(host.state_dict())
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        1, cfg.vocab, (4, P)))
    batch, T = serve.prompt_batch(cfg, host, toks)
    a, ca = cpu["prefill"](host, batch, max_len=T + G)
    b, cb = gpu["prefill"](card, serve.prompt_batch(cfg, card, toks.cuda())[0],
                           max_len=T + G)
    errs, same = [], 0
    for t in range(G + 1):
        errs.append(_rel_err(a[:, -1], b[:, -1]))
        tok = a[:, -1].argmax(-1)
        same += int(torch.equal(tok, b[:, -1].argmax(-1).cpu()))
        if t == G:
            break
        step = serve.step_batch(cfg, tok[:, None], T + t)
        a, ca = cpu["decode"](host, ca, step, T + t)
        b, cb = gpu["decode"](card, cb, step, T + t)
    return max(errs), same, G + 1


def serving_child(out: str) -> None:
    """Phase 13's work, in a process of its own (so the card's memory is
    the serving path's alone): qwen2.5-14b at full width and depth
    through ``serve_lm_torch.main`` twice; cached decode against a full
    re-forward at full width, 2 layers, float32; the four dense smoke
    configs on the card against the CPU, float32.  Writes its results to
    ``out`` (pickle)."""
    use_src()
    import dataclasses
    import pickle
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    res = {"runs": []}
    for _ in range(2):
        gen, stats = serve.main(["--arch", SERVE_ARCH, "--full",
                                 "--device", "cuda"])
        res["runs"].append((gen, stats))
        torch.cuda.empty_cache()
    full = reg.get_config(SERVE_ARCH)
    res["params"] = reg.count_params(full)
    res["profile"] = profile_decode(full)
    torch.cuda.empty_cache()
    res["decode_vs_forward"], _ = decode_vs_forward(
        dataclasses.replace(full, n_layers=2, dtype="float32"))
    res["card_vs_cpu"] = {arch: card_vs_cpu(dataclasses.replace(
        reg.get_smoke_config(arch), dtype="float32"))
        for arch in DENSE_ARCHS}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def serving_moe_child(out: str) -> None:
    """Phase 14's work, in a process of its own: deepseek-v2-lite at full
    width and depth through ``serve_lm_torch.main`` twice; phi3.5-moe at
    full width cut to ``MOE_CUT_LAYERS`` layers through
    ``serve_lm_torch.serve`` twice (the example's prompts); a profile of
    deepseek's decode; cached decode against a re-forward at deepseek's
    full width, 1 dense + 1 MoE layer, float32, at capacity factor E/k;
    both MoE smoke configs with each ``moe_impl`` on the card against
    the CPU, float32.  Writes its results to ``out`` (pickle)."""
    use_src()
    import dataclasses
    import pickle
    import numpy as np
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    res = {}
    deep = reg.get_config(MOE_ARCH)
    cut = dataclasses.replace(reg.get_config(MOE_CUT_ARCH),
                              n_layers=MOE_CUT_LAYERS)
    prompts = np.random.default_rng(0).integers(1, cut.vocab, (4, 16))
    for cfg, run in ((deep, lambda: serve.main(
            ["--arch", MOE_ARCH, "--full", "--device", "cuda"])),
            (cut, lambda: serve.serve(cut, prompts, 24, device="cuda"))):
        runs = []
        for _ in range(2):
            runs.append(run())
            torch.cuda.empty_cache()
        full = reg.get_config(cfg.name)
        res[cfg.name] = {"runs": runs, "vocab": cfg.vocab,
                         "layers": cfg.n_layers, "of": full.n_layers,
                         "full_params": reg.count_params(full),
                         "params": reg.count_params(cfg),
                         "active": reg.count_params(cfg, active_only=True)}
    res["profile"] = profile_decode(deep)
    torch.cuda.empty_cache()
    # no drops: at cf 1.25 a re-forward of S + 1 tokens has another
    # capacity, and drops other pairs, than the cached step
    res["decode_vs_forward"], _ = decode_vs_forward(dataclasses.replace(
        deep, n_layers=2, dtype="float32",
        capacity_factor=deep.n_experts / deep.top_k))
    res["card_vs_cpu"] = {
        (arch, impl): card_vs_cpu(dataclasses.replace(
            reg.get_smoke_config(arch), dtype="float32", moe_impl=impl))
        for arch in (MOE_ARCH, MOE_CUT_ARCH)
        for impl in ("einsum", "scatter")}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def long_prefill(cfg, S: int) -> dict:
    """One request of ``S`` prompt tokens through ``cfg``'s prefill on
    the card, three times (CUDA events): first, warm, and once more with
    CUDA events around every block.  Returns the first and warm ms,
    whether the logits are finite, the peak memory and each block
    kind's share of the third prefill's time."""
    import numpy as np
    import torch
    from repro_torch.models import registry as reg
    fns = reg.build(cfg, device="cuda")
    model = fns["init"](torch.Generator("cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab, (1, S)), device="cuda")
    spans = []

    def before(block, args):
        spans.append((block.kind, torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        spans[-1][1].record()

    def after(block, args, out):
        spans[-1][2].record()

    res = {}
    for label in ("first", "warm", "split"):
        hooks = []
        if label == "split":
            hooks = [b.register_forward_pre_hook(before)
                     for b in model.layers]
            hooks += [b.register_forward_hook(after) for b in model.layers]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, _ = fns["prefill"](model, {"tokens": toks})
        ev[1].record()
        torch.cuda.synchronize()
        res[f"{label}_ms"] = ev[0].elapsed_time(ev[1])
        for h in hooks:
            h.remove()
    res["finite"] = bool(torch.isfinite(logits).all())
    res["shape"] = tuple(logits.shape)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    share = {}
    for kind, a, b in spans:
        share[kind] = share.get(kind, 0.0) + a.elapsed_time(b)
    res["share"] = {k: v / res["split_ms"] for k, v in share.items()}
    del model, logits
    torch.cuda.empty_cache()
    return res


def serving_ssm_child(out: str) -> None:
    """Phase 15's work, in a process of its own: zamba2-2.7b and
    xlstm-1.3b at full width and depth through ``serve_lm_torch.main``
    twice each, a profile of each one's decode, one ``SSM_LONG_PROMPT``
    token prefill of each at the default ``ssm_chunk``; cached decode
    against a re-forward at full width, depth cut to ``SSM_CUT_LAYERS``,
    float32, ``ssm_chunk`` 8 (16 prompt and 24 decoded tokens); both
    smoke configs on the card against the CPU, float32.  Writes its
    results to ``out`` (pickle)."""
    use_src()
    import dataclasses
    import pickle
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    res = {}
    for arch in SSM_ARCHS:
        full = reg.get_config(arch)
        runs = []
        for _ in range(2):
            runs.append(serve.main(["--arch", arch, "--full", "--device",
                                    "cuda"]))
            torch.cuda.empty_cache()
        r = res[arch] = {"runs": runs, "vocab": full.vocab,
                         "layers": full.n_layers,
                         "params": reg.count_params(full)}
        r["profile"] = profile_decode(full)
        torch.cuda.empty_cache()
        r["long"] = long_prefill(full, SSM_LONG_PROMPT)
        r["decode_vs_forward"], _ = decode_vs_forward(
            dataclasses.replace(full, n_layers=SSM_CUT_LAYERS[arch],
                                dtype="float32", ssm_chunk=8), G=24)
        r["card_vs_cpu"] = card_vs_cpu(dataclasses.replace(
            reg.get_smoke_config(arch), dtype="float32"))
    with open(out, "wb") as f:
        pickle.dump(res, f)


def serving_encdec_vlm_child(out: str) -> None:
    """Phase 16's work, in a process of its own: whisper-base at full
    width and depth through ``serve_lm_torch.main`` twice; qwen2-vl-72b
    at full width cut to ``VLM_CUT_LAYERS`` layers through
    ``serve_lm_torch.serve`` twice (the example's prompts); a profile of
    each one's decode; cached decode against a re-forward, float32, at
    whisper's full width and depth and at qwen2-vl's full width cut to 2
    layers; both smoke configs on the card against the CPU, float32.
    Writes its results to ``out`` (pickle)."""
    use_src()
    import dataclasses
    import pickle
    import numpy as np
    import torch
    from repro_torch.models import registry as reg
    serve = load_example("serve_lm_torch")
    res = {}
    whisper = reg.get_config(ENCDEC_ARCH)
    vlm = reg.get_config(VLM_ARCH)
    cut = dataclasses.replace(vlm, n_layers=VLM_CUT_LAYERS)
    prompts = np.random.default_rng(0).integers(1, cut.vocab, (4, 16))
    for cfg, run in ((whisper, lambda: serve.main(
            ["--arch", ENCDEC_ARCH, "--full", "--device", "cuda"])),
            (cut, lambda: serve.serve(cut, prompts, 24, device="cuda"))):
        runs = []
        for _ in range(2):
            runs.append(run())
            torch.cuda.empty_cache()
        full = reg.get_config(cfg.name)
        r = res[cfg.name] = {"runs": runs, "vocab": cfg.vocab,
                             "layers": cfg.n_layers, "of": full.n_layers,
                             "full_params": reg.count_params(full),
                             "params": reg.count_params(cfg)}
        r["profile"] = profile_decode(cfg)
        torch.cuda.empty_cache()
    for arch, cfg in ((ENCDEC_ARCH, whisper),
                      (VLM_ARCH, dataclasses.replace(vlm, n_layers=2))):
        r = res[arch]
        r["decode_vs_forward"], r["cache_lengths"] = decode_vs_forward(
            dataclasses.replace(cfg, dtype="float32"))
        r["card_vs_cpu"] = card_vs_cpu(dataclasses.replace(
            reg.get_smoke_config(arch), dtype="float32"))
    with open(out, "wb") as f:
        pickle.dump(res, f)


def run_child(label: str, target, timeout: int) -> tuple[dict, float]:
    """Run ``target(out)`` in a spawned process, killed after ``timeout``
    seconds; returns the results it pickled and the seconds it took."""
    import multiprocessing
    import pickle
    timeout = CLOCK.clip(label, timeout)
    RANK_DIR.mkdir(parents=True, exist_ok=True)
    out = RANK_DIR / f"{label.replace(' ', '')}.pkl"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = multiprocessing.get_context("spawn").Process(
        target=target, args=(str(out),))
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.kill()
        proc.join(30)
        check(False, f"{label}: still running after {timeout}s")
    check(proc.exitcode == 0, f"{label}: exit code {proc.exitcode}")
    with open(out, "rb") as f:
        res = pickle.load(f)
    return res, time.perf_counter() - t0


def check_serves(label: str, runs, vocab: int) -> None:
    """Two serves of 4 requests x 24 tokens: ids inside the vocabulary,
    finite last logits, the same tokens both times."""
    import numpy as np
    (g1, s1), (g2, s2) = runs
    check(g1.shape == (4, 24) and ((g1 >= 0) & (g1 < vocab)).all()
          and s1["logits_finite"] and s2["logits_finite"],
          f"{label}: generations {g1.shape}, finite "
          f"{s1['logits_finite']}/{s2['logits_finite']}")
    check(np.array_equal(g1, g2), f"{label}: the two serves' tokens differ")


def say_serve(label: str, s: dict, params: str) -> None:
    say(f"{label}: 4 requests x 16 prompt + 24 generated tokens; weights "
        f"{s['weight_bytes']} bytes ({params}), init "
        f"{s['init_s']:.2f}s, prefill {s['prefill_ms']:.3f} ms, decode "
        f"{s['decode_ms_per_token']:.3f} ms/token (CUDA events), peak "
        f"{s['peak_bytes'] / 1e9:.2f} GB; reading the weights once takes "
        f"{s['weight_bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def say_profile(label: str, card: str, prof: dict) -> None:
    say(f"{label} decode under torch.profiler ({card}): "
        f"{prof['steps']} steps of 4 requests, {prof['wall_ms']:.3f} ms a "
        f"step on the host's clock, of which the device's kernels "
        f"{prof['device_ms']:.3f} ms ({prof['kernels']:.0f} kernels a "
        f"step; busy share {prof['device_ms'] / prof['wall_ms']:.3f})")


def phase_serving(card: str) -> None:
    """Phase 13: the LM serving path (no kernel of the miner: the dense
    decoder's attention and matmuls are PyTorch ops, as they are ``jnp``
    in the JAX package), in a spawned process, timed out and killed
    after ``SERVE_TIMEOUT`` seconds."""
    import torch
    torch.cuda.empty_cache()
    say(f"phase 13 serving: the miner's process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    res, secs = run_child("phase 13", serving_child, SERVE_TIMEOUT)
    check_serves("phase 13", res["runs"], 152_064)
    for i, (_, s) in enumerate(res["runs"]):
        say_serve(f"phase 13 serving {SERVE_ARCH} full width, 48 layers, "
                  f"bf16 ({card}), serve {i + 1}", s,
                  f"{res['params']} parameters")
    say(f"phase 13 serving: the two serves' tokens are identical; req 0 -> "
        f"{res['runs'][0][0][0][:12].tolist()}")
    say_profile("phase 13", card, res["profile"])
    errs = res["decode_vs_forward"]
    check(max(errs) <= 2e-4,
          f"phase 13: cached decode against re-forward, errors {errs}")
    say(f"phase 13 decode = re-forward: {SERVE_ARCH} full width, 2 layers, "
        f"float32, 8 cached steps against a re-forward of the prefix: max "
        f"|diff| / max(1, max |logit|) = {max(errs):.3g} (tolerance 2e-4)")
    for arch, (err, same, n) in res["card_vs_cpu"].items():
        check(err <= 1e-4, f"phase 13: {arch} card against CPU {err}")
        say(f"phase 13 card = CPU: {arch} smoke config, float32, prefill + "
            f"8 decode steps: max rel err {err:.3g} (tolerance 1e-4), "
            f"greedy tokens equal at {same} of {n} steps")
    say(f"phase 13 serving: {secs:.1f}s")


def phase_serving_moe(card: str) -> None:
    """Phase 14: the mixture-of-experts family's serving path (routing,
    both dispatches, the experts' products and MLA are PyTorch ops, as
    they are ``jnp`` in the JAX package), in a spawned process, timed
    out and killed after ``MOE_TIMEOUT`` seconds."""
    import torch
    torch.cuda.empty_cache()
    say(f"phase 14 serving-moe: the miner's process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    res, secs = run_child("phase 14", serving_moe_child, MOE_TIMEOUT)
    for arch in (MOE_ARCH, MOE_CUT_ARCH):
        r = res[arch]
        check_serves(f"phase 14 {arch}", r["runs"], r["vocab"])
        depth = (f"{r['layers']} layers" if r["layers"] == r["of"] else
                 f"depth cut to {r['layers']} of {r['of']} layers (the "
                 f"{r['full_params'] * 2 / 1e9:.2f} GB of bf16 weights of "
                 f"all {r['of']} do not fit the card)")
        for i, (_, s) in enumerate(r["runs"]):
            say_serve(f"phase 14 serving {arch} full width, {depth}, bf16 "
                      f"({card}), serve {i + 1}", s,
                      f"{r['params']} parameters, {r['active']} active")
        say(f"phase 14 serving {arch}: the two serves' tokens are "
            f"identical; req 0 -> {r['runs'][0][0][0][:12].tolist()}")
    say_profile(f"phase 14 {MOE_ARCH}", card, res["profile"])
    errs = res["decode_vs_forward"]
    check(max(errs) <= 2e-4,
          f"phase 14: cached decode against re-forward, errors {errs}")
    say(f"phase 14 decode = re-forward: {MOE_ARCH} full width, 2 layers (1 "
        f"dense + 1 MoE), float32, capacity factor E/k so that no pair is "
        f"dropped (at 1.25 a re-forward of S + 1 tokens has another "
        f"capacity and drops other pairs than the cached step: the JAX "
        f"package's semantics), 8 cached steps against a re-forward of "
        f"the prefix: max |diff| / max(1, max |logit|) = {max(errs):.3g} "
        f"(tolerance 2e-4)")
    for (arch, impl), (err, same, n) in res["card_vs_cpu"].items():
        check(err <= 1e-4,
              f"phase 14: {arch} {impl} card against CPU {err}")
        say(f"phase 14 card = CPU: {arch} smoke config, moe_impl={impl}, "
            f"float32, prefill + 8 decode steps: max rel err {err:.3g} "
            f"(tolerance 1e-4), greedy tokens equal at {same} of {n} steps")
    say(f"phase 14 serving-moe: {secs:.1f}s")


def phase_serving_ssm(card: str) -> None:
    """Phase 15: the recurrent families' serving path (Mamba2's chunked
    SSD, mLSTM's chunked form, sLSTM's recurrence, zamba2's shared
    attention: PyTorch ops, as they are ``jnp`` in the JAX package), in a
    spawned process, timed out and killed after ``SSM_TIMEOUT``
    seconds."""
    import torch
    torch.cuda.empty_cache()
    say(f"phase 15 serving-ssm: the miner's process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    res, secs = run_child("phase 15", serving_ssm_child, SSM_TIMEOUT)
    for arch in SSM_ARCHS:
        r = res[arch]
        want_bytes, want_params = SSM_WEIGHTS[arch]
        check_serves(f"phase 15 {arch}", r["runs"], r["vocab"])
        check(r["params"] == want_params,
              f"phase 15 {arch}: {r['params']} parameters, repro has "
              f"{want_params}")
        for i, (_, s) in enumerate(r["runs"]):
            check(s["weight_bytes"] == want_bytes,
                  f"phase 15 {arch}: weights {s['weight_bytes']} bytes, "
                  f"not {want_bytes}")
            say_serve(f"phase 15 serving {arch} full width, {r['layers']} "
                      f"layers, bf16 ({card}), serve {i + 1}", s,
                      f"{r['params']} parameters")
        say(f"phase 15 serving {arch}: the two serves' tokens are "
            f"identical; req 0 -> {r['runs'][0][0][0][:12].tolist()}")
        say_profile(f"phase 15 {arch}", card, r["profile"])
        lp = r["long"]
        check(lp["finite"], f"phase 15 {arch}: the {SSM_LONG_PROMPT}-token "
                            f"prefill's logits are not finite")
        shares = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            lp["share"].items()))
        say(f"phase 15 long prompt: {arch} full width and depth, bf16, 1 "
            f"request of {SSM_LONG_PROMPT} tokens at ssm_chunk "
            f"{long_chunk(arch)} ({SSM_LONG_PROMPT // long_chunk(arch)} "
            f"chunks), logits {lp['shape']} finite; prefill "
            f"{lp['first_ms']:.3f} ms first, {lp['warm_ms']:.3f} ms warm "
            f"(CUDA events), peak {lp['peak_bytes'] / 1e9:.2f} GB; a third "
            f"prefill with CUDA events around each block, "
            f"{lp['split_ms']:.3f} ms, by block kind: {shares}")
        errs = r["decode_vs_forward"]
        check(max(errs) <= 2e-4,
              f"phase 15 {arch}: cached decode against re-forward, "
              f"errors {errs}")
        say(f"phase 15 decode = re-forward: {arch} full width, "
            f"{SSM_CUT_LAYERS[arch]} layers, float32, ssm_chunk 8, 16 "
            f"prompt tokens then 24 cached steps against a re-forward of "
            f"the prefix (17-40 tokens): max |diff| / max(1, max |logit|) "
            f"= {max(errs):.3g} (tolerance 2e-4)")
        err, same, n = r["card_vs_cpu"]
        check(err <= 1e-4, f"phase 15: {arch} card against CPU {err}")
        say(f"phase 15 card = CPU: {arch} smoke config, float32, prefill + "
            f"8 decode steps: max rel err {err:.3g} (tolerance 1e-4), "
            f"greedy tokens equal at {same} of {n} steps")
    say(f"phase 15 serving-ssm: {secs:.1f}s")


def phase_serving_encdec_vlm(card: str) -> None:
    """Phase 16: the encoder-decoder and VLM families' serving path
    (whisper's encoder and cross-attention, qwen2-vl's M-RoPE: PyTorch
    ops, as they are ``jnp`` in the JAX package), in a spawned process,
    timed out and killed after ``ENCDEC_VLM_TIMEOUT`` seconds."""
    import torch
    from repro_torch.models import registry as reg
    torch.cuda.empty_cache()
    say(f"phase 16 serving-encdec-vlm: the miner's process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    res, secs = run_child("phase 16", serving_encdec_vlm_child,
                          ENCDEC_VLM_TIMEOUT)
    whisper = reg.get_config(ENCDEC_ARCH)
    media = {ENCDEC_ARCH: f"{whisper.encoder_frames} stub frames (30 s of "
                          f"audio) and 16 prompt tokens",
             VLM_ARCH: "a 16 x 16 stub image and 16 text tokens (272 "
                       "M-RoPE positions)"}
    reforward = {ENCDEC_ARCH: "6 layers, the frames re-encoded at each "
                              "re-forward",
                 VLM_ARCH: "cut to 2 layers, the M-RoPE positions "
                           "continuing through the re-forward"}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        r = res[arch]
        check_serves(f"phase 16 {arch}", r["runs"], r["vocab"])
        check(r["full_params"] == ENCDEC_VLM_PARAMS[arch],
              f"phase 16 {arch}: {r['full_params']} parameters at full "
              f"width, repro has {ENCDEC_VLM_PARAMS[arch]}")
        depth = (f"{r['layers']} layers" if r["layers"] == r["of"] else
                 f"depth cut to {r['layers']} of {r['of']} layers (the "
                 f"{r['full_params'] * 2 / 1e9:.2f} GB of bf16 weights of "
                 f"all {r['of']} do not fit the card)")
        for i, (_, s) in enumerate(r["runs"]):
            say_serve(f"phase 16 serving {arch} full width, {depth}, bf16 "
                      f"({card}), {media[arch]}, serve {i + 1}", s,
                      f"{r['params']} parameters; {r['full_params']} at "
                      f"full depth, as repro counts")
        say(f"phase 16 serving {arch}: the two serves' tokens are "
            f"identical; req 0 -> {r['runs'][0][0][0][:12].tolist()}")
        say_profile(f"phase 16 {arch}", card, r["profile"])
        errs = r["decode_vs_forward"]
        check(max(errs) <= 2e-4,
              f"phase 16 {arch}: cached decode against re-forward, errors "
              f"{errs}")
        lens = {k: sorted(v) for k, v in r["cache_lengths"].items()}
        say(f"phase 16 decode = re-forward: {arch} full width, "
            f"{reforward[arch]}, float32, 8 cached steps against a "
            f"re-forward of the prefix: max |diff| / max(1, max |logit|) = "
            f"{max(errs):.3g} (tolerance 2e-4); attention cache lengths "
            f"after the decode {lens}")
        err, same, n = r["card_vs_cpu"]
        check(err <= 1e-4, f"phase 16: {arch} card against CPU {err}")
        say(f"phase 16 card = CPU: {arch} smoke config, float32, prefill + "
            f"8 decode steps: max rel err {err:.3g} (tolerance 1e-4), "
            f"greedy tokens equal at {same} of {n} steps")
    lens = res[ENCDEC_ARCH]["cache_lengths"]
    check(lens == {"attn": {24}, "cross_attn": {whisper.encoder_frames}},
          f"phase 16 {ENCDEC_ARCH}: cache lengths {lens} after the decode "
          f"(self-attention 16 + 8, cross-attention "
          f"{whisper.encoder_frames} frames)")
    say(f"phase 16 serving-encdec-vlm: {secs:.1f}s")


def long_chunk(arch: str) -> int:
    """The chunk ``pick_chunk`` gives the long prompt at ``arch``'s
    default ``ssm_chunk``."""
    from repro_torch.models import registry as reg
    from repro_torch.models.ssm import pick_chunk
    return pick_chunk(SSM_LONG_PROMPT, reg.get_config(arch).ssm_chunk)


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------

def train_args() -> list:
    """``repro_torch.launch.train``'s arguments of the full-width run: the
    CLI's AdamW defaults (lr 3e-3, cosine, warmup steps // 10)."""
    B, S = TRAIN_BATCH
    return ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len",
            str(S), "--global-batch", str(B), "--seed", "0", "--device",
            "cuda"]


def train_batch(cfg, step: int, device: str = "cuda") -> dict:
    """The CLI's batch of ``step`` (the token pipeline, with the family's
    stub media), as tensors on ``device``."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import stub_batches
    B, S = TRAIN_BATCH
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    extra = stub_batches(cfg, S, B)
    batch = dict(pipe.batch(step), **(extra(step) if extra else {}))
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_step_times(cfg, fns, model, opt_state, steps: int = 3) -> dict:
    """More steps of the trained model, each split by CUDA events into the
    forward + backward pass and AdamW's update; then one step under
    ``torch.profiler`` (its kernels and their summed device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.train_step import make_train_step
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    params = dict(model.named_parameters())
    fb, up = [], []
    for i in range(steps):
        batch = train_batch(cfg, TRAIN_STEPS + i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        model.zero_grad(set_to_none=True)
        loss, _ = fns["loss_fn"](model, batch)
        loss.backward()
        ev[1].record()
        _, opt_state, _ = adamw_update(
            opt, params, {n: p.grad for n, p in params.items()}, opt_state)
        ev[2].record()
        torch.cuda.synchronize()
        fb.append(ev[0].elapsed_time(ev[1]))
        up.append(ev[1].elapsed_time(ev[2]))
    step = make_train_step(cfg, opt, fns["loss_fn"])
    batch = train_batch(cfg, TRAIN_STEPS + steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    return {"fwd_bwd_ms": fb, "adamw_ms": up, "wall_ms": wall_ms,
            "device_ms": busy_us / 1e3, "kernels": len(kernels)}


def batch_loss(fns, model, batch) -> float:
    import torch
    with torch.no_grad():
        return float(fns["loss_fn"](model, batch)[0])


def one_step_lowers_the_loss(cfg, fns, model, lr: float = 1e-5) -> tuple:
    """The loss of one batch before and after one AdamW step on it (a
    fresh optimizer state, constant lr ``lr``)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    batch = train_batch(cfg, 100)
    before = batch_loss(fns, model, batch)
    opt = AdamWConfig(lr=lr, schedule="constant", warmup_steps=0)
    make_train_step(cfg, opt, fns["loss_fn"])(model, init_train_state(model),
                                              batch)
    return before, batch_loss(fns, model, batch)


def ddp_steps(cfg, fns, model, steps: int = 3) -> list:
    """``steps`` compressed data-parallel steps of ``model`` in a one-rank
    NCCL group (its address on localhost); returns the losses."""
    import torch.distributed as dist
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import (init_error_state,
                                               make_train_step_ddp)
    from repro_torch.train.train_step import init_train_state
    one_rank_nccl_group()
    try:
        opt = AdamWConfig(lr=3e-4, schedule="constant", warmup_steps=0)
        step = make_train_step_ddp(cfg, opt, fns["loss_fn"],
                                   dist.group.WORLD, compress=True)
        state = init_train_state(model)
        err = init_error_state(dict(model.named_parameters()))
        losses = []
        for i in range(steps):
            model, state, err, m = step(model, state, err,
                                        train_batch(cfg, 200 + i))
            losses.append(float(m["loss"]))
        del err, state
        return losses
    finally:
        dist.destroy_process_group()


def grads_of(cfg, remat: str, microbatches: int, dtype: str,
             seed: int = 5) -> tuple:
    """The loss and float32 gradients (on the CPU) of one train step at
    full width cut to ``TRAIN_CUT_LAYERS`` layers on the card, computed
    in ``dtype``, no clipping, from the weights of ``seed``."""
    import dataclasses
    import torch
    from repro_torch.models import registry as reg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS, remat=remat,
                              dtype=dtype)
    fns = reg.build(cfg, device="cuda", masters=True)
    model = fns["init"](torch.Generator("cuda").manual_seed(seed))
    opt = AdamWConfig(lr=1e-5, clip_norm=None, schedule="constant",
                      warmup_steps=0)
    _, _, m = make_train_step(cfg, opt, fns["loss_fn"],
                              microbatches=microbatches)(
        model, init_train_state(model), train_batch(cfg, 0))
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    return float(m["loss"]), grads


def max_grad_err(a: dict, b: dict) -> float:
    return max(_rel_err(a[n], b[n]) for n in a)


def train_card_vs_cpu(arch: str) -> tuple:
    """One float32 train step of ``arch``'s smoke config on the card and
    on the CPU from the same weights and batch (lr 1e-5 constant: at the
    first step AdamW moves every weight by about lr): the loss's
    relative error, and the largest relative error of the gradients and
    of the updated masters."""
    import dataclasses
    import torch
    from repro_torch.models import registry as reg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = dataclasses.replace(reg.get_smoke_config(arch), dtype="float32")
    opt = AdamWConfig(lr=1e-5, schedule="constant", warmup_steps=0)
    host = reg.build(cfg, device="cpu", masters=True)["init"](
        torch.Generator().manual_seed(0))
    tree = reg.params_to_jax(cfg, host)
    out = {}
    for dev in ("cpu", "cuda"):
        fns = reg.build(cfg, device=dev, masters=True)
        model = reg.params_from_jax(cfg, tree, device=dev, masters=True)
        _, _, m = make_train_step(cfg, opt, fns["loss_fn"])(
            model, init_train_state(model), train_batch(cfg, 0, dev))
        out[dev] = (float(m["loss"]),
                    {n: p.detach().cpu() for n, p in
                     model.named_parameters()},
                    {n: p.grad.cpu() if p.grad is not None
                     else torch.zeros(p.shape)      # qwen2-vl: embeds in
                     for n, p in model.named_parameters()})
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out["cuda"]
    return (abs(lg - lc) / max(1.0, abs(lc)), max_grad_err(gc, gg),
            max_grad_err(pc, pg))


def resume_on_card() -> tuple:
    """minicpm's smoke config trained 12 steps uncut, and cut at step 6
    (a checkpoint every 3 steps) then resumed: the two runs' losses of
    steps 6-11 and the largest difference of their final masters."""
    import shutil
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry as reg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    cfg = reg.get_smoke_config(TRAIN_ARCH)
    fns = reg.build(cfg, device="cuda", masters=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=9)
    opt = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    full = train_loop(cfg, fns, TrainLoopConfig(
        steps=12, ckpt_every=1000, log_every=1000), opt, pipe,
        device="cuda")
    train_loop(cfg, fns, TrainLoopConfig(
        steps=6, ckpt_every=3, log_every=1000, ckpt_dir=str(TRAIN_CKPT)),
        opt, pipe, device="cuda")
    resumed = train_loop(cfg, fns, TrainLoopConfig(
        steps=12, ckpt_every=1000, log_every=1000,
        ckpt_dir=str(TRAIN_CKPT)), opt, pipe, device="cuda", resume=True)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        full["model"].parameters(), resumed["model"].parameters()))
    return full["losses"][6:], resumed["losses"], resumed["steps_run"], diff


def one_rank_nccl_group():
    """A one-rank NCCL group on localhost (its port free now)."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))


def cli_steps(cfg, steps: int, mesh=None) -> dict:
    """``train_loop`` with the CLI run's pipeline and AdamW config
    (cosine, warmup ``TRAIN_STEPS // 10``, ``TRAIN_STEPS`` total) for its
    first ``steps`` steps from seed 0, on ``mesh`` or unsharded on the
    card; returns ``train_loop``'s result."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry as reg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    B, S = TRAIN_BATCH
    return train_loop(
        cfg, reg.build(cfg, device="cuda", masters=True),
        TrainLoopConfig(steps=steps, seed=0, log_every=1000),
        AdamWConfig(lr=3e-3, schedule="cosine",
                    warmup_steps=max(1, TRAIN_STEPS // 10),
                    total_steps=TRAIN_STEPS),
        TokenPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0),
        device=None if mesh is not None else "cuda", mesh=mesh)


def mesh_run_1x1(cfg) -> dict:
    """``train_loop(mesh=)`` on a 1×1 ("data", "model") mesh over a
    one-rank NCCL group: ``cfg`` (minicpm-2b at full width and depth)
    trained ``MESH1_STEPS`` steps from seed 0 with the CLI run's
    pipeline and AdamW config (cosine, warmup 1, ``TRAIN_STEPS`` total).
    The mesh path (DTensor masters and moments, the use-site gathers,
    the shard hints, the sharded loss and optimizer) at full depth on
    the production backend; degenerate as a mesh: every axis has size
    1, so every placement is ``Replicate`` and no collective moves
    data."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    one_rank_nccl_group()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = cli_steps(cfg, MESH1_STEPS, mesh)
        secs = time.perf_counter() - t0
        wq = dict(out["model"].named_parameters())["layers.0.attn.wq"]
        res = {"losses": out["losses"], "seconds": secs,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "wq": f"{type(wq).__name__} {tuple(wq.placements)}"}
        del out, wq
        torch.cuda.empty_cache()
        return res
    finally:
        dist.destroy_process_group()


def greedy_serve(fns, model, prompts, steps: int, mesh=None) -> dict:
    """Prefill ``prompts`` (B, S) and ``steps`` greedy decode steps of
    ``model``, on ``mesh`` (the global batch on every rank) or unsharded:
    the tokens (B, steps + 1), each step's last-position logits (float32,
    on the CPU), the decode's ms a token (CUDA events), the peak bytes
    of the decode (its resident weights and caches included) and the
    caches."""
    import torch
    from repro_torch.runtime.sharding import active_mesh
    full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    B, S = prompts.shape
    with active_mesh(mesh):
        logits, cache = fns["prefill"](model, {"tokens": prompts},
                                       max_len=S + steps)
        outs = [full(logits)[:, -1].float()]
        toks = [outs[-1].argmax(-1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for i in range(steps):
            logits, cache = fns["decode"](model, cache,
                                          {"tokens": toks[-1][:, None]},
                                          S + i)
            outs.append(full(logits)[:, -1].float())
            toks.append(outs[-1].argmax(-1))
        ev[1].record()
        torch.cuda.synchronize()
    return {"tokens": torch.stack(toks, 1).cpu().numpy(),
            "logits": [o.cpu() for o in outs],
            "decode_ms": ev[0].elapsed_time(ev[1]) / steps,
            "peak_bytes": torch.cuda.max_memory_allocated(), "cache": cache}


def serve_prompts(cfg, device="cuda"):
    import numpy as np
    import torch
    B, S, _ = SERVE_MESH
    return torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (B, S)), device=device)


def serve_mesh_1x1(cfg) -> dict:
    """``cfg`` (minicpm-2b at full width and depth, bf16 weights held for
    serving, seed 0) serving ``SERVE_MESH`` unsharded, then placed on a
    1×1 ("data", "model") mesh over a one-rank NCCL group and served
    again through the same ``prefill`` and ``decode``: both serves'
    tokens and logits, decode times and decode peaks."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as reg
    from repro_torch.runtime.sharding import place_model
    fns = reg.build(cfg, device="cuda")
    model = fns["init"](torch.Generator("cuda").manual_seed(0))
    prompts = serve_prompts(cfg)
    steps = SERVE_MESH[2]
    ref = greedy_serve(fns, model, prompts, steps)
    ref.pop("cache")
    torch.cuda.empty_cache()
    one_rank_nccl_group()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        place_model(cfg, model, mesh)
        got = greedy_serve(fns, model, prompts, steps, mesh=mesh)
        leaf = got.pop("cache")[0]["k"]
        got["cache"] = f"{type(leaf).__name__} {tuple(leaf.placements)}"
    finally:
        dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()
    return {"ref": ref, "mesh": got, "exact": all(
        torch.equal(a, b) for a, b in zip(ref["logits"], got["logits"]))}


def training_child(out: str) -> None:
    """Phase 17's work, in a process of its own: minicpm-2b at full width
    and depth trained ``TRAIN_STEPS`` steps through the CLI
    (``repro_torch.launch.train.main``: float32 masters, bf16 compute,
    remat "block", the token pipeline, AdamW at the CLI's defaults),
    then more steps timed and profiled, one step at a small constant lr
    on one batch, three compressed data-parallel steps in a one-rank
    NCCL group; a second run from the same seed; remat on and off and
    one or two microbatches at full width cut to ``TRAIN_CUT_LAYERS``
    layers; the ten smoke configs' train step on the card against the
    CPU; a smoke run cut and resumed on the card.  Writes its results to
    ``out`` (pickle)."""
    use_src()
    import pickle
    import torch
    from repro_torch.launch import train as cli
    from repro_torch.models import registry as reg
    full = reg.get_config(TRAIN_ARCH)
    res = {"params": reg.count_params(full), "layers": full.n_layers,
           "d_model": full.d_model, "vocab": full.vocab,
           "remat_mode": full.remat, "tied": full.tie_embeddings}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = cli.main(train_args())
    res["run_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    model = run["model"]
    res["master_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    res["masters_float32"] = all(p.dtype == torch.float32
                                 and p.requires_grad
                                 for p in model.parameters())
    res["losses"], res["grad_norms"] = run["losses"], run["grad_norms"]
    fns = reg.build(full, device="cuda", masters=True)
    res["times"] = train_step_times(full, fns, model, run["opt"])
    del run
    torch.cuda.empty_cache()
    res["one_step"] = one_step_lowers_the_loss(full, fns, model)
    torch.cuda.empty_cache()
    res["ddp"] = ddp_steps(full, fns, model)
    res["ddp_peak_bytes"] = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    again = cli_steps(full, TRAIN_AGAIN_STEPS)
    res["losses_again"] = again["losses"]
    del again
    torch.cuda.empty_cache()
    cut = {key: grads_of(full, *key) for key in (
        ("block", 1, "bfloat16"), ("none", 1, "bfloat16"),
        ("block", 1, "float32"), ("block", 2, "float32"))}
    res["remat"] = (
        abs(cut["block", 1, "bfloat16"][0] - cut["none", 1, "bfloat16"][0]),
        max_grad_err(cut["none", 1, "bfloat16"][1],
                     cut["block", 1, "bfloat16"][1]))
    res["microbatches"] = (
        abs(cut["block", 2, "float32"][0] - cut["block", 1, "float32"][0]),
        max_grad_err(cut["block", 1, "float32"][1],
                     cut["block", 2, "float32"][1]))
    del cut
    res["card_vs_cpu"] = {arch: train_card_vs_cpu(arch)
                          for arch in reg.ARCHS}
    res["resume"] = resume_on_card()
    torch.cuda.empty_cache()
    res["mesh1"] = mesh_run_1x1(full)
    res["serve1"] = serve_mesh_1x1(reg.get_config(TRAIN_ARCH))
    with open(out, "wb") as f:
        pickle.dump(res, f)


def phase_training(card: str) -> dict:
    """Phase 17: training (the loss, autograd through remat, AdamW, the
    loop with its checkpoints and the compressed data-parallel step are
    PyTorch ops, as they are ``jnp`` in the JAX package; no kernel of the
    miner), in a spawned process, timed out and killed after
    ``TRAIN_TIMEOUT`` seconds."""
    import math
    import torch
    torch.cuda.empty_cache()
    say(f"phase 17 training: the miner's process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    res, secs = run_child("phase 17", training_child, TRAIN_TIMEOUT)
    B, S = TRAIN_BATCH
    check(res["params"] == TRAIN_PARAMS,
          f"phase 17: {res['params']} parameters, repro has {TRAIN_PARAMS}")
    check(res["masters_float32"], "phase 17: the masters are not float32 "
                                  "parameters that take gradients")
    losses, gnorms = res["losses"], res["grad_norms"]
    ln_v = math.log(res["vocab"])
    check(len(losses) == TRAIN_STEPS and abs(losses[0] - ln_v) <= 0.5,
          f"phase 17: step-0 loss {losses[0]} not within 0.5 of ln V "
          f"{ln_v:.3f}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"phase 17: losses {losses}, grad norms {gnorms}")
    say(f"phase 17 training {TRAIN_ARCH} full width and depth "
        f"({res['layers']} layers, d {res['d_model']}, vocab "
        f"{res['vocab']}, tied {res['tied']}, remat {res['remat_mode']!r}; "
        f"{card}): {res['params']} parameters, float32 masters "
        f"{res['master_bytes']} bytes, bf16 compute; {TRAIN_STEPS} steps "
        f"of {B} x {S} tokens through repro_torch.launch.train (AdamW lr "
        f"3e-3 cosine, warmup 1) in {res['run_s']:.2f}s; peak "
        f"{res['peak_bytes'] / 1e9:.2f} GB")
    say(f"phase 17 losses {[round(x, 4) for x in losses]} (ln V = "
        f"{ln_v:.3f}); grad norms {[round(x, 3) for x in gnorms]}")
    again = res["losses_again"]
    dl = max(abs(a - b) / abs(a) for a, b in zip(losses, again))
    check(len(again) == TRAIN_AGAIN_STEPS and dl <= 1e-6,
          f"phase 17: two runs from seed 0 differ by {dl}: {losses} / "
          f"{again}")
    say(f"phase 17 the same seed again (its first {TRAIN_AGAIN_STEPS} "
        f"steps through train_loop, the CLI's config): losses within "
        f"{dl:.3g} relative (tolerance 1e-6)")
    t = res["times"]
    fb, up = statistics.median(t["fwd_bwd_ms"]), statistics.median(
        t["adamw_ms"])
    say(f"phase 17 step time ({card}; CUDA events, median of "
        f"{len(t['fwd_bwd_ms'])} steps after the run): forward + backward "
        f"{fb:.3f} ms (each {[round(x, 3) for x in t['fwd_bwd_ms']]}), "
        f"AdamW {up:.3f} ms (each {[round(x, 3) for x in t['adamw_ms']]}), "
        f"step {fb + up:.3f} ms; {B * S / ((fb + up) / 1e3):.0f} tokens/s; "
        f"reading and writing the masters, gradients and moments once "
        f"(28 bytes a parameter) takes "
        f"{res['params'] * 28 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    say(f"phase 17 one train step under torch.profiler ({card}): "
        f"{t['wall_ms']:.3f} ms on the host's clock, of which the device's "
        f"kernels {t['device_ms']:.3f} ms ({t['kernels']} kernels; busy "
        f"share {t['device_ms'] / t['wall_ms']:.3f})")
    before, after = res["one_step"]
    check(after < before, f"phase 17: one step at lr 1e-5 took the batch's "
                          f"loss from {before} to {after}")
    say(f"phase 17 one step at constant lr 1e-5 (fresh AdamW state) on one "
        f"batch: its loss {before:.6f} -> {after:.6f}")
    ddp = res["ddp"]
    check(len(ddp) == 3 and all(math.isfinite(x) for x in ddp),
          f"phase 17: compressed DDP losses {ddp}")
    say(f"phase 17 compressed DDP (int8 error feedback, one-rank NCCL group "
        f"on localhost) at full width: 3 steps, losses "
        f"{[round(x, 4) for x in ddp]}; peak {res['ddp_peak_bytes'] / 1e9:.2f}"
        f" GB with the residuals")
    dloss, derr = res["remat"]
    check(dloss <= 1e-6 and derr <= 1e-5,
          f"phase 17: remat on against off: loss {dloss}, grads {derr}")
    say(f"phase 17 remat: {TRAIN_ARCH} full width cut to {TRAIN_CUT_LAYERS} "
        f"layers, bf16: \"block\" against \"none\": loss |diff| {dloss:.3g}, "
        f"gradients max |diff| / max(1, max |g|) {derr:.3g} (tolerance 1e-5)")
    dloss, derr = res["microbatches"]
    check(dloss <= 1e-5 and derr <= 1e-5,
          f"phase 17: 2 microbatches against 1: loss {dloss}, grads {derr}")
    say(f"phase 17 microbatches: {TRAIN_ARCH} full width cut to "
        f"{TRAIN_CUT_LAYERS} layers, float32: 2 microbatches of 4 against 1 "
        f"of 8: loss |diff| {dloss:.3g}, gradients max |diff| / max(1, max "
        f"|g|) {derr:.3g} (tolerance 1e-5 each)")
    for arch, (el, eg, ep) in res["card_vs_cpu"].items():
        check(el <= 1e-5 and eg <= 1e-4 and ep <= 1e-4,
              f"phase 17: {arch} train step card against CPU: loss {el}, "
              f"grads {eg}, masters {ep}")
        say(f"phase 17 card = CPU: {arch} smoke config, float32, one train "
            f"step: loss {el:.3g} (tolerance 1e-5), gradients {eg:.3g}, "
            f"updated masters {ep:.3g} (tolerance 1e-4, relative to max(1, "
            f"max |x|))")
    want, got, n, diff = res["resume"]
    dl = max(abs(a - b) / abs(a) for a, b in zip(want, got))
    check(n == 6 and len(got) == 6 and dl <= 1e-6 and diff <= 1e-6,
          f"phase 17: resumed {n} steps, losses {got} against {want}, "
          f"masters differ by {diff}")
    say(f"phase 17 resume: {TRAIN_ARCH} smoke config on the card, cut at "
        f"step 6 and resumed from its checkpoint: steps 6-11 losses within "
        f"{dl:.3g} relative and final masters within {diff:.3g} of the uncut "
        f"run's (tolerance 1e-6 each)")
    m1 = res["mesh1"]
    dl = max(abs(a - b) / abs(a)
             for a, b in zip(losses[:MESH1_STEPS], m1["losses"]))
    check(len(m1["losses"]) == MESH1_STEPS and dl <= 1e-6,
          f"phase 17: the 1x1 mesh run's losses {m1['losses']} against the "
          f"CLI run's {losses[:MESH1_STEPS]}")
    say(f"phase 17 mesh 1x1 ({card}): {TRAIN_ARCH} at full width and depth "
        f"through train_loop(mesh=) on a 1x1 (data, model) mesh over a "
        f"one-rank NCCL group (degenerate: layers.0.attn.wq is {m1['wq']}): "
        f"{MESH1_STEPS} steps in {m1['seconds']:.2f}s with init, losses "
        f"{[round(x, 6) for x in m1['losses']]} = the CLI run's first "
        f"{MESH1_STEPS} within {dl:.3g} relative (tolerance 1e-6); peak "
        f"{m1['peak_bytes'] / 1e9:.2f} GB")
    s1 = res["serve1"]
    ref, got = s1["ref"], s1["mesh"]
    B, S, steps = SERVE_MESH
    check(s1["exact"] and (ref["tokens"] == got["tokens"]).all(),
          f"phase 17: the 1x1 mesh serve differs from the unsharded one: "
          f"tokens {got['tokens'][0]} / {ref['tokens'][0]}")
    say(f"phase 17 serving on the 1x1 mesh ({card}): {TRAIN_ARCH} at full "
        f"width and depth, bf16 weights held for serving, {B} requests x "
        f"{S} prompt + {steps} decoded tokens through prefill/decode "
        f"under active_mesh (caches {got['cache']}): tokens and every "
        f"step's logits bit for bit the unsharded serve's; decode "
        f"{got['decode_ms']:.3f} ms/token on the mesh, "
        f"{ref['decode_ms']:.3f} unsharded (CUDA events); decode peak "
        f"{got['peak_bytes']} bytes on the mesh, {ref['peak_bytes']} "
        f"unsharded; req 0 -> {got['tokens'][0].tolist()}")
    say(f"phase 17 training: {secs:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 18: FSDP + tensor parallelism on a 2x2 mesh
# ---------------------------------------------------------------------------

def mesh_cfg():
    import dataclasses
    from repro_torch.models import registry as reg
    return dataclasses.replace(reg.get_config(TRAIN_ARCH),
                               n_layers=MESH_LAYERS, dtype="float32")


def mesh_train(cfg, mesh=None) -> dict:
    """``MESH_STEPS`` steps of ``cfg`` through ``train_loop`` from seed 0
    (phase 17's pipeline; AdamW at the CLI's weight decay and clip, at a
    constant lr ``MESH_LR``: its first step moves every weight by about
    lr whatever the gradient's size, so a gradient that float32 rounding
    flips moves a master by a fraction of lr), on ``mesh`` or unsharded
    on cuda:0: the losses, the gradient norms, each step's seconds and
    the model, whose ``.grad``s hold the last step's clipped
    gradients."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry as reg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    B, S = TRAIN_BATCH
    stamps = []

    def stamp(step):             # called as each step starts
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return {}

    out = train_loop(
        cfg, reg.build(cfg, device="cuda", masters=True),
        TrainLoopConfig(steps=MESH_STEPS, seed=0, log_every=1000),
        AdamWConfig(lr=MESH_LR, schedule="constant", warmup_steps=0),
        TokenPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0),
        device=None if mesh is not None else "cuda", mesh=mesh,
        extra_batch=stamp)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "model": out["model"],
            "step_s": [b - a for a, b in zip(stamps, stamps[1:])]}


def mesh_rank(rank: int, world: int, backend: str, store: str, runs,
              out: str, group_timeout: float) -> None:
    """A rank of phase 18: joins a ``world``-rank gloo group on cuda:0,
    trains ``mesh_cfg()`` on the ``MESH_SHAPE`` ("data", "model") mesh
    through ``train_loop(mesh=)`` (DTensor's collectives routed through
    c10d), then the same steps unsharded, and writes its local master
    bytes (and the bytes the specs imply), its peak, the placements of
    one unit's ``wq``, ``w_up`` and the tied embedding, each step's
    seconds, both runs' losses and gradient norms, and how far its
    shards of the last step's clipped gradients (relative to each
    tensor's largest unsharded gradient) and of the final masters (in
    units of lr) are from the same blocks of the unsharded run's (each
    rank checks its own, so nothing is gathered)."""
    use_src()
    import datetime
    import math
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import c10d_collectives, make_mesh
    from repro_torch.runtime import sharding as sh
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=group_timeout))
    try:
        with c10d_collectives():
            cfg = mesh_cfg()
            mesh = make_mesh(MESH_SHAPE, ("data", "model"), device="cuda")
            torch.cuda.reset_peak_memory_stats()
            run = mesh_train(cfg, mesh)
            model = run["model"]
            named = dict(model.named_parameters())
            specs = sh.param_specs(cfg, model, mesh)
            axes = sh.mesh_axes(mesh)
            res = {"losses": run["losses"], "grad_norms": run["grad_norms"],
                   "step_s": run["step_s"],
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "local_bytes": sum(p.to_local().numel() * 4
                                      for p in named.values()),
                   "spec_bytes": sum(
                       p.numel() * 4 // math.prod(
                           axes[a] for e in specs[n] if e is not None
                           for a in ((e,) if isinstance(e, str) else e))
                       for n, p in named.items()),
                   "placements": {n: (str(specs[n]),
                                      str(tuple(named[n].placements)),
                                      tuple(named[n].to_local().shape))
                                  for n in ("layers.0.attn.wq",
                                            "layers.0.mlp.w_up", "embed")}}
            del run
            ref = mesh_train(cfg)
            res["ref_losses"], res["ref_step_s"] = ref["losses"], ref["step_s"]
            res["ref_grad_norms"] = ref["grad_norms"]
            res["grad_err"], res["master_err"], res["no_grad"] = 0.0, 0.0, []
            for n, a in ref["model"].named_parameters():
                p = named[n]

                def block(t):        # this rank's block of an unsharded tensor
                    return distribute_tensor(t.detach(), mesh, p.placements,
                                             src_data_rank=None).to_local()
                if a.grad is None or p.grad is None:
                    res["no_grad"].append(n)
                    continue
                err = float((block(a.grad) - p.grad.to_local()).abs().max())
                scale = float(a.grad.abs().max())
                res["grad_err"] = max(res["grad_err"], err / scale if scale
                                      else 0.0 if err == 0 else math.inf)
                res["master_err"] = max(res["master_err"], float(
                    (block(a) - p.to_local().detach()).abs().max()) / MESH_LR)
            del ref, model, named
            res["serve"] = mesh_serves(cfg, mesh)
            with open(out, "wb") as f:
                pickle.dump(res, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_serves(cfg, mesh) -> dict:
    """``cfg`` (float32 weights from seed 0) serving ``SERVE_MESH``'s
    prompts and ``MESH_SERVE_STEPS`` decoded tokens unsharded on this
    rank, then on ``mesh`` with its weights placed by
    their FSDP specs and by their compute specs (tensor parallel only,
    replicated over "data"): each serve's largest logit error against
    the unsharded one (relative to max(1, max |logit|)), whether its
    tokens are the same, its decode ms a token, and this rank's local
    cache bytes beside the share ``cache_specs`` gives it."""
    import math
    import torch
    from repro_torch.models import registry as reg
    from repro_torch.runtime import sharding as sh
    fns = reg.build(cfg, device="cuda")
    prompts = serve_prompts(cfg)
    steps = MESH_SERVE_STEPS
    ref = greedy_serve(fns, fns["init"](torch.Generator(
        "cuda").manual_seed(0)), prompts, steps)
    axes = sh.mesh_axes(mesh)
    out = {"ref_ms": ref["decode_ms"]}
    for weights in ("fsdp", "data_replicated"):
        model = fns["init"](torch.Generator("cuda").manual_seed(0))
        sh.place_model(cfg, model, mesh,
                       data_replicated=weights == "data_replicated")
        got = greedy_serve(fns, model, prompts, steps, mesh=mesh)
        caches = [c for c in got["cache"] if c is not None]
        specs = sh.cache_specs(cfg, mesh, caches)
        out[weights] = {
            "err": max(float((a - b).abs().max()) / max(
                1.0, float(a.abs().max()))
                for a, b in zip(ref["logits"], got["logits"])),
            "tokens": bool((ref["tokens"] == got["tokens"]).all()),
            "decode_ms": got["decode_ms"],
            "cache_bytes": sum(v.to_local().numel() * v.element_size()
                               for c in caches for v in c.values()),
            "spec_bytes": sum(
                v.numel() * v.element_size() // math.prod(
                    axes[a] for e in sp[k] if e is not None
                    for a in ((e,) if isinstance(e, str) else e))
                for c, sp in zip(caches, specs) for k, v in c.items()),
            "cache_placements": {k: str(tuple(v.placements))
                                 for k, v in caches[0].items()}}
        del model, got
    return out


def phase_mesh(card: str) -> None:
    """Phase 18: FSDP + tensor parallelism over a 2×2 ("data", "model")
    mesh of 4 gloo ranks on cuda:0 (NCCL refuses several ranks on one
    card): minicpm-2b at full width cut to ``MESH_LAYERS`` layers, float32,
    ``MESH_STEPS`` steps of 8 × 64 tokens through ``train_loop(mesh=)``
    at lr ``MESH_LR``, held against the same steps unsharded on every
    rank: losses and gradient norms 1e-5 relative; each rank's shards
    of the last step's clipped gradients 1e-4 of the tensor's largest
    unsharded gradient (the sharded backward and the gradients'
    redistribution); its final master shards within lr / 2 (the
    owned-block norm and AdamW on local shards: an update left out or
    of the wrong sign is lr or 2 lr away; both runs start from the same
    masters).  Gloo stages every gather and reduce-scatter through host
    memory, so the step time is a correctness check's, not a speed."""
    B, S = TRAIN_BATCH
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    results = spawn_ranks("phase18", world, "gloo", None, MESH_TIMEOUT,
                          target=mesh_rank)
    secs = time.perf_counter() - t0
    r0 = results[0]
    losses, ref = r0["losses"], r0["ref_losses"]
    norms, ref_norms = r0["grad_norms"], r0["ref_grad_norms"]
    dl = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    dn = max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms))
    gerr = max(r["grad_err"] for r in results)
    err = max(r["master_err"] for r in results)
    seen = [(r["losses"], r["ref_losses"], r["grad_norms"]) for r in results]
    check(all(x == seen[0] for x in seen),
          f"phase 18: the ranks' losses or norms differ: {seen}")
    check(not any(r["no_grad"] for r in results),
          f"phase 18: no gradient for {[r['no_grad'] for r in results]}")
    check(len(losses) == MESH_STEPS and dl <= 1e-5 and dn <= 1e-5
          and gerr <= 1e-4 and err <= 0.5,
          f"phase 18: 2x2 mesh losses {losses} against unsharded {ref}, "
          f"gradient norms {norms} against {ref_norms}, gradients "
          f"{[r['grad_err'] for r in results]}, masters (in lr) "
          f"{[r['master_err'] for r in results]}")
    say(f"phase 18 mesh ({card}): {TRAIN_ARCH} at full width cut to "
        f"{MESH_LAYERS} layers, float32, on a {MESH_SHAPE[0]}x{MESH_SHAPE[1]}"
        f" (data, model) mesh of {world} gloo ranks on cuda:0: "
        f"{MESH_STEPS} steps of {B} x {S} tokens through "
        f"train_loop(mesh=), losses {[round(x, 6) for x in losses]} = "
        f"unsharded {[round(x, 6) for x in ref]} within {dl:.3g} relative "
        f"(tolerance 1e-5), gradient norms {[round(x, 6) for x in norms]} "
        f"within {dn:.3g} (tolerance 1e-5), every rank's clipped gradient "
        f"shards within {gerr:.3g} of the tensor's largest unsharded "
        f"gradient (tolerance 1e-4) and final master shards within "
        f"{err:.3g} lr of the unsharded masters' blocks (tolerance 0.5 "
        f"lr, lr {MESH_LR})")
    for name, (spec, pl, shape) in r0["placements"].items():
        say(f"phase 18 {name}: spec {spec} -> placements {pl}, local "
            f"shape {shape}")
    say(f"phase 18 embed: vocab {mesh_cfg().vocab} is odd, so _fit drops "
        f"'model' from its spec and only d_model is sharded (over data)")
    for r, res in enumerate(results):
        check(res["local_bytes"] == res["spec_bytes"],
              f"phase 18 rank {r}: local masters {res['local_bytes']} bytes,"
              f" the specs imply {res['spec_bytes']}")
        say(f"phase 18 rank {r}: local float32 masters {res['local_bytes']} "
            f"bytes (= the specs' share), peak "
            f"{res['peak_bytes'] / 1e9:.2f} GB, step seconds "
            f"{[round(x, 2) for x in res['step_s']]}")
    say(f"phase 18 unsharded (rank 0): step seconds "
        f"{[round(x, 2) for x in r0['ref_step_s']]}; the mesh's step time "
        f"is gloo staging every collective through host memory: a "
        f"correctness check, not a speed")
    B, S, _ = SERVE_MESH
    steps = MESH_SERVE_STEPS
    for weights in ("fsdp", "data_replicated"):
        errs = [r["serve"][weights]["err"] for r in results]
        check(max(errs) <= 1e-5
              and all(r["serve"][weights]["tokens"] for r in results),
              f"phase 18: serving on the mesh ({weights} weights): logit "
              f"errors {errs}, tokens "
              f"{[r['serve'][weights]['tokens'] for r in results]}")
        for r, res in enumerate(results):
            sv = res["serve"][weights]
            check(sv["cache_bytes"] == sv["spec_bytes"],
                  f"phase 18 rank {r}: local cache {sv['cache_bytes']} "
                  f"bytes, cache_specs give {sv['spec_bytes']}")
        sv = r0["serve"][weights]
        say(f"phase 18 serving on the mesh ({card}; {weights} weights): "
            f"{TRAIN_ARCH} at full width cut to {MESH_LAYERS} layers, "
            f"float32, {B} requests x {S} prompt + {steps} decoded tokens "
            f"on every rank: logits within {max(errs):.3g} of the "
            f"unsharded serve's (tolerance 1e-5), tokens identical; each "
            f"rank's caches {sv['cache_bytes']} bytes = cache_specs' share "
            f"(placed {sv['cache_placements']}); decode "
            f"{sv['decode_ms']:.1f} ms/token (unsharded "
            f"{r0['serve']['ref_ms']:.2f}; gloo)")
    say(f"phase 18 mesh: {secs:.1f}s")


# ---------------------------------------------------------------------------
# phase 19: dry run and roofline
# ---------------------------------------------------------------------------

SERVED = (4, 24)        # phase 17's served shape: batch, cache positions


def dryrun_child(out: str) -> None:
    """Phase 19's CPU work, in a process of its own beside phases 12-18:
    ``launch.dryrun`` for minicpm-2b ``decode_32k`` on the production
    (16×16) mesh at full width and depth (rank 0 of a fake group of 256),
    ``launch.dryrun_mining`` single / reduce_scatter, and the dry run of
    phase 17's served shape (``SERVED``, chips 1, tp 1, the weights held
    as served)."""
    use_src()
    import pickle
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, dryrun_mining
    from repro_torch.models import registry as reg
    torch.set_num_threads(2)
    res = {}
    t0 = time.perf_counter()
    res["decode_32k"] = dryrun.run_cell(TRAIN_ARCH, "decode_32k", "single",
                                        str(DRYRUN_DIR))
    res["decode_32k_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["mining"] = dryrun_mining.run("single", str(DRYRUN_DIR),
                                      reduce="reduce_scatter")
    res["mining_s"] = time.perf_counter() - t0
    B, S = SERVED
    res["served"] = dryrun.run_cell(
        TRAIN_ARCH, "served", "single", str(DRYRUN_DIR),
        cfg=reg.get_config(TRAIN_ARCH),
        shape=ShapeConfig("served", S, B, "decode"), mesh_shape=(1, 1),
        masters=False)
    with open(out, "wb") as f:
        pickle.dump(res, f)


def start_dryrun():
    import multiprocessing
    RANK_DIR.mkdir(parents=True, exist_ok=True)
    out = RANK_DIR / "phase19.pkl"
    out.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(
        target=dryrun_child, args=(str(out),))
    proc.start()
    return proc, out, time.perf_counter()


def support_round_on_card(cell: dict) -> dict:
    """The mining dry run's support round at its per-rank shapes (PP =
    parts per rank), run for real on the card from seeded inputs: the
    map phase with the two-launch kernels B3 + B4 (``backend="pallas"``)
    against the plain join (``"ref"``), exact, the kernels' ms a round
    (CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import device_local_supports
    from repro_torch.launch.dryrun_mining import random_meta, random_stores
    shapes = cell["shapes"]
    PP = cell["parts_per_dev"]
    P, G, M, K, T, F, C = (shapes[k] for k in "PGMKTFC")
    meta = random_meta(np.random.default_rng(0), C, P, K, T)
    stores = [torch.as_tensor(a, device="cuda") for a in random_stores(
        np.random.default_rng(19), PP, P, G, M, K, T, F)]
    before = launch_counts()
    reset_launch_counts()
    got = device_local_supports(meta, *stores, backend="pallas")
    torch.cuda.synchronize()
    launches = launch_counts()
    want = device_local_supports(meta, *stores, backend="ref")
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms = time_ms(lambda: device_local_supports(meta, *stores,
                                               backend="pallas"),
                 runs=5, batch=3)
    restore_launch_counts(before)
    return {"err": err, "ms": ms, "launches": launches,
            "frequent": int((want[0] >= 100).sum()),
            "max_support": int(want[0].max()), "PP": PP}


def phase_dryrun(card: str, child, res17: dict) -> None:
    """Phase 19: the dry run and the roofline.  (a) the production decode
    cell and (b) the mining support round, from the child started with
    phase 12; (c) that round at its per-rank shapes on the card, B3 + B4
    against the plain join, beside the analytic memory bound; (d) phase
    17's decode on the 1×1 mesh beside ``analyze``'s bound for the
    served shape; (e) the dry run's predicted peak for that serve beside
    its measured peak."""
    import pickle
    proc, out, t0 = child
    proc.join(CLOCK.clip("phase 19", DRYRUN_TIMEOUT))
    if proc.is_alive():
        proc.kill()
        proc.join(30)
        check(False, "phase 19: the dry runs still running")
    check(proc.exitcode == 0, f"phase 19: dry runs exit code {proc.exitcode}")
    with open(out, "rb") as f:
        dry = pickle.load(f)
    say(f"phase 19 dry runs: ready {time.perf_counter() - t0:.1f}s after "
        f"they started (decode_32k {dry['decode_32k_s']:.1f}s, mining "
        f"{dry['mining_s']:.1f}s, on the host's CPU beside phases 12-18)")
    d = dry["decode_32k"]
    check(d["status"] == "ok" and d["flops"] > 0 and d["argument_bytes"] > 0,
          f"phase 19: decode_32k dry run {d.get('status')}")
    say(f"[dryrun] {d['arch']} decode_32k single: "
        f"args={d['argument_bytes'] / 2**30:.2f}GiB "
        f"temp={d['temp_bytes'] / 2**30:.2f}GiB "
        f"flops/dev={d['flops']:.3e} bottleneck={d['bottleneck']}")
    say(f"phase 19 (a) {d['arch']} decode_32k on the (16, 16) mesh, rank 0 "
        f"of 256 (H100 peaks at 700 W; this card {card}): t_compute "
        f"{d['t_compute']:.6f}s, t_memory {d['t_memory']:.6f}s, "
        f"t_collective {d['t_collective']:.6f}s, bound {d['bottleneck']}; "
        f"model FLOPs/chip {d['model_flops_per_chip']:.4e}, useful "
        f"{d['useful_ratio']:.4f}, roofline fraction "
        f"{d['roofline_fraction']:.6f}; collectives {d['collectives']}")
    m = dry["mining"]
    sup = m["support"]
    check(sup["collectives"] == {"reduce-scatter": 1, "all-gather": 1},
          f"phase 19: the mining support round's collectives "
          f"{sup['collectives']}")
    say(f"phase 19 (b) mining single reduce_scatter, shapes {m['shapes']}: "
        f"support t_compute {sup['t_compute']:.3g}s, t_memory "
        f"{sup['t_memory']:.6f}s, t_collective {sup['t_collective']:.3g}s, "
        f"bound {sup['bottleneck']}, wire {sup['wire_bytes']:.0f} B, "
        f"collectives {sup['collectives']}; materialize t_memory "
        f"{m['materialize']['t_memory']:.6f}s, collectives "
        f"{m['materialize']['collectives']}")
    rnd = support_round_on_card(m)
    check(rnd["err"] == 0, f"phase 19: B3 + B4 against the plain join at "
                           f"the dry run's shapes, max abs err {rnd['err']}")
    check(rnd["launches"]["embedding_join"] == 1
          and rnd["launches"]["support_count"] == 1,
          f"phase 19: launches {rnd['launches']}")
    say(f"phase 19 (c) ({card}): the support round's map phase at the dry "
        f"run's per-rank shapes (PP {rnd['PP']}, P {m['shapes']['P']}, C "
        f"{m['shapes']['C']}, G {m['shapes']['G']}, M {m['shapes']['M']}, "
        f"K {m['shapes']['K']}, T {m['shapes']['T']}, F "
        f"{m['shapes']['F']}; seeded inputs) with B3 + B4: equal to the "
        f"plain join (max abs err 0), {rnd['ms']:.4f} ms a round (median "
        f"of 5 batches of 3) beside the analytic t_memory "
        f"{sup['t_memory'] * 1e3:.4f} ms; largest support "
        f"{rnd['max_support']}")
    s = dry["served"]
    mesh = res17["serve1"]["mesh"]
    bound_ms = max(s["t_compute"], s["t_memory"], s["t_collective"]) * 1e3
    say(f"phase 19 (d) ({card}): phase 17's decode on the 1x1 mesh "
        f"{mesh['decode_ms']:.3f} ms/token beside analyze's bound for "
        f"(B {SERVED[0]}, S {SERVED[1]}, chips 1, tp 1) {bound_ms:.3f} ms "
        f"(t_compute {s['t_compute'] * 1e3:.4f}, t_memory "
        f"{s['t_memory'] * 1e3:.4f}, bound {s['bottleneck']}; "
        f"{bound_ms / mesh['decode_ms']:.3f} of the roofline)")
    predicted = s["argument_bytes"] + s["temp_bytes"]
    say(f"phase 19 (e) ({card}): the dry run's predicted decode peak for "
        f"that serve {predicted} bytes (arguments {s['argument_bytes']} + "
        f"temp {s['temp_bytes']}) beside max_memory_allocated over its "
        f"decode on the card {mesh['peak_bytes']} "
        f"({mesh['peak_bytes'] / predicted:.4f} of the prediction)")


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
    use_src()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    global CLOCK
    CLOCK = RunClock()
    phase = CLOCK.phase
    # the host oracle of the two main runs, each in a process of its own
    # beside the card's work (they take minutes of host time)
    pool = ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    dry = None
    try:
        with phase("phase 1"):
            oracle_c2 = pool.submit(oracle, C2_DB, C2_MINSUP, C2_MAX_SIZE)
            db40 = pool.submit(generate_db, 40_000, 0)
            oracle40 = pool.submit(oracle, MAIN40_DB, main_minsup(40_000),
                                   MAIN_CFG["max_size"])
            oracle80 = pool.submit(oracle, MAIN80_DB, main_minsup(80_000),
                                   MAIN_CFG["max_size"])
            db80 = pool.submit(generate_db, 80_000, 1)
            card = phase_device()
        with phase("phase 2"):
            phase_parity_small()
        with phase("phase 3"):
            phase_small()
            phase_many_triples(oracle_c2)
        # every fit of one DB shares the first fit's host prep
        with prep_memo():
            with phase("phase 4"):
                graphs40 = make_db("4 packed", db40)
                res4, launches4, secs4, want40, peak4 = main_run(
                    "4 packed", graphs40, True, oracle40)
                check(launches4["fused_level_packed"] > 0,
                      "the packed kernel never launched on the main path")
                torch.cuda.empty_cache()
            with phase("phase 11"):
                phase_device_loop(graphs40, want40, (res4, secs4, peak4),
                                  card)
                del res4
                torch.cuda.empty_cache()
            with phase("phase 4"):
                args4 = level2_inputs(graphs40, "fused_level_packed")
                rec_packed = kernel_record(
                    "fused_level_packed", args4, True,
                    launches4["fused_level_packed"])
                del args4
                torch.cuda.empty_cache()
                args4, kw4 = level3_pass2_inputs(graphs40)
                rec_mat = materialize_record(
                    args4, kw4, launches4["materialize_level"])
                del args4, kw4
                torch.cuda.empty_cache()
            with phase("phase 6"):
                res6, launches6, _, _, _ = main_run(
                    "6 two-launch", graphs40, True, want40,
                    backend="pallas")
                n6 = len(res6.stats)
                check(launches6["embedding_join"]
                      == launches6["support_count"] == n6,
                      f"the two-launch kernels launched {launches6} times "
                      f"on phase 6's {n6} levels (1 each per level)")
                check(launches6["fused_level_packed"]
                      == launches6["fused_level"] == 0,
                      "a fused kernel ran on the two-launch path")
                args6 = level2_inputs(graphs40, "embedding_join",
                                      backend="pallas")
                recs_two = two_launch_records(args6, launches6)
                del args6
                torch.cuda.empty_cache()
            with phase("phase 7"):
                _, launches7, _, _, _ = main_run(
                    "7 legacy", graphs40, False, want40, pipeline="legacy",
                    backend="pallas")
                check(launches7["embedding_join"] > 0
                      and launches7["support_count"] > 0,
                      "the two-launch kernels never launched on the legacy "
                      "path")
                torch.cuda.empty_cache()
            with phase("phase 10"):
                phase_supervised(graphs40, want40)
                del graphs40
                torch.cuda.empty_cache()
        with prep_memo():
            with phase("phase 8"):
                # the 80K DB's host prep beside phase 8's ranks
                graphs80 = make_db("5 dense", db80)
                prep80 = PrepBeside(graphs80)
                phase_multiworker_small()
                phase_multiworker_shrink()
                phase_multiworker_main(want40)
            with phase("phase 5"):
                t = time.perf_counter()
                prep80.join()
                say(f"phase 5 dense: its host prep, made beside phase 8, "
                    f"was ready {time.perf_counter() - t:.1f}s after it")
                _, launches5, _, _, _ = main_run("5 dense", graphs80,
                                                 False, oracle80)
                check(launches5["fused_level"] > 0,
                      "the dense kernel never launched on the main path")
                args5 = level2_inputs(graphs80, "fused_level")
                rec_dense = kernel_record("fused_level", args5, False,
                                          launches5["fused_level"])
                del args5, graphs80
                torch.cuda.empty_cache()
        with phase("phase 9"):
            phase_nccl()
        with phase("phase 12"):
            dry = start_dryrun()        # phase 19's CPU work, beside these
            phase_examples()
        with phase("phase 13"):
            phase_serving(card)
        with phase("phase 14"):
            phase_serving_moe(card)
        with phase("phase 15"):
            phase_serving_ssm(card)
        with phase("phase 16"):
            phase_serving_encdec_vlm(card)
        with phase("phase 17"):
            res17 = phase_training(card)
        with phase("phase 18"):
            phase_mesh(card)
        with phase("phase 19"):
            phase_dryrun(card, dry, res17)
    except SmokeFailure as exc:
        # on both streams: a caller that keeps only the end of standard
        # error still sees which phase failed and when
        for out in (sys.stdout, sys.stderr):
            print(f"[chip_smoke] FAIL: {exc}\n[chip_smoke] phase seconds "
                  f"so far (run {CLOCK.used():.1f} s): "
                  f"{json.dumps(CLOCK.seconds)}", file=out, flush=True)
        return 1
    finally:
        pool.shutdown(cancel_futures=True)
        if dry is not None and dry[0].is_alive():
            dry[0].kill()
            dry[0].join(30)
    say(f"every phase passed in {CLOCK.used():.1f}s")
    print(json.dumps({"phase_seconds": CLOCK.seconds}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [rec_packed, rec_dense, *recs_two,
                                  rec_mat]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
