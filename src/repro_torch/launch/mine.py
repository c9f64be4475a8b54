"""Mining launcher of the PyTorch port (single-sync, device-loop or
legacy pipeline, one device).

    python -m repro_torch.launch.mine --dataset pubchem-like \
        --n-graphs 40000 --avg-edges 28 --minsup 0.15 --partitions 8 \
        --max-size 4
    python -m repro_torch.launch.mine --dataset paper-toy --minsup 2 \
        --partitions 2 --pipeline legacy --backend pallas --device cpu
    python -m repro_torch.launch.mine --dataset pubchem-like \
        --n-graphs 10 --minsup 4 --partitions 2 --max-size 5 --seed 5 \
        --device cpu --fault-schedule 'kernel_fault@3*2;wire_bitflip@4' \
        --fault-log faults.jsonl
    python -m repro_torch.launch.mine --dataset paper-toy --minsup 2 \
        --partitions 2 --max-size 4 --pipeline device_loop --device cpu

Runs on the CUDA device by default; ``--device cpu`` runs the plain
PyTorch versions of the kernels instead.  Any of ``--fault-schedule``,
``--fault-log``, ``--deadline`` or ``--partial-ok`` mines under the
recovery supervisor (``core/supervisor.py``); a verified partial result
exits 0 with a ``PARTIAL RESULT`` line.  A malformed input database
exits 2 with a one-line diagnosis (graph id + edge index).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="pubchem-like",
                    choices=["pubchem-like", "synthetic", "paper-toy"])
    ap.add_argument("--n-graphs", type=int, default=100)
    ap.add_argument("--avg-edges", type=float, default=12.0)
    ap.add_argument("--minsup", type=float, default=0.2,
                    help="fraction (0,1) or absolute count (>=1)")
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--scheme", default="2", choices=["1", "2", "density"],
                    help="partition scheme: 1 = graph count, 2 = LPT by "
                         "edges, density = snake-deal by edge density")
    ap.add_argument("--max-size", type=int, default=None)
    ap.add_argument("--max-embeddings", type=int, default=32)
    ap.add_argument("--reduce", default=None,
                    choices=["psum", "reduce_scatter"],
                    help="shuffle collective (default: reduce_scatter for "
                         "single_sync, psum for legacy)")
    ap.add_argument("--pipeline", default="single_sync",
                    choices=["single_sync", "device_loop", "legacy"],
                    help="single_sync: one device program and one host "
                         "transfer per level; device_loop: the ENTIRE "
                         "run queued on the device with a single "
                         "device->host transfer (needs --max-size); "
                         "legacy: the two-program pipeline (the "
                         "differential oracle)")
    ap.add_argument("--candgen", default="host",
                    choices=["host", "device"],
                    help="candidate generation for the per-level "
                         "pipelines: host python generator (default) or "
                         "the device generator (the device_loop "
                         "stepping stone)")
    ap.add_argument("--device-c-budget", type=int, default=None,
                    help="device_loop: canonical candidate budget per "
                         "level (default: auto-sized)")
    ap.add_argument("--device-raw-budget", type=int, default=None,
                    help="device_loop: structural slot budget before "
                         "canonicality (default: 4x the c-budget)")
    ap.add_argument("--device-max-states", type=int, default=64,
                    help="device canonicality machine state bound")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="device_loop: checkpoint-chunk cadence in "
                         "levels (default: no mid-run checkpoints — "
                         "exactly one transfer per run)")
    ap.add_argument("--unroll", type=int, default=0,
                    help="device_loop: >0 queues the run's level bodies "
                         "in calls of this many")
    ap.add_argument("--dense-wire", action="store_true",
                    help="disable the sharded wire layout")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable overlapped host candidate generation")
    ap.add_argument("--backend", default=None,
                    choices=["ref", "pallas", "fused", "fused_packed"],
                    help="kernels backend (default: fused on CUDA, ref on "
                         "the CPU; pallas = the two-launch kernels)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable shape bucketing")
    ap.add_argument("--bucket-floors", default=None, metavar="C,S,K",
                    help="bucket family floors for the candidate axis, "
                         "survivor cap and vertex slots (default 64,32,8)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--fault-schedule", default=None, metavar="SPEC",
                    help="chaos mode: inject a deterministic fault "
                         "schedule, e.g. 'worker_loss@2;wire_bitflip@3'"
                         " (see repro_torch.runtime.faults); mining runs "
                         "under the recovery supervisor")
    ap.add_argument("--max-retries", type=int, default=5,
                    help="supervisor recovery-attempt budget")
    ap.add_argument("--fault-log", default=None,
                    help="write the structured fault-event log (JSONL, "
                         "one line per event, crash-safe) here; implies "
                         "supervised mining")
    ap.add_argument("--deadline", type=float, default=None,
                    help="whole-run wall-clock budget in seconds; "
                         "implies supervised mining")
    ap.add_argument("--level-deadline", type=float, default=None,
                    help="fixed per-phase watchdog deadline in seconds "
                         "(default: self-calibrating EWMA policy)")
    ap.add_argument("--partial-ok", action="store_true",
                    help="on deadline/retry-budget exhaustion return a "
                         "verified PARTIAL RESULT (exit 0 + marker) "
                         "instead of raising; implies supervised mining")
    ap.add_argument("--no-audit", action="store_true",
                    help="disable the continuous invariant auditor "
                         "(device audit word + host spot checks)")
    ap.add_argument("--audit-report", default=None,
                    help="write the auditor's per-level report JSON here")
    args = ap.parse_args()

    from repro_torch.core.graphdb import (GraphValidationError, paper_toy_db,
                                          pubchem_like_db, random_db)
    from repro_torch.core.mining import Mirage, MirageConfig, PartialResult
    from repro_torch.core.supervisor import MiningSupervisor, SupervisorConfig
    from repro_torch.runtime import faults
    from repro_torch.runtime.watchdog import Watchdog

    if args.dataset == "paper-toy":
        graphs = paper_toy_db()
    elif args.dataset == "pubchem-like":
        graphs = pubchem_like_db(args.n_graphs, seed=args.seed,
                                 avg_edges=args.avg_edges)
    else:
        graphs = random_db(args.n_graphs, seed=args.seed)

    minsup = args.minsup if args.minsup < 1 else int(args.minsup)
    bucket_kw = {}
    if args.bucket_floors:
        c, s, k = (int(x) for x in args.bucket_floors.split(","))
        bucket_kw = dict(bucket_c_floor=c, bucket_s_floor=s,
                         bucket_k_floor=k)
    scheme = args.scheme if args.scheme == "density" else int(args.scheme)
    cfg = MirageConfig(
        minsup=minsup, n_partitions=args.partitions, scheme=scheme,
        max_size=args.max_size, max_embeddings=args.max_embeddings,
        reduce=args.reduce, backend=args.backend, pipeline=args.pipeline,
        sharded_wire=False if args.dense_wire else None,
        overlap_candgen=not args.no_overlap, candgen=args.candgen,
        device_c_budget=args.device_c_budget,
        device_raw_budget=args.device_raw_budget,
        device_max_states=args.device_max_states,
        device_loop_ckpt_every=args.ckpt_every,
        device_loop_unroll=args.unroll,
        checkpoint_dir=args.ckpt_dir,
        bucket_shapes=not args.no_bucket,
        audit=not args.no_audit, **bucket_kw)

    supervised = (args.fault_schedule or args.fault_log
                  or args.deadline is not None or args.partial_ok)
    if args.fault_schedule:
        schedule = faults.FaultSchedule.parse(args.fault_schedule)
        faults.install(schedule)
        print(f"[mine] chaos schedule: {schedule.describe()}")

    if args.fault_log:
        os.makedirs(os.path.dirname(args.fault_log) or ".", exist_ok=True)

    sup = None
    t0 = time.perf_counter()
    try:
        if supervised:
            watchdog = None
            if args.level_deadline is not None:
                watchdog = Watchdog(run_deadline_s=args.deadline,
                                    phase_default=args.level_deadline)
            sup = MiningSupervisor(
                cfg, SupervisorConfig(
                    max_retries=args.max_retries,
                    fault_log_path=args.fault_log,
                    deadline_s=args.deadline,
                    on_exhausted="partial" if args.partial_ok
                    else "raise"),
                watchdog=watchdog, device=args.device)
            res = sup.mine(graphs, resume=args.resume)
            miner = sup.last_miner
        else:
            miner = Mirage(cfg, device=args.device)
            res = miner.fit(graphs, resume=args.resume)
            if miner.last_device_loop is not None:
                info = miner.last_device_loop
                print(f"[mine] device_loop: completed={info['completed']} "
                      f"chunks={info['chunks']} "
                      f"escalations={info['escalations']}"
                      + (f" fallback={info['fallback']}"
                         if info["fallback"] else ""))
    except GraphValidationError as exc:
        # a malformed database is an input bug, not a crash: diagnose
        # (graph id + edge index) on stderr, no traceback
        print(f"[mine] invalid database: {exc}", file=sys.stderr)
        raise SystemExit(2)
    dt = time.perf_counter() - t0

    if sup is not None and sup.events:
        print(f"[mine] recovered from {len(sup.events)} fault(s):")
        for ev in sup.events:
            print(f"  attempt {ev.attempt}: {ev.kind} at level "
                  f"{ev.level} -> {ev.action} ({ev.detail})")
    if sup is not None and sup.watchdog and sup.watchdog.trips:
        for trip in sup.watchdog.trips:
            print(f"[mine] watchdog trip: level {trip['level']} "
                  f"exceeded {trip['deadline_s']:.2f}s phase deadline "
                  f"after {trip['elapsed_s']:.2f}s")

    partial = isinstance(res, PartialResult)
    if partial:
        print(f"[mine] PARTIAL RESULT ({res.reason}): verified prefix "
              f"through level {res.last_level}, audited={res.audited}")
    print(f"[mine] |G|={len(graphs)} minsup={res.minsup} "
          f"partitions={args.partitions} scheme={args.scheme} "
          f"pipeline={miner.cfg.pipeline} reduce={miner.cfg.reduce} "
          f"device={miner.device} backend={miner.backend}")
    print(f"[mine] frequent patterns: {sum(res.counts())} "
          f"(per level: {res.counts()})")
    if partial:
        print(f"[mine] wall: {dt:.2f}s")
    else:
        print(f"[mine] wall: {dt:.2f}s  overflow: {res.total_overflow}")
        for st in res.stats:
            print(f"  level {st.level}: candidates={st.n_candidates} "
                  f"frequent={st.n_frequent} {st.seconds:.2f}s "
                  f"(map {st.map_seconds:.2f}s) "
                  f"imbalance={st.imbalance:.2f}")
    if args.audit_report:
        report = (sup.audit_report if sup is not None
                  else (miner.auditor.report if miner.auditor else []))
        with open(args.audit_report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[mine] audit report ({len(report)} row(s)) -> "
              f"{args.audit_report}")
    if args.out:
        payload = {
            "n_graphs": len(graphs), "minsup": res.minsup,
            "counts": res.counts(), "seconds": dt,
            "levels": [[list(map(list, c)) for c in lvl]
                       for lvl in res.levels],
        }
        if partial:
            payload.update(partial=True, reason=res.reason,
                           last_level=res.last_level,
                           audited=res.audited)
        with open(args.out, "w") as f:
            json.dump(payload, f)


if __name__ == "__main__":
    main()
