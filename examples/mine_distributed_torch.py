"""Distributed mining with a crash and a resume on the PyTorch port: W
workers, one ``torch.distributed`` rank each (started by
``torch.distributed.run``), mine one molecule-like DB into a checkpoint
directory.  Run 1 stops after level 2 (the "crash"); run 2 starts again,
resumes from the level-2 checkpoint and mines on to level 5 — the
paper's iterative HDFS handoff, end to end.  The resumed run's frequent
set must equal the host oracle ``mine_host``.

    PYTHONPATH=src python examples/mine_distributed_torch.py \\
        [--workers 8] [--device cuda|cpu]

On the card each rank takes a card of its own under NCCL.  With
``--device cpu``, or with more workers than cards, the ranks use gloo
(on the card, several ranks then share one).  Every rank's group gives
up a collective after ``--group-timeout`` seconds, so a rank that raises
ends its peers instead of hanging them, and each run is killed after
``--timeout`` seconds.
"""
import argparse
import ast
import datetime
import hashlib
import math
import os
import shutil
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DB = dict(n_graphs=64, seed=11, avg_edges=14)
MINSUP = 0.12


def frequent_digest(supports: dict) -> str:
    """SHA-256 of the sorted (code, support) pairs."""
    return hashlib.sha256(
        repr(sorted(supports.items())).encode()).hexdigest()


def child(args) -> None:
    """One rank: join the group torch.distributed.run set up, mine, and
    (rank 0) print the levels and the frequent set's digest."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.graphdb import pubchem_like_db
    from repro_torch.core.mapreduce import MiningMesh
    from repro_torch.core.mining import Mirage, MirageConfig

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    kw = {}
    if args.device == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available; "
                               "pass --device cpu to mine on the CPU")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(device)
        backend = "nccl" if world <= n_cards else "gloo"
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=args.group_timeout),
        **kw)
    try:
        mesh = MiningMesh.from_process_group(dist.group.WORLD, device)
        # one write per line: the ranks share the launcher's stdout
        print(f"rank {rank}/{world}: backend {backend}, device {device}\n",
              end="", flush=True)
        graphs = pubchem_like_db(DB["n_graphs"], seed=DB["seed"],
                                 avg_edges=DB["avg_edges"])
        cfg = MirageConfig(minsup=MINSUP, n_partitions=16, scheme=2,
                           reduce="reduce_scatter",
                           checkpoint_dir=args.ckpt_dir,
                           max_size=args.max_size)
        res = Mirage(cfg, mesh).fit(graphs, resume=True)
        if rank == 0:
            print(f"LEVELS: {res.counts()}\n"
                  f"FREQUENT: {frequent_digest(res.supports)}\n", end="",
                  flush=True)
    finally:
        dist.destroy_process_group()


def run(args, max_size: int) -> str:
    """Both halves of one run: W ranks under torch.distributed.run, in a
    session of their own that is killed whole after ``--timeout``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={args.workers}", os.path.abspath(__file__),
           "--child", "--device", args.device, "--ckpt-dir", args.ckpt_dir,
           "--max-size", str(max_size),
           "--group-timeout", str(args.group_timeout)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out)
        raise RuntimeError(f"run killed after {args.timeout}s")
    lines = [l for l in out.splitlines()
             if l.startswith(("rank ", "LEVELS:", "FREQUENT:"))]
    print("\n".join(lines))
    if proc.returncode != 0:
        print(out[-4000:])
        raise RuntimeError(f"run exited {proc.returncode}")
    return out


def _field(out: str, key: str) -> str:
    return [l for l in out.splitlines() if l.startswith(key)][-1][
        len(key):].strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "mine_distributed_ckpt"))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before a run is killed")
    ap.add_argument("--group-timeout", type=float, default=120.0,
                    help="seconds a rank waits in one collective")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--max-size", type=int, default=5,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return
    if 16 % args.workers:
        ap.error("--workers must divide the 16 partitions")
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available; "
                               "pass --device cpu to mine on the CPU")

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    print(f"=== run 1 on {args.workers} workers ({args.device}): mine to "
          f"level 2, then 'crash' (max_size=2) ===")
    out1 = run(args, max_size=2)
    print(f"checkpoints on disk: {sorted(os.listdir(args.ckpt_dir))}")

    print("=== run 2: restart; resumes from the level-2 checkpoint and "
          "continues mining ===")
    out2 = run(args, max_size=5)
    l1 = ast.literal_eval(_field(out1, "LEVELS:"))
    l2 = ast.literal_eval(_field(out2, "LEVELS:"))
    print(f"levels before crash: {l1}  -> after resume: {l2}")
    assert len(l2) > len(l1), "resume must continue past the crash"

    from repro_torch.core.graphdb import pubchem_like_db
    from repro_torch.core.host_miner import mine_host
    graphs = pubchem_like_db(DB["n_graphs"], seed=DB["seed"],
                             avg_edges=DB["avg_edges"])
    host = mine_host(graphs, math.ceil(MINSUP * len(graphs)), max_size=5)
    assert l2 == [len(l) for l in host.levels], (l2, host.levels)
    assert _field(out2, "FREQUENT:") == frequent_digest(
        {c: i.support for c, i in host.frequent.items()}), \
        "the resumed run's frequent set differs from mine_host"
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    print("resumed run equals mine_host; fault-injection resume OK")


if __name__ == "__main__":
    main()
