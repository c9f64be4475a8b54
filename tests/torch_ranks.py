"""Run a script as the W ranks of a gloo process group on the CPU (the
port's multi-worker tests), or as the JAX package on W simulated
devices (its reference), each in fresh processes.

Every rank gets the group's collective timeout and the whole run a wall
timeout: a rank that raises leaves its peers blocked in a collective
only until the group times out, and a run past its wall timeout is
killed, so that a failing case fails instead of hanging the suite.
Each process writes ``repr`` of its ``RESULT`` dict (numpy values made
plain Python) to its own file; the caller reads it back with
``ast.literal_eval``.
"""
import ast
import os
import subprocess
import sys
import textwrap
import time

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# seconds a rank waits in one collective before its group gives up
GROUP_TIMEOUT = 60

_RANK_PROLOGUE = textwrap.dedent(f"""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ARGS = sys.argv[4:]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + OUT + "/store", rank=RANK,
        world_size=WORLD, timeout=datetime.timedelta(seconds={GROUP_TIMEOUT}))
    from repro_torch.core.mapreduce import MiningMesh
    MESH = MiningMesh.from_process_group(dist.group.WORLD, "cpu")
    RESULT = {{}}
""")

_PLAIN = textwrap.dedent("""
    def _plain(x):
        if isinstance(x, dict):
            return {_plain(k): _plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(_plain(v) for v in x)
        if isinstance(x, (np.ndarray, np.generic)):
            return x.tolist()
        return x
""")

_RANK_EPILOGUE = _PLAIN + textwrap.dedent("""
    with open(OUT + f"/rank{RANK}.txt", "w") as _f:
        _f.write(repr(_plain(RESULT)))
    dist.barrier()
    dist.destroy_process_group()
""")

_JAX_PROLOGUE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    OUT = sys.argv[1]
    ARGS = sys.argv[2:]
    RESULT = {}
""")

_JAX_EPILOGUE = _PLAIN + textwrap.dedent("""
    with open(OUT + "/jax.txt", "w") as _f:
        _f.write(repr(_plain(RESULT)))
""")


def _wait(procs, logs, timeout):
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(
            f"killed after {timeout}s:\n" + "\n".join(
                open(l).read()[-3000:] for l in logs))
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(
        f"process {i} exited {procs[i].returncode}:\n"
        f"{open(logs[i]).read()[-4000:]}" for i in bad)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def run(tmp_path, *, ranks=None, jax=None, args=(), timeout=300):
    """Start, side by side, ``ranks = (body, world)``: ``body`` as every
    rank of a ``world``-rank gloo group, and ``jax = (body, devices)``:
    ``body`` in one process of the JAX package on ``devices`` simulated
    CPU devices.  Returns ``(rank_results, jax_result)``: each rank's
    ``RESULT`` dict in rank order (None without ``ranks``) and the JAX
    process's (None without ``jax``).  A rank body sees ``RANK``,
    ``WORLD``, ``MESH`` (the port's mesh of the group, on the CPU); both
    see ``ARGS`` (``args`` as strings) and fill ``RESULT``."""
    out = tmp_path / f"run{len(list(tmp_path.glob('run*')))}"
    out.mkdir()
    procs, logs = [], []

    def start(script, argv, log, env):
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *map(str, argv)], stdout=f,
                stderr=subprocess.STDOUT, env=env))

    if jax is not None:
        body, devices = jax
        script = out / "jax_ref.py"
        script.write_text(_JAX_PROLOGUE + textwrap.dedent(body)
                          + _JAX_EPILOGUE)
        start(script, [out, *args], out / "jax_log.txt", _env(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}"))
    world = 0
    if ranks is not None:
        body, world = ranks
        script = out / "rank.py"
        script.write_text(_RANK_PROLOGUE + textwrap.dedent(body)
                          + _RANK_EPILOGUE)
        for r in range(world):
            start(script, [r, world, out, *args], out / f"log{r}.txt",
                  _env())
    _wait(procs, logs, timeout)
    read = lambda name: ast.literal_eval((out / name).read_text())
    return ([read(f"rank{r}.txt") for r in range(world)] if ranks else None,
            read("jax.txt") if jax else None)
