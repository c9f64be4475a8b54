#!/usr/bin/env python3
"""Time the port's four CUDA kernels against those of another checkout
(for example the parent commit) on one card, in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_parent.py build/parent

Run from the repository root on a machine with a CUDA card.  The other
checkout's ``repro_torch`` package is imported beside this one under
another name, so each side's kernels are called through that side's own
wrappers, whatever their launch geometry and C signatures are, and each
side's build module builds its own ``csrc`` into its own ``build/``
directory.  Every kernel runs on the level-2 inputs of the main runs of
``chip_smoke.py`` (the 40K-graph packed run for the packed kernel, the
40K two-launch run for the join and the reduction, the 80K-graph dense
run for the dense kernel); the two sides' outputs must be equal, and
the two are timed in turns (other, this, this, other), each turn 5
batches of 10 back-to-back calls between two CUDA events.  Prints the
card's name and power limit, one line per kernel, and a JSON line of
the medians."""
from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OTHER = "repro_torch_other"


def load_other(checkout: Path) -> None:
    """Import the checkout's ``repro_torch`` as package ``OTHER`` (its
    modules import each other relatively)."""
    init = checkout / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)


def wrappers(package: str):
    """The four kernel wrappers of ``package``."""
    fl = importlib.import_module(f"{package}.kernels.fused_level")
    ej = importlib.import_module(f"{package}.kernels.embedding_join")
    sc = importlib.import_module(f"{package}.kernels.support_count")
    return {"fused_level_packed": fl.fused_level_packed,
            "fused_level": fl.fused_level,
            "embedding_join": ej.embedding_join,
            "support_count": sc.support_count}


def main() -> int:
    import torch
    import chip_smoke as cs

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    load_other(Path(sys.argv[1]).resolve())
    other, this = wrappers(OTHER), wrappers("repro_torch")
    results = {}

    def compare(name, *args):
        run_o = lambda: other[name](*args)
        run_m = lambda: this[name](*args)
        got_o, got_m = run_o(), run_m()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got_o, got_m))
        t_o = cs.time_samples(run_o, 5, batch=10)
        t_m = cs.time_samples(run_m, 5, batch=10)
        t_m += cs.time_samples(run_m, 5, batch=10)
        t_o += cs.time_samples(run_o, 5, batch=10)
        ms_o, ms_m = statistics.median(t_o), statistics.median(t_m)
        results[name] = {"other_ms": ms_o, "this_ms": ms_m, "equal": same}
        print(f"{name}: other {ms_o:.4f} ms, this {ms_m:.4f} ms "
              f"({ms_o / ms_m:.2f}x), outputs equal: {same}", flush=True)
        return same

    ok = True
    g40 = cs.make_db("40K", 40_000, 0)
    a = cs.level2_inputs(g40, "fused_level_packed")
    ok &= compare("fused_level_packed", *a)
    del a
    a = cs.level2_inputs(g40, "embedding_join", backend="pallas")
    ok &= compare("embedding_join", *a)
    joined = this["embedding_join"](*a)
    del a, g40
    ok &= compare("support_count", *joined)
    del joined
    torch.cuda.empty_cache()

    g80 = cs.make_db("80K", 80_000, 1)
    a = cs.level2_inputs(g80, "fused_level")
    del g80
    ok &= compare("fused_level", *a)
    print(json.dumps({"compare_parent": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
