"""The control of the check: the program with one of its own shortcuts
switched on, which breaks the configuration's guarantee (exact
supports), at a cell's own size, beside the program as it runs in the
benchmark, on each seed given.  Each is one whole run of the cell
(``run_cell``: set-up, a window of ``MIN_FITS`` fits, the check), with
the shortcut set in the program's configuration.

    python3 gpubench/control.py --workload nci40k.ms15 --seeds 11 12 13

Prints one JSON line per (seed, variant) with ``correct`` and the
numbers the check compared, each beside its limit.  The benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from harness.runner import run_cell  # noqa: E402
from harness.spec import load_cell  # noqa: E402

# the shortcut a later change might take to cut pass 2's work and the
# stores' memory: the occurrence lists capped at half the default
# embeddings a graph (M 16 against 32), with the exactness valve
# (escalation on overflow) off, so that a support may be undercounted
CONTROL = "approx_m16"
CONTROLS = {
    "sound": {},
    CONTROL: {"max_embeddings": 16, "escalate_on_overflow": False},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound", CONTROL],
                    choices=list(CONTROLS))
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        for name in args.variants:
            t = time.perf_counter()
            r = run_cell(cell, seed, 0.0, False, overrides=CONTROLS[name])
            print(json.dumps({
                "workload": cell.name, "seed": seed, "variant": name,
                "correct": r["correct"], "failed": r["failed"],
                "checks": r["checks"],
                "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
