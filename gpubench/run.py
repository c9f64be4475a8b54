r"""The benchmark of ``repro_torch`` (MIRAGE on PyTorch and CUDA): one run of
one cell of ``BENCHMARK.json``.

    python3 gpubench/run.py --workload nci40k.ms15 --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is the result as one JSON object;
the numbers the check compared, each beside its limit, are the last
lines of standard error.  Exits non-zero, with no result, when the cards
are missing or a forbidden module (JAX, or the JAX package ``repro``)
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# PyTorch's own kernel cache (jiterator) inside the checkout, at a fixed
# path, so that only a checkout's first run fills it
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      str(ROOT / "build" / "gpubench_cache" / "torch_kernels"))

from harness.runner import NoDevice, forbidden_modules, run_cell  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except NoDevice as exc:
        print(f"[gpubench] {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[gpubench] forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
