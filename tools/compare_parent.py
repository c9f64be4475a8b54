#!/usr/bin/env python3
"""Time the port's four CUDA kernels against those of another checkout
(for example the parent commit) on one card, in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_parent.py build/parent

Run from the repository root on a machine with a CUDA card.  Both
checkouts' ``src/repro_torch/kernels/csrc`` are built (each by its own
``build.py``, into its own ``build/`` directory); every kernel is called
through its C entry point on the level-2 inputs of the main runs of
``chip_smoke.py`` (the 40K-graph packed run for the packed kernel, the
80K-graph dense run for the dense kernel, the 40K two-launch run for the
join and the reduction), the two outputs must be equal, and the two are
timed in turns (other, this, this, other), each turn 5 batches of 10
back-to-back launches between two CUDA events.  Prints the card's name
and power limit, one line per kernel, and a JSON line of the medians.
The other checkout is called with the entry points of the commit before
the dense kernel and the reduction were redesigned: the reduction with
no grid arguments, the dense kernel with the join kernels' block
width."""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def load_build(checkout: Path):
    """The build module of a checkout, loaded on its own (it has no
    package-relative imports), so that it builds that checkout's
    sources into that checkout's build directory."""
    path = checkout / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(str(checkout)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as mine
    from repro_torch.kernels import fused_level as fl
    from repro_torch.kernels import support_count as sc

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    theirs = load_build(other)
    lib_m, lib_o = mine._library(), theirs._library()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptrs = lambda xs: [x.data_ptr() for x in xs]
    results = {}

    def compare(name, run_o, run_m):
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
    sched_meta, tiles, gmask, pol, pmask, src, dst, emask = a
    PP, P, G, M, K = pol.shape
    T, F = src.shape[1], src.shape[3]
    NT, Cs, Gw = tiles.shape[0], sched_meta.shape[0], gmask.shape[0]

    def packed(lib, threads):
        def run():
            sup = torch.zeros((PP, Cs), dtype=torch.int32, device="cuda")
            emb = torch.zeros_like(sup)
            vb = torch.empty((PP, Cs, Gw), dtype=torch.uint32, device="cuda")
            rc = lib.fused_level_packed_launch(
                *ptrs((sched_meta, tiles, gmask, pol, pmask, src, dst, emask,
                       sup, emb, vb)),
                PP, P, G, M, K, T, F, NT, Cs // NT, Gw, threads, stream())
            assert rc == 0, rc
            return sup, emb, vb
        return run
    ok &= compare("fused_level_packed", packed(lib_o, theirs.block_threads(F)),
                  packed(lib_m, mine.block_threads(F)))
    del a, sched_meta, tiles, pol, pmask, src, dst, emask, gmask

    a = cs.level2_inputs(g40, "embedding_join", backend="pallas")
    meta, pol, pmask, src, dst, emask = a
    PP, P, G, M, K = pol.shape
    T, F, C = src.shape[1], src.shape[3], meta.shape[0]

    def join(lib, threads):
        def run():
            out = torch.empty((2, PP, C, G), dtype=torch.int32, device="cuda")
            rc = lib.embedding_join_launch(
                *ptrs((meta, pol, pmask, src, dst, emask, out[0], out[1])),
                PP, P, G, M, K, T, F, C, threads, stream())
            assert rc == 0, rc
            return out[0], out[1]
        return run
    ok &= compare("embedding_join", join(lib_o, theirs.block_threads(F)),
                  join(lib_m, mine.block_threads(F)))
    matched, count = join(lib_m, mine.block_threads(F))()
    del a, meta, pol, pmask, src, dst, emask, g40

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def reduce(lib, geometry):
        def run():
            sup = torch.empty((PP, C), dtype=torch.int32, device="cuda")
            emb = torch.empty_like(sup)
            rc = lib.support_count_launch(*ptrs((matched, count, sup, emb)),
                                          PP, C, G, *geometry, stream())
            assert rc == 0, rc
            return sup, emb
        return run
    ok &= compare("support_count", reduce(lib_o, ()),
                  reduce(lib_m, sc.reduce_geometry(PP * C, n_sm)))
    del matched, count
    torch.cuda.empty_cache()

    g80 = cs.make_db("80K", 80_000, 1)
    a = cs.level2_inputs(g80, "fused_level")
    del g80
    sched_meta, tiles, pol, pmask, src, dst, emask = a
    PP, P, G, M, K = pol.shape
    T, F = src.shape[1], src.shape[3]
    NT, Cs = tiles.shape[0], sched_meta.shape[0]

    def dense(lib, geometry):
        def run():
            sup = torch.zeros((PP, Cs), dtype=torch.int32, device="cuda")
            emb = torch.zeros_like(sup)
            rc = lib.fused_level_launch(
                *ptrs((sched_meta, tiles, pol, pmask, src, dst, emask, sup,
                       emb)),
                PP, P, G, M, K, T, F, NT, Cs // NT, *geometry, stream())
            assert rc == 0, rc
            return sup, emb
        return run
    ok &= compare("fused_level", dense(lib_o, (theirs.block_threads(F),)),
                  dense(lib_m, fl.dense_geometry(PP, T)))
    print(json.dumps({"compare_parent": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
