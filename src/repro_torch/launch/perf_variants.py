"""Variant runner, the counterpart of ``repro.launch.perf_variants``:
runs ``repro``'s hillclimb cells (three chosen pairs) as ``--variant``
dry runs of ``repro_torch.launch.dryrun`` (one subprocess each, cached
by ``cell_path``), the mining parts-per-device pair through
``repro_torch.launch.dryrun_mining``, and prints the before/after
table.

    python -m repro_torch.launch.perf_variants --out results
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (arch, shape, variant-json, env, label)
VARIANTS = [
    # --- cell 2: minicpm prefill (worst useful_ratio) -------------------
    ("minicpm-2b", "prefill_32k", '{"attn_schedule": "tri"}', {},
     "P7 tri attention schedule"),
    ("minicpm-2b", "prefill_32k", '{"prefill_logits": "last"}', {},
     "P8 last-position prefill logits"),
    ("minicpm-2b", "prefill_32k",
     '{"attn_schedule": "tri", "prefill_logits": "last"}', {},
     "P7+P8 combined"),
    # --- cell 1: qwen2-vl train (most collective-bound) -----------------
    ("qwen2-vl-72b", "train_4k", "", {"DRYRUN_MICROBATCHES": "4"},
     "P5 microbatches 16->4"),
    ("qwen2-vl-72b", "train_4k", '{"seq_parallel": true}', {},
     "P6 sequence parallelism"),
    ("qwen2-vl-72b", "train_4k", '{"seq_parallel": true}',
     {"DRYRUN_MICROBATCHES": "4"}, "P5+P6 combined"),
    # --- P5 on the per-ubatch grad-AR diagnosis (qwen2.5 / xlstm) -------
    ("qwen2.5-14b", "train_4k", "", {"DRYRUN_MICROBATCHES": "4"},
     "P5 qwen2.5 microbatches 16->4"),
    ("xlstm-1.3b", "train_4k", "", {"DRYRUN_MICROBATCHES": "4"},
     "P5 xlstm microbatches 16->4"),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results")
    ap.add_argument("--timeout", type=int, default=5400)
    args = ap.parse_args()
    env0 = dict(os.environ)
    env0["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))

    results = []
    for (arch, shape, variant, env_extra, label) in VARIANTS:
        from repro_torch.launch.dryrun import cell_path
        path = cell_path(args.out, "single", arch, shape, variant)
        if env_extra:  # env changes the artifact: tag the filename
            path = path.replace(".json",
                                "__" + "_".join(f"{k}={v}" for k, v in
                                                env_extra.items()) + ".json")
        if not os.path.exists(path):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", "single",
                   "--out", args.out]
            if variant:
                cmd += ["--variant", variant]
            env = dict(env0)
            env.update(env_extra)
            print(f"[variant] {label}: {arch} {shape} {variant} {env_extra}")
            r = subprocess.run(cmd, env=env, timeout=args.timeout,
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(f"[variant-FAIL] {label}\n{r.stderr[-1500:]}")
                continue
            src = cell_path(args.out, "single", arch, shape, variant)
            if src != path and os.path.exists(src):
                os.replace(src, path)
        with open(path) as f:
            d = json.load(f)
        d["_label"] = label
        results.append(d)

    # mining parts-per-dev decoupling (P10)
    for pp in (1, 16):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun_mining",
               "--mesh", "single", "--out", args.out,
               "--reduce", "psum", "--parts-per-dev", str(pp)]
        subprocess.run(cmd, env=env0, timeout=args.timeout)

    print("\nlabel | tC | tM | tX | useful | temp GiB")
    for d in results:
        print(f"{d['_label']} | {d['t_compute']:.3f} | {d['t_memory']:.3f}"
              f" | {d['t_collective']:.3f} | {d['useful_ratio']:.3f}"
              f" | {d['temp_bytes']/2**30:.1f}")


if __name__ == "__main__":
    main()
