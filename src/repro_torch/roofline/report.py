"""The dry-run, roofline and mining tables from the dry runs' JSON
cells (``launch.dryrun``, ``launch.dryrun_mining``), the counterpart of
``repro.roofline.report``: the same tables from the same cells.

    python -m repro_torch.roofline.report --results results > tables.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(results: str, mesh: str) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results, "dryrun", mesh,
                                              "*.json"))):
        with open(path) as f:
            d = json.load(f)
        d["_file"] = os.path.basename(path)
        cells.append(d)
    return cells


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | step | status | args GiB/dev | temp GiB/dev "
            "| compile s |",
            "|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("kind") == "mining":
            continue
        if d.get("status") == "skipped":
            rows.append(f"| {d['arch']} | {d['shape']} | — | SKIP: "
                        f"{d['reason'][:60]}… | — | — | — |")
            continue
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['step']} | ok "
            f"| {fmt_bytes(d['argument_bytes'])} "
            f"| {fmt_bytes(d['temp_bytes'])} "
            f"| {d.get('compile_seconds', 0):.0f} |")
    return "\n".join(rows)


def roofline_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | t_comp s | t_mem s | t_coll s | bound "
            "| MODEL_FLOPs/chip | useful | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("status") != "ok" or d.get("kind") == "mining":
            continue
        rows.append(
            f"| {d['arch']} | {d['shape']} "
            f"| {d['t_compute']:.3f} | {d['t_memory']:.3f} "
            f"| {d['t_collective']:.3f} | {d['bottleneck']} "
            f"| {d['model_flops_per_chip']:.2e} "
            f"| {d['useful_ratio']:.3f} | {d['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def mining_table(cells: list[dict]) -> str:
    rows = ["| mesh | reduce | phase | t_comp s | t_mem s | t_coll s "
            "| bound | collectives |",
            "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("kind") != "mining":
            continue
        for phase in ("support", "materialize"):
            p = d[phase]
            rows.append(
                f"| {d['mesh']} | {d['reduce']} | {phase} "
                f"| {p['t_compute']:.4f} | {p['t_memory']:.4f} "
                f"| {p['t_collective']:.6f} | {p['bottleneck']} "
                f"| {p['collectives']} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    args = ap.parse_args()
    for mesh in ("single", "multi"):
        cells = load_cells(args.results, mesh)
        if not cells:
            continue
        print(f"\n### Dry-run — {mesh} pod "
              f"({'512' if mesh == 'multi' else '256'} chips)\n")
        print(dryrun_table(cells))
        print(f"\n### Roofline — {mesh} pod\n")
        print(roofline_table(cells))
        mt = mining_table(cells)
        if mt.count("\n") > 1:
            print(f"\n### Mining step — {mesh} pod\n")
            print(mt)


if __name__ == "__main__":
    main()
