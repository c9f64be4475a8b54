"""Dry run of the MIRAGE mining step itself on the production mesh, the
counterpart of ``repro.launch.dryrun_mining`` — the paper-representative
roofline cell.

One level's map+shuffle+reduce (the support round,
``core.mapreduce._support_program``) and the survivor materialization
(``core.mapreduce._materialize_program``) are run for one rank at
production-plausible shapes:

    NP = parts_per_dev × W partitions, G graphs each, P patterns,
    C candidates, M embeddings, F edge occurrences,

W the production mesh's ranks (256, or 512 for "multi").  This process
is rank 0 of a ``fake`` process group of W ranks (its collectives move
nothing), and the rank's stores are fake tensors (shapes only); the
candidate rows are drawn from a seed.  The compute body is the
reference join (``backend="ref"``, the CUDA kernels' algorithm in plain
PyTorch, as ``repro`` lowers its reference join for the TPU), so the
collective structure is the real one; ``roofline.cost`` counts rank 0's
collectives, with wire bytes over the link rate of each group (NVLink
inside a node of 8, the inter-node rate across nodes).  The HBM term is
``repro``'s analytic model, as it is, over the H100's bandwidth.

    python -m repro_torch.launch.dryrun_mining --mesh both --out results
"""
import argparse
import json
import os
import time


def random_meta(rng, C: int, P: int, K: int, T: int):
    """(C, 5) int32 candidate rows: parent pattern in [0, P), the two
    vertex slots in [0, K), the forward flag and the edge triple in [0,
    T)."""
    import numpy as np
    return np.stack([rng.integers(0, P, C), rng.integers(0, K, C),
                     rng.integers(0, K, C), rng.integers(0, 2, C),
                     rng.integers(0, T, C)], axis=1).astype(np.int32)


def random_stores(rng, PP: int, P: int, G: int, M: int, K: int, T: int,
                  F: int):
    """Random-but-consistent (pol, pmask, src, dst, emask) numpy stores
    of PP partitions: vertex ids in [0, 32), PAD -1 off the masks, each
    mask row set from slot 0 to a length uniform in [0, width], as the
    stores are."""
    import numpy as np

    def prefix(shape):
        n = rng.integers(0, shape[-1] + 1, shape[:-1])
        return np.arange(shape[-1]) < n[..., None]

    pmask = prefix((PP, P, G, M))
    pol = rng.integers(0, 32, (PP, P, G, M, K), dtype=np.int32)
    pol = np.where(pmask[..., None], pol, -1).astype(np.int32)
    emask = prefix((PP, T, G, F))
    src = np.where(emask, rng.integers(0, 32, (PP, T, G, F)), -1)
    dst = np.where(emask, rng.integers(0, 32, (PP, T, G, F)), -1)
    return pol, pmask, src.astype(np.int32), dst.astype(np.int32), emask


def analytic_bytes(parts_per_dev: int, P: int, Cp: int, G: int, M: int,
                   K: int, T: int, F: int) -> float:
    """``repro``'s per-device HBM model of the join: it streams pol +
    eol once per candidate tile."""
    pol_b = parts_per_dev * P * G * M * K * 4
    eol_b = parts_per_dev * T * G * F * 9
    return pol_b / P * Cp / parts_per_dev + eol_b


def run(mesh_kind: str, out_dir: str, *, reduce: str, parts_per_dev: int = 4,
        P: int = 64, C: int = 256, G: int = 2048, M: int = 32, K: int = 6,
        T: int = 64, F: int = 32, minsup: int = 100,
        world: int = 0) -> dict:
    """One cell's result dict (also written under ``out_dir``).
    ``world`` replaces the production mesh's rank count (tests)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.mapreduce import (MiningMesh, _materialize_program,
                                            _support_program)
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.roofline.cost import count_step
    from repro_torch.roofline.hw import HBM_BW, PEAK_FLOPS_BF16

    W = world or (512 if mesh_kind == "multi" else 256)
    NP = parts_per_dev * W
    Cp = ((C + W - 1) // W) * W
    out = {"kind": "mining", "mesh": mesh_kind, "chips": W,
           "reduce": reduce, "parts_per_dev": parts_per_dev,
           "shapes": dict(NP=NP, P=P, C=Cp, G=G, M=M, K=K, T=T, F=F)}
    meta = random_meta(np.random.default_rng(0), Cp, P, K, T)
    t0 = time.perf_counter()
    with fake_group(W):
        mmesh = MiningMesh(dist.group.WORLD, 0, W, torch.device("cpu"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            pol = torch.empty((parts_per_dev, P, G, M, K), dtype=torch.int32)
            pmask = torch.empty((parts_per_dev, P, G, M), dtype=torch.bool)
            src = torch.empty((parts_per_dev, T, G, F), dtype=torch.int32)
            dst = torch.empty_like(src)
            emask = torch.empty((parts_per_dev, T, G, F), dtype=torch.bool)
        stores = (pol, pmask, src, dst, emask)
        args = meta.nbytes + sum(t.numel() * t.element_size()
                                 for t in stores)
        for phase, fn in (
                ("support", lambda: _support_program(
                    mmesh, meta, *stores, minsup=minsup, backend="ref",
                    reduce=reduce, gather_gsup=False)),
                ("materialize", lambda: _materialize_program(
                    mmesh, meta, *stores, max_embeddings=M))):
            _, cost = count_step(fn, fake_mode=fake)
            analytic = analytic_bytes(parts_per_dev, P, Cp, G, M, K, T, F)
            out[phase] = {
                "flops": cost.flops,
                "hbm_bytes_analytic": analytic,
                "wire_bytes": cost.collective_wire_bytes,
                "payload_bytes": cost.collective_payload_bytes,
                "collectives": {k: v["count"]
                                for k, v in cost.collectives.items()},
                "t_compute": cost.flops / PEAK_FLOPS_BF16,
                "t_memory": analytic / HBM_BW,
                "t_collective": cost.collective_seconds,
                "temp_bytes": cost.peak_bytes,
                "argument_bytes": args,
            }
            terms = {k: out[phase][f"t_{k}"]
                     for k in ("compute", "memory", "collective")}
            out[phase]["bottleneck"] = max(terms, key=terms.get)
    out["seconds"] = time.perf_counter() - t0

    os.makedirs(os.path.join(out_dir, "dryrun", mesh_kind), exist_ok=True)
    tag = f"__pp{parts_per_dev}" if parts_per_dev != 4 else ""
    path = os.path.join(out_dir, "dryrun", mesh_kind,
                        f"mirage_mining__{reduce}{tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[dryrun-mining] {mesh_kind} reduce={reduce}: "
          f"support bottleneck={out['support']['bottleneck']} "
          f"wire={out['support']['wire_bytes']:.3e}B "
          f"temp={out['support']['temp_bytes']/2**30:.2f}GiB -> {path}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results")
    ap.add_argument("--reduce", default="both",
                    choices=["psum", "reduce_scatter", "both"])
    ap.add_argument("--parts-per-dev", type=int, default=4)
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    reduces = (["psum", "reduce_scatter"] if args.reduce == "both"
               else [args.reduce])
    for m in meshes:
        for r in reduces:
            run(m, args.out, reduce=r, parts_per_dev=args.parts_per_dev)


if __name__ == "__main__":
    main()
