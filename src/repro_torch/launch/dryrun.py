"""Production dry run, the counterpart of ``repro.launch.dryrun`` (which
lowers and compiles each cell for 256 or 512 simulated TPU devices):
every (arch × shape) step on the production meshes, counted for one
rank, with its memory, cost and roofline terms on H100s.

    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k \\
        --mesh single --out results
    python -m repro_torch.launch.dryrun --all --mesh both --out results

This process is rank 0 of a ``fake`` process group of the mesh's
``chips`` ranks (``torch.testing._internal.distributed.fake_pg``: its
collectives return at once and move nothing).  The model and its AdamW
state are made under ``FakeTensorMode`` (shapes only: nothing is
allocated, nothing is computed) and placed on ``make_production_mesh``
as training or serving places them; then the real step runs once
(``train_step`` in microbatches, ``prefill`` or ``decode``) under
``roofline.cost.count_step``, which counts rank 0's matmul FLOPs on its
local shards, its op bytes, its collectives and the peak of the bytes
its step makes live.  Rank 0's memory: its argument bytes (local
parameters, optimizer state, batch shard, caches and decode's int32
position, as ``repro``'s ``memory_analysis()`` counts its arguments),
output bytes and the step's peak live bytes (``temp_bytes``).  The
weights are the float32 masters for every step, as ``repro``'s dry run
lowers them.

``--all`` runs one subprocess per cell (JSON result cache keyed on
(mesh, arch, shape) — rerunning skips finished cells).  Skipped cells
(long_500k on full-attention archs) are recorded with their reason.
``DRYRUN_MICROBATCHES`` sets the train step's microbatches,
``DRYRUN_DECODE_WEIGHTS=replicated`` places decode's weights by their
compute specs (tensor parallel only, replicated over the data axes),
and ``DRYRUN_DUMP_OPS=<path>`` writes the step's per-op cost listing
(in place of ``repro``'s ``DRYRUN_DUMP_HLO``: there is no HLO).
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks, for the duration; an existing fake group of that size is
    kept, any other group is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            yield
            return
        raise RuntimeError("a process group is already initialized: the "
                           "dry run needs its own fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tensors) -> int:
    """Bytes of this rank's blocks of ``tensors`` (DTensors or plain)."""
    from repro_torch.roofline.hw import DTYPE_BYTES
    from repro_torch.runtime.sharding import local
    return sum(local(t).numel() * DTYPE_BYTES[t.dtype] for t in tensors)


def _leaves(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _microbatches(shape, chips: int, tp: int) -> int:
    return int(os.environ.get("DRYRUN_MICROBATCHES",
                              max(1, shape.global_batch // (chips // tp))))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, variant: str = "", cfg=None, shape=None, mesh_shape=None,
             masters: bool = True) -> dict:
    """One cell's result dict.  ``cfg``, ``shape`` (a ``ShapeConfig``)
    and ``mesh_shape`` (a ("data", "model") shape) replace the registry
    config of ``arch``, ``SHAPES[shape_name]`` and the production mesh
    (tests run smoke configs on small fake meshes; the chip smoke test
    predicts a served shape on a 1×1 mesh).  ``masters=False`` holds
    the weights as serving holds them (prefill and decode only)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import SHAPES, cell_applicable, shape_lowers
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         worker_count)
    from repro_torch.launch.specs import input_specs, layer_caches
    from repro_torch.models.registry import build, get_config, model_class
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.cost import count_step
    from repro_torch.runtime.sharding import (active_mesh, batch_specs,
                                              cache_spec, mesh_axes, place,
                                              place_model)
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = cfg if cfg is not None else get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **json.loads(variant))
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    world = 1
    for n in mesh_shape:
        world *= n
    step_name = shape_lowers(shape)

    with fake_group(world):
        if len(mesh_shape) == 3:
            mesh = make_production_mesh(multi_pod=True, device="cpu")
        else:
            mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        chips = worker_count(mesh)
        tp = mesh_axes(mesh)["model"]
        if step_name == "train_step" and not masters:
            raise ValueError("a train step needs the float32 masters")
        fns = build(cfg, device="cpu", masters=masters)
        t0 = time.perf_counter()
        # fake leaves, made under the fake mode; the step runs with the
        # mode off (DTensor's own bookkeeping needs real tensors), each op
        # on a fake leaf dispatching through it
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            model = model_class(cfg)(cfg, device="meta", masters=masters)
            for name, p in list(model.named_parameters()):
                mod, _, attr = name.rpartition(".")
                model.get_submodule(mod).register_parameter(
                    attr, torch.nn.Parameter(torch.empty(p.shape,
                                                         dtype=p.dtype)))
            batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in input_specs(cfg, shape).items()}
            if step_name == "decode_step":
                cache = [None if c is None else
                         {k: torch.zeros(v.shape, dtype=v.dtype)
                          for k, v in c.items()}
                         for c in layer_caches(cfg, shape)]
        replicated = (os.environ.get("DRYRUN_DECODE_WEIGHTS")
                      == "replicated" and shape.kind == "decode")
        place_model(cfg, model, mesh, data_replicated=replicated)
        args = _local_bytes(model.parameters()) + sum(
            _local_bytes([place(v, s, mesh)]) for v, s in zip(
                batch.values(), batch_specs(cfg, mesh, batch).values()))
        micro = 1
        if step_name == "train_step":
            micro = _microbatches(shape, chips, tp)
            opt = init_train_state(model)
            args += _local_bytes(_leaves(opt))
            step = make_train_step(cfg, AdamWConfig(), fns["loss_fn"],
                                   microbatches=micro, mesh=mesh)

            def run():
                return step(model, opt, batch)
        elif step_name == "prefill_step":
            def run():
                with active_mesh(mesh):
                    return fns["prefill"](model, batch)
        else:
            cache = [None if c is None else
                     {k: place(v, cache_spec(k, v.shape, mesh), mesh)
                      for k, v in c.items()} for c in cache]
            args += _local_bytes(_leaves(cache)) + 4   # + the int32 pos

            def run():
                with active_mesh(mesh):
                    return fns["decode"](model, cache, batch,
                                         shape.seq_len - 1)
        t_build = time.perf_counter() - t0
        out, cost = count_step(run, fake_mode=fake)
        t_step = time.perf_counter() - t0 - t_build
        outputs = _leaves(out)
        if step_name == "train_step":
            outputs = list(out[0].parameters()) + _leaves(out[1:])
        out_bytes = _local_bytes(outputs)

    dump = os.environ.get("DRYRUN_DUMP_OPS")
    if dump:
        with open(dump, "w") as f:
            f.write(cost.op_listing() + "\n")
    memory = {"argument_bytes": args, "output_bytes": out_bytes,
              "temp_bytes": cost.peak_bytes}
    report = analyze(cfg, shape, mesh_name=mesh_kind, chips=chips,
                     step=step_name, cost=cost, memory=memory, tp=tp,
                     microbatches=micro, notes=variant)
    res = report.to_json()
    res.update({"status": "ok", "build_seconds": t_build,
                "step_seconds": t_step, "ops": sum(
                    c for c, _, _ in cost.by_op.values())})
    print(f"[dryrun] {cfg.name} {shape_name} {mesh_kind}: "
          f"args={res['argument_bytes']/2**30:.2f}GiB "
          f"temp={res['temp_bytes']/2**30:.2f}GiB "
          f"flops/dev={res['flops']:.3e} "
          f"bottleneck={res['bottleneck']}")
    print(f"[dryrun] memory (rank 0): {memory}")
    print(f"[dryrun] collectives (rank 0): {res['collectives']}")
    return res


def cell_path(out_dir, mesh, arch, shape, variant=""):
    import hashlib
    tag = ""
    if variant:
        tag = "__" + hashlib.sha1(variant.encode()).hexdigest()[:8]
    # normalize to the registry module id so CLI aliases share the cache
    from repro_torch.models.registry import _ALIASES
    safe = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    return os.path.join(out_dir, "dryrun", mesh,
                        f"{safe}__{shape}{tag}.json")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results")
    ap.add_argument("--variant", default="",
                    help="JSON dict of ModelConfig overrides (perf iters)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        from repro_torch.configs.base import SHAPES
        from repro_torch.models.registry import ARCHS
        jobs = [(a, s, m) for m in meshes for a in ARCHS for s in SHAPES]
        failures = []
        for (a, s, m) in jobs:
            path = cell_path(args.out, m, a, s)
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {m} {a} {s}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m,
                   "--out", args.out]
            print(f"[run] {m} {a} {s}")
            try:
                r = subprocess.run(cmd, timeout=args.timeout,
                                   capture_output=True, text=True)
            except subprocess.TimeoutExpired:
                failures.append((m, a, s, "TIMEOUT"))
                print(f"[FAIL-TIMEOUT] {m} {a} {s}")
                continue
            if r.returncode != 0:
                failures.append((m, a, s, r.stderr[-2000:]))
                print(f"[FAIL] {m} {a} {s}\n{r.stderr[-2000:]}")
            else:
                lines = [l for l in r.stdout.strip().splitlines()
                         if l.startswith("[dryrun]") or "skipped" in l]
                print(lines[0] if lines else "[done]")
        print(f"\n{len(failures)} failures")
        for f in failures:
            print("FAILED:", f[0], f[1], f[2])
        sys.exit(1 if failures else 0)

    for m in meshes:
        path = cell_path(args.out, m, args.arch, args.shape, args.variant)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            res = run_cell(args.arch, args.shape, m, args.out,
                           variant=args.variant)
        except Exception:
            traceback.print_exc()
            sys.exit(1)
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        print(f"[saved] {path}")


if __name__ == "__main__":
    main()
