"""End-to-end training loop, the counterpart of ``repro.train.loop``:
data pipeline + train step + checkpointing, on one device or over a
device mesh (FSDP + tensor parallelism).

Fault tolerance contract (the JAX package's):
  * checkpoint every ``ckpt_every`` steps: params, optimizer state, step
    (the data-pipeline cursor IS the step — the pipeline is a pure
    function of it);
  * ``resume=True`` restarts from the newest complete checkpoint, on a
    possibly different mesh or on none (elastic): state is written
    unsharded and placed again on load;
  * the loop is deterministic: same seed + same global batch schedule
    regardless of shard count.

A checkpoint holds the JAX package's tree (``{"params": ..., "opt":
{"m", "v", "step"}}``, the blocks stacked back into ``group_{gi}``
lists by ``params_to_jax``) in the shared npz + JSON format, so a run
started by either package resumes in the other.

On a mesh every rank draws (or loads) the full masters from the seed on
its own device and keeps its block of each (``place_model``: nothing
moves between ranks), the AdamW moments are placed as their masters,
every rank makes the whole global batch from the pipeline and keeps its
block, and a checkpoint gathers the state and is written by rank 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from ..data.pipeline import TokenPipeline
from ..models.registry import (leaves_from_jax, params_from_jax,
                               params_to_jax, resolve_device)
from ..optim.adamw import AdamWConfig
from ..runtime import checkpoint as ckpt
from ..runtime.sharding import is_sharded, place_model
from .train_step import init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "train_loop", "opt_state_to_jax",
           "opt_state_from_jax"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


def opt_state_to_jax(cfg, opt_state: dict) -> dict:
    """AdamW's state in the JAX package's layout: ``m`` and ``v`` as
    ``params_to_jax`` trees, ``step`` a 0-d int32 array."""
    return {"m": params_to_jax(cfg, opt_state["m"]),
            "v": params_to_jax(cfg, opt_state["v"]),
            "step": np.asarray(opt_state["step"].cpu().numpy(), np.int32)}


def opt_state_from_jax(cfg, tree: dict, model, device) -> dict:
    """The inverse of ``opt_state_to_jax`` for ``model``'s parameters;
    each moment is placed as its master when the model is on a mesh."""
    params = dict(model.named_parameters())

    def moment(p, a):
        t = torch.as_tensor(np.array(a, np.float32), device=device)
        if not is_sharded(p):
            return t
        return distribute_tensor(t, p.device_mesh, p.placements,
                                 src_data_rank=None)

    def moments(t):
        return {n: moment(params[n], a)
                for n, a in leaves_from_jax(cfg, t, params).items()}

    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": torch.as_tensor(np.asarray(tree["step"]),
                                    dtype=torch.int32, device=device)}


def train_loop(cfg, fns: dict, loop_cfg: TrainLoopConfig,
               opt_cfg: AdamWConfig, pipeline: TokenPipeline,
               *, device=None, mesh=None, resume: bool = False,
               extra_batch: Optional[Callable[[int], dict]] = None
               ) -> dict:
    """Trains ``fns["init"]``'s model (``registry.build(cfg, device,
    masters=True)``) on ``device`` (the card unless the caller names
    another) for steps ``[step0, loop_cfg.steps)``; ``step0`` is 0, or
    the newest checkpoint's step with ``resume``.  ``extra_batch(step)``
    adds inputs to each batch (stub frames, embeddings).  Returns
    ``{"losses", "grad_norms", "model", "opt", "steps_run"}``: the JAX
    loop's result (the model in place of its params) and each step's
    gradient norm before clipping.

    ``mesh`` (a ``launch.mesh.make_mesh`` DeviceMesh with axes ("data",
    "model") or ("pod", "data", "model")) trains FSDP + tensor parallel
    over it, every rank of the mesh calling ``train_loop`` alike; the
    masters are then DTensors and ``device`` is the mesh's.  Every
    rank's result is the same."""
    if mesh is not None:
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        device = mesh.device_type
    device = resolve_device(device)
    step0 = 0
    if resume and loop_cfg.ckpt_dir and ckpt.latest_step(loop_cfg.ckpt_dir):
        state, meta = ckpt.load_step(loop_cfg.ckpt_dir)
        model = params_from_jax(cfg, state["params"], device=device,
                                masters=True)
        if mesh is not None:
            place_model(cfg, model, mesh)
        opt_state = opt_state_from_jax(cfg, state["opt"], model, device)
        step0 = int(meta["step"])
    else:
        model = fns["init"](torch.Generator(device).manual_seed(
            loop_cfg.seed))
        if mesh is not None:
            place_model(cfg, model, mesh)
        opt_state = init_train_state(model)
    held = [n for n, p in model.named_parameters()
            if not p.requires_grad or p.dtype != torch.float32]
    if held:
        raise ValueError(f"train_loop needs float32 masters (build(cfg, "
                         f"masters=True)); {held[:3]} are held for serving")

    step_fn = make_train_step(cfg, opt_cfg, fns["loss_fn"],
                              microbatches=loop_cfg.microbatches, mesh=mesh)
    losses, grad_norms = [], []
    for step in range(step0, loop_cfg.steps):
        batch = dict(pipeline.batch(step))
        if extra_batch is not None:
            batch.update(extra_batch(step))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % loop_cfg.log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            state = {"params": params_to_jax(cfg, model),
                     "opt": opt_state_to_jax(cfg, opt_state)}
            if mesh is None or dist.get_rank() == 0:
                ckpt.save_step(loop_cfg.ckpt_dir, step + 1, state,
                               metadata={"kind": "train", "loss": loss})
            if mesh is not None:    # the checkpoint is whole for every rank
                dist.barrier()
    return {"losses": losses, "grad_norms": grad_norms, "model": model,
            "opt": opt_state, "steps_run": loop_cfg.steps - step0}
