"""Training step assembly, the counterpart of
``repro.train.train_step``: the loss's backward pass + AdamW, with
optional gradient accumulation over microbatches, built from a
registry ``loss_fn``.  On a mesh (``make_train_step(..., mesh=)``, the
model placed by ``runtime.sharding.place_model``) each microbatch of the
global batch is placed by ``batch_specs`` before the loss runs on it."""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..runtime.sharding import (active_mesh, batch_specs, is_sharded,
                                mesh_scope, place)

__all__ = ["make_train_step", "init_train_state", "split_batch",
           "place_batch"]


def init_train_state(model) -> dict:
    """AdamW's zero state beside ``model``'s masters."""
    return adamw_init(dict(model.named_parameters()))


def split_batch(batch: Mapping[str, torch.Tensor], n: int) -> list[dict]:
    """``batch`` cut into ``n`` equal contiguous splits of its batch axis
    (axis 0; axis 1 of ``positions3``), in order: the microbatches of a
    step, or the ranks' shards of a data-parallel one."""
    parts = [{} for _ in range(n)]
    for k, v in batch.items():
        axis = 1 if k == "positions3" else 0
        b = v.shape[axis]
        if b % n:
            raise ValueError(f"{k}: batch {b} does not split into {n}")
        for i, piece in enumerate(torch.split(v, b // n, dim=axis)):
            parts[i][k] = piece
    return parts


def place_batch(cfg, batch: Mapping[str, torch.Tensor], mesh) -> dict:
    """``batch`` (the global batch, the same on every rank) placed by
    ``batch_specs``: each rank keeps its block of the batch axis."""
    specs = batch_specs(cfg, mesh, batch)
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's full value, any other tensor itself."""
    return t.full_tensor() if is_sharded(t) else t


def make_train_step(cfg, opt_cfg: AdamWConfig, loss_fn: Callable,
                    *, microbatches: int = 1, mesh=None) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (model,
    opt_state, metrics)``.  The masters' float32 ``.grad``s are summed
    over the ``microbatches`` leading splits of the batch, then divided
    by their number, and AdamW updates the masters in place; afterwards
    each ``.grad`` holds the (clipped) gradient the update used.  The
    metrics are the last microbatch's loss-function metrics plus
    ``lr``, ``grad_norm`` and ``loss`` (the mean over the microbatches),
    each a tensor on the model's device.  With ``mesh`` the batch is the
    global one and the step runs under ``active_mesh(mesh)``; the
    metrics are plain tensors, the same on every rank."""

    def train_step(model, opt_state, batch):
        with active_mesh(mesh), mesh_scope():
            return step(model, opt_state, batch)

    def step(model, opt_state, batch):
        model.zero_grad(set_to_none=True)
        loss = None
        for mb in (split_batch(batch, microbatches)
                   if microbatches > 1 else [batch]):
            if mesh is not None:
                mb = place_batch(cfg, mb, mesh)
            l, metrics = loss_fn(model, mb)
            l.backward()
            l = _plain(l.detach())
            loss = l if loss is None else loss + l
        params = dict(model.named_parameters())
        for p in params.values():
            # a replicated master's gradient arrives as a partial sum
            if is_sharded(p.grad) and p.grad.placements != p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        if microbatches > 1:
            loss = loss / microbatches
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(microbatches)
        _, opt_state, om = adamw_update(
            opt_cfg, params, {n: p.grad for n, p in params.items()},
            opt_state)
        metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
        return model, opt_state, {**metrics, **om, "loss": loss}

    return train_step
