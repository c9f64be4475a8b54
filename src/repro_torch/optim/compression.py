"""Int8 error-feedback gradient compression for the data-parallel
all-reduce, the counterpart of ``repro.optim.compression``, over a
``torch.distributed`` process group.

Each gradient leaf (plus the residual its rank carried from the last
step) is quantized to int8 with a per-leaf scale; the payload is
all-reduced as int32, the scales are all-reduced and averaged, and the
quantization residual is carried into the next step (error feedback
keeps the scheme unbiased in the long run — Seide et al. / Karimireddy
et al.).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist

from ..train.train_step import split_batch
from .adamw import adamw_update

__all__ = ["compress_psum", "init_error_state", "make_train_step_ddp"]


def init_error_state(params: Mapping[str, torch.Tensor]) -> dict:
    """A float32 zero residual beside each parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _quant(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``g`` at scale max|g| / 127 (+1e-30), rounded half
    to even as ``jnp.round`` rounds."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_psum(grads: Mapping[str, torch.Tensor],
                  err: Mapping[str, torch.Tensor], group
                  ) -> tuple[Mapping[str, torch.Tensor],
                             Mapping[str, torch.Tensor]]:
    """Error-feedback int8 all-reduce over ``group``: returns the
    gradients averaged over the ranks and the new residuals.  The codes
    are summed as int32 (127 × ranks stays far inside its range), the
    scales summed in float32 and averaged.  Both are written in place,
    leaf by leaf, into the float32 ``grads`` and ``err`` that are
    returned: at full width a second copy of either would not fit the
    card beside the masters and the AdamW moments."""
    n = float(dist.get_world_size(group))
    for name, grad in grads.items():
        g = grad.float() + err[name]
        q, scale = _quant(g)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, group=group)
        torch.sub(g, q.float() * scale, out=err[name])
        grad.copy_(qsum.float() * (ssum / n) / n)
    return grads, err


def make_train_step_ddp(cfg, opt_cfg, loss_fn: Callable, group, *,
                        compress: bool = True) -> Callable:
    """The explicit data-parallel step over ``group``: ``step(model,
    opt_state, err, batch) -> (model, opt_state, err, metrics)``.  Each
    rank takes its block of the global ``batch``, the parameters stay
    replicated, the gradients are averaged over the ranks by the
    compressed all-reduce (or a plain one when not ``compress``), every
    rank applies the same AdamW update, and the metrics' ``loss`` is the
    mean over the ranks."""
    def step(model, opt_state, err, batch):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, split_batch(batch, world)[rank])
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                 for n, p in params.items()}
        if compress:
            grads, err = compress_psum(grads, err, group)
        else:
            for g in grads.values():
                dist.all_reduce(g, group=group)
                g.div_(world)
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        lsum = loss.detach().clone()
        dist.all_reduce(lsum, group=group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return model, opt_state, err, {**metrics, **om,
                                       "loss": lsum / world}
    return step
