"""AdamW with global-norm clipping and schedules, the counterpart of
``repro.optim.adamw``, on float32 tensors: the masters, their gradients
and the moments are mappings from the model's parameter names to
tensors, and ``adamw_update`` updates the masters and moments in place
under ``no_grad``.  The arithmetic is the JAX package's, in float32.

Weight decay (ROADMAP C6) applies to a leaf of two or more dimensions
as one layer holds it: the port's parameters are per layer, so the
per-layer vectors (norm scales, Mamba2's ``A_log``/``D``/``dt_bias``,
xLSTM's ``f_bias``) are exempt, as ``repro``'s rule says they should
be.  ``repro`` tests ``ndim`` on leaves stacked over a leading layer
axis, so it decays every such vector inside a scanned group and exempts
only the top-level ``final_norm``.

On a mesh the masters, gradients and moments are DTensors of the same
placements (``runtime.sharding.param_specs``): the clip takes one
global norm over the shards, and the update runs on each rank's local
shards in place (``ndim`` is the global shape's, as ever).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from ..runtime.sharding import is_sharded, local

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "schedule_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"          # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: final decay fraction of run
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor on the step's device: linear warmup, then constant,
    cosine to ``min_lr_frac``, or MiniCPM's Warmup-Stable-Decay."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        mult = torch.ones((), dtype=torch.float32, device=step.device)
    elif cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        mult = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1 - cfg.decay_frac)
        t = torch.clamp((step - decay_start)
                        / max(cfg.total_steps - decay_start, 1), 0, 1)
        mult = 1 - (1 - cfg.min_lr_frac) * t       # stable then linear decay
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * mult


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero float32 moments ``m`` and ``v`` beside each parameter (placed
    as it is, on a mesh), and ``step`` 0 (int32, on the parameters'
    device)."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {n: torch.zeros_like(z)
                              for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _owns(t) -> bool:
    """Whether this rank counts DTensor ``t``'s local shard in a sum over
    the mesh: it is the first of the ranks that hold the same block
    (coordinate 0 on every mesh dim that does not shard ``t``)."""
    from torch.distributed.tensor import Shard
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if not isinstance(p, Shard))


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scales the float32 ``grads`` in place by min(1, max_norm / their
    global norm) and returns them with that norm.  DTensor gradients (on
    one mesh) count each block once: a replicated block is summed by one
    of the ranks that hold it, and the ranks' sums are all-reduced over
    every mesh dim."""
    sq = [torch.linalg.vector_norm(local(g), dtype=torch.float32) ** 2
          for g in grads]
    sharded = [g for g in grads if is_sharded(g)]
    if sharded:
        import torch.distributed as dist
        sq = [s if not is_sharded(g) or _owns(g) else torch.zeros_like(s)
              for s, g in zip(sq, grads)]
        total = torch.stack(sq).sum()
        mesh = sharded[0].device_mesh
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
        gnorm = torch.sqrt(total)
    else:
        gnorm = torch.sqrt(torch.stack(sq).sum())
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    for g in grads:
        local(g).mul_(scale)
    return grads, gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, Optional[torch.Tensor]], state: dict
                 ) -> tuple[Mapping[str, torch.Tensor], dict, dict]:
    """One AdamW step: the masters ``params`` and the moments of
    ``state`` are updated in place and returned, with ``{"lr",
    "grad_norm"}`` (float32 tensors; the norm 0 without clipping).  A
    gradient of None counts as zeros, as an unused parameter's gradient
    is in JAX; the gradients are clipped in place.  On a mesh each
    gradient is placed as its master and every rank updates its local
    shards."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    names = list(params)
    grads = [_placed_like(params[n], grads[n].float())
             if grads[n] is not None
             else torch.zeros_like(params[n], dtype=torch.float32)
             for n in names]
    gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for n, g in zip(names, grads):
        wd = params[n].ndim >= 2
        p, m, v = (local(t) for t in (params[n], state["m"][n],
                                       state["v"][n]))
        g = local(g)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if wd:   # decay matrices only (per-layer vectors exempt)
            delta.add_(cfg.weight_decay * p)
        p.sub_(delta.mul_(lr))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "lr": lr, "grad_norm": gnorm}


def _placed_like(p, g):
    """Gradient ``g``, which on a mesh must be placed as its master ``p``:
    the update works on the local shards (``train_step`` places a
    replicated master's partial-sum gradient)."""
    if is_sharded(g) and g.placements != p.placements:
        raise ValueError(f"gradient placed {g.placements}, its master "
                         f"{p.placements}")
    return g
