"""Device meshes, the counterpart of ``repro.launch.mesh``: a named
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, rank ``r`` at the row-major position ``r`` (``repro``'s device
order).

single pod : (16, 16)    -> ("data", "model")
multi-pod  : (2, 16, 16) -> ("pod", "data", "model")

The process group comes first: ``torch.distributed.init_process_group``
with its address, world size and rank (NCCL with one rank per card;
gloo where several ranks share a card or run on the CPU).  Defined as
functions, so importing this module touches no device.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from ..models.registry import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "worker_count",
           "c10d_collectives"]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, device=None):
    """The mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    ranks of the default process group, on ``device`` (the card unless
    the caller names the CPU).  Every rank of the group calls it; raises
    when the group has fewer ranks than the mesh, or none, and for a
    gloo group on the card outside ``c10d_collectives()``."""
    from torch.distributed.device_mesh import DeviceMesh
    device = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the process group has {have} — "
            f"start {n} ranks and call torch.distributed."
            f"init_process_group first")
    if (device.type == "cuda" and dist.get_backend() == "gloo"
            and not _routed()):
        raise RuntimeError(
            "a gloo mesh on the card needs DTensor's collectives routed "
            "through c10d: build and use it inside "
            "repro_torch.launch.mesh.c10d_collectives()")
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _group(group):
    """The process group of a functional collective's ``group``
    argument: a (DeviceMesh, mesh dim) pair, a 1-D DeviceMesh or a
    group."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if hasattr(group, "get_group"):
        return group.get_group()
    if isinstance(group, str):              # a registered group's name
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group)
    return group


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    pg = _group(group)
    n = dist.get_world_size(pg)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    return out if dim == 0 else torch.cat(out.chunk(n, 0), dim)


def _all_gather(self, gather_dim, group, tag=""):
    return _gather(self, gather_dim, group)


def _op(name):
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[str(name).lower()]


def _all_reduce(self, reduceOp, group, tag=""):
    pg = _group(group)
    out = self.clone()
    dist.all_reduce(out, op=_op(reduceOp), group=pg)
    if str(reduceOp).lower() == "avg":
        out = out / dist.get_world_size(pg)
    return out


def _reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
    pg = _group(group)
    n = dist.get_world_size(pg)
    x = self if scatter_dim == 0 else torch.cat(
        self.chunk(n, scatter_dim), 0)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=_op(reduceOp), group=pg)
    if str(reduceOp).lower() == "avg":
        out = out / n
    return out


def _all_to_all(self, output_split_sizes, input_split_sizes, group,
                tag=""):
    pg = _group(group)
    x = self.contiguous()
    rows = (sum(output_split_sizes) if output_split_sizes is not None
            else x.shape[0])
    out = x.new_empty((rows, *x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes, input_split_sizes,
                           group=pg)
    return out


_ROUTED = {"all_gather_tensor": _all_gather, "all_reduce": _all_reduce,
           "reduce_scatter_tensor": _reduce_scatter,
           "all_to_all_single": _all_to_all}


def _routed() -> bool:
    import torch.distributed._functional_collectives as funcol
    return all(getattr(funcol, n) is f for n, f in _ROUTED.items())


@contextlib.contextmanager
def c10d_collectives():
    """Inside it, DTensor's functional collectives (all-gather,
    all-reduce, reduce-scatter, all-to-all) are the blocking c10d
    collectives, for this process; on leaving, the functional ones are
    back.  Under gloo with CUDA tensors (several ranks sharing one card)
    torch 2.11's functional all-gather crashes the process, while
    ``dist.all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_to_all_single`` work, as the miner's gloo ranks on one card
    use them.  The values are the same; each call waits for its
    result."""
    import torch.distributed._functional_collectives as funcol
    saved = {n: getattr(funcol, n) for n in _ROUTED}
    for n, f in _ROUTED.items():
        setattr(funcol, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(funcol, n, f)


def worker_count(mesh) -> int:
    return int(mesh.mesh.numel())
