"""Per-rank cost counter of one eager step, the counterpart of
``repro.roofline.hlo`` (which walks the compiled per-device HLO).

PyTorch runs eagerly, so the port counts a step while it runs: a
``TorchDispatchMode`` sees every aten op the step issues on this rank.
An op on DTensors is passed on (the mode returns ``NotImplemented``) to
DTensor, which runs it as ops on each rank's local shards and as
collectives, and those come back through the mode: so every figure is
this rank's, counted on its local shards.  (A mode that counted the
DTensor-level op would count the global product: a (256, 4096) @ (4096,
4096) product over a 16×16 mesh is 8.59e9 FLOPs globally.)  The ops
that DTensor's sharding propagation runs on fake tensors of the global
shapes, to learn an output's shape, are skipped.

  * matmul FLOPs: ``torch.utils.flop_counter``'s formulas (mm, bmm,
    addmm, baddbmm, convolutions, the attention ops) on the local
    shapes;
  * HBM-traffic proxy: Σ (operand + output bytes) over every aten op
    that is not a view, an upper bound as ``repro``'s instruction walk
    is (nothing is fused in eager mode, so it is the bytes the eager
    step really moves, counting each op's reads and writes);
  * collectives: DTensor's functional collectives (all-gather,
    all-reduce, reduce-scatter, all-to-all) and the c10d ones
    (``launch.mesh.c10d_collectives`` routes DTensor through them), each
    with its group's size and global ranks; wire bytes are the payload
    times ``_wire_factor`` (``repro``'s ring factors), and its seconds
    the wire bytes over ``hw.link_bw`` of its group (NVLink inside a
    node, the inter-node rate across nodes);
  * peak live bytes of the tensors the step makes (``LiveBytes``), the
    counterpart of ``memory_analysis()``'s temp size.

``repro``'s ``unknown_trip_whiles`` has no subject here: an eager step
unrolls every loop as it runs, so each trip is counted.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import traceback
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .hw import DTYPE_BYTES, link_bw

__all__ = ["StepCost", "LiveBytes", "CostCounter", "count_step",
           "_wire_factor", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


# wire-byte multiplier per payload byte for a ring algorithm over N chips
def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0          # collective-permute


@dataclasses.dataclass
class StepCost:
    """One rank's cost of one step.  ``collectives`` maps a kind to
    ``{"count", "payload_bytes", "wire_bytes", "seconds"}``;
    ``by_op`` an aten op's name to ``[calls, flops, bytes]``."""
    flops: float = 0.0
    bytes_hbm: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_payload_bytes: float = 0.0
    collective_seconds: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    collectives_by_site: dict = dataclasses.field(default_factory=dict)
    n_matmuls: int = 0
    peak_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)

    def top_sites(self, n: int = 12) -> list[tuple[str, float]]:
        return sorted(self.collectives_by_site.items(),
                      key=lambda kv: -kv[1])[:n]

    def op_listing(self) -> str:
        """The per-op listing, by FLOPs then bytes, one line each."""
        rows = sorted(self.by_op.items(), key=lambda kv: (-kv[1][1],
                                                          -kv[1][2]))
        return "\n".join(f"{name}\tcalls={c}\tflops={f:.6e}\tbytes={b:.6e}"
                         for name, (c, f, b) in rows)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class LiveBytes:
    """Bytes of the storages that the tensors made under the counter
    hold, while any of those tensors lives, and their peak.  A storage
    is charged once however many views of it live.  Tensors that
    autograd makes in C++ without an aten call are not seen."""

    def __init__(self):
        self.live = self.peak = 0
        self._refs: dict[int, list] = {}

    @staticmethod
    def key(t: torch.Tensor):
        """The id of ``t``'s storage, None when it has none."""
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return None

    def add(self, t: torch.Tensor, made: bool = True) -> None:
        """Count ``t`` live while it lives; ``made`` is False for a view
        or an in-place result, whose storage counts only when the
        counter saw it made."""
        key = self.key(t)
        if key is None:
            return
        ref = self._refs.get(key)
        if ref is None and not made:
            return
        if ref is None:
            st = t.untyped_storage()
            ref = self._refs[key] = [0, st.nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]


_SKIP = {"aten.detach", "aten.lift_fresh", "aten.lift_fresh_copy",
         "prim.device", "aten.empty", "aten.empty_strided",
         "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
         "aten.arange", "aten.sym_size", "aten.sym_stride",
         "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size",
         "_c10d_functional.wait_tensor", "c10d.barrier",
         "aten._local_scalar_dense"}


def _group_ranks(group) -> list[int]:
    """The global ranks of a collective's group: a registered group's
    name (functional collectives) or the process group itself."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):     # a c10d op's argument
        group = dist.ProcessGroup.unbox(group)
    return list(dist.get_process_group_ranks(group))


def _collective(name: str, args, kwargs, out):
    """(kind, payload bytes, group ranks) of a collective op, None for
    any other op.  The payload is the gathered output of an all-gather
    and the whole input of the other kinds, as ``repro`` counts it."""
    ns, _, op = name.partition(".")
    kw = dict(kwargs)
    if ns == "_c10d_functional":
        kind = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}.get(op.rstrip("_"))
        if kind is None:
            return None
        group = args[-1] if isinstance(args[-1], str) else kw["group_name"]
        src = out if kind == "all-gather" else args[0]
    elif ns == "c10d":
        table = {"allreduce_": ("all-reduce", 0, 1),
                 "allreduce_coalesced_": ("all-reduce", 0, 1),
                 "_allgather_base_": ("all-gather", 0, 2),
                 "allgather_": ("all-gather", 0, 2),
                 "allgather_into_tensor_coalesced_": ("all-gather", 0, 2),
                 "_reduce_scatter_base_": ("reduce-scatter", 1, 2),
                 "reduce_scatter_": ("reduce-scatter", 1, 2),
                 "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1,
                                                      2),
                 "alltoall_base_": ("all-to-all", 1, 2),
                 "broadcast_": ("collective-permute", 0, 1)}
        if op not in table:
            return None
        kind, data, pg = table[op]
        group, src = args[pg], args[data]
    else:
        return None
    payload = sum(_nbytes(t) for t in _tensors(src))
    return kind, payload, _group_ranks(group)


def _site() -> str:
    """The innermost frame of the port's model, train or optim code that
    issued a collective (file:line function)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    skip = (os.path.join(here, "runtime", "sharding.py"),
            os.path.join(here, "launch", "mesh.py"),
            os.path.join(here, "roofline"))
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(here) and not fr.filename.startswith(
                skip):
            rel = os.path.relpath(fr.filename, here)
            return f"{rel}:{fr.lineno} {fr.name}"
    return "?"


class CostCounter(TorchDispatchMode):
    """Counts each aten op this rank runs into ``self.cost`` (a
    ``StepCost``) and the live bytes of the tensors it makes into
    ``self.live``.  ``fake_mode``: the ``FakeTensorMode`` the step runs
    under, if any: fake tensors of any other mode (DTensor's sharding
    propagation) are not the step's work."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        self._fake, self._mode = FakeTensor, fake_mode
        self._flops = flop_registry
        self.cost = StepCost()
        self.live = LiveBytes()

    def _foreign(self, tensors) -> bool:
        """Whether the op is not the step's: fake tensors of another
        mode, or an op that DTensor's sharding propagation runs (on fake
        tensors of the global shapes, under the step's own fake mode
        when it has one) to learn an output's shape."""
        if any(isinstance(t, self._fake) and t.fake_mode is not self._mode
               for t in tensors):
            return True
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.endswith("_sharding_prop.py"):
                return True
            f = f.f_back
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if self._foreign(ins):
            return out
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") \
            else str(func)
        outs = _tensors(out)
        c = self.cost
        coll = _collective(name, args, kwargs, out)
        if coll is not None:
            kind, payload, ranks = coll
            wire = payload * _wire_factor(kind, max(len(ranks), 2))
            c.collective_payload_bytes += payload
            c.collective_wire_bytes += wire
            c.collective_seconds += wire / link_bw(ranks) if wire else 0.0
            e = c.collectives.setdefault(kind, {
                "count": 0, "payload_bytes": 0.0, "wire_bytes": 0.0,
                "seconds": 0.0})
            e["count"] += 1
            e["payload_bytes"] += payload
            e["wire_bytes"] += wire
            e["seconds"] += wire / link_bw(ranks) if wire else 0.0
            site = f"{kind} {_site()}"
            c.collectives_by_site[site] = (
                c.collectives_by_site.get(site, 0.0) + wire)
        flops = 0.0
        packet = getattr(func, "_overloadpacket", None)
        if packet in self._flops:
            flops = float(self._flops[packet](*args, **kwargs, out_val=out))
            c.flops += flops
            c.n_matmuls += 1
        nbytes = 0
        if name not in _SKIP and not getattr(func, "is_view", False):
            nbytes = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
            c.bytes_hbm += nbytes
        row = c.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        view = getattr(func, "is_view", False)
        seen = {LiveBytes.key(t) for t in ins}
        for t in outs:
            self.live.add(t, made=not view and LiveBytes.key(t) not in seen)
        return out


def count_step(fn: Callable, *args, fake_mode=None, **kwargs
               ) -> tuple[Any, StepCost]:
    """``fn(*args, **kwargs)`` run once under a ``CostCounter``: its
    result and this rank's ``StepCost`` (``peak_bytes`` the peak live
    bytes of the tensors the step made)."""
    counter = CostCounter(fake_mode)
    with counter:
        out = fn(*args, **kwargs)
    counter.cost.peak_bytes = counter.live.peak
    return out, counter.cost
