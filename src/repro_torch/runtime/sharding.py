"""Placement rules, the counterpart of ``repro.runtime.sharding``.

The mining side: ``partition_block``, the placement rule of the mining
stores across workers.  The OL and edge-OL stores are partition-major
(dim 0 is the graph-partition axis), blocked over the workers.  Worker
``r`` of ``W`` holds the contiguous block ``[r·NP/W, (r+1)·NP/W)``, so
worker order IS partition order and the level wire's per-worker support
shards reassemble by plain concatenation.  The upload, the checkpoint
save and the resume all use this one rule.

The LM side: FSDP + tensor parallelism over a named
``torch.distributed.device_mesh.DeviceMesh`` whose axes are
``("data", "model")`` or ``("pod", "data", "model")``:

  "model"          tensor parallelism: attention heads / ffn hidden /
                   vocab / experts
  "data" (+"pod")  data parallelism over the batch AND the FSDP shard
                   axis of the masters and AdamW moments (ZeRO-3: each
                   unit's weights are gathered over these axes at their
                   use, ``gather_for_compute``)

A spec is ``repro``'s PartitionSpec as a tuple: one entry per tensor
dim, None, an axis name, or a tuple of axis names (major first).  The
rules are ``repro``'s regex table over ``repro``'s parameter paths
(``registry.jax_layout`` gives each of the port's per-layer parameters
its path and stacked shape), so every spec equals ``repro``'s with the
leading ``(repeat,)`` entry dropped.  ``placements`` turns a spec into
DTensor placements (``Shard(d)`` on each mesh dim that the entry of
tensor dim ``d`` names, ``Replicate()`` elsewhere), ``redistribute``
plays the part of ``with_sharding_constraint``.

The mesh functions take a ``DeviceMesh`` or any object with
``axis_names`` and a ``shape`` mapping from axis name to size (the
tables need no devices).
"""
from __future__ import annotations

import collections
import contextlib
import math
import re
from typing import Any, Mapping, Optional

import torch

__all__ = ["partition_block", "fsdp_axes", "logical_rules", "param_specs",
           "compute_specs", "batch_specs", "cache_spec", "cache_specs",
           "placements", "place", "place_model", "active_mesh",
           "current_mesh", "mesh_scope", "shard_hint", "gather_for_compute",
           "mesh_axes", "is_sharded", "local", "cache_zeros", "write_seq",
           "place_cache", "as_residual", "keep_grad_layout", "local_over"]


def partition_block(n_partitions: int, rank: int, n_workers: int) -> slice:
    """The slice of the partition axis that worker ``rank`` of
    ``n_workers`` holds; raises unless the partitions divide evenly."""
    if n_partitions % n_workers:
        raise ValueError(f"{n_partitions} partitions do not divide over "
                         f"{n_workers} workers")
    if not 0 <= rank < n_workers:
        raise ValueError(f"rank {rank} outside [0, {n_workers})")
    per = n_partitions // n_workers
    return slice(rank * per, (rank + 1) * per)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> dict[str, int]:
    """The mesh's axis names, in order, with their sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _size(axes: dict[str, int], names) -> int:
    return math.prod(axes[a] for a in names)


def fsdp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes (pod+data on multi-pod meshes)."""
    return tuple(a for a in mesh_axes(mesh) if a != "model")


_ACTIVE_MESH: list = [None]


class active_mesh:
    """Context manager under which the model code's ``shard_hint`` and
    ``gather_for_compute`` act on ``mesh`` (no-ops with None: the
    unsharded path runs the same code unchanged)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()


def current_mesh():
    """The innermost ``active_mesh``'s mesh, None outside one."""
    return _ACTIVE_MESH[-1]


@contextlib.contextmanager
def mesh_scope():
    """Under an active mesh, DTensor's implicit replication: the plain
    tensors a module makes (positions, masks, zeros) act as replicated
    DTensors beside the sharded activations.  ``train_step`` enters it
    around the forward and the backward pass (the backward of an op keeps
    its plain operands), and every function that ``remat`` may recompute
    enters it again.  Nothing without a mesh; nested scopes keep the
    outermost."""
    from torch.distributed.tensor import DTensor
    if (current_mesh() is None
            or DTensor._op_dispatcher._allow_implicit_replication):
        yield       # no mesh, or an outer scope holds it
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def logical_rules(mesh) -> list[tuple[str, tuple]]:
    """(path-regex, spec), ``repro``'s table rule for rule.  Regexes are
    matched against '/'-joined ``repro`` parameter paths like
    'group_0/0/attn/wq'."""
    dp = fsdp_axes(mesh)          # e.g. ("data",) or ("pod", "data")
    m = "model"
    return [
        # embeddings / lm head: vocab on model, d_model on fsdp
        (r"embed$", (m, dp)),
        (r"lm_head$", (dp, m)),
        # attention: heads on model, d_model on fsdp
        (r"attn/wq$", (dp, m, None)),
        (r"attn/wk$", (dp, m, None)),
        (r"attn/wv$", (dp, m, None)),
        (r"attn/wo$", (m, None, dp)),
        (r"attn/b[qkv]$", (m, None)),
        # MLA: lora dims on model where possible
        (r"attn/w_dkv$", (dp, m)),
        (r"attn/w_kr$", (dp, None)),
        (r"attn/w_uk$", (None, m, None)),
        (r"attn/w_uv$", (None, m, None)),
        (r"attn/w_dq$", (dp, m)),
        (r"attn/w_uq$", (None, m, None)),
        # dense mlp: hidden on model
        (r"mlp/w_(up|gate)$", (dp, m)),
        (r"mlp/w_down$", (m, dp)),
        # MoE: expert parallelism (experts on model), fsdp inside expert
        (r"moe/router$", (dp, None)),
        (r"moe/w_(up|gate)$", (m, dp, None)),
        (r"moe/w_down$", (m, dp, None)),
        (r"moe/shared/w_(up|gate)$", (dp, m)),
        (r"moe/shared/w_down$", (m, dp)),
        # mamba2: inner channels on model
        (r"mixer/w_in$", (dp, m)),
        (r"mixer/w_out$", (m, dp)),
        (r"mixer/conv$", (None, m)),
        # xlstm
        (r"mixer/w(q|k|v)$", (dp, m, None)),
        (r"mixer/wo$", (m, None, dp)),
        (r"mixer/ogate$", (dp, m, None)),
        (r"mixer/w_zifo$", (dp, None, m, None)),
        (r"mixer/r_zifo$", (None, m, None, None)),
        # shared attention (zamba2) — same as attn
        (r"shared_attn/wq$", (dp, m, None)),
        (r"shared_attn/wk$", (dp, m, None)),
        (r"shared_attn/wv$", (dp, m, None)),
        (r"shared_attn/wo$", (m, None, dp)),
        # No head_dim fallbacks: an arch whose head count does not
        # divide the model axis keeps its attention weights
        # model-replicated (dp-sharded storage, gathered at use), as in
        # repro.
    ]


def _entry_axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _fit(spec: tuple, shape, axes: dict[str, int]) -> tuple:
    """Drop axis assignments that don't divide the dim (tiny smoke shapes
    or head counts < mesh axis)."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = _size(axes, _entry_axes(ax))
        out.append(ax if dim % size == 0 and dim >= size else None)
    return tuple(out)


def _spec_for(path_str: str, shape, rules, axes: dict[str, int]) -> tuple:
    """Best-fitting matching rule: rules are tried in order and the first
    one that survives `_fit` with the most sharded dims wins; () when
    none shards a dim."""
    ndim = len(shape)
    best, best_n = (), 0
    for rx, spec in rules:
        if not re.search(rx, path_str):
            continue
        extra = ndim - len(spec)    # group-stacked leading (repeat,) dim
        if extra < 0:
            continue
        fitted = _fit((None,) * extra + tuple(spec), shape, axes)
        n = sum(1 for p in fitted if p is not None)
        if n > best_n:
            best, best_n = fitted, n
    return best


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg, params, mesh) -> dict[str, tuple]:
    """The storage spec of each of the port's parameters (a model, or a
    mapping from its parameter names to tensors of their shapes):
    ``repro``'s spec of the same leaf at its stacked shape, less the
    leading ``(repeat,)`` entry for a per-layer tensor."""
    from ..models.registry import jax_layout
    named = _named(params)
    layout = jax_layout(cfg, named)
    repeats = collections.Counter(path for path, index in layout.values()
                                  if index is not None)
    rules = logical_rules(mesh)
    axes = mesh_axes(mesh)
    out = {}
    for name, (path, index) in layout.items():
        shape = tuple(named[name].shape)
        if index is not None:
            shape = (repeats[path],) + shape
        spec = _spec_for("/".join(map(str, path)), shape, rules, axes)
        out[name] = spec[1:] if index is not None else spec
    return out


def _strip(spec: tuple, dp) -> tuple:
    out = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, str):
            out.append(None if part in dp else part)
        else:
            kept = tuple(a for a in part if a not in dp)
            out.append(kept if kept else None)
    return tuple(out)


def compute_specs(cfg, params, mesh) -> dict[str, tuple]:
    """Use-site (ZeRO-3 'gathered') specs: the storage spec with the dp
    axes stripped — weights stay TP-sharded on 'model' but are gathered
    over the fsdp axes for the matmul."""
    dp = set(fsdp_axes(mesh))
    return {n: _strip(s, dp) for n, s in param_specs(cfg, params,
                                                      mesh).items()}


def batch_specs(cfg, mesh, batch: Mapping[str, Any]) -> dict[str, tuple]:
    """Batch arrays: leading batch dim over the DP axes (replicated when
    the batch doesn't divide, e.g. long_500k's batch=1); ``positions3``
    (3, B, S) on its axis 1."""
    axes = mesh_axes(mesh)
    dp = fsdp_axes(mesh)
    dp_size = _size(axes, dp)
    out = {}
    for name, leaf in batch.items():
        shp = tuple(leaf.shape)
        if name == "positions3":
            ok = shp[1] % dp_size == 0 and shp[1] >= dp_size
            out[name] = (None, dp if ok else None, None)
            continue
        ok = shp[0] % dp_size == 0 and shp[0] >= dp_size
        out[name] = (dp if ok else None,) + (None,) * (len(shp) - 1)
    return out


def _cache_spec(name: str, shp: tuple, axes: dict[str, int], dp) -> tuple:
    """``repro``'s rule for one per-layer cache leaf (B, ...): the
    indices are ``repro``'s less the leading (repeat,) dim."""
    dp_size = _size(axes, dp)
    msize = axes["model"]
    parts: list = [None] * len(shp)
    is_kv = name in ("k", "v", "ckv", "kr")
    if len(shp) < 1:
        return tuple(parts)
    batch_ok = shp[0] % dp_size == 0 and shp[0] >= dp_size
    if batch_ok:
        parts[0] = dp
    if is_kv and len(shp) >= 2:
        seq_axes: list = []
        if not batch_ok:
            seq_axes.extend(dp)
        heads_ok = len(shp) >= 3 and shp[2] % msize == 0 and shp[2] >= msize
        if heads_ok:
            parts[2] = "model"
        else:
            seq_axes.append("model")
        if seq_axes:
            size = _size(axes, seq_axes)
            if shp[1] % size == 0 and shp[1] >= size:
                parts[1] = tuple(seq_axes)
    elif len(shp) >= 2 and shp[1] % msize == 0 and shp[1] >= msize:
        parts[1] = "model"      # recurrent state: heads on model
    return tuple(parts)


def cache_spec(name: str, shape, mesh) -> tuple:
    """The spec of one per-layer cache leaf ``name`` of ``shape`` (B,
    ...) on ``mesh``: ``cache_specs``' rule for a single leaf."""
    return _cache_spec(name, tuple(shape), mesh_axes(mesh), fsdp_axes(mesh))


def cache_specs(cfg, mesh, caches: list) -> list:
    """Decode-cache sharding of the port's per-block caches (a list, one
    dict or None per block), ``repro``'s rule less the stacked dim.

    KV caches (leaves named k/v/ckv/kr; layout (B, T, ...)):
      * batch over DP when divisible, else the SEQUENCE dim takes DP
        (context-parallel decode — the long_500k batch=1 case);
      * kv-heads dim over "model" when divisible, else "model" also
        lands on the sequence dim.
    Recurrent states (ssm/mlstm/slstm): batch over DP, heads over model.
    """
    return [None if c is None else
            {k: cache_spec(k, v.shape, mesh) for k, v in c.items()}
            for c in caches]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that the entry of tensor dim ``d`` names, ``Replicate()``
    on the others and on every axis of size 1 (one block is the whole
    dim).  An entry naming several axes must name them in the mesh's
    order (major first), which is DTensor's order of nested shards."""
    from torch.distributed.tensor import Replicate, Shard
    axes = mesh_axes(mesh)
    names = list(axes)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]} used twice in {spec}")
            if axes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def place(t: torch.Tensor, spec: tuple, mesh):
    """``t`` (the full tensor, the same on every rank) as a DTensor placed
    by ``spec``: each rank keeps its block, nothing moves between
    ranks."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def place_model(cfg, model: torch.nn.Module, mesh, *,
                data_replicated: bool = False) -> torch.nn.Module:
    """Replaces every parameter of ``model`` (its full values, drawn or
    loaded the same on every rank) by a DTensor parameter placed by
    ``param_specs`` (FSDP + tensor parallel), in place; returns the
    model.  ``data_replicated`` places them by ``compute_specs`` instead:
    tensor parallel only, each rank of a "model" group holding its
    whole share (the serving weights of ``repro``'s
    ``DRYRUN_DECODE_WEIGHTS=replicated``: no gather over the data axes
    at each use, for params·bytes/tp of memory on every rank)."""
    specs = (compute_specs if data_replicated else param_specs)(
        cfg, model, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod.register_parameter(attr, torch.nn.Parameter(
            place(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad))
    return model


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing it writes the DTensor),
    any other tensor itself."""
    return t.to_local() if is_sharded(t) else t


# ---------------------------------------------------------------------------
# use sites
# ---------------------------------------------------------------------------

def shard_hint(x, *dims: Any):
    """Constrain activation sharding.  ``dims`` entries: "dp" (the fsdp/
    batch axes), "model", None, or tuples thereof.  Axes that don't exist
    on the active mesh or don't divide the dim are dropped.  Returns
    ``x`` itself without an active mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    axes = mesh_axes(mesh)
    parts = []
    for dim_size, d in zip(x.shape, dims):
        if d is None:
            parts.append(None)
            continue
        if d == "dp":
            names = fsdp_axes(mesh)
        else:
            names = tuple(a for a in _entry_axes(d) if a in axes)
        if not names:
            parts.append(None)
            continue
        size = _size(axes, names)
        parts.append(names if dim_size % size == 0 and dim_size >= size
                     else None)
    return _redistribute(x, mesh, placements(tuple(parts), mesh))


class _Reduce(torch.autograd.Function):
    """``y.redistribute(mesh, want)`` for a ``y`` that holds partial
    sums, whose gradient is the incoming gradient placed as ``want`` too
    (reduced there when it arrives as partial sums): the gradient of a
    sum is the same for every one of its partial terms, so the incoming
    gradient's value is the gradient of ``y`` in any layout.  DTensor's
    own backward of a reduction hands on partial sums, and the products
    that receive them gather their weights whole, where ``repro``'s
    program (and Megatron's tensor-parallel layers) reduce the gradient
    once and keep every product on its shards."""

    @staticmethod
    def forward(ctx, y, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return y.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if any(p.is_partial() for p in grad.placements):
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None


def _redistribute(y, mesh, want):
    if list(y.placements) == list(want):
        return y
    if any(p.is_partial() for p in y.placements):
        return _Reduce.apply(y, mesh, tuple(want))
    return y.redistribute(mesh, want)


class _KeepGradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) != list(ctx.placements):
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def keep_grad_layout(t):
    """``t`` whose gradient comes back placed as ``t`` is (a DTensor on a
    mesh; ``t`` itself otherwise).  The loss gathers the vocab-sharded
    logits for its logsumexp, and DTensor would hand their gradient back
    whole, so that the head's weight gradient is computed over the whole
    vocabulary on every "model" rank; placed back as the logits were,
    each rank computes its vocabulary shard's."""
    return _KeepGradLayout.apply(t) if is_sharded(t) else t


def as_residual(y, x):
    """A sub-layer's output ``y`` placed as the residual stream ``x`` it
    is added to (on a mesh; ``y`` itself otherwise): the partial sums of
    a row-parallel product are reduced right there, as XLA's propagation
    and Megatron's row-parallel layer reduce them, instead of being
    carried on into the next sub-layer, where DTensor would choose
    layouts ``repro``'s program does not have."""
    if not (is_sharded(y) and is_sharded(x)):
        return y
    return _redistribute(y, x.device_mesh, x.placements)


def gather_for_compute(params: Mapping[str, torch.Tensor],
                       cast: Optional[torch.dtype] = None) -> dict:
    """ZeRO-3 use-site gather: every weight of ``params`` (a mapping from
    names to parameters) redistributed to its compute spec, the storage
    placements with the dp axes replicated (model-sharded only).
    Called inside each unit's body, so one unit's gathered weights are
    live at a time, and recomputed with it under remat.

    ``cast``: compute dtype applied to >=2-D float32 leaves BEFORE the
    gather, as ``repro`` does it: the gather moves the compute copy, not
    the float32 master; gradients flow back in float32 through the cast.

    Without an active mesh only the cast is done.  Under one, a leaf
    that is not a DTensor raises: the model was not placed."""
    from torch.distributed.tensor import Replicate
    mesh = current_mesh()
    dp = () if mesh is None else [a != "model" for a in mesh_axes(mesh)]
    out = {}
    for name, leaf in params.items():
        if (cast is not None and leaf.ndim >= 2
                and leaf.dtype == torch.float32):
            leaf = leaf.to(cast)
        if mesh is not None:
            if not is_sharded(leaf):
                raise ValueError(f"{name} is not placed on the active mesh")
            want = [Replicate() if d else p
                    for d, p in zip(dp, leaf.placements)]
            if want != list(leaf.placements):
                leaf = leaf.redistribute(mesh, want)
        out[name] = leaf
    return out


# ---------------------------------------------------------------------------
# decode caches on a mesh
# ---------------------------------------------------------------------------

def cache_zeros(name: str, shape, dtype, like: torch.Tensor
                ) -> torch.Tensor:
    """A zero cache leaf ``name`` of global ``shape``, made as ``like``
    (an activation) is made: on its device, and fake when it is fake
    (the dry run).  Under an active mesh a DTensor placed by
    ``cache_spec``, each rank making only its block."""
    mesh = current_mesh()
    if mesh is None:
        return local(like).new_zeros(tuple(shape), dtype=dtype)
    from torch.distributed.tensor import DTensor
    place_ = placements(cache_spec(name, shape, mesh), mesh)
    block = list(shape)
    for i, p in enumerate(place_):
        if p.is_shard():
            block[p.dim] //= mesh.size(i)
    return DTensor.from_local(local(like).new_zeros(block, dtype=dtype),
                              mesh, place_, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``; a plain tensor is the full value,
    the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_sharded(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def write_seq(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos:pos + S] = new`` in place (``new`` (B, S, ...)).  On
    a mesh each rank writes the part of ``new`` that falls in its own
    block of the cache: ``new`` is moved to the cache's placements (its
    sequence axis whole), and where the cache's sequence axis is sharded
    (context-parallel decode) only the rank whose block holds a position
    writes it."""
    S = new.shape[1]
    if not is_sharded(cache):
        cache[:, pos:pos + S] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    want = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    part = _as_dtensor(new, mesh).redistribute(mesh, want).to_local()
    block = cache.to_local()
    index = 0               # this rank's block of the sequence axis
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):
            index = index * mesh.size(i) + mesh.get_local_rank(i)
    T = block.shape[1]
    lo, hi = max(pos, index * T), min(pos + S, (index + 1) * T)
    if lo < hi:
        block[:, lo - index * T:hi - index * T] = \
            part[:, lo - pos:hi - pos].to(block.dtype)


def place_cache(cache: Optional[dict]) -> Optional[dict]:
    """A block's cache (a dict of leaves, or None) with each leaf placed
    by ``cache_spec`` under an active mesh (a leaf already so placed is
    kept, so a cache written in place stays the caller's); ``cache``
    itself without one."""
    mesh = current_mesh()
    if mesh is None or cache is None:
        return cache
    out = {}
    for name, leaf in cache.items():
        leaf = _as_dtensor(leaf, mesh)
        want = placements(cache_spec(name, leaf.shape, mesh), mesh)
        out[name] = (leaf if list(leaf.placements) == want
                     else leaf.redistribute(mesh, want))
    return out


def local_over(fn, args, dims, out_dims):
    """``fn(*args)`` on DTensors run on each rank's own blocks, for a
    function independent per batch row and per head (or expert):
    ``dims[i]`` gives arg ``i``'s (batch axis, head axis), either None;
    ``out_dims`` each output's, whose head axis may be "partial": an
    output summed over the heads, left as each rank's partial sum.  The
    batch axis goes over the data axes when they divide it, the head
    axis over "model" when it divides the heads (the first arg's with a
    head axis), replicated otherwise.  No collective
    runs inside (the backward reduces the gradient of an arg that every
    share of the work used); plain tensors (no mesh) call ``fn`` as it
    is."""
    if not any(is_sharded(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(a for a in args if is_sharded(a)).device_mesh
    names = mesh.mesh_dim_names
    dp = math.prod(mesh.size(j) for j, a in enumerate(names)
                   if a != "model")
    B = next(a.shape[d[0]] for a, d in zip(args, dims) if d[0] is not None)
    H = next((a.shape[d[1]] for a, d in zip(args, dims)
              if d[1] is not None), 1)

    def want(b, h):
        out = []
        for j, a in enumerate(names):
            n = mesh.size(j)
            if n == 1:
                out.append(Replicate())
            elif a == "model":
                out.append(Replicate() if h is None or H % n else
                           Partial() if h == "partial" else Shard(h))
            else:
                out.append(Shard(b) if b is not None and B % dp == 0
                           else Replicate())
        return out

    # an arg replicated on a mesh axis that the call splits is used by
    # every rank's share of the work: its gradient there is a partial sum
    places = [want(*d) for d in dims]
    split = {j for p in places for j, q in enumerate(p) if q.is_shard()}
    loc = [_as_dtensor(a, mesh).redistribute(mesh, p).to_local(
               grad_placements=[Partial() if j in split and q.is_replicate()
                                else q for j, q in enumerate(p)])
           for a, p in zip(args, places)]
    outs = fn(*loc)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    res = tuple(DTensor.from_local(o, mesh, want(*d), run_check=False)
                for o, d in zip(outs, out_dims))
    return res[0] if single else res
