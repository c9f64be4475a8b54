"""Architecture registry in plain PyTorch, the counterpart of
``repro.models.registry``: ``--arch <id>`` -> config + model functions.

``build(cfg, device=)`` returns the function set of every family: the
dense decoder, the VLM (qwen2-vl), mixture-of-experts, ssm (xlstm),
hybrid (zamba2) and encoder-decoder (whisper) families:
    init(generator) -> model                              [random init]
    loss_fn(model, batch) -> (loss, {"ce", "aux"})        [training]
    prefill(model, batch, max_len=None) -> (logits, cache)
    decode(model, cache, batch, pos) -> (logits, cache)

``build(cfg, masters=True)``'s ``init`` makes a model of float32
masters that take gradients (training); without it the matmul weights
are held in the compute dtype (serving).  ``params_from_jax`` loads the
JAX package's parameters (as numpy arrays) into the port's modules and
``params_to_jax`` gives them back in the JAX tree's layout (tests,
training checkpoints), so that the two packages can be held against
each other on the same weights and resume each other's runs.
"""
from __future__ import annotations

import importlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..runtime.sharding import (batch_specs, current_mesh, keep_grad_layout,
                                mesh_scope, place)
from .encdec import EncDec
from .transformer import LM, block_specs

ARCHS = [
    "whisper_base", "zamba2_2p7b", "granite_20b", "gemma2_2b", "minicpm_2b",
    "qwen2p5_14b", "deepseek_v2_lite", "phi3p5_moe", "xlstm_1p3b",
    "qwen2_vl_72b",
]

_ALIASES = {
    "whisper-base": "whisper_base", "zamba2-2.7b": "zamba2_2p7b",
    "granite-20b": "granite_20b", "gemma2-2b": "gemma2_2b",
    "minicpm-2b": "minicpm_2b", "qwen2.5-14b": "qwen2p5_14b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe", "xlstm-1.3b": "xlstm_1p3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

__all__ = ["ARCHS", "get_config", "get_smoke_config", "build",
           "count_params", "jax_layout", "leaves_from_jax", "list_archs",
           "model_class", "params_from_jax", "params_to_jax",
           "resolve_device", "stack_to_jax"]


def list_archs() -> list[str]:
    return list(ARCHS)


def _module(name: str):
    name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another; raises when CUDA is asked for and there is none."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{device} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------

def model_class(cfg) -> type:
    """The family's module: ``EncDec`` for the encoder-decoder family
    (whisper's ``audio``), ``LM`` for every other."""
    return EncDec if cfg.family in ("encdec", "audio") else LM


def count_params(cfg, active_only: bool = False) -> int:
    """Exact parameter count from the model's parameter shapes on the
    ``meta`` device (nothing is allocated).  ``active_only`` counts only
    top_k of the n_experts routed experts, by the JAX package's rule:
    the expert parameters are those under ``moe`` other than ``shared``
    and ``router``."""
    total = expert = 0
    for name, p in model_class(cfg)(cfg, device="meta").named_parameters():
        total += p.numel()
        keys = name.split(".")
        if "moe" in keys and "shared" not in keys and "router" not in keys:
            expert += p.numel()
    if active_only and cfg.n_experts:
        total -= int(expert * (1 - cfg.top_k / cfg.n_experts))
    return total


# the port's parameters that are norms: each is {"scale": ...} in the
# JAX tree
_NORMS = frozenset({"ln1", "ln2", "post_ln1", "post_ln2", "final_norm",
                    "kv_norm", "q_norm", "norm"})


def jax_layout(cfg, names) -> dict[str, tuple[tuple, Optional[int]]]:
    """Where each of the port's parameter ``names`` sits in the JAX
    ``init_lm`` (``init_encdec``) tree: ``(path, index)``, the keys from
    the root (strings, and the sub-layer's position in a ``group_{gi}``
    list) and the index into the leaf's leading stacked axis (a block's
    repeat, an encoder layer), None for an unstacked leaf.  The one
    mapping of ``params_from_jax`` and ``params_to_jax``."""
    specs = block_specs(cfg)
    out = {}
    for name in names:
        keys = name.split(".")
        index = None
        if keys[0] == "layers":
            gi, r, li, _, _ = specs[int(keys[1])]
            path, index = (f"group_{gi}", li, *keys[2:]), r
        elif keys[:2] == ["encoder", "layers"]:
            path, index = ("encoder", "layers", *keys[3:]), int(keys[2])
        else:
            path = tuple(keys)
        if keys[-1] in _NORMS:
            path += ("scale",)
        out[name] = (path, index)
    return out


def _leaf_paths(tree, prefix=()):
    """The key paths of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items for p in _leaf_paths(v, prefix + (k,))]


def leaves_from_jax(cfg, tree, names) -> dict[str, np.ndarray]:
    """The arrays of the JAX tree ``tree`` that ``jax_layout`` places at
    the port's parameter ``names`` (a stacked leaf indexed at the
    block's repeat or the encoder layer); raises when a JAX leaf has no
    counterpart or a name has no JAX leaf."""
    layout = jax_layout(cfg, names)
    used = {path for path, _ in layout.values()}
    extra = [p for p in _leaf_paths(tree) if p not in used]
    if extra:
        raise KeyError(f"JAX parameters {extra} have no counterpart")
    out = {}
    for name, (path, index) in layout.items():
        node = tree
        try:
            for k in path:
                node = node[k]
        except (KeyError, IndexError) as e:
            raise KeyError(f"no JAX parameter {path} for {name}") from e
        arr = np.asarray(node)
        out[name] = arr if index is None else arr[index]
    return out


def params_from_jax(cfg, tree, *, device, masters: bool = False) -> LM:
    """The port's model holding the JAX ``init_lm`` (``init_encdec``)
    parameters ``tree`` (numpy arrays, or anything ``np.asarray``
    takes), placed by ``jax_layout``: each ``group_{gi}`` leaf's leading
    ``(repeat,)`` axis is unstacked into the blocks, and
    ``encoder.layers``' leading ``(encoder_layers,)`` axis into the
    encoder's layers.  For serving the matmul weights are held in
    ``cfg.dtype``, cast from the float32 masters as the JAX code casts
    them at each use; norm scales, biases, the MoE router, xLSTM's gate
    and recurrent weights and Mamba2's ``A_log``/``D``/``dt_bias`` stay
    float32.  With ``masters`` every parameter is a float32 master that
    takes a gradient (training).  The hybrid family's top-level
    ``shared_attn`` fills the LM's one shared attention."""
    model = model_class(cfg)(cfg, device="meta", masters=masters).to_empty(
        device=device)
    want = dict(model.named_parameters())
    arrays = leaves_from_jax(cfg, tree, want)
    with torch.no_grad():
        for name, p in want.items():
            src = torch.from_numpy(np.array(arrays[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)}, "
                                 f"port {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def params_to_jax(cfg, params) -> dict:
    """The inverse of ``params_from_jax``: the JAX ``init_lm``
    (``init_encdec``) tree of ``params`` (a model, or a mapping from its
    parameter names to tensors of their shapes: gradients, optimizer
    moments) as float32 numpy arrays, the blocks stacked back into
    ``group_{gi}`` lists of sub-layer dicts and the encoder layers into
    ``encoder.layers``.  DTensors (a model placed on a mesh) are
    gathered to their full values: every rank of the mesh calls it."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())

    def numpy(t):
        t = t.detach()
        if isinstance(t, DTensor):      # placed on a mesh: gather
            t = t.full_tensor()
        return t.to("cpu", torch.float32).numpy()

    return stack_to_jax(cfg, {n: numpy(t) for n, t in params.items()},
                        np.stack)


def stack_to_jax(cfg, leaves: dict, stack: Callable) -> dict:
    """The JAX tree of the port's per-layer ``leaves`` (a mapping from
    parameter names to arrays): each stacked leaf is ``stack`` of its
    blocks' arrays in repeat order (``np.stack`` for numpy, ``torch.stack``
    for tensors, ``meta`` ones included)."""
    stacks: dict[tuple, dict] = {}
    for name, (path, index) in jax_layout(cfg, leaves).items():
        stacks.setdefault(path, {})[index] = leaves[name]
    tree: dict = {}
    for path, parts in stacks.items():
        if None in parts:
            leaf = parts[None]
        else:
            if sorted(parts) != list(range(len(parts))):
                raise ValueError(f"{path}: stacked indices {sorted(parts)}")
            leaf = stack([parts[i] for i in range(len(parts))])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _listify(tree)


def _listify(node):
    """Nested dicts whose keys are all ints 0..n-1 become lists (the
    JAX tree's ``group_{gi}`` lists of sub-layers)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


# ---------------------------------------------------------------------------

def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32 plus the z-loss 1e-4·mean(logz²):
    logz the logsumexp of each position's logits, the gold logit the
    label's (the JAX package extracts it with a masked sum, for its
    vocab-sharded logits; a gather gives the same value).  On a mesh
    (DTensor logits, the batch over the data axes) the port takes the
    masked sum too, and each mean is the global mean over the tokens."""
    logits = keep_grad_layout(logits.float())
    logz = torch.logsumexp(logits, -1)
    if isinstance(logits, DTensor):
        # on a mesh: the masked sum over the (maybe vocab-sharded)
        # logits, one partial sum per vocab shard
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(labels[..., None] == vocab, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (logz - gold).mean()
    return loss + 1e-4 * torch.mean(logz ** 2)


# ---------------------------------------------------------------------------

def build(cfg, device=None, *, masters: bool = False
          ) -> dict[str, Callable]:
    """The functions of ``cfg`` on ``device`` (the card unless the caller
    names another); ``init`` makes float32 masters that take gradients
    when ``masters`` (training).  ``batch`` is ``{"tokens": (B, S)}``,
    or for the decoder families ``{"embeds": (B, S, d)}`` in its place,
    with ``"positions3"`` (3, B, S) beside either (M-RoPE); the
    encoder-decoder family's batch adds ``"frames"`` (B, F, d), which
    prefill encodes once into the cross caches.  ``loss_fn``'s batch
    adds ``"labels"`` (B, S) and returns ``(loss, {"ce", "aux"})``: the
    cross-entropy with its z-loss plus the MoE auxiliary loss, and (as
    in the JAX package) ``"ce"`` is that same sum.  ``max_len`` sizes the
    self-attention caches; cross caches keep the F frames and recurrent
    states have no length.

    Serving on a mesh: a model placed by ``runtime.sharding.place_model``
    (its FSDP specs, or ``data_replicated`` ones) serves through the same
    ``prefill`` and ``decode`` under ``runtime.sharding.active_mesh``,
    every rank calling them alike with the global batch: the batch is
    placed by ``batch_specs``, prefill returns each cache placed by
    ``cache_specs``' rule and decode writes into those caches in place;
    the logits are DTensors (``full_tensor()`` gives their values)."""
    device = resolve_device(device)
    cls = model_class(cfg)
    encdec = cls is EncDec

    def init(generator: Optional[torch.Generator]) -> LM:
        return cls(cfg, device=device, generator=generator, masters=masters)

    def inputs(batch) -> dict:
        if encdec:
            return {"tokens": batch["tokens"].to(device)}
        kw = ({"embeds": batch["embeds"].to(device)} if "embeds" in batch
              else {"tokens": batch["tokens"].to(device)})
        if "positions3" in batch:
            kw["positions3"] = batch["positions3"].to(device)
        return kw

    def loss_fn(model, batch):
        kw = inputs(batch)
        if encdec:
            kw["frames"] = batch["frames"].to(device)
        logits, _, aux = model(**kw)
        loss = _ce_loss(logits, batch["labels"].to(device)) + aux
        return loss, {"ce": loss, "aux": aux}

    def placed(batch) -> dict:
        """``batch`` on ``device``; under an active mesh (serving on a
        mesh) the global batch, the same on every rank, placed by
        ``batch_specs``: each rank keeps its block."""
        batch = {k: v.to(device) for k, v in batch.items()}
        mesh = current_mesh()
        if mesh is None:
            return batch
        specs = batch_specs(cfg, mesh, batch)
        return {k: place(v, specs[k], mesh) for k, v in batch.items()}

    @torch.no_grad()
    def prefill(model, batch, max_len: Optional[int] = None):
        with mesh_scope():
            batch = placed(batch)
            kw = inputs(batch)
            if encdec:
                kw["frames"] = batch["frames"]
            logits, cache, _ = model(
                **kw, make_cache=True, max_len=max_len,
                last_logit_only=(cfg.prefill_logits == "last"))
        return logits, cache

    @torch.no_grad()
    def decode(model, cache, batch, pos: int):
        with mesh_scope():
            logits, cache, _ = model(**inputs(placed(batch)), cache=cache,
                                     cache_pos=pos)
        return logits, cache

    return {"init": init, "loss_fn": loss_fn, "prefill": prefill,
            "decode": decode}
