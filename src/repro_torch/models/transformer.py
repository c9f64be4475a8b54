"""Model assembly in plain PyTorch, the counterpart of
``repro.models.transformer``, for the dense decoder family (qwen2.5,
granite, minicpm and gemma2's alternating local/global attention), the
VLM family (qwen2-vl: the dense decoder fed embeddings and M-RoPE
positions), the mixture-of-experts family (deepseek-v2-lite's latent
attention and leading dense layer, phi3.5-moe's GQA), the ssm family
(xlstm: mLSTM blocks with an sLSTM every ``slstm_every``), the hybrid
family (zamba2: Mamba2 blocks and, every ``hybrid_attn_every``, one
shared attention block's weights with a block's own norms, MLP and KV
cache) and the decoder of the encoder-decoder family (whisper:
self-attention, then cross-attention over the encoder's output and the
MLP; the encoder is ``encdec.py``'s).

The JAX package scans each group of sub-layers ``repeat`` times over
stacked parameters.  Eager PyTorch has nothing to gain from a scan, so
the port unrolls the groups into one list of blocks in execution order
(group by group, repeat by repeat, sub-layer by sub-layer) and keeps one
cache per block.  ``repro_torch.models.registry.params_from_jax`` maps
the stacked JAX parameters onto these blocks.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import (as_residual, current_mesh,
                                gather_for_compute, is_sharded, mesh_scope,
                                place_cache, shard_hint)
from .attention import MLA, Attention
from .common import (cdtype, dense_init, held_dtype, norm_init, param,
                     rmsnorm, softcap)
from .mlp import MLP, MoE
from .ssm import Mamba2
from .xlstm import MLSTM, SLSTM

__all__ = ["GroupSpec", "arch_groups", "Block", "LM", "remat",
           "call_gathered"]

RECURRENT = {"mamba": Mamba2, "mlstm": MLSTM, "slstm": SLSTM}


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    unit: tuple[tuple[str, str], ...]   # ((mixer, ffn), ...) per sub-layer
    repeat: int


def arch_groups(cfg) -> list[GroupSpec]:
    fam = cfg.family
    L = cfg.n_layers
    if fam in ("dense", "vlm"):
        if cfg.local_global:
            assert L % 2 == 0
            return [GroupSpec((("attn_local", "mlp"), ("attn", "mlp")),
                              L // 2)]
        return [GroupSpec((("attn", "mlp"),), L)]
    if fam == "moe":
        mixer = "mla" if cfg.mla else "attn"
        groups = []
        if cfg.first_dense:
            groups.append(GroupSpec(((mixer, "mlp"),), cfg.first_dense))
        groups.append(GroupSpec(((mixer, "moe"),), L - cfg.first_dense))
        return groups
    if fam == "ssm":   # xlstm
        if cfg.slstm_every:
            e = cfg.slstm_every
            assert L % e == 0
            unit = tuple(("mlstm", "none") for _ in range(e - 1))
            unit += (("slstm", "none"),)
            return [GroupSpec(unit, L // e)]
        return [GroupSpec((("mlstm", "none"),), L)]
    if fam == "hybrid":  # zamba2
        e = cfg.hybrid_attn_every
        assert e and L % e == 0
        unit = tuple(("mamba", "none") for _ in range(e))
        unit += (("shared_attn", "mlp"),)
        return [GroupSpec(unit, L // e)]
    if fam in ("encdec", "audio"):
        # decoder-side groups (self-attn -> cross-attn -> mlp);
        # the encoder stack is assembled by encdec.py
        return [GroupSpec((("attn", "none"), ("cross_attn", "mlp")), L)]
    raise ValueError(f"unknown family {fam}")


def block_specs(cfg) -> list[tuple[int, int, int, str, str]]:
    """(group, repeat, sub-layer, mixer, ffn) of every block, in
    execution order."""
    return [(gi, r, li, m, f)
            for gi, g in enumerate(arch_groups(cfg))
            for r in range(g.repeat)
            for li, (m, f) in enumerate(g.unit)]


def _norm(cfg, device, masters=False) -> nn.Parameter:
    return param(norm_init(cfg.d_model, device), masters)


def remat(cfg, fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of keeping
    its activations when ``cfg.remat == "block"`` and autograd records
    (training); called plainly otherwise.  Remat changes memory, never
    values: nothing in a block draws random numbers."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def call_gathered(module: nn.Module, params: dict, *args, **kwargs):
    """``module(*args, **kwargs)`` with its parameters replaced by
    ``params`` (``gather_for_compute``'s output, keyed by the module's
    parameter names), or plainly when ``params`` is None."""
    if params is None:
        return module(*args, **kwargs)
    return functional_call(module, params, args, kwargs)


def _gathered(module: nn.Module, dt) -> "dict | None":
    """``module``'s parameters gathered for compute in ``dt`` under an
    active mesh (ZeRO-3 use-site gather), None without one."""
    if current_mesh() is None:
        return None
    return gather_for_compute(dict(module.named_parameters()), cast=dt)


def _embed(tokens, w):
    """The rows of ``w`` at ``tokens``.  On a mesh whose axes shard the
    vocabulary, a one-hot product instead: its contraction over the
    vocab shards leaves one partial sum per shard (Megatron's
    vocab-parallel embedding), the same values, and the gradient is the
    product's; its (B, S, V) one-hot is the size of the logits."""
    if is_sharded(w) and any(p.is_shard() for p in w.placements):
        from torch.distributed.tensor import Replicate, distribute_tensor
        # the one-hot's vocab axis sharded as the table's rows are: each
        # rank's product, forward and backward, is its vocab shard's
        vocab = distribute_tensor(
            torch.arange(w.shape[0], device=tokens.device), w.device_mesh,
            [p if p.is_shard(0) else Replicate() for p in w.placements],
            src_data_rank=None)
        return (tokens[..., None] == vocab).to(w.dtype) @ w
    return F.embedding(tokens, w)


class Block(nn.Module):
    """One sub-layer: ``ln1`` → mixer (→ ``post_ln1``) → residual, then
    ``ln2`` → MLP or MoE (→ ``post_ln2``) → residual.  The mixer is GQA
    (self- or cross-attention) or MLA under ``attn``; Mamba2, mLSTM or
    sLSTM under ``mixer``; or, for ``"shared_attn"``, the LM's one shared
    ``Attention``, handed in at each call and not held by the block.
    Norm scales in float32."""

    def __init__(self, cfg, mixer: str, ffn: str, *, device,
                 generator=None, masters=False):
        super().__init__()
        if mixer not in ("attn", "attn_local", "cross_attn", "mla",
                         "shared_attn", *RECURRENT):
            raise ValueError(mixer)
        if ffn not in ("mlp", "moe", "none"):
            raise ValueError(ffn)
        self.cfg, self.kind, self.ffn = cfg, mixer, ffn
        kw = {"device": device, "generator": generator, "masters": masters}
        self.ln1 = _norm(cfg, device, masters)
        if mixer in RECURRENT:
            self.mixer = RECURRENT[mixer](cfg, **kw)
        elif mixer != "shared_attn":
            mix = MLA if mixer == "mla" else Attention
            self.attn = mix(cfg, **kw)
        if ffn != "none":
            self.ln2 = _norm(cfg, device, masters)
            if ffn == "moe":
                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg, **kw)
        if cfg.post_norms:
            self.post_ln1 = _norm(cfg, device, masters)
            if ffn != "none":
                self.post_ln2 = _norm(cfg, device, masters)

    def forward(self, x, *, cache=None, cache_pos=None, make_cache=False,
                max_len=None, shared=None, positions3=None,
                encoder_out=None):
        """Returns (x, cache, aux): aux is the MoE's auxiliary loss, None
        for the other feed-forwards.  A recurrent mixer's cache is its
        state: prefill (``make_cache``) returns the final state, decode
        (``cache_pos``) returns the stepped state, and ``max_len`` does
        not apply.  ``shared`` is the LM's shared attention;
        ``positions3`` the M-RoPE positions of self-attention;
        ``encoder_out`` what cross-attention attends to (None at decode:
        its cache)."""
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, eps=cfg.norm_eps,
                    zero_centered=cfg.post_norms)
        if self.kind in RECURRENT:
            if cache_pos is not None:
                y, new_cache = self.mixer(h, state=cache)
            elif make_cache:
                y, new_cache = self.mixer(h, return_state=True)
            else:
                y, new_cache = self.mixer(h), None
        else:
            attn = shared if self.kind == "shared_attn" else self.attn
            kw = {}
            if self.kind == "cross_attn":
                kw = {"is_cross": True, "cross_inputs": encoder_out}
            elif self.kind in ("attn", "attn_local"):
                kw = {"layer_local": self.kind == "attn_local",
                      "positions3": positions3}
            y, new_cache = attn(h, cache=cache, cache_pos=cache_pos,
                                make_cache=make_cache, max_len=max_len,
                                **kw)
        if cfg.post_norms:
            y = rmsnorm(self.post_ln1, y, eps=cfg.norm_eps,
                        zero_centered=True)
        x = x + as_residual(y, x)
        aux = None
        if self.ffn != "none":
            h = rmsnorm(self.ln2, x, eps=cfg.norm_eps,
                        zero_centered=cfg.post_norms)
            if self.ffn == "moe":
                y, aux = self.moe(h)
            else:
                y = self.mlp(h)
            if cfg.post_norms:
                y = rmsnorm(self.post_ln2, y, eps=cfg.norm_eps,
                            zero_centered=True)
            x = x + as_residual(y, x)
        return x, new_cache, aux


class LM(nn.Module):
    """The decoder (``init_lm`` and ``forward_lm`` of the JAX package):
    ``embed`` (V, d) and ``lm_head`` (d, V, untied only) in the compute
    dtype, ``final_norm`` in float32, the hybrid family's one
    ``shared_attn`` (every ``"shared_attn"`` block runs it), and
    ``layers`` in execution order.
    Each tensor is drawn from ``generator`` in float32 and cast before
    the next is drawn, so at most one float32 tensor lives at a time.
    With ``masters`` every tensor stays float32 and takes a gradient
    (training).  On the ``meta`` device nothing is allocated."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg, self.masters = cfg, masters
        dt = held_dtype(cfg, masters)
        self.embed = param(dense_init(
            (cfg.vocab, cfg.d_model), generator=generator, device=device,
            dtype=dt, scale=0.02), masters)
        self.final_norm = _norm(cfg, device, masters)
        if not cfg.tie_embeddings:
            self.lm_head = param(dense_init(
                (cfg.d_model, cfg.vocab), generator=generator,
                device=device, dtype=dt), masters)
        if cfg.family == "hybrid":
            self.shared_attn = Attention(cfg, device=device,
                                         generator=generator,
                                         masters=masters)
        specs = block_specs(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, m, f, device=device, generator=generator,
                  masters=masters)
            for (_, _, _, m, f) in specs)
        # where each unit (a repeat of a group's sub-layers) starts
        self.units = [i for i, (_, _, li, _, _) in enumerate(specs)
                      if li == 0] + [len(specs)]

    def forward(self, tokens=None, *, embeds=None, positions3=None,
                encoder_out=None, cache=None, cache_pos=None,
                make_cache=False, max_len=None, last_logit_only=False):
        """Returns (logits, caches, aux), as ``forward_lm`` does: the
        caches are a list, one per block, when ``make_cache`` (prefill,
        each self-attention cache of ``max_len`` positions) or ``cache``
        (decode at ``cache_pos``: attention caches written in place,
        recurrent states replaced, cross caches read) is given, else
        None; aux is the sum of the MoE blocks' auxiliary losses
        (float32, 0 for the dense family).  The input is ``tokens`` (B,
        S) or, when given, ``embeds`` (B, S, d), cast to the compute
        dtype and not scaled; ``positions3`` (3, B, S) are the M-RoPE
        positions and ``encoder_out`` (B, F, d) the encoder's output.

        The embedding rows are gathered in float32 and then cast (the JAX
        package casts the whole table, then gathers): the same values,
        and a training master's gradient is scatter-added in float32
        where the JAX package adds it in the compute dtype.  In training
        (no cache) under ``cfg.remat == "block"`` each unit of blocks is
        recomputed in the backward pass.

        Under ``runtime.sharding.active_mesh`` (training or serving on a
        mesh: the model placed by ``place_model``, the inputs DTensors)
        each unit's (each block's, with caches) weights, the embedding and
        the untied head are gathered at their use
        (``gather_for_compute``), the embedded stream, the
        sequence-parallel residual and the logits carry ``repro``'s
        ``shard_hint``s, and every cache is placed by ``cache_specs``'
        rule (``place_cache``), all under the caller's ``mesh_scope``."""
        cfg = self.cfg
        dt = cdtype(cfg)
        # under a mesh the embedding and the untied head are gathered at
        # their use; the embedding in float32, so that its rows and the
        # tied head are cast after the gather, as without a mesh (its
        # gradient adds up in float32: ROADMAP §C, "the embedding
        # gathered in float32")
        mesh = current_mesh() is not None
        embed_w = (gather_for_compute({"embed": self.embed})["embed"]
                   if mesh else self.embed)
        if embeds is None:
            x = _embed(tokens, embed_w).to(dt)
            if cfg.post_norms:  # gemma-style input scaling, factor in dt
                x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt,
                                     device=x.device)
        else:
            x = embeds.to(dt)
        x = shard_hint(x, "dp", None, None)
        # the use-site cast of the gathered weights: the masters' to the
        # compute dtype; weights held for serving are used as held
        cast = dt if self.masters else None
        shared = getattr(self, "shared_attn", None)
        if shared is not None and mesh:
            shared = functools.partial(call_gathered, shared,
                                       _gathered(shared, cast))
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if cache is None and not make_cache:      # train: unit by unit
            for a, b in zip(self.units, self.units[1:]):
                x, aux_total = remat(cfg, self._unit, a, b, x, aux_total,
                                     shared, positions3, encoder_out)
            new_caches = None
        else:
            new_caches = []
            for i, layer in enumerate(self.layers):
                x, nc, aux = call_gathered(
                    layer, _gathered(layer, cast), x,
                    cache=cache[i] if cache is not None else None,
                    cache_pos=cache_pos, make_cache=True, max_len=max_len,
                    shared=shared, positions3=positions3,
                    encoder_out=encoder_out)
                new_caches.append(place_cache(nc))
                if aux is not None:
                    aux_total = aux_total + aux
        if last_logit_only:
            # serving prefill: only the final position's logits are
            # needed — slice BEFORE the head matmul
            x = x[:, -1:]
        x = rmsnorm(self.final_norm, x, eps=cfg.norm_eps,
                    zero_centered=cfg.post_norms)
        if cfg.tie_embeddings:
            head = embed_w.T
        elif mesh:      # cast before the gather, as repro does
            head = gather_for_compute({"lm_head": self.lm_head},
                                      cast=dt)["lm_head"]
        else:
            head = self.lm_head
        # vocab stays TP-sharded through the loss
        logits = shard_hint(x @ head.to(dt), "dp", None, "model")
        logits = softcap(logits, cfg.final_softcap)
        return logits, new_caches, aux_total

    def _unit(self, a, b, x, aux_total, shared, positions3, encoder_out):
        """Blocks ``a`` to ``b`` (one unit) without caches (training): x
        and the running auxiliary loss after them.  Under a mesh the
        unit's weights are gathered here, inside what ``remat``
        recomputes, so one unit's gathered weights are live at a time
        (repro's ``unit_body``)."""
        with mesh_scope():
            layers = self.layers[a:b]
            gathered = [_gathered(layer, cdtype(self.cfg))
                        for layer in layers]
            if self.cfg.seq_parallel:
                x = shard_hint(x, "dp", "model", None)
            for layer, params in zip(layers, gathered):
                x, _, aux = call_gathered(
                    layer, params, x, shared=shared, positions3=positions3,
                    encoder_out=encoder_out)
                if aux is not None:
                    aux_total = aux_total + aux
            return x, aux_total
