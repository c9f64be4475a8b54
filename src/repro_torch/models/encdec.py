"""Encoder-decoder assembly in plain PyTorch (whisper-base), the
counterpart of ``repro.models.encdec``.

The audio conv frontend is a stub, as in the JAX package: the encoder
takes precomputed mel-frame embeddings (B, F, d_model) and runs a
non-causal transformer over them; the decoder is ``transformer.LM``,
whose cross-attention blocks attend to the encoder's output.
"""
from __future__ import annotations

from torch import nn

from .attention import Attention
from .common import cdtype, rmsnorm
from .mlp import MLP
from ..runtime.sharding import as_residual, mesh_scope
from .transformer import LM, _gathered, _norm, call_gathered, remat

__all__ = ["Encoder", "EncDec"]


class EncoderLayer(nn.Module):
    """``ln1`` → non-causal self-attention (the cross mode over its own
    normed input) → residual, ``ln2`` → MLP → residual."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        kw = {"device": device, "generator": generator, "masters": masters}
        self.ln1 = _norm(cfg, device, masters)
        self.attn = Attention(cfg, **kw)
        self.ln2 = _norm(cfg, device, masters)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x):
        eps = self.cfg.norm_eps
        h = rmsnorm(self.ln1, x, eps=eps)
        y, _ = self.attn(h, is_cross=True, cross_inputs=h)
        x = x + as_residual(y, x)
        return x + as_residual(self.mlp(rmsnorm(self.ln2, x, eps=eps)), x)


class Encoder(nn.Module):
    """``encoder_layers`` layers, then ``final_norm`` (float32)."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device=device, generator=generator,
                         masters=masters)
            for _ in range(cfg.encoder_layers))
        self.final_norm = _norm(cfg, device, masters)

    def forward(self, frames):
        """frames (B, F, d_model), cast to the compute dtype -> the
        encoder's output (B, F, d_model); under ``cfg.remat == "block"``
        each layer is recomputed in the backward pass of training.  Under
        a mesh each layer's weights are gathered at its use."""
        x = frames.to(cdtype(self.cfg))
        for layer in self.layers:
            x = remat(self.cfg, _encoder_layer, layer, x)
        return rmsnorm(self.final_norm, x, eps=self.cfg.norm_eps)


def _encoder_layer(layer: EncoderLayer, x):
    """One encoder layer; under a mesh its weights are gathered here,
    inside what ``remat`` recomputes (repro's encoder ``body``)."""
    with mesh_scope():
        return call_gathered(layer, _gathered(layer, cdtype(layer.cfg)), x)


class EncDec(LM):
    """``init_encdec``'s model: the decoder ``LM`` (its embedding, head
    and blocks) plus ``encoder``; ``masters`` as ``LM``'s."""

    def __init__(self, cfg, *, device, generator=None, masters=False):
        super().__init__(cfg, device=device, generator=generator,
                         masters=masters)
        self.encoder = Encoder(cfg, device=device, generator=generator,
                               masters=masters)

    def encode(self, frames):
        return self.encoder(frames)

    def forward(self, tokens, *, frames=None, encoder_out=None, **kw):
        """``forward_encdec``: encodes ``frames`` unless ``encoder_out``
        is given, then runs the decoder (``LM.forward``'s ``cache``,
        ``cache_pos``, ``make_cache``, ``max_len``, ``last_logit_only``).
        Decode passes neither: the cross caches built at prefill hold
        the encoder's keys and values."""
        if encoder_out is None and frames is not None:
            encoder_out = self.encode(frames)
        return super().forward(tokens, encoder_out=encoder_out, **kw)
