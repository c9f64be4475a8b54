"""Dispatch wrappers around the mining kernels.

``backend`` selection:
  "ref"           plain PyTorch — default on the CPU, also the test oracle
  "fused"         the single-launch fused kernel (join + per-candidate
                  reduction in one launch, parent-grouped candidate
                  schedule; DESIGN.md §5-6) — the default on CUDA
  "fused_packed"  the fused kernel with bit-packed verdict words (support
                  counting is AND+popcount, DESIGN.md §12); bit-identical
                  to "fused"

The wrappers own the padding contract of ``repro.kernels.ops``: G is
padded to the graph tile with PAD -1 and zero masks, the packed tile_g
rounds to a multiple of 32, and ``gmask = tail_mask(G, n_words(Gp))``
zeroes the ragged tail.  The padding is virtual: the kernels and their
plain versions treat graphs past G as padding, so the stores are never
copied to a padded shape, and the packed outputs have the padded JAX
shape (PP, Cs, Gp/32).  The schedule's rows are padded to ``tile_c`` by
``candgen.schedule_candidates``.
"""
from __future__ import annotations

from typing import Literal

import torch

from ..core.embedding import LevelOL, local_supports_ref, support_bits_ref
from .bitset import WORD, n_words, tail_mask
from .fused_level import fused_level, fused_level_packed

Backend = Literal["ref", "fused", "fused_packed"]
BACKENDS = ("ref", "fused", "fused_packed")

__all__ = ["fused_level_supports", "fused_level_supports_packed",
           "device_local_supports", "default_backend", "is_fused_backend",
           "check_backend", "DEFAULT_TILE_G"]

# graph tile of the JAX package's kernels (repro/kernels/embedding_join.py)
DEFAULT_TILE_G = 128


def default_backend(device: torch.device | str) -> Backend:
    return "fused" if torch.device(device).type == "cuda" else "ref"


def check_backend(backend: str | None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not available in repro_torch (one of "
            f"{BACKENDS}); the two-launch 'pallas' backend is ROADMAP "
            f"queue B items 3-4")


def is_fused_backend(backend: str | None) -> bool:
    return backend in ("fused", "fused_packed")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fused_level_supports(sched_meta, tiles, pol, pmask, src, dst, emask):
    """Per-(partition, scheduled-candidate) (support, embed_count) in ONE
    kernel launch covering every device-local partition.  Outputs are in
    scheduled order.  The dense outputs do not depend on the graph tile,
    so there is no padding to do."""
    return fused_level(sched_meta, tiles, pol, pmask, src, dst, emask)


def fused_level_supports_packed(sched_meta, tiles, pol, pmask, src, dst,
                                emask, *, tile_g: int = DEFAULT_TILE_G):
    """Packed twin of :func:`fused_level_supports`: ``(sup, emb, vbits)``
    with ``vbits (PP, Cs, Gp/32)`` uint32, Gp = G padded to the 32-aligned
    graph tile, pad-bit tail zero."""
    G = pol.shape[2]
    tg = min(_round_up(tile_g, WORD), _round_up(G, WORD))
    Gp = _round_up(G, tg)
    gmask = tail_mask(G, words=n_words(Gp), device=pol.device)
    return fused_level_packed(sched_meta, tiles, gmask, pol, pmask, src,
                              dst, emask)


def device_local_supports(meta, pol, pmask, src, dst, emask, *,
                          packed: bool = False):
    """Map phase on one device through the plain PyTorch join (backend
    "ref"): the summed (C,) local support and embed count plus the
    per-partition (PP, C) embed counts (the straggler-rebalance cost
    signal).  ``meta`` is host rows.  ``packed=True`` routes through the
    bitset-shaped oracle (``support_bits_ref``), bit-identical by
    construction, so the packed pipeline stays exercised on the CPU."""
    if packed:
        sup_pp, emb_pp, _ = support_bits_ref(meta, pol, pmask, src, dst,
                                             emask)
    else:
        sup_pp, emb_pp = local_supports_ref(LevelOL(pol, pmask), src, dst,
                                            emask, meta)
    return (sup_pp.sum(0, dtype=torch.int32),
            emb_pp.sum(0, dtype=torch.int32), emb_pp)
