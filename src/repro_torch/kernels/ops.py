"""Dispatch wrappers around the mining kernels.

``backend`` selection:
  "ref"           plain PyTorch — default on the CPU, also the test oracle
  "pallas"        the two-launch pipeline (the join kernel writes (C, G)
                  intermediates, then the reduction kernel sums them) —
                  the on-device oracle for the fused kernels and the
                  backend of the legacy pipeline; named after the JAX
                  package's backend it ports
  "fused"         the single-launch fused kernel (join + per-candidate
                  reduction in one launch, parent-grouped candidate
                  schedule; DESIGN.md §5-6) — the default on CUDA
  "fused_packed"  the fused kernel with bit-packed verdict words (support
                  counting is AND+popcount, DESIGN.md §12); bit-identical
                  to "fused"

The fused wrappers own the padding contract of ``repro.kernels.ops``: G is
padded to the graph tile with PAD -1 and zero masks, the packed tile_g
rounds to a multiple of 32, and ``gmask = tail_mask(G, n_words(Gp))``
zeroes the ragged tail.  The padding is virtual: the kernels and their
plain versions treat graphs past G as padding, so the stores are never
copied to a padded shape, and the packed outputs have the padded JAX
shape (PP, Cs, Gp/32).  The schedule's rows are padded to ``tile_c`` by
``candgen.schedule_candidates``.  The two-launch kernels take any C and
G, so nothing is padded for them.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ..core.candgen import schedule_candidates
from ..core.embedding import LevelOL, local_supports_ref, support_bits_ref
from .bitset import WORD, n_words, tail_mask
from .embedding_join import embedding_join
from .fused_level import DEFAULT_TILE_C, fused_level, fused_level_packed
from .ref import embedding_join_ref, support_count_ref
from .support_count import support_count

Backend = Literal["ref", "pallas", "fused", "fused_packed"]
BACKENDS = ("ref", "pallas", "fused", "fused_packed")

__all__ = ["level_supports", "fused_level_supports",
           "fused_level_supports_packed", "device_local_supports",
           "default_backend", "is_fused_backend", "is_packed_backend",
           "check_backend", "DEFAULT_TILE_G"]

# graph tile of the JAX package's kernels (repro/kernels/embedding_join.py)
DEFAULT_TILE_G = 128


def default_backend(device: torch.device | str) -> Backend:
    return "fused" if torch.device(device).type == "cuda" else "ref"


def check_backend(backend: str | None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not available in repro_torch: it "
            f"takes one of {BACKENDS} (the JAX package's interpret-mode "
            f"backends run on the CPU here as the kernels' plain versions "
            f"on CPU tensors)")


def is_fused_backend(backend: str | None) -> bool:
    return backend in ("fused", "fused_packed")


def is_packed_backend(backend: str | None) -> bool:
    return backend == "fused_packed"


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
                          backend: Backend = "ref", packed: bool = False):
    """Map phase on one device for the non-fused backends: the summed (C,)
    local support and embed count plus the per-partition (PP, C) embed
    counts (the straggler-rebalance cost signal).  The fused backends
    cover the partition axis in their own launch
    (:func:`fused_level_supports`).

    "ref" runs the plain PyTorch join over host rows ``meta``;
    ``packed=True`` routes it through the bitset-shaped oracle
    (``support_bits_ref``), bit-identical by construction, so the packed
    pipeline stays exercised on the CPU.  "pallas" runs the two-launch
    kernels on ``meta`` as a tensor on the stores' device (host rows are
    copied there): the join writes the (PP, C, G) ``matched``/``count``
    intermediates, freed on return, and the reduction sums them.  It
    stays dense whatever ``packed`` says, as in the JAX package: it is
    the oracle for the fused path, and the packing lives in the shuffle
    and the wire."""
    if backend == "pallas":
        if not isinstance(meta, torch.Tensor):
            meta = torch.from_numpy(np.asarray(meta, np.int32).reshape(-1, 5)
                                    ).to(pol.device)
        sup_pp, emb_pp = support_count(
            *embedding_join(meta, pol, pmask, src, dst, emask))
    elif backend != "ref":
        raise ValueError(f"device_local_supports runs the non-fused "
                         f"backends ('ref', 'pallas'), not {backend!r}")
    elif packed:
        sup_pp, emb_pp, _ = support_bits_ref(meta, pol, pmask, src, dst,
                                             emask)
    else:
        sup_pp, emb_pp = local_supports_ref(LevelOL(pol, pmask), src, dst,
                                            emask, meta)
    return (sup_pp.sum(0, dtype=torch.int32),
            emb_pp.sum(0, dtype=torch.int32), emb_pp)


def level_supports(meta, pol, pmask, src, dst, emask, *,
                   backend: Backend | None = None,
                   tile_g: int = DEFAULT_TILE_G,
                   tile_c: int = DEFAULT_TILE_C):
    """Per-candidate (local_support, embed_count) (C,) of one partition
    (pol (P, G, M, K), src (T, G, F)) — the whole map-phase compute of a
    MIRAGE iteration on it, the counterpart of
    ``repro.kernels.ops.level_supports``.  The fused backends build the
    parent-grouped schedule from the host rows of ``meta`` and gather
    their outputs back to canonical order; "pallas" takes ``meta`` as
    given (host rows are copied to the stores' device)."""
    backend = backend or default_backend(pol.device)
    check_backend(backend)
    if backend == "ref":
        matched, count = embedding_join_ref(meta, pol, pmask, src, dst,
                                            emask)
        return support_count_ref(matched, count)
    stores = [x[None] for x in (pol, pmask, src, dst, emask)]
    if backend == "pallas":
        sup, emb, _ = device_local_supports(meta, *stores, backend=backend)
        return sup, emb
    rows = (meta.cpu().numpy() if isinstance(meta, torch.Tensor)
            else np.asarray(meta))
    sched = schedule_candidates(rows.astype(np.int32).reshape(-1, 5),
                                tile_c)
    sched_meta, tiles, inv = (torch.from_numpy(a).to(pol.device) for a in
                              (sched.meta, sched.tiles,
                               sched.inv.astype(np.int64)))
    if is_packed_backend(backend):
        sup, emb, _ = fused_level_supports_packed(sched_meta, tiles, *stores,
                                                  tile_g=tile_g)
    else:
        sup, emb = fused_level_supports(sched_meta, tiles, *stores)
    return sup[0].index_select(0, inv), emb[0].index_select(0, inv)
