"""Plain PyTorch versions of the two-launch kernels (the counterpart of
``repro.kernels.ref``): the same contracts, built on the semantic source
of truth ``core.embedding.join_valid``.  The tests hold the kernels and
the JAX package's kernels against them, and the CPU path runs them;
nothing on the CUDA path calls them.

Both accept any number of leading dimensions in front of the JAX
shapes: pol (..., P, G, M, K), src (..., T, G, F) give matched/count
(..., C, G), and the wrappers pass the (PP, ...) partition stack.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.embedding import join_valid

__all__ = ["embedding_join_ref", "support_count_ref"]


def embedding_join_ref(meta, pol, pmask, src, dst, emask):
    """(..., C, G) int32 ``matched`` (1 iff the graph holds >= 1 child
    embedding) and ``count`` (joined (m, f) pairs) for the candidate rows
    ``meta`` (C, 5) [parent, stub, to, fwd, triple], host rows or a
    tensor."""
    rows = (meta.cpu().numpy() if isinstance(meta, torch.Tensor)
            else np.asarray(meta)).astype(np.int64).reshape(-1, 5)
    lead, G = pol.shape[:-4], pol.shape[-3]
    matched = torch.zeros(lead + (len(rows), G), dtype=torch.int32,
                          device=pol.device)
    count = torch.zeros_like(matched)
    for c, (parent, stub, to, fwd, triple) in enumerate(rows.tolist()):
        valid = join_valid(pol.select(-4, parent), pmask.select(-3, parent),
                           src.select(-3, triple), dst.select(-3, triple),
                           emask.select(-3, triple), stub, to, fwd)
        matched[..., c, :] = valid.flatten(-2).any(-1)
        count[..., c, :] = valid.flatten(-2).sum(-1, dtype=torch.int32)
    return matched, count


def support_count_ref(matched, count):
    """(..., C) int32 support and embed totals over the graph axis; the
    sums wrap mod 2^32 as the JAX int32 sums do."""
    return (matched.sum(-1, dtype=torch.int32),
            count.sum(-1, dtype=torch.int32))
