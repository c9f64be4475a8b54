"""Per-candidate, per-graph embedding join: the first launch of the
two-launch backend "pallas" — the CUDA kernel's wrapper.

``embedding_join`` replaces the TPU kernel
``repro.kernels.embedding_join.embedding_join_pallas``
(``src/repro/kernels/embedding_join.py:98``) together with the vmap over
the device-local partitions that ``repro.kernels.ops`` wraps around it.
The kernel is ``embedding_join_kernel`` in ``csrc/two_launch.cu``; it
runs the row walk of ``csrc/join.cuh`` that the fused kernels run, and
joins each run of equal consecutive meta rows once.  The source note
there says what bounds it on the H100.

Inputs (one device):
  meta       (C, 5) int32     [parent, stub, to, fwd, triple]
  pol        (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) bool
  src/dst    (PP, T, G, F) int32                emask (PP, T, G, F) bool
Outputs: matched, count (PP, C, G) int32.  The stores are not padded:
the outputs have the real G columns (the JAX wrapper pads G to the graph
tile; padded graphs match nothing, so its sums are the same).

The wrapper runs the plain version (``ref.embedding_join_ref``) only for
tensors on the CPU.  On a CUDA tensor it launches the kernel on the
current stream or raises; each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import torch

from .build import check_tensors, join_geometry, launch, on_cpu, store_dims
from .ref import embedding_join_ref

__all__ = ["embedding_join", "launches", "reset_launches"]

# kernel launches since the last reset_launches()
launches = {"embedding_join": 0}


def reset_launches() -> None:
    launches["embedding_join"] = 0


def _check(meta, pol, pmask, src, dst, emask):
    """Validate what the kernel takes; return (PP, P, G, M, K, T, F, C)."""
    PP, P, G, M, K, T, F = store_dims(pol, pmask, src, dst, emask)
    if meta.dim() != 2 or meta.shape[1] != 5:
        raise ValueError(f"meta {tuple(meta.shape)} must be (C, 5)")
    check_tensors(pol.device, dict(meta=meta, pol=pol, src=src, dst=dst),
                  dict(pmask=pmask, emask=emask))
    return PP, P, G, M, K, T, F, meta.shape[0]


def embedding_join(meta, pol, pmask, src, dst, emask):
    """Per-(partition, candidate, graph) ``(matched, count)``.  The meta
    rows must index inside the stores (the callers check their host rows;
    on the card a row outside them gives zeros)."""
    PP, P, G, M, K, T, F, C = _check(meta, pol, pmask, src, dst, emask)
    if on_cpu(pol):
        return embedding_join_ref(meta, pol, pmask, src, dst, emask)
    threads, smem = join_geometry(PP, T)
    matched = torch.empty((PP, C, G), dtype=torch.int32, device=pol.device)
    count = torch.empty_like(matched)
    if C and G:
        launch("embedding_join", launches,
               (meta, pol, pmask, src, dst, emask, matched, count),
               (PP, P, G, M, K, T, F, C, threads, smem))
    return matched, count
