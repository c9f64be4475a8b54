"""Per-candidate support reduction: the second launch of the two-launch
backend "pallas" — the CUDA kernel's wrapper.

``support_count`` replaces the TPU kernel
``repro.kernels.support_count.support_count_pallas``
(``src/repro/kernels/support_count.py:41``):

  support[..., c] = sum_g matched[..., c, g]
  embeds[..., c]  = sum_g count[..., c, g]

int32, wrapping mod 2^32 as the JAX sums do.  The kernel is
``support_count_kernel`` in ``csrc/two_launch.cu``.  The JAX wrapper pads
C and G to the kernel's tiles; this kernel takes any C and G, and data
pointers at any 4-byte offset, so nothing is padded or copied.

The wrapper runs the plain version (``ref.support_count_ref``) only for
tensors on the CPU.  On a CUDA tensor it launches the kernel on the
current stream or raises; each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import functools

import torch

from .build import check_tensors, launch, on_cpu
from .ref import support_count_ref

__all__ = ["support_count", "reduce_geometry", "launches",
           "reset_launches"]

# one warp per row, REDUCE_WARPS warps a CTA, REDUCE_CTAS_PER_SM CTAs an
# SM (a full H100 SM: 64 warps)
REDUCE_WARPS = 8
REDUCE_CTAS_PER_SM = 8

# kernel launches since the last reset_launches()
launches = {"support_count": 0}


def reset_launches() -> None:
    launches["support_count"] = 0


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def reduce_geometry(rows: int, n_sm: int) -> tuple[int, int]:
    """``(blocks, threads)`` of the reduction: one warp per row, at most
    a full card's worth of CTAs, which then stride over the rows."""
    blocks = min(-(-rows // REDUCE_WARPS), n_sm * REDUCE_CTAS_PER_SM)
    return max(blocks, 1), REDUCE_WARPS * 32


def support_count(matched: torch.Tensor, count: torch.Tensor):
    """``(support, embeds)`` of shape (PP, C) from (PP, C, G) int32
    ``matched`` and ``count``."""
    if matched.dim() != 3 or count.shape != matched.shape:
        raise ValueError(f"matched {tuple(matched.shape)} / count "
                         f"{tuple(count.shape)} must both be (PP, C, G)")
    check_tensors(matched.device, dict(matched=matched, count=count), {})
    if on_cpu(matched):
        return support_count_ref(matched, count)
    PP, C, G = matched.shape
    sup = torch.empty((PP, C), dtype=torch.int32, device=matched.device)
    emb = torch.empty_like(sup)
    if PP * C == 0 or G == 0:
        return sup.zero_(), emb.zero_()
    blocks, threads = reduce_geometry(PP * C, _sm_count(matched.device))
    launch("support_count", launches, (matched, count, sup, emb),
           (PP, C, G, blocks, threads))
    return sup, emb
