"""The yardstick of the kernels: the card's peaks and the least work one
pass-1 call needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, and 67e12 32-bit operations a second outside the
tensor cores (the FP32 rate; a compare counts as one operation, so the
bound of a compare-bound call is, if anything, too low, and its share
too small, never too large).

``b1_counts`` is ``chip_smoke.py::level_bound`` (commit d8253df) frozen,
without the tile table, and counted from the level's candidates rather
than from the kernel's tiling, so that it reads the same work whatever
implements pass 1:

* bytes: each valid candidate row (parent, stub, to, forward, triple:
  five int32) once; for each parent a valid row references, its
  embedding mask rows in full plus the K vertex slots (int32) of every
  set embedding; for each triple a valid row references, its occurrence
  mask rows in full plus src and dst (int32) of every set occurrence;
  the outputs once: a support and an embedding count (int32) and the
  ceil(G / 32) verdict words (uint32) of every valid row and partition;
* compares: for each valid row, every set parent embedding against every
  set edge occurrence of the same graph and partition.

The counts are made on the device with a handful of reductions and stay
there until the run has ended, so that counting adds no host sync to
the traced window.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "b1_counts", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def b1_counts(sched_meta, pol, pmask, src, emask):
    """``(bytes, compares)`` of one ``fused_level_packed`` call as a (2,)
    float64 tensor on the inputs' device.  ``sched_meta`` (Cs, 6):
    [parent, stub, to, forward, triple, valid] per row; ``pol`` (PP, P,
    G, M, K) and ``pmask`` (PP, P, G, M): the parent store; ``src`` and
    ``emask`` (PP, T, G, F): the edge occurrences."""
    import torch
    f64 = torch.float64
    PP, P, G, M, K = pol.shape
    T, F = src.shape[1], src.shape[3]
    valid = (sched_meta[:, 5] != 0).to(f64)
    parent = sched_meta[:, 0].long().clamp(0, P - 1)
    triple = sched_meta[:, 4].long().clamp(0, T - 1)
    nm = pmask.sum(-1, dtype=torch.int32).to(f64)        # (PP, P, G)
    nf = emask.sum(-1, dtype=torch.int32).to(f64)        # (PP, T, G)
    used_p = torch.zeros(P, dtype=f64, device=pol.device).index_add_(
        0, parent, valid) > 0
    used_t = torch.zeros(T, dtype=f64, device=pol.device).index_add_(
        0, triple, valid) > 0
    rows = valid.sum()
    words = -(-G // 32)
    nbytes = (rows * 5 * 4
              + used_p.sum() * PP * G * M * pmask.element_size()
              + (nm.sum((0, 2)) * used_p).sum() * K * 4
              + used_t.sum() * PP * G * F * emask.element_size()
              + (nf.sum((0, 2)) * used_t).sum() * (4 + 4)
              + rows * PP * (4 + 4 + words * 4))
    pairs = torch.einsum("apg,atg->pt", nm, nf)          # (P, T)
    compares = (pairs[parent, triple] * valid).sum()
    return torch.stack([nbytes, compares])


def bound_s(nbytes: float, compares: float) -> float:
    """The least seconds a call could take: the larger of its bytes over
    the memory rate and its compares over the 32-bit rate."""
    return max(nbytes / HBM_BYTES_PER_S, compares / INT32_OPS_PER_S)
