"""Bit-packed graph bitsets on torch tensors: pack/unpack, lane-AND/OR,
popcount, tail masks, and the support path's byte model.

Layout contract (DESIGN.md §12, identical to ``repro.kernels.bitset``):

* a length-``n`` bit vector packs to ``ceil(n / 32)`` 32-bit words,
* bit ``i`` lives in word ``i // 32`` at position ``i % 32`` (LSB-first),
* pad bits beyond ``n`` are ZERO.

Words are ``torch.uint32`` tensors at every public boundary.  PyTorch's
CPU kernels do not shift ``uint32`` tensors (``<<``/``>>`` raise
``NotImplementedError``), so every helper computes in int64 with the
value masked to 32 bits and converts to ``uint32`` only on the way out.
The same code runs on any device; on a CUDA tensor the work stays on the
card.  The lane ops also take numpy word arrays, as the JAX package's do.
"""
from __future__ import annotations

import torch

__all__ = ["WORD", "n_words", "pack_bits", "unpack_bits", "popcount",
           "tail_mask", "lane_and", "lane_or", "packed_any_count",
           "support_path_cost_model"]

WORD = 32
_MASK32 = 0xFFFFFFFF


def n_words(n: int) -> int:
    """Number of 32-bit words needed for an ``n``-bit vector."""
    return -(-int(n) // WORD)


def _as_i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit pattern) words as non-negative int64."""
    if words.dtype == torch.uint32:
        return words.to(torch.int64)
    return words.to(torch.int64) & _MASK32


def pack_bits(bits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pack a boolean (or 0/1 integer) tensor into uint32 words along
    ``dim``: length ``n`` becomes ``ceil(n / 32)`` words, LSB-first, pad
    bits zero."""
    b = torch.movedim(bits, dim, -1).to(torch.int64) != 0
    n = b.shape[-1]
    w = n_words(n)
    pad = w * WORD - n
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (w, WORD)).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    words = (b << shifts).sum(-1)
    return torch.movedim(words.to(torch.uint32), -1, dim)


def unpack_bits(words: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: expand words back to ``n`` bools."""
    w = _as_i64(torch.movedim(words, dim, -1))
    shifts = torch.arange(WORD, dtype=torch.int64, device=w.device)
    bits = (w[..., None] >> shifts) & 1
    bits = bits.reshape(bits.shape[:-2] + (-1,))[..., :n] != 0
    return torch.movedim(bits, -1, dim)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR), returned as int32."""
    x = _as_i64(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _MASK32) >> 24).to(torch.int32)


def tail_mask(n: int, words: int | None = None,
              device: torch.device | str | None = None) -> torch.Tensor:
    """uint32 word vector with bits ``[0, n)`` set and the rest clear;
    ``words`` (>= ``n_words(n)``) pads it with all-zero words."""
    w = n_words(n) if words is None else int(words)
    return pack_bits(torch.arange(w * WORD, device=device) < int(n))


def lane_and(a, b):
    """Lane-wise AND of packed words (set intersection); uint32 out for
    tensors, the operands' own dtype for numpy arrays."""
    if isinstance(a, torch.Tensor):
        return (_as_i64(a) & _as_i64(b)).to(torch.uint32)
    return a & b


def lane_or(a, b):
    """Lane-wise OR of packed words (set union; re-mask the tail if the
    operands disagree about pad bits)."""
    if isinstance(a, torch.Tensor):
        return (_as_i64(a) | _as_i64(b)).to(torch.uint32)
    return a | b


def packed_any_count(words: torch.Tensor, n: int, dim: int = -1
                     ) -> torch.Tensor:
    """Count set bits of an ``n``-bit packed vector along ``dim`` — AND
    with the ragged-tail mask, popcount, sum.  int32."""
    mask = tail_mask(n, words=words.shape[dim], device=words.device)
    shape = [1] * words.dim()
    shape[dim] = -1
    masked = _as_i64(words) & _as_i64(mask).reshape(shape)
    return popcount(masked).sum(dim, dtype=torch.int32)


def support_path_cost_model(c: int, g: int, n_workers: int, *,
                            packed: bool) -> dict:
    """Modeled support-dimension bytes for one mining level (the JAX
    package's model, ``repro.kernels.bitset.support_path_cost_model``):

    * ``hbm_bytes`` — the (C, G) verdict lanes a dense backend carries as
      int32 vs ``(C, ceil(G/32))`` 32-bit bitset words,
    * ``collective_bytes`` — the per-worker verdict all-gather after
      ``reduce_scatter`` thresholding (int8 lanes vs packed words),
    * ``host_bytes`` — the per-worker gsup wire slice (int32 vs the
      2x-uint16 packed words of the sharded wire).

    The constants mirror ``core/level_step.py::wire_cost_model``."""
    w = max(int(n_workers), 1)
    ring = (w - 1) / w
    cs = -(-int(c) // w)
    if packed:
        hbm = c * n_words(g) * 4
        coll = ring * n_words(c) * 4
        host = -(-cs // 2) * 4
    else:
        hbm = c * g * 4
        coll = ring * c * 1
        host = cs * 4
    return {"hbm_bytes": float(hbm), "collective_bytes": float(coll),
            "host_bytes": float(host),
            "total_bytes": float(hbm + coll + host)}
