"""Map / shuffle / reduce phases of MIRAGE on one worker (W=1).

The JAX package runs these as ``shard_map`` SPMD programs over a TPU
mesh (``repro.core.mapreduce``).  This slice of the port runs one worker:
the collectives of the shuffle are identities, but the code keeps their
shape — the ``reduce_scatter`` shuffle still packs its verdicts to bit
lanes and unpacks them again when ``packed`` is on — so the multi-worker
slice (ROADMAP queue A item 8) only swaps in ``torch.distributed`` calls.

``map_reduce_supports`` and ``map_materialize`` are the two programs of
the legacy pipeline (support round, then pass 2, with host round trips
between them); the single-sync pipeline runs the same phases inside one
level program (``core/level_step.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.bitset import pack_bits, unpack_bits
from ..kernels.ops import (device_local_supports, fused_level_supports,
                           fused_level_supports_packed, is_fused_backend)
from .candgen import schedule_candidates
from .embedding import LevelOL, materialize_ol

__all__ = ["MiningMesh", "map_reduce_supports", "map_materialize",
           "reduce_supports", "worker_imbalance"]


@dataclasses.dataclass(frozen=True)
class MiningMesh:
    """The worker pool of one run.  This slice of the port has one
    worker: one device, every partition on it."""

    @property
    def n_workers(self) -> int:
        return 1

    @staticmethod
    def single_device() -> "MiningMesh":
        return MiningMesh()


def worker_imbalance(cost: torch.Tensor, n_workers: int) -> torch.Tensor:
    """max/mean per-worker cost under the blocked partition→worker
    assignment, as a float32 0-dim tensor (1.0 when the mesh is idle)."""
    per_worker = cost.to(torch.float32).reshape(n_workers, -1).sum(-1)
    mean = per_worker.mean()
    one = torch.ones((), dtype=torch.float32, device=cost.device)
    return torch.where(mean > 0, per_worker.max() / mean, one)


def reduce_supports(local_sup: torch.Tensor, minsup: int, reduce: str, *,
                    packed: bool = False):
    """The shuffle: dense-key aggregation of (C,) local supports into the
    global supports and the int8 frequent verdicts.  With one worker the
    psum, psum_scatter and all_gather are identities."""
    if reduce == "psum":
        gsup = local_sup
        verdict = (gsup >= minsup).to(torch.int8)
    elif reduce == "reduce_scatter":
        gsup = local_sup                                   # (C/W,) shard
        if packed:
            cs = gsup.shape[0]
            words = pack_bits(gsup >= minsup)              # (ceil(cs/32),)
            shards = words.reshape(-1, words.shape[0])     # (W, ww)
            verdict = unpack_bits(shards, cs).reshape(-1).to(torch.int8)
        else:
            verdict = (gsup >= minsup).to(torch.int8)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    return gsup, verdict


def _support_program(meta, pol, pmask, src, dst, emask, *, minsup: int,
                     backend: str, reduce: str):
    """The support round of a non-fused backend: the map phase over the
    device's partitions, then the shuffle."""
    local_sup, _local_emb, emb_pp = device_local_supports(
        meta, pol, pmask, src, dst, emask, backend=backend)
    gsup, verdict = reduce_supports(local_sup, minsup, reduce)
    return gsup, verdict, emb_pp


def _support_program_fused(sched_meta, tiles, inv, pol, pmask, src, dst,
                           emask, *, minsup: int, backend: str,
                           reduce: str):
    """The support round of a fused backend: ONE kernel launch covers
    every local partition and candidate tile.  Inputs are in scheduled
    (parent-grouped) order; the inverse permutation is applied before
    the shuffle, so the shuffle and the caller see canonical order."""
    if backend == "fused_packed":
        sup_pp, emb_pp_s, _vbits = fused_level_supports_packed(
            sched_meta, tiles, pol, pmask, src, dst, emask)
    else:
        sup_pp, emb_pp_s = fused_level_supports(sched_meta, tiles, pol,
                                                pmask, src, dst, emask)
    local_sup = sup_pp.sum(0, dtype=torch.int32).index_select(0, inv)
    emb_pp = emb_pp_s.index_select(1, inv)               # (PP, C) canonical
    gsup, verdict = reduce_supports(local_sup, minsup, reduce)
    return gsup, verdict, emb_pp


def map_reduce_supports(mmesh: MiningMesh, meta, pol, pmask, src, dst,
                        emask, *, minsup: int, backend: str,
                        reduce: str = "psum"):
    """One full map+shuffle+reduce support round of the legacy pipeline.

    Returns ``(global_support (C,), frequent_verdict (C,), per-partition
    embed counts (NP, C))`` as host numpy, in canonical candidate order
    for every backend.  The reduce_scatter variant needs the candidate
    axis divisible by the worker count; when it is not, the metadata is
    padded with the rows ``mining.py`` pads with and every output is
    sliced back to C.  The fused backends build the parent-grouped tile
    schedule here, on the host, from the host rows ``meta``."""
    meta = np.asarray(meta, np.int32).reshape(-1, 5)
    C = meta.shape[0]
    W = mmesh.n_workers
    if reduce == "reduce_scatter" and C % W:
        pad = W - C % W
        meta = np.concatenate(
            [meta, np.tile([[0, 0, 0, 1, 0]], (pad, 1))]).astype(np.int32)
    kw = dict(minsup=minsup, backend=backend, reduce=reduce)
    if is_fused_backend(backend):
        sched = schedule_candidates(meta)
        gsup, verdict, emb_pp = _support_program_fused(
            *(torch.from_numpy(a).to(pol.device) for a in
              (sched.meta, sched.tiles, sched.inv.astype(np.int64))),
            pol, pmask, src, dst, emask, **kw)
    else:
        gsup, verdict, emb_pp = _support_program(meta, pol, pmask, src,
                                                 dst, emask, **kw)
    return (gsup.cpu().numpy()[:C], verdict.cpu().numpy()[:C],
            emb_pp.cpu().numpy()[:, :C])


def map_materialize(keep_meta, pol, pmask, src, dst, emask, *,
                    max_embeddings: int, out_width: int | None = None):
    """Pass 2 for the retry path: the next level's OL store
    (NP, C', G, M, W) for the surviving candidates ``keep_meta`` (host
    rows) and the total overflow as a Python int (one device→host read,
    as in the JAX package)."""
    lvl, over = materialize_ol(LevelOL(pol, pmask), src, dst, emask,
                               keep_meta, max_embeddings=max_embeddings,
                               out_width=out_width)
    return lvl.ol, lvl.mask, int(over.sum())
