"""Map / shuffle / reduce phases of MIRAGE over a pool of workers.

The JAX package runs these as ``shard_map`` SPMD programs over a TPU
mesh, one process driving every device (``repro.core.mapreduce``).  The
port is multi-controller: one ``torch.distributed`` rank per worker,
each rank running the same host driver on the same inputs and holding
its block of the partition axis (``runtime/sharding.py``).  The
shuffle's collectives run on the rank's device tensors:

  psum                    → ``dist.all_reduce``
  psum_scatter (tiled)    → ``dist.reduce_scatter_tensor``
  all_gather (tiled)      → ``dist.all_gather_into_tensor``

The process group's backend belongs to the caller: NCCL for one rank per
card, gloo on the CPU.  ``MiningMesh.single_device()`` is the one-worker
mesh with no process group: its collectives are identities.

``map_reduce_supports`` and ``map_materialize`` are the two programs of
the legacy pipeline (support round, then pass 2, with host round trips
between them); the single-sync pipeline runs the same phases inside one
level program (``core/level_step.py``).
"""
from __future__ import annotations

import dataclasses
import socket
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.bitset import pack_bits, unpack_bits
from ..kernels.ops import (device_local_supports, fused_level_supports,
                           fused_level_supports_packed, is_fused_backend,
                           is_packed_backend)
from .candgen import schedule_candidates
from .embedding import LevelOL, materialize_ol

__all__ = ["MiningMesh", "map_reduce_supports", "map_materialize",
           "reduce_supports", "worker_imbalance"]


@dataclasses.dataclass(frozen=True)
class MiningMesh:
    """The worker pool of one run: one rank of ``group`` per worker, on
    ``device``.  ``group=None`` is the one-worker mesh (no process
    group; every collective is an identity).  ``ranks_per_device``
    counts the ranks of the group that share this rank's device (they
    share its memory too)."""

    group: Optional["dist.ProcessGroup"] = None
    rank: int = 0
    n_workers: int = 1
    device: Optional[torch.device] = None
    ranks_per_device: int = 1

    @staticmethod
    def single_device() -> "MiningMesh":
        return MiningMesh()

    @staticmethod
    def from_process_group(group: "dist.ProcessGroup",
                           device: torch.device | str) -> "MiningMesh":
        """The mesh of an initialized process group, this rank working on
        ``device``.  Collective over the group: the ranks exchange where
        they run, to count those sharing this rank's device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = MiningMesh(group, dist.get_rank(group),
                          dist.get_world_size(group), device)
        where = torch.tensor([[zlib.crc32(socket.gethostname().encode()),
                               device.index if device.index is not None
                               else -1]], dtype=torch.int64)
        seen = mesh.all_gather(where.to(device)).cpu()
        return dataclasses.replace(
            mesh, ranks_per_device=int((seen == where).all(1).sum()))

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) of ``t`` over the workers, in place."""
        if self.group is not None:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every worker's ``t`` concatenated along dim 0, in rank order."""
        if self.group is None:
            return t
        if t.dtype == torch.bool:
            return self.all_gather(t.view(torch.uint8)).view(torch.bool)
        out = t.new_empty((self.n_workers * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This worker's block of dim 0 of the sum of ``t`` over the
        workers (dim 0 must divide by the worker count)."""
        if self.group is None:
            return t
        out = t.new_empty((t.shape[0] // self.n_workers, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        return out

    def barrier(self) -> None:
        """Host barrier over the workers."""
        if self.group is not None:
            dist.barrier(group=self.group)


def worker_imbalance(cost: torch.Tensor, n_workers: int) -> torch.Tensor:
    """max/mean per-worker cost under the blocked partition→worker
    assignment, as a float32 0-dim tensor (1.0 when the mesh is idle)."""
    per_worker = cost.to(torch.float32).reshape(n_workers, -1).sum(-1)
    mean = per_worker.mean()
    one = torch.ones((), dtype=torch.float32, device=cost.device)
    return torch.where(mean > 0, per_worker.max() / mean, one)


def reduce_supports(local_sup: torch.Tensor, mesh: MiningMesh, minsup: int,
                    reduce: str, *, gather_gsup: bool = False,
                    packed: bool = False):
    """The shuffle: dense-key aggregation of (C,) local supports into the
    global supports and the int8 frequent verdicts (C,).

    ``psum`` gives every worker the whole support vector.
    ``reduce_scatter`` gives each worker its contiguous C/W key shard
    (the reducer owns a key range) and all-gathers only the verdicts —
    and, with ``gather_gsup``, the supports.  With ``packed`` each worker
    packs its verdict shard into ``ceil(C/W/32)`` words, the words are
    gathered, and each shard unpacks ragged: bit-identical to the dense
    exchange."""
    if reduce == "psum":
        gsup = mesh.all_reduce(local_sup)
        verdict = (gsup >= minsup).to(torch.int8)
    elif reduce == "reduce_scatter":
        gsup = mesh.reduce_scatter(local_sup)              # (C/W,) shard
        if packed:
            cs = gsup.shape[0]
            words = pack_bits(gsup >= minsup).view(torch.int32)
            shards = mesh.all_gather(words).view(torch.uint32).reshape(
                -1, words.shape[0])                        # (W, ww)
            verdict = unpack_bits(shards, cs).reshape(-1).to(torch.int8)
        else:
            verdict = mesh.all_gather((gsup >= minsup).to(torch.int8))
        if gather_gsup:
            gsup = mesh.all_gather(gsup)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    return gsup, verdict


def _support_program(mesh, meta, pol, pmask, src, dst, emask, *,
                     minsup: int, backend: str, reduce: str,
                     gather_gsup: bool = True):
    """The support round of a non-fused backend: the map phase over the
    rank's partitions, then the shuffle (``reduce_supports``; without
    ``gather_gsup`` a ``reduce_scatter`` round leaves each rank its
    support shard, as ``repro``'s program does)."""
    local_sup, _local_emb, emb_pp = device_local_supports(
        meta, pol, pmask, src, dst, emask, backend=backend)
    gsup, verdict = reduce_supports(local_sup, mesh, minsup, reduce,
                                    gather_gsup=gather_gsup)
    return gsup, verdict, emb_pp


def _support_program_fused(mesh, sched_meta, tiles, inv, pol, pmask, src,
                           dst, emask, *, minsup: int, backend: str,
                           reduce: str):
    """The support round of a fused backend: ONE kernel launch covers
    every local partition and candidate tile.  Inputs are in scheduled
    (parent-grouped) order; the inverse permutation is applied before
    the shuffle, so the shuffle and the caller see canonical order."""
    if is_packed_backend(backend):
        sup_pp, emb_pp_s, _vbits = fused_level_supports_packed(
            sched_meta, tiles, pol, pmask, src, dst, emask)
    else:
        sup_pp, emb_pp_s = fused_level_supports(sched_meta, tiles, pol,
                                                pmask, src, dst, emask)
    local_sup = sup_pp.sum(0, dtype=torch.int32).index_select(0, inv)
    emb_pp = emb_pp_s.index_select(1, inv)               # (PP, C) canonical
    gsup, verdict = reduce_supports(local_sup, mesh, minsup, reduce,
                                    gather_gsup=True)
    return gsup, verdict, emb_pp


def map_reduce_supports(mmesh: MiningMesh, meta, pol, pmask, src, dst,
                        emask, *, minsup: int, backend: str,
                        reduce: str = "psum"):
    """One full map+shuffle+reduce support round of the legacy pipeline.

    Returns ``(global_support (C,), frequent_verdict (C,), per-partition
    embed counts (NP, C))`` as host numpy on every rank, in canonical
    candidate order for every backend: the supports and each rank's
    (NP/W, C) embed counts are all-gathered before the host reads them.  The reduce_scatter variant needs the candidate
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
            mmesh, *(torch.from_numpy(a).to(pol.device) for a in
              (sched.meta, sched.tiles, sched.inv.astype(np.int64))),
            pol, pmask, src, dst, emask, **kw)
    else:
        gsup, verdict, emb_pp = _support_program(mmesh, meta, pol, pmask,
                                                 src, dst, emask, **kw)
    emb_pp = mmesh.all_gather(emb_pp)                    # (NP, C)
    return (gsup.cpu().numpy()[:C], verdict.cpu().numpy()[:C],
            emb_pp.cpu().numpy()[:, :C])


def map_materialize(mmesh: MiningMesh, keep_meta, pol, pmask, src, dst,
                    emask, *, max_embeddings: int,
                    out_width: int | None = None):
    """Pass 2 for the retry path: the rank's block (NP/W, C', G, M, W) of
    the next level's OL store for the surviving candidates ``keep_meta``
    (host rows) and the overflow summed over every worker as a Python
    int (one device→host read, as in the JAX package).  Every rank sees
    the same overflow, so every rank's escalation valve takes the same
    decision."""
    ol, mask, total = _materialize_program(
        mmesh, keep_meta, pol, pmask, src, dst, emask,
        max_embeddings=max_embeddings, out_width=out_width)
    return ol, mask, int(total)


def _materialize_program(mmesh: MiningMesh, keep_meta, pol, pmask, src,
                         dst, emask, *, max_embeddings: int,
                         out_width: int | None = None):
    """``map_materialize``'s device work: the rank's block of the next
    OL store and mask, and the overflow summed over the workers as a
    (1,) int64 tensor on the device."""
    lvl, over = materialize_ol(LevelOL(pol, pmask), src, dst, emask,
                               keep_meta, max_embeddings=max_embeddings,
                               out_width=out_width)
    total = mmesh.all_reduce(over.sum().to(torch.int64).reshape(1))
    return lvl.ol, lvl.mask, total
