"""Map / shuffle / reduce phases of MIRAGE on one worker (W=1).

The JAX package runs these as ``shard_map`` SPMD programs over a TPU
mesh (``repro.core.mapreduce``).  This slice of the port runs one worker:
the collectives of the shuffle are identities, but the code keeps their
shape — the ``reduce_scatter`` shuffle still packs its verdicts to bit
lanes and unpacks them again when ``packed`` is on — so the multi-worker
slice (ROADMAP queue A item 8) only swaps in ``torch.distributed`` calls.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.bitset import pack_bits, unpack_bits
from .embedding import LevelOL, materialize_ol

__all__ = ["MiningMesh", "map_materialize", "reduce_supports",
           "worker_imbalance"]


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
