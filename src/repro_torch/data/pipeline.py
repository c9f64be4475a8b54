"""Deterministic, shardable, resumable synthetic data pipeline, a copy
of ``repro.data.pipeline`` (numpy only): the same batches, bit for bit,
for any ``(seed, step, shard, n_shards)``.

Every batch is a pure function of (seed, step, shard) — the pipeline
cursor IS the step counter, so checkpoint/restore and elastic re-sharding
are free: a restarted job with a different dp-shard count regenerates
exactly the same global batch.

The token stream has learnable structure (noisy affine next-token rule
over the vocab) so end-to-end examples show loss actually falling.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    mult: int = 31
    offset: int = 7

    def _rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        """(len(rows), seq_len+1) tokens for global row indices."""
        out = np.empty((len(rows), self.seq_len + 1), np.int64)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 65_537 + int(r))
            toks = np.empty(self.seq_len + 1, np.int64)
            toks[0] = rng.integers(0, self.vocab)
            nz = rng.random(self.seq_len) < self.noise
            rnd = rng.integers(0, self.vocab, self.seq_len)
            for t in range(self.seq_len):
                nxt = (toks[t] * self.mult + self.offset) % self.vocab
                toks[t + 1] = rnd[t] if nz[t] else nxt
            out[i] = toks
        return out

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1
              ) -> dict[str, np.ndarray]:
        """Local slice of the global batch for this dp shard."""
        assert self.global_batch % n_shards == 0
        per = self.global_batch // n_shards
        rows = np.arange(shard * per, (shard + 1) * per)
        toks = self._rows(step, rows)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
