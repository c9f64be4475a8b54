"""Whole-run device-resident mining loop (pipeline="device_loop",
DESIGN.md §13) — the port of ``repro.core.device_loop``.

The single-sync pipeline reads the device once per level: the wire, then
host candgen and a new dispatch.  This module takes the loop off the
host.  Every level of the run is one *body*, queued on the current
stream with no device→host read anywhere in it:

  1. candidate generation — ``candgen.device_candidates``: rightmost-
     path extension slots over array-shaped DFS codes and the bounded-
     state ``min_dfs_canonical_array`` machine, compacted into a fixed
     candidate budget CB in EXACTLY the host generator's order;
  2. schedule + map — the fused backends take ``candgen.device_schedule``
     and launch B1 (packed) or B2 (dense) on it; ``"pallas"`` launches
     the two-launch kernels B3 + B4 on the device-built candidate table;
     ``"ref"`` (the CPU's) runs the plain join;
  3. shuffle — ``mapreduce.reduce_supports`` with the supports gathered
     on every rank (the run outputs need them all);
  4. reduce — verdict-masked prefix-sum compaction of the survivors into
     the SPP parent slots, then pass 2 as one
     ``kernels.materialize.materialize_level`` launch over the slots;
  5. bookkeeping — the level's stats row (candidates, survivors,
     overflow, imbalance, bail flags), survivor supports and codes
     written at the level's slot of the run outputs.

JAX runs the bodies inside one ``lax.while_loop`` whose condition is
``(k < k_stop) & (n_par > 0) & ok``.  Eager PyTorch has no device-side
loop, but the level count is known on the host: each body is one level
and ``max_size`` is finite, so the miner queues exactly ``k_stop −
k_cur`` bodies per chunk, in ``ceil(·/unroll)`` calls of the program
(one call when ``unroll`` is 0).  Only ``n_par > 0`` and ``ok`` are
device values: each body computes ``live = (n_par > 0) & ok`` on the
device and updates every element of the carry through
``torch.where(live, new, old)`` (the OL stores in place, so that no
third store is allocated; the carry object itself is updated in place,
so that no caller holds a parent store past its body).  A body past the
end of the run still launches its kernels on inputs it then discards.

The host receives ONE transfer per chunk — the run wire:

  [ out_stats (NL·6) | out_sups (NL·SPP) | out_codes (NL·SPP·L·5)
    | k_final | n_par | ok | total_overflow | checksum ]

word for word the JAX package's layout, checked with the same
position-salted checksum (``level_step.wire_checksum``).

Memory: ``repro`` carries SPP = max(bucket(n_par0), CB) parent slots;
at the 40K-graph scale that is 2048 slots of a (PP, G, M, NV) store,
which no card holds twice.  The miner clamps SPP to the device's free
memory (``Mirage._device_loop_slots``, CUDA only), and a level with more
survivors than slots sets ``FLAG_SLOT_OVF``: the run bails and the
miner replays it through the single-sync pipeline, exactly.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.materialize import materialize_level
from ..kernels.ops import (device_local_supports, fused_level_supports,
                           fused_level_supports_packed, is_fused_backend)
from .candgen import device_candidates, device_schedule
from .level_step import _IMBAL_FX, upload, wire_checksum
from .mapreduce import MiningMesh, reduce_supports, worker_imbalance

__all__ = ["DeviceLoopFallback", "RunWire", "RunCarry", "run_wire_words",
           "decode_run_wire", "init_carry", "run_program", "NSTAT",
           "FLAG_RAW_OVF", "FLAG_CANON_OVF", "FLAG_STATE_OVF",
           "FLAG_SCHED_OVF", "FLAG_SLOT_OVF"]

#: per-level stats words in the run wire:
#: [n_candidates, n_keep, overflow, imbalance·2^16, bail flags, reserved]
NSTAT = 6

#: bail-flag bits (stats word 4): any nonzero flag stops the loop and
#: sends the miner to the single-sync fallback
FLAG_RAW_OVF = 1        # structural slots overflowed the raw budget
FLAG_CANON_OVF = 2      # canonical candidates overflowed CB
FLAG_STATE_OVF = 4      # canonicality machine overflowed max_states
FLAG_SCHED_OVF = 8      # tile-padded schedule overflowed the row budget
FLAG_SLOT_OVF = 16      # survivors overflowed the (memory-clamped) SPP


class DeviceLoopFallback(RuntimeError):
    """The device loop bailed (budget/state/schedule/slot overflow, or
    overflow at the M ceiling) — the miner replays the run through the
    per-level single-sync pipeline, which has no static budgets."""


@dataclasses.dataclass
class RunWire:
    """Host view of the run's single transfer."""

    stats: np.ndarray      # (NL, NSTAT) int32 per-level stats rows
    sups: np.ndarray       # (NL, SPP) int32 survivor supports, slot order
    codes: np.ndarray      # (NL, SPP, L, 5) int32 survivor DFS codes
    k_final: int           # parent size the loop stopped at
    n_par: int             # surviving parent count at the stop
    ok: bool               # False = a bail flag tripped mid-run
    total_overflow: int    # M-cap overflow summed over the run


def run_wire_words(n_levels: int, spp: int, max_edges: int) -> int:
    """Total int32 words of the run wire (incl. trailer + checksum)."""
    return (n_levels * NSTAT + n_levels * spp
            + n_levels * spp * max_edges * 5 + 4 + 1)


def decode_run_wire(body: np.ndarray, n_levels: int, spp: int,
                    max_edges: int) -> RunWire:
    """Decode a (checksum-stripped) run-wire body by explicit offsets."""
    o = 0
    stats = body[o:o + n_levels * NSTAT].reshape(n_levels, NSTAT)
    o += n_levels * NSTAT
    sups = body[o:o + n_levels * spp].reshape(n_levels, spp)
    o += n_levels * spp
    codes = body[o:o + n_levels * spp * max_edges * 5].reshape(
        n_levels, spp, max_edges, 5)
    o += n_levels * spp * max_edges * 5
    k_final, n_par, ok, tovf = (int(x) for x in body[o:o + 4])
    return RunWire(stats, sups, codes, k_final, n_par, bool(ok), tovf)


@dataclasses.dataclass
class RunCarry:
    """The loop carry, all on the device (the JAX ``while_loop`` carry
    minus the static inputs)."""

    k: torch.Tensor          # () int32 parent size of the next body
    n_par: torch.Tensor      # () int32 live parent count
    codes: torch.Tensor      # (SPP, L, 5) int32 parent codes
    pol: torch.Tensor        # (PP, SPP, G, M, NV) int32 parent store
    pmask: torch.Tensor      # (PP, SPP, G, M) bool
    out_codes: torch.Tensor  # (NL, SPP, L, 5) int32
    out_sups: torch.Tensor   # (NL, SPP) int32
    out_stats: torch.Tensor  # (NL, NSTAT) int32
    ok: torch.Tensor         # () bool
    tovf: torch.Tensor       # () int32 overflow summed over the run


def init_carry(k0: int, codes: np.ndarray, pol: torch.Tensor,
               pmask: torch.Tensor, n_levels: int) -> RunCarry:
    """A fresh carry at parent size ``k0``: ``codes`` (SPP, L, 5) host
    rows (the first rows real, -1 after) and the parent store already at
    its (PP, SPP, G, M, NV) shape.  Built before the first body: the one
    host→device copy is a pinned, non-blocking upload."""
    dev = pol.device
    spp, L = codes.shape[0], codes.shape[1]
    n_par = int((codes[:, 0, 0] >= 0).sum())

    def scalar(v, dtype=torch.int32):
        return torch.full((), v, dtype=dtype, device=dev)

    return RunCarry(
        k=scalar(k0), n_par=scalar(n_par), codes=upload(codes, dev),
        pol=pol, pmask=pmask,
        out_codes=torch.full((n_levels, spp, L, 5), -1, dtype=torch.int32,
                             device=dev),
        out_sups=torch.zeros((n_levels, spp), dtype=torch.int32,
                             device=dev),
        out_stats=torch.zeros((n_levels, NSTAT), dtype=torch.int32,
                              device=dev),
        ok=scalar(True, torch.bool), tovf=scalar(0))


def _body(c: RunCarry, k: int, triples, src, dst, emask, *,
          mesh: MiningMesh, minsup: int, backend: str, reduce: str,
          packed: bool, n_vertex_slots: int, c_budget: int, raw_budget: int,
          max_states: int, tile_c: int, sched_rows: int,
          n_triples: int) -> None:
    """One level (parent size ``k``, known to the host) of the run,
    queued without a device→host read.  The carry is updated in place,
    so that no caller holds the parent store past the body: two stores
    (parent and child) are alive at any time."""
    SPP = c.codes.shape[0]
    M, K = c.pol.shape[-2:]
    dev = c.pol.device
    live = (c.n_par > 0) & c.ok

    # 1. right-most-extension candidates, host order (candgen.py)
    meta, child, n_cand, cg_flags = device_candidates(
        c.codes, c.n_par, triples, n_vertex_slots=n_vertex_slots,
        raw_budget=raw_budget, budget=c_budget, max_states=max_states)

    # 2+3. map phase + shuffle — the level program's kernels and
    # collectives, on a schedule built on the device
    if is_fused_backend(backend):
        sched, tiles, inv, sc_ovf = device_schedule(
            meta, n_cand, tile_c=tile_c, n_triples=n_triples,
            rows=sched_rows)
        if packed:
            sup_pp, emb_s, _vbits = fused_level_supports_packed(
                sched, tiles, c.pol, c.pmask, src, dst, emask)
        else:
            sup_pp, emb_s = fused_level_supports(
                sched, tiles, c.pol, c.pmask, src, dst, emask)
        local_sup = sup_pp.sum(0, dtype=torch.int32).index_select(0, inv)
        emb_pp = emb_s.index_select(1, inv)                  # (PP, CB)
    else:
        local_sup, _, emb_pp = device_local_supports(
            meta, c.pol, c.pmask, src, dst, emask, backend=backend,
            packed=packed)
        sc_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    gsup, verdict = reduce_supports(local_sup, mesh, minsup, reduce,
                                    gather_gsup=True, packed=packed)

    # 4. survivor compaction into the SPP parent slots; survivors past
    # the slots land in the dump slot SPP and trip FLAG_SLOT_OVF
    CB = meta.shape[0]
    real = torch.arange(CB, device=dev) < n_cand
    keep = (verdict != 0) & real
    rank = keep.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    n_keep = rank[-1] + 1
    dest = torch.where(keep & (rank < SPP), rank, SPP).to(torch.int64)
    surv = torch.zeros(SPP + 1, dtype=torch.int64, device=dev).scatter_(
        0, dest, torch.arange(CB, dtype=torch.int64, device=dev))[:SPP]
    valid_s = torch.arange(SPP, device=dev) < n_keep
    cmeta = meta.index_select(0, surv)                       # (SPP, 5)

    # pass 2: one launch over the SPP slots; the slots at or past the
    # survivor count (read on the device) do no join and come out PAD
    new_pol, new_pmask, over = materialize_level(
        cmeta, n_keep, c.pol, c.pmask, src, dst, emask, max_embeddings=M,
        out_width=K)
    overflow = over.sum(dtype=torch.int64)
    overflow = mesh.all_reduce(overflow.reshape(1))[0].to(torch.int32)

    # 5. run-output bookkeeping at this level's slot
    cost = mesh.all_gather((emb_pp * real[None, :]).sum(1, dtype=torch.int32))
    imbal = worker_imbalance(cost, mesh.n_workers)
    flags = (cg_flags[0].to(torch.int32) * FLAG_RAW_OVF
             | cg_flags[1].to(torch.int32) * FLAG_CANON_OVF
             | cg_flags[2].to(torch.int32) * FLAG_STATE_OVF
             | sc_ovf.to(torch.int32) * FLAG_SCHED_OVF
             | (n_keep > SPP).to(torch.int32) * FLAG_SLOT_OVF)
    slot = k - 1
    stats = torch.stack([n_cand, n_keep, overflow,
                         (imbal * _IMBAL_FX).to(torch.int32), flags,
                         torch.zeros_like(flags)])
    sups = torch.where(valid_s, gsup.index_select(0, surv), 0)
    codes = torch.where(valid_s[:, None, None], child.index_select(0, surv),
                        -1)
    c.out_stats[slot] = torch.where(live, stats, c.out_stats[slot])
    c.out_sups[slot] = torch.where(live, sups.to(torch.int32),
                                   c.out_sups[slot])
    c.out_codes[slot] = torch.where(live, codes, c.out_codes[slot])
    c.k = torch.where(live, c.k + 1, c.k)
    c.n_par = torch.where(live, n_keep, c.n_par)
    c.codes = torch.where(live, codes, c.codes)
    c.pol = torch.where(live, new_pol, c.pol, out=new_pol)
    c.pmask = torch.where(live, new_pmask, c.pmask, out=new_pmask)
    c.ok = torch.where(live, c.ok & (flags == 0), c.ok)
    c.tovf = torch.where(live, c.tovf + overflow, c.tovf)


def run_wire(c: RunCarry) -> torch.Tensor:
    """The run wire of a carry, on the device, checksum word last."""
    body = torch.cat([
        c.out_stats.reshape(-1), c.out_sups.reshape(-1),
        c.out_codes.reshape(-1),
        torch.stack([c.k, c.n_par, c.ok.to(torch.int32), c.tovf])])
    return torch.cat([body, wire_checksum(body).reshape(1)])


@functools.lru_cache(maxsize=32)
def _run_program(mmesh: MiningMesh, minsup: int, backend: str,
                 reduce: str, packed: bool, max_edges: int,
                 n_vertex_slots: int, c_budget: int, raw_budget: int,
                 max_states: int, n_levels: int, tile_c: int,
                 sched_rows: int, n_triples: int):
    """Build (once per static config) the whole-run program:
    ``program(carry, k_first, n_bodies, triples, src, dst, emask) ->
    (wire, carry)`` queues ``n_bodies`` predicated bodies for parent
    sizes ``k_first, k_first + 1, ...`` on ``carry`` (updated in place
    and returned) and the run wire after them.

    All shapes are static: CB (``c_budget``) is the canonical candidate
    budget, CBR (``raw_budget``) the structural raw budget, SPP (the
    carry's codes axis) the parent/survivor slot count, NL the level-slot
    count, and the fused schedule lives in ``sched_rows`` rows of
    ``tile_c``.  ``max_edges`` and ``n_levels`` are checked against the
    carry."""
    body = functools.partial(
        _body, mesh=mmesh, minsup=minsup, backend=backend, reduce=reduce,
        packed=packed, n_vertex_slots=n_vertex_slots, c_budget=c_budget,
        raw_budget=raw_budget, max_states=max_states, tile_c=tile_c,
        sched_rows=sched_rows, n_triples=n_triples)

    def program(carry: RunCarry, k_first: int, n_bodies: int, triples,
                src, dst, emask):
        if (carry.codes.shape[1] != max_edges
                or carry.out_stats.shape[0] != n_levels):
            raise ValueError("the carry's shape differs from the program's")
        if not (0 < k_first and k_first + n_bodies - 1 <= n_levels):
            raise ValueError(f"bodies {k_first}..{k_first + n_bodies - 1} "
                             f"outside the run's {n_levels} level slots")
        for k in range(k_first, k_first + n_bodies):
            body(carry, k, triples, src, dst, emask)
        return run_wire(carry), carry

    return program


def run_program(*args, **kwargs):
    """Public accessor of the cached whole-run program: it looks
    ``_run_program`` up at each call, so a wrapper patched over it (a
    build-count tracer in tests) is seen through it."""
    return _run_program(*args, **kwargs)
