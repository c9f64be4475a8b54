"""Single-sync level program (DESIGN.md §8), on every worker's rank.

One mining level runs as ONE stretch of device work queued on the
current stream — the port of ``repro.core.level_step._level_program``;
each rank runs it over its own block of partitions:

  1. pass-1 support counting   (the fused kernel, the two-launch
                                kernels, or the plain join)
  2. the shuffle               (``mapreduce.reduce_supports``: the
                                collectives of the rank's process group)
  3. survivor compaction       (verdict-masked prefix-sum rank, one
                                scatter; survivor metadata gathered to the
                                front, padded to a static cap S)
  4. the audit word            (device-side invariant checks, §14)
  5. pass-2 materialization    (child OLs for the S compact slots)
  6. the straggler rebalance   (the (NP,) partition costs all-gathered,
                                so every rank takes the same LPT
                                decision)
  7. the wire                  (supports | scalars | perm | checksum)

Nothing in it reads a device value back before the wire: the host learns
the survivor count only from the wire itself.  So pass 2 is one kernel
launch over all S slots (``kernels/materialize.py``, ``csrc/
materialize.cu``) that reads the survivor count on the device: a slot at
or past it does no join and is written as PAD, the counterpart of the
JAX program's ``lax.cond`` skip.  On the CPU its plain version runs
``materialize_one`` per slot and masks those slots.  Each rank receives
exactly ONE device→host transfer per level, the int32 wire (see
``repro.core.level_step`` for the layouts).  With the sharded layout
each rank packs its own shard — its Cp/W support slice, the replicated
scalars and perm, a shard checksum — and the shards are all-gathered on
the device, because every rank needs the whole wire to drive the next
level; the host then verifies each shard's checksum.  A rank's shard is laid out as:

  [0:Cp/W]    global support per (padded) candidate of the rank's key
              slice (all Cp with the dense layout) — with ``packed``,
              two uint16 supports per int32 word
  [+0]        true survivor count (may exceed the cap S — driver retries)
  [+1]        overflow (matches dropped by the M cap, survivors only)
  [+2]        rebalanced flag (0/1)
  [+3]        imbalance, 16.16 fixed point
  [+4]        audit word (0 = every check passed)
  [+5:-1]     the (NP,) partition permutation that was applied
  [-1]        checksum word over everything before it

The wire must equal the JAX package's word for word.  Its arithmetic is
wrapping uint32; PyTorch does not shift or multiply ``uint32`` on the
CPU, so the words are held in int64 masked to 32 bits, and every product
is split into 16-bit halves so that no intermediate overflows int64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.fused_level import DEFAULT_TILE_C
from ..kernels.materialize import materialize_level
from ..kernels.ops import (device_local_supports, fused_level_supports,
                           fused_level_supports_packed, is_fused_backend)
from ..runtime import faults, trace
from ..runtime.errors import WireIntegrityError
from .buckets import bucket_size
from .candgen import pad_schedule, schedule_candidates
from .mapreduce import MiningMesh, reduce_supports, worker_imbalance

__all__ = ["LevelWire", "LevelOutputs", "PendingLevel", "dispatch_level",
           "run_level", "unpack_wire", "fetch_wire", "upload",
           "reassemble_wire", "wire_words",
           "wire_cost_model", "wire_checksum", "level_program",
           "lpt_permutation", "permute_stores", "AUDIT_MONOTONIC",
           "AUDIT_COMPACT", "AUDIT_RANGE", "AUDIT_NKEEP"]

_IMBAL_FX = 1 << 16

# wire scalar words per shard: n_keep | overflow | rebalanced |
# imbalance | audit
_N_SCALARS = 5

# audit-word bit flags (device-side invariant checks, 0 = clean)
AUDIT_MONOTONIC = 1     # child support exceeds its parent's support
AUDIT_COMPACT = 2       # a valid compact slot holds a non-survivor
AUDIT_RANGE = 4         # support negative or above the DB graph count
AUDIT_NKEEP = 8         # survivor count exceeds the real candidate count

# the JAX package's checksum constants (word i contributes
# (w_i ^ i*SALT) * MIX, all in wrapping uint32; the final >> 1 makes the
# value fit int32)
_CSUM_SALT = 0x9E3779B1
_CSUM_MIX = 0x85EBCA77
_MASK32 = 0xFFFFFFFF

_WIRE_FETCH_ATTEMPTS = 3


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant ``b``
    below 2^32, without any int64 overflow (16-bit split of ``b``)."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _u32_to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) reinterpreted as int32 bit patterns."""
    return (w - ((w >> 31) & 1) * (1 << 32)).to(torch.int32)


def wire_checksum(wire: torch.Tensor) -> torch.Tensor:
    """Checksum word (int32, 0-dim) of an int32 wire body — bit-identical
    to ``repro.core.level_step.wire_checksum``."""
    u = wire.to(torch.int64) & _MASK32
    idx = torch.arange(u.shape[0], dtype=torch.int64, device=u.device)
    mixed = _mul32(u ^ _mul32(idx, _CSUM_SALT), _CSUM_MIX)
    return ((mixed.sum() & _MASK32) >> 1).to(torch.int32)


def wire_words(cp: int, n_partitions: int, n_shards: int = 1,
               packed: bool = False) -> int:
    """Total int32 words of the wire: ``n_shards`` shards of
    [gsup slice | 5 scalars | perm | checksum]."""
    if cp % n_shards:
        raise ValueError(f"Cp={cp} not divisible into {n_shards} shards")
    cs = cp // n_shards
    gw = -(-cs // 2) if packed else cs
    return n_shards * (gw + _N_SCALARS + n_partitions + 1)


def reassemble_wire(host: np.ndarray, n_partitions: int,
                    n_shards: int = 1, *, packed: bool = False,
                    cp: Optional[int] = None) -> Optional[np.ndarray]:
    """Verify a fetched wire's per-shard checksums and reassemble the
    dense body ``[gsup (Cp) | scalars | perm]`` (checksums stripped).
    Returns None when any shard fails its checksum (the caller
    re-fetches).  With ``packed`` the checksum is verified over the
    packed words, and only then are the supports expanded to int32."""
    shards = host.reshape(n_shards, -1)
    for s in shards:
        if int(wire_checksum(torch.from_numpy(s[:-1].copy()))) != int(s[-1]):
            return None
    if not packed:
        cs = shards.shape[1] - (_N_SCALARS + n_partitions + 1)
        return np.concatenate([shards[:, :cs].reshape(-1), shards[0, cs:-1]])
    if cp is None:
        raise ValueError("packed wire reassembly needs cp")
    cs = cp // n_shards                                # supports per shard
    gw = -(-cs // 2)                                   # packed words
    u = shards[:, :gw].astype(np.uint32)
    lo = (u & np.uint32(0xFFFF)).astype(np.int32)
    hi = (u >> np.uint32(16)).astype(np.int32)
    gsup = np.stack([lo, hi], axis=-1).reshape(n_shards, -1)[:, :cs]
    return np.concatenate([gsup.reshape(-1), shards[0, gw:-1]])


def wire_cost_model(cp: int, n_partitions: int, n_workers: int, *,
                    reduce: str, sharded: Optional[bool] = None,
                    packed: bool = False) -> dict:
    """Modeled per-worker wire bytes for one level (the JAX package's
    model, ``repro.core.level_step.wire_cost_model``): ``host_bytes`` the
    level wire this worker's host reads in the JAX package's
    single-controller layout, ``collective_bytes`` the bytes it moves in
    the shuffle's collectives (ring factors).  ``psum``: dense wire plus
    a 2(W-1)/W·Cp·4 B all-reduce; dense ``reduce_scatter``: scatter
    (4 B), verdict (1 B) and support (4 B) gathers; sharded: the support
    gather goes, the (NP,) cost vector is gathered, and the host reads
    its own shard.  ``packed`` ships the verdicts as bit lanes and the
    supports as two uint16 per word."""
    W = n_workers
    if sharded is None:
        sharded = reduce == "reduce_scatter"
    ring = (W - 1) / W
    tail = _N_SCALARS + n_partitions + 1          # scalars + perm + csum
    vbytes = (-(-cp // 32) * 4) if packed else cp * 1   # verdict gather

    def gw(n):                                    # gsup words on the wire
        return -(-n // 2) if packed else n

    if reduce == "psum":
        coll = 2 * ring * cp * 4
        host = (gw(cp) + tail) * 4
    elif not sharded:
        coll = ring * (cp * 4 + vbytes + cp * 4)
        host = (gw(cp) + tail) * 4
    else:
        coll = ring * (cp * 4 + vbytes + n_partitions * 4)
        host = (gw(cp // W) + tail) * 4
    return {"host_bytes": host, "collective_bytes": coll,
            "total_bytes": host + coll}


@dataclasses.dataclass
class LevelWire:
    """Host view of the single per-level transfer."""

    gsup: np.ndarray        # (C,) int32 — global supports, canonical order
    n_keep: int             # true survivor count (may exceed the cap)
    overflow: int           # matches dropped by the M cap (survivors only)
    rebalanced: bool
    imbalance: float
    perm: np.ndarray        # (NP,) applied partition permutation
    audit: int = 0          # device audit bit flags (0 = clean)


@dataclasses.dataclass
class LevelOutputs:
    """Device-resident results of one level."""

    wire: LevelWire
    pol: torch.Tensor       # (NP/W, S, G, M, K') — compact survivor OLs
    pmask: torch.Tensor     # (NP/W, S, G, M)


def _pack_wire(gsup, n_keep, overflow, do_reb, imbal, audit, perm, *,
               packed: bool) -> torch.Tensor:
    g = gsup.to(torch.int64)
    if packed:
        # two uint16 supports per int32 word (lossless: the driver only
        # packs when every support fits 16 bits); the checksum covers
        # the PACKED words
        u = g & _MASK32
        if u.shape[0] % 2:
            u = torch.cat([u, u.new_zeros(1)])
        g = _u32_to_i32((u[0::2] | (u[1::2] << 16)) & _MASK32)
    scalars = torch.stack([
        n_keep.to(torch.int32), overflow.to(torch.int32),
        do_reb.to(torch.int32), (imbal * _IMBAL_FX).to(torch.int32),
        audit.to(torch.int32)])
    body = torch.cat([g.to(torch.int32), scalars, perm.to(torch.int32)])
    return torch.cat([body, wire_checksum(body).reshape(1)])


def lpt_permutation(cost: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Device LPT repack, the twin of ``repro.core.level_step.
    lpt_permutation`` and of ``mining._lpt_order``: heaviest partition
    first onto the lightest worker bucket with room; returns the (NP,)
    int32 permutation laying the buckets contiguously (the blocked
    partition→worker rule).  NP is small, so the sequential loop is a
    few dozen tiny device ops that never read back to the host."""
    npn = cost.shape[0]
    per = npn // n_workers
    dev = cost.device
    order = torch.argsort(-cost, stable=True)
    buckets = torch.arange(n_workers, device=dev)
    slots = torch.arange(npn, device=dev)
    load = torch.zeros(n_workers, dtype=cost.dtype, device=dev)
    cnt = torch.zeros(n_workers, dtype=torch.int64, device=dev)
    pos = torch.zeros(npn, dtype=torch.int32, device=dev)
    inf = torch.full((), float("inf"), dtype=cost.dtype, device=dev)
    for i in range(npn):
        # one-element index tensors throughout: indexing with a 0-dim
        # device tensor would read it back to the host
        item = order[i:i + 1]
        b = torch.where(cnt < per, load, inf).argmin().reshape(1)
        onto = buckets == b
        pos = torch.where(slots == b * per + cnt.gather(0, b),
                          item.to(torch.int32), pos)
        load = load + torch.where(onto, cost.index_select(0, item), 0)
        cnt = cnt + onto
    return pos


def _rebalance(cost: torch.Tensor, n_workers: int, rebalance: bool,
               threshold: float):
    """The straggler decision over the (NP,) partition costs: (fired,
    imbalance, permutation).  It needs more than one worker."""
    NP = cost.shape[0]
    imbal = worker_imbalance(cost, n_workers)
    ident = torch.arange(NP, dtype=torch.int32, device=cost.device)
    if rebalance and n_workers > 1:
        do_reb = imbal > threshold
        perm = torch.where(
            do_reb, lpt_permutation(cost.to(torch.float32), n_workers),
            ident)
    else:
        do_reb = torch.zeros((), dtype=torch.bool, device=cost.device)
        perm = ident
    return do_reb, imbal, perm


def level_program(mesh: MiningMesh, c_real: int, psup: torch.Tensor, *args,
                  minsup: int, backend: str, reduce: str,
                  max_embeddings: int, survivor_cap: int,
                  child_width: Optional[int], sharded: bool,
                  packed: bool = False, n_graphs: int = -1,
                  rebalance: bool = False, threshold: float = 1.25):
    """One level's device work on this rank: returns ``(wire, ol,
    mask)``, all on the stores' device, without reading anything back to
    the host.  ``wire`` is the whole wire (every rank's shard, gathered,
    with the sharded layout); ``ol``/``mask`` are this rank's block of
    the child store.

    ``args`` is ``(sched_meta, tiles, inv, pol, pmask, src, dst, emask)``
    for the fused backends and ``(meta, meta_host, pol, pmask, src, dst,
    emask)`` for "pallas" and "ref": the two-launch kernels read the
    (Cp, 5) candidate table ``meta`` on the device, the plain join loops
    over the same table as host rows ``meta_host``.  Both compute the
    padded candidate rows in full, as the JAX package's two-launch and
    ref backends do, so their supports ride in the wire's padded tail.
    The true candidate count ``c_real`` masks the padded rows.

    The straggler rebalance (``rebalance``, trigger ``threshold`` on the
    max/mean worker cost) needs more than one worker; otherwise the wire
    reports no rebalance and the identity permutation, as the JAX
    program does."""
    if sharded and reduce != "reduce_scatter":
        raise ValueError(
            f"the sharded wire needs reduce='reduce_scatter' (each worker "
            f"owns a support slice), got reduce={reduce!r}")
    S = survivor_cap
    # pass 1: the join (B1), the shuffle, the survivor compaction
    with trace.device_span("level.pass1", psup.device):
        if is_fused_backend(backend):
            sched_meta, tiles, inv, pol, pmask, src, dst, emask = args
            if packed:
                sup_pp, emb_s, _vbits = fused_level_supports_packed(
                    sched_meta, tiles, pol, pmask, src, dst, emask)
            else:
                sup_pp, emb_s = fused_level_supports(
                    sched_meta, tiles, pol, pmask, src, dst, emask)
            local_sup = sup_pp.sum(0, dtype=torch.int32).index_select(0, inv)
            emb_pp = emb_s.index_select(1, inv)                  # (PP, Cp)
            meta_can = sched_meta.index_select(0, inv)[:, :5]
        else:
            meta_can, meta_host, pol, pmask, src, dst, emask = args
            local_sup, _, emb_pp = device_local_supports(
                meta_can if backend == "pallas" else meta_host, pol, pmask,
                src, dst, emask, backend=backend, packed=packed)
        dev = pol.device

        # sharded: gsup stays this rank's (Cp/W,) key slice; only the
        # verdicts are gathered
        gsup, verdict = reduce_supports(local_sup, mesh, minsup, reduce,
                                        gather_gsup=not sharded, packed=packed)
        Cp = verdict.shape[0]
        real = torch.arange(Cp, device=dev) < c_real
        keep = (verdict != 0) & real

        # verdict-masked prefix-sum compaction: survivor i's compact slot is
        # its rank among survivors; one scatter inverts rank -> id.  Ranks
        # past the cap and non-survivors land in the extra slot S, dropped.
        rank = keep.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
        n_keep = rank[-1] + 1
        dest = torch.where(keep & (rank < S), rank, S).to(torch.int64)
        surv = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_(
            0, dest, torch.arange(Cp, dtype=torch.int64, device=dev))[:S]
        cmeta = meta_can.index_select(0, surv)                   # (S, 5)
        valid_s = torch.arange(S, device=dev) < n_keep           # (S,)

    # continuous invariant audit (§14): psup is PARENT-indexed (-1 =
    # unknown / padding); each candidate gathers its parent's support
    # through the meta parent column.  Sharded, gsup is this rank's key
    # slice: the slice-local violation counts are summed over the ranks
    par = meta_can[:, 0].to(torch.int64)
    Pn = psup.shape[0]
    psc = torch.where((par >= 0) & (par < Pn),
                      psup.index_select(0, par.clamp(0, Pn - 1)), -1)
    if sharded:
        cs_a = gsup.shape[0]
        lo = mesh.rank * cs_a
        psl = psc[lo:lo + cs_a]
        real_a = real[lo:lo + cs_a]
    else:
        psl, real_a = psc, real
    gs_a = gsup.to(torch.int32)
    mono_bad = ((gs_a > psl) & real_a & (psl >= 0)).sum()
    if n_graphs >= 0:
        rng_bad = (((gs_a < 0) | (gs_a > n_graphs)) & real_a).sum()
    else:
        rng_bad = torch.zeros((), dtype=torch.int64, device=dev)

    # pass 2: one launch over the S compact slots; the slots at or past
    # the survivor count (read on the device) do no join and come out PAD
    with trace.device_span("level.pass2", dev, slots=S):
        ol, mask, over = materialize_level(
            cmeta, n_keep, pol, pmask, src, dst, emask,
            max_embeddings=max_embeddings, out_width=child_width)
    overflow = over.sum(dtype=torch.int64)

    # one all-reduce for the counts every rank must agree on: the
    # overflow, and the audit counts (slice-local when sharded; summing
    # W equal replicated counts keeps them zero or not, all the word
    # reads)
    overflow, mono_bad, rng_bad = mesh.all_reduce(torch.stack(
        [overflow, mono_bad.to(torch.int64), rng_bad.to(torch.int64)]))
    comp_bad = (valid_s & ~keep.index_select(0, surv)).sum()
    audit = (torch.where(mono_bad > 0, AUDIT_MONOTONIC, 0)
             | torch.where(comp_bad > 0, AUDIT_COMPACT, 0)
             | torch.where(rng_bad > 0, AUDIT_RANGE, 0)
             | torch.where(n_keep > c_real, AUDIT_NKEEP, 0))

    # the (NP,) partition costs, gathered so that every rank takes the
    # identical rebalance decision
    cost = mesh.all_gather((emb_pp * real[None, :]).sum(1, dtype=torch.int32))
    do_reb, imbal, perm = _rebalance(cost, mesh.n_workers, rebalance,
                                     threshold)
    wire = _pack_wire(gsup, n_keep, overflow, do_reb, imbal, audit, perm,
                      packed=packed)
    if sharded:
        wire = mesh.all_gather(wire)                # (W · shard,)
    return wire, ol, mask


def permute_stores(mesh: MiningMesh, perm: np.ndarray, *arrays):
    """Apply a wire-reported partition permutation to the rank's blocks
    of the stores (pol, pmask, src, dst, emask): after it, global
    position j holds the partition that was at ``perm[j]``.  Each rank
    sends only its partitions, in one ``all_to_all_single`` per store
    with per-rank split sizes along dim 0; ``perm`` came home in the
    wire, so the splits are host ints and nothing is read back."""
    W, r = mesh.n_workers, mesh.rank
    perm = np.asarray(perm, np.int64)
    per = perm.shape[0] // W
    # the partitions this rank sends, grouped by destination rank and in
    # the order of their new positions there
    new_pos = np.argsort(perm, kind="stable")       # old index -> new
    mine = np.arange(r * per, (r + 1) * per)
    send = mine[np.argsort(new_pos[mine], kind="stable")]
    send_counts = np.bincount(new_pos[send] // per, minlength=W)
    # what arrives, grouped by source rank, each group in new-position
    # order; ``take`` restores the new positions' order
    wanted = perm[r * per:(r + 1) * per]
    src_rank = wanted // per
    recv_counts = np.bincount(src_rank, minlength=W)
    arrival = np.argsort(src_rank, kind="stable")   # arrival slot -> pos
    take = np.empty(per, np.int64)
    take[arrival] = np.arange(per)
    send_idx = torch.from_numpy(send - r * per)
    take_idx = torch.from_numpy(take)
    out = []
    for a in arrays:
        x = a.view(torch.uint8) if a.dtype == torch.bool else a
        buf = x.index_select(0, send_idx.to(x.device))
        got = torch.empty_like(buf)
        dist.all_to_all_single(got, buf, recv_counts.tolist(),
                               send_counts.tolist(), group=mesh.group)
        got = got.index_select(0, take_idx.to(x.device))
        out.append(got.view(torch.bool) if a.dtype == torch.bool else got)
    return tuple(out)


def _fetch_wire(wire_d: torch.Tensor, level: Optional[int],
                n_partitions: int, n_shards: int = 1, packed: bool = False,
                cp: Optional[int] = None) -> np.ndarray:
    """The ONE device→host transfer of a clean level, integrity-checked.
    The chaos hook corrupts the host copy only, so the device buffer
    stays pristine.  A checksum mismatch triggers a bounded re-fetch
    from the device buffer, then :class:`WireIntegrityError` — never
    silently wrong supports."""
    for attempt in range(_WIRE_FETCH_ATTEMPTS):
        host = faults.corrupt_wire(_copy_to_host(wire_d), level)
        body = reassemble_wire(host, n_partitions, n_shards,
                               packed=packed, cp=cp)
        if body is not None:
            trace.annotate("level.wait", refetches=attempt)
            return body
    raise WireIntegrityError(
        f"level wire failed checksum {_WIRE_FETCH_ATTEMPTS}x"
        + (f" at level {level}" if level is not None else ""))


def fetch_wire(wire_d: torch.Tensor, level: Optional[int] = None
               ) -> np.ndarray:
    """Fetch and verify a DENSE single-shard wire (trailing checksum
    word), with the level wire's bounded re-fetch and chaos hook — the
    device-loop pipeline's one run wire per chunk."""
    return _fetch_wire(wire_d, level, 0, 1, False, None)


def _copy_to_host(wire_d: torch.Tensor) -> np.ndarray:
    """One device→host copy of the wire (on the CPU, a view of it: the
    chaos hook flips bits in a copy)."""
    return wire_d.cpu().numpy()


def unpack_wire(wire: np.ndarray, C: int, Cp: int, n_partitions: int
                ) -> LevelWire:
    """Decode the (checksum-stripped) wire body by explicit offsets."""
    return LevelWire(
        gsup=wire[:C],
        n_keep=int(wire[Cp]),
        overflow=int(wire[Cp + 1]),
        rebalanced=bool(wire[Cp + 2]),
        imbalance=float(wire[Cp + 3]) / _IMBAL_FX,
        perm=wire[Cp + 5: Cp + 5 + n_partitions],
        audit=int(wire[Cp + 4]),
    )


@dataclasses.dataclass
class PendingLevel:
    """A level whose device work is queued on the current stream but not
    synced.  ``finish()`` performs the level's single blocking
    device→host copy — the driver calls it only after it has done the
    NEXT level's host candidate generation in the shadow of this level's
    device work (DESIGN.md §11)."""

    wire_d: torch.Tensor
    pol: torch.Tensor
    pmask: torch.Tensor
    C_real: int
    Cp: int
    n_partitions: int
    n_shards: int              # 1 = dense wire; W = sharded
    level: Optional[int]
    packed: bool = False       # gsup slices ship 2x uint16 per word

    def finish(self) -> LevelOutputs:
        """Block on the wire (the one host sync), verify + decode it.
        ``Mirage`` traces this call as the span ``level.wait``."""
        wire = unpack_wire(
            _fetch_wire(self.wire_d, self.level, self.n_partitions,
                        self.n_shards, self.packed, self.Cp),
            self.C_real, self.Cp, self.n_partitions)
        return LevelOutputs(wire, self.pol, self.pmask)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device tensor without a synchronizing copy: pinned
    staging and a non-blocking copy on CUDA, a plain copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def dispatch_level(
    mmesh: MiningMesh,
    meta_p: np.ndarray,       # (Cp, 5) padded candidate metadata (host)
    C_real: int,              # unpadded candidate count
    pol: torch.Tensor,        # (NP/W, P, G, M, K) — the rank's block
    pmask: torch.Tensor,
    src: torch.Tensor,        # (NP/W, T, G, F)
    dst: torch.Tensor,
    emask: torch.Tensor,
    *,
    minsup: int,
    backend: str,
    reduce: str,
    max_embeddings: int,
    survivor_cap: int,
    rebalance: bool = False,
    threshold: float = 1.25,
    child_width: Optional[int] = None,
    sched_floor: Optional[int] = None,
    level: Optional[int] = None,
    sharded: bool = False,
    packed: bool = False,
    tile_c: Optional[int] = None,
    psup: Optional[np.ndarray] = None,
    n_graphs: int = -1,
) -> PendingLevel:
    """Queue one level's device work WITHOUT a host sync.

    The fused backends build the parent-grouped tile schedule host-side
    (only the real rows are scheduled; the row axis is bucketed with
    whole invalid tiles when ``sched_floor`` is set, and the inverse
    permutation of the padded candidates parks on an invalid row).
    ``tile_c`` pins the schedule's tile width (None = the default 8).
    ``psup`` is the parent-indexed support vector for the audit word
    (-1 = unknown), padded to the store's parent axis; ``n_graphs`` arms
    the support-range check (-1 disables it).  ``rebalance`` and
    ``threshold`` arm the straggler rebalance (more than one worker).
    Returns a :class:`PendingLevel`; the caller owns retry policy."""
    Cp = meta_p.shape[0]
    W = mmesh.n_workers
    n_partitions = pol.shape[0] * W           # the perm and cost are global
    if sharded and Cp % W:
        raise ValueError(
            f"sharded wire needs the padded candidate count divisible by "
            f"the worker count, got Cp={Cp}, W={W}")
    # chaos hook: a scheduled kernel fault fires here, before any work
    # is queued, standing in for a launch or device-side error (the
    # supervisor's degradation ladder answers it by swapping backends)
    faults.maybe_raise("kernel", level)
    dev = pol.device
    P_axis, T_axis = pol.shape[1], src.shape[1]
    psup_p = np.full((P_axis,), -1, np.int32)
    if psup is not None:
        n_par = min(len(psup), P_axis)
        psup_p[:n_par] = np.asarray(psup, np.int32)[:n_par]
    meta_p = np.asarray(meta_p, np.int32)
    kw = dict(minsup=minsup, backend=backend, reduce=reduce,
              max_embeddings=max_embeddings, survivor_cap=survivor_cap,
              child_width=child_width, sharded=sharded, packed=packed,
              n_graphs=n_graphs, rebalance=rebalance, threshold=threshold)
    if is_fused_backend(backend):
        tc = tile_c if tile_c is not None else DEFAULT_TILE_C
        if sched_floor is not None:
            sched = schedule_candidates(meta_p[:C_real], tc,
                                        max_inflation=float("inf"))
            rows = bucket_size(sched.meta.shape[0], sched_floor)
        else:
            sched = schedule_candidates(meta_p[:C_real], tc)
            rows = sched.meta.shape[0]
        sched = pad_schedule(sched, rows_to=rows, inv_to=Cp)
        if (sched.tiles[:, 0] >= P_axis).any() or (
                sched.tiles[:, 1] >= T_axis).any():
            raise ValueError("schedule references a parent or triple "
                             "outside the stores")
        args = (upload(sched.meta, dev), upload(sched.tiles, dev),
                upload(sched.inv.astype(np.int64), dev))
    else:
        if (meta_p[:, 0] >= P_axis).any() or (meta_p[:, 4] >= T_axis).any():
            raise ValueError("candidate rows reference a parent or triple "
                             "outside the stores")
        args = (upload(meta_p, dev), meta_p)
    wire_d, new_pol, new_pmask = level_program(
        mmesh, C_real, upload(psup_p, dev), *args, pol, pmask, src, dst,
        emask, **kw)
    return PendingLevel(wire_d, new_pol, new_pmask, C_real, Cp,
                        n_partitions,
                        W if sharded else 1, level, packed)


def run_level(*args, **kwargs) -> LevelOutputs:
    """Dispatch one level and perform its single host sync:
    ``dispatch_level(...).finish()``, the non-overlapped form, with
    :func:`dispatch_level`'s signature."""
    return dispatch_level(*args, **kwargs).finish()
