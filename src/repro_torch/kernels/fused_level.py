"""Single-launch fused map phase of one level (join + support): the CUDA
kernels, their wrappers and their plain PyTorch versions.

``fused_level_packed`` replaces the TPU kernel
``repro.kernels.fused_level.fused_level_packed_pallas``
(``src/repro/kernels/fused_level.py:263``, the main path while the
database has fewer than 2^16 graphs); ``fused_level`` replaces its dense
twin ``fused_level_pallas`` (``src/repro/kernels/fused_level.py:194``).
Both kernels live in ``csrc/fused_level.cu`` and share one join device
function, as the Pallas kernels share ``_joined_blocks``.  The source
note there says what bounds them on the H100 and what the design does
about it.

Inputs (one device; ``ops.py`` owns the padding contract):
  sched_meta (Cs, 6) int32  [parent, stub, to, fwd, triple, valid]
  tiles      (NT, 2) int32  [parent, triple] per tile of Cs/NT rows
  gmask      (Gw,)   uint32 valid-graph bit lanes (packed only)
  pol        (PP, P, G, M, K) int32, PAD -1     pmask (PP, P, G, M) bool
  src/dst    (PP, T, G, F) int32                emask (PP, T, G, F) bool

Outputs, in scheduled order (gather with ``schedule.inv``):
  sup (PP, Cs) int32, emb (PP, Cs) int32 and, packed, vbits (PP, Cs, Gw)
  uint32 — the per-graph verdict words.  Graphs in [G, 32·Gw) are
  treated as padding (PAD vertices, zero masks) without being stored.

A wrapper runs its plain version only for tensors on the CPU.  On a
CUDA tensor it launches the kernel on the current stream or raises;
each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .bitset import WORD, pack_bits, popcount

__all__ = ["fused_level", "fused_level_packed", "fused_level_ref",
           "fused_level_packed_ref", "build_kernels", "launches",
           "reset_launches", "DEFAULT_TILE_C"]

DEFAULT_TILE_C = 8

# kernel launches per wrapper since the last reset_launches()
launches = {"fused_level_packed": 0, "fused_level": 0}

_CSRC = Path(__file__).resolve().parent / "csrc" / "fused_level.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SMEM_LIMIT = 160 * 1024        # dynamic shared memory a block may take
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def build_kernels() -> tuple[Path, str]:
    """Compile ``csrc/fused_level.cu`` for sm_90a into the build
    directory (keyed by the source's hash) unless already built.
    Returns the library path and nvcc's log (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when already built)."""
    digest = hashlib.sha256(_CSRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"fused_level_{digest}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                           str(_CSRC)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_level_packed_launch.argtypes = [p] * 11 + [i] * 11 + [p]
        lib.fused_level_packed_launch.restype = i
        lib.fused_level_launch.argtypes = [p] * 9 + [i] * 10 + [p]
        lib.fused_level_launch.restype = i
        _lib = lib
    return _lib


def _check(sched_meta, tiles, pol, pmask, src, dst, emask, gmask=None):
    """Validate what the kernels take; return (PP, P, G, M, K, T, F, NT,
    TC)."""
    if pol.dim() != 5 or pmask.shape != pol.shape[:4]:
        raise ValueError(f"pol {tuple(pol.shape)} / pmask "
                         f"{tuple(pmask.shape)} must be (PP,P,G,M,K) / "
                         f"(PP,P,G,M)")
    PP, P, G, M, K = pol.shape
    if src.dim() != 4 or src.shape[0] != PP or src.shape[2] != G:
        raise ValueError(f"src {tuple(src.shape)} must be (PP,T,G,F) with "
                         f"PP={PP}, G={G}")
    if dst.shape != src.shape or emask.shape != src.shape:
        raise ValueError("src, dst and emask must share one shape")
    _, T, _, F = src.shape
    if sched_meta.dim() != 2 or sched_meta.shape[1] != 6:
        raise ValueError(f"sched_meta {tuple(sched_meta.shape)} must be "
                         f"(Cs, 6)")
    if tiles.dim() != 2 or tiles.shape[1] != 2 or tiles.shape[0] == 0:
        raise ValueError(f"tiles {tuple(tiles.shape)} must be (NT, 2)")
    Cs, NT = sched_meta.shape[0], tiles.shape[0]
    if Cs % NT:
        raise ValueError(f"Cs={Cs} not a multiple of NT={NT}")
    named = dict(sched_meta=sched_meta, tiles=tiles, pol=pol, src=src,
                 dst=dst)
    for name, x in named.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for name, x in dict(pmask=pmask, emask=emask).items():
        if x.dtype not in (torch.bool, torch.uint8, torch.int8):
            raise TypeError(f"{name} must be bool/uint8/int8, got {x.dtype}")
    if gmask is not None:
        named["gmask"] = gmask
        if gmask.dtype != torch.uint32 or gmask.dim() != 1:
            raise TypeError(f"gmask must be a 1-D uint32 tensor, got "
                            f"{gmask.dtype} {tuple(gmask.shape)}")
        if gmask.shape[0] * WORD < G:
            raise ValueError(f"gmask holds {gmask.shape[0]} words, fewer "
                             f"than G={G} graphs need")
    named.update(pmask=pmask, emask=emask)
    dev = pol.device
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, pol on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return PP, P, G, M, K, T, F, NT, Cs // NT


def _threads(F: int) -> int:
    """Block width: 128 graphs per CTA unless the staged edge rows
    (9 bytes per occurrence per thread) need a narrower block."""
    t = 128
    while t > 32 and F * t * 9 > _SMEM_LIMIT:
        t //= 2
    if F * t * 9 > 227 * 1024:
        raise ValueError(f"F={F} occurrences per graph exceed the shared "
                         f"memory of one block")
    return t


def _launch(name: str, tensors, dims, NT: int, PP: int) -> None:
    """Launch kernel ``name`` on the current stream of the tensors'
    device with the pointers of ``tensors`` and the ints ``dims``;
    raise on a launch error, else count the launch."""
    if NT > 65535 or PP > 65535:
        raise ValueError(f"grid ({NT} tiles, {PP} partitions) exceeds the "
                         f"CUDA grid limits")
    entry = getattr(_library(), f"{name}_launch")
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = entry(*(x.data_ptr() for x in tensors), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA ones
    (kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cpu"


def fused_level_packed(sched_meta, tiles, gmask, pol, pmask, src, dst,
                       emask):
    """Packed single-launch level supports: ``(sup, emb, vbits)``."""
    PP, P, G, M, K, T, F, NT, TC = _check(sched_meta, tiles, pol, pmask,
                                          src, dst, emask, gmask)
    if _on_cpu(pol):
        return fused_level_packed_ref(sched_meta, tiles, gmask, pol, pmask,
                                      src, dst, emask)
    Cs, Gw, dev = sched_meta.shape[0], gmask.shape[0], pol.device
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    vbits = torch.empty((PP, Cs, Gw), dtype=torch.uint32, device=dev)
    _launch("fused_level_packed",
            (sched_meta, tiles, gmask, pol, pmask, src, dst, emask, sup, emb,
             vbits),
            (PP, P, G, M, K, T, F, NT, TC, Gw, _threads(F)), NT, PP)
    return sup, emb, vbits


def fused_level(sched_meta, tiles, pol, pmask, src, dst, emask):
    """Dense single-launch level supports: ``(sup, emb)``."""
    PP, P, G, M, K, T, F, NT, TC = _check(sched_meta, tiles, pol, pmask,
                                          src, dst, emask)
    if _on_cpu(pol):
        return fused_level_ref(sched_meta, tiles, pol, pmask, src, dst,
                               emask)
    Cs, dev = sched_meta.shape[0], pol.device
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    _launch("fused_level",
            (sched_meta, tiles, pol, pmask, src, dst, emask, sup, emb),
            (PP, P, G, M, K, T, F, NT, TC, _threads(F)), NT, PP)
    return sup, emb


# ---------------------------------------------------------------------------
# plain PyTorch versions (same function, same inputs)
# ---------------------------------------------------------------------------

def _slot_values(po: torch.Tensor, slot: int) -> torch.Tensor:
    """po[..., slot], or 0 when slot is outside [0, K)."""
    K = po.shape[-1]
    if 0 <= slot < K:
        return po[..., slot]
    return torch.zeros(po.shape[:-1], dtype=po.dtype, device=po.device)


def _fused_ref(sched_meta, tiles, gmask, pol, pmask, src, dst, emask):
    PP, P, G, M, K = pol.shape
    Cs, NT = sched_meta.shape[0], tiles.shape[0]
    tc = Cs // NT
    dev = pol.device
    meta_h = sched_meta.cpu().tolist()
    tiles_h = tiles.cpu().tolist()
    sup = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    emb = torch.zeros((PP, Cs), dtype=torch.int32, device=dev)
    vbits = None
    if gmask is not None:
        Gw = gmask.shape[0]
        vbits = torch.zeros((PP, Cs, Gw), dtype=torch.uint32, device=dev)
        gm = gmask.to(torch.int64)
    for ct in range(NT):
        rows = meta_h[ct * tc:(ct + 1) * tc]
        if not any(r[5] for r in rows):
            continue                        # whole-invalid tile: skipped
        parent, triple = tiles_h[ct]
        po = pol[:, parent]                                   # (PP,G,M,K)
        pm = pmask[:, parent].bool()
        s, d = src[:, triple], dst[:, triple]                 # (PP,G,F)
        pair_ok = pm[..., :, None] & emask[:, triple].bool()[..., None, :]
        member = torch.zeros(pair_ok.shape, dtype=torch.bool, device=dev)
        for k in range(K):                  # once per tile, as the TPU
            member |= d[..., None, :] == po[..., :, k, None]
        for i, (_, stub, to, fwd, _, valid) in enumerate(rows):
            row = ct * tc + i
            ok = (s[..., None, :] == _slot_values(po, stub)[..., None]) & pair_ok
            if fwd == 1:
                ok &= ~member
            else:
                ok &= d[..., None, :] == _slot_values(po, to)[..., None]
            hit = ok.flatten(-2).any(-1)                      # (PP, G)
            emb[:, row] = ok.flatten(-3).sum(-1, dtype=torch.int32) * valid
            if vbits is None:
                sup[:, row] = hit.sum(-1, dtype=torch.int32) * valid
                continue
            words = pack_bits(hit & (valid != 0)).to(torch.int64)
            words = torch.nn.functional.pad(words, (0, Gw - words.shape[-1]))
            words = words & gm
            vbits[:, row] = words.to(torch.uint32)
            sup[:, row] = popcount(words).sum(-1, dtype=torch.int32)
    return sup, emb, vbits


def fused_level_packed_ref(sched_meta, tiles, gmask, pol, pmask, src, dst,
                           emask):
    """Plain PyTorch version of the packed kernel (same inputs, same
    outputs, any device)."""
    return _fused_ref(sched_meta, tiles, gmask, pol, pmask, src, dst, emask)


def fused_level_ref(sched_meta, tiles, pol, pmask, src, dst, emask):
    """Plain PyTorch version of the dense kernel."""
    sup, emb, _ = _fused_ref(sched_meta, tiles, None, pol, pmask, src, dst,
                             emask)
    return sup, emb
