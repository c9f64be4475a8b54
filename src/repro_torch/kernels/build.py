"""Build, bind and launch the port's CUDA kernels.

Every source under ``csrc/`` (``*.cu``, sharing the ``*.cuh`` headers)
is compiled for sm_90a with ``nvcc``, one process per source, all
started together, and linked into ONE shared library with a plain C
interface, loaded with ``ctypes``.  The library is keyed by a hash over
every ``.cu`` and ``.cuh`` file and built into the gitignored
``build/repro_torch_kernels/`` at first use.  A failed build or launch
raises: nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build_kernels", "launch", "on_cpu", "join_geometry",
           "store_dims", "check_tensors", "SMEM_MAX", "JOIN_CHUNK",
           "JOIN_WARPS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v"]
SMEM_MAX = 227 * 1024           # dynamic shared memory of one block (H100)

# C entry points: (pointer arguments, int arguments), then the stream
_ENTRIES = {
    "fused_level_packed_launch": (11, 12),
    "fused_level_launch": (9, 11),
    "embedding_join_launch": (8, 10),
    "support_count_launch": (4, 5),
    "materialize_level_launch": (10, 10),
}
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` for sm_90a (in parallel) and link them
    into the build directory's library unless it is already built.
    Returns the library path and nvcc's log (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when already built)."""
    out = _BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out, ""
    work = _BUILD_DIR / f"tmp.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        sources = sorted(_CSRC.glob("*.cu"))
        objs = [work / f"{s.stem}.o" for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *_COMPILE_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        log = ""
        for s, p in zip(sources, procs):
            text, _ = p.communicate()
            log += text
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} "
                                   f"({p.returncode}):\n{text}")
        lib = work / out.name
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, log


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptr, n_int) in _ENTRIES.items():
            entry = getattr(lib, name)
            entry.argtypes = [p] * n_ptr + [i] * n_int + [p]
            entry.restype = i
        _lib = lib
    return _lib


def on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA ones
    (kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cpu"


def store_dims(pol, pmask, src, dst, emask) -> tuple[int, ...]:
    """Shapes of the parent and edge OL stacks the join kernels take:
    ``(PP, P, G, M, K, T, F)``; raise on inconsistent shapes."""
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
    return PP, P, G, M, K, T, F


def check_tensors(device: torch.device, int32: dict, masks: dict,
                  other: dict | None = None) -> None:
    """Raise unless the ``int32`` tensors are int32, the ``masks`` are
    bool/uint8/int8 (one byte per element), and all of them (and
    ``other``) are contiguous and on ``device``."""
    for name, x in int32.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for name, x in masks.items():
        if x.dtype not in (torch.bool, torch.uint8, torch.int8):
            raise TypeError(f"{name} must be bool/uint8/int8, got {x.dtype}")
    for name, x in {**int32, **masks, **(other or {})}.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the join kernels (B1-B3, the row walk of csrc/join.cuh): one CTA owns
# JOIN_CHUNK graphs (one per lane of a warp) of one partition, with
# JOIN_WARPS warps taking rows
JOIN_CHUNK = 32
JOIN_WARPS = 8
# per warp: its parent's spans, its slot-range ends, its per-graph counts
JOIN_WARP_BYTES = 3 * JOIN_CHUNK * 4
# per warp without the CTA's triple span table: also its triple's spans
JOIN_LAZY_WARP_BYTES = 4 * JOIN_CHUNK * 4
# the walk's static shared memory (its row counter), rounded up: a block's
# static and dynamic shared memory share SMEM_MAX
JOIN_STATIC_BYTES = 16


def join_geometry(PP: int, T: int) -> tuple[int, int]:
    """Launch geometry of the join kernels: ``(threads, shared_bytes)`` of
    each CTA of their (graph chunks, PP) grid.  A CTA holds the uint32
    mask spans of every triple for its 32 graphs while that table fits
    in one block's shared memory (T up to 1,791), and each warp 3 x 32
    words of its own; past that, the table goes and each warp keeps the
    spans of its current triple too (the kernel tells the two apart by
    the shared bytes it is given).  M, F, K, T, the row count and G
    have no limit here.  Raises ``ValueError`` on more partitions than
    the grid's y limit."""
    smem = T * JOIN_CHUNK * 4 + JOIN_WARPS * JOIN_WARP_BYTES
    if smem + JOIN_STATIC_BYTES > SMEM_MAX:
        smem = JOIN_WARPS * JOIN_LAZY_WARP_BYTES
    if PP > 65535:
        raise ValueError(f"{PP} partitions exceed the CUDA grid limit")
    return JOIN_WARPS * 32, smem


def launch(name: str, counts: dict, tensors, dims) -> None:
    """Launch kernel ``name`` on the current stream of the tensors'
    device with the pointers of ``tensors`` and the ints ``dims``;
    raise on a launch error, else add one to ``counts[name]``."""
    entry = getattr(_library(), f"{name}_launch")
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = entry(*(x.data_ptr() for x in tensors), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counts[name] += 1
