"""Fault-tolerant checkpointing (mining levels + training steps).

Design goals, per the 1000+-node brief:

  * **Atomic**: write to ``<dir>/.tmp.<step>`` then rename — a killed
    writer never corrupts the latest checkpoint.
  * **Self-describing**: a JSON skeleton mirrors the pytree structure;
    leaves live in one compressed ``.npz`` (bool leaves bit-packed at
    rest, logical shape in the skeleton).  No pickle anywhere.
  * **Integrity-checked**: the manifest records a SHA-256 digest per
    leaf; ``load_pytree`` verifies every leaf on read and raises
    :class:`~repro_torch.runtime.errors.CheckpointIntegrityError` on any
    mismatch, truncation, or unreadable file — silent bit-rot cannot
    reach the miner.  (Pre-digest checkpoints load with verification
    skipped — the manifest simply carries no digests.)
  * **Portable**: arrays are saved unsharded as host numpy, so the
    JAX package and this port read each other's checkpoints (the format
    is ``repro.runtime.checkpoint``'s, byte for byte).
  * **Resumable scan**: ``latest_step`` finds the newest structurally
    complete checkpoint, reaping incomplete step dirs and stale
    ``.tmp.*`` spill dirs from dead writers as it scans (the store is
    single-writer, so a temp dir seen by a scan is garbage by
    definition); ``load_step`` with no explicit step falls back to the
    newest checkpoint that *passes digest verification*, reaping any
    corrupt newer ones.

With several workers the store stays single-writer: the miner gathers
the ranks' blocks of the canonical store to rank 0, which alone calls
``save_step``, and the other ranks wait for it at a barrier; on resume
rank 0 reads first (reaping what it must) and every other rank then
reads the step it left (``core/mining.py``).

This is the analogue of MIRAGE's between-iteration HDFS writes: the
reducer output of level k (here: the level-k OL store + frequent codes)
is durably on disk — and provably intact — before level k+1 starts, so
any worker loss replays at most one level.  Torch tensors are saved as
their host numpy copies; loads return numpy leaves.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from . import faults
from .errors import CheckpointIntegrityError

__all__ = ["save_pytree", "load_pytree", "latest_step", "save_step",
           "load_step", "all_steps", "ChunkCadence",
           "CheckpointIntegrityError"]

_LEAF = "__leaf__"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp.ckpt."


def _encode(tree: Any, leaves: list[np.ndarray]) -> Any:
    """JSON skeleton with array leaves replaced by {_LEAF: idx}."""
    if isinstance(tree, dict):
        return {str(k): _encode(v, leaves) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_encode(v, leaves) for v in tree]}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        a = (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
             else tree)
        if a.dtype == np.bool_:
            # bool leaves (the OL masks dominate mining checkpoints) are
            # stored bit-packed — 8x smaller at rest, and the digest is
            # taken over the packed bytes, i.e. over what is actually on
            # disk.  The logical shape rides in the skeleton; _decode
            # re-expands, so packed-at-rest is invisible to callers and
            # a run may save packed and resume dense (or vice versa).
            leaves.append(np.packbits(a.reshape(-1)))
            return {_LEAF: len(leaves) - 1, "__packed_bool__": list(a.shape)}
        leaves.append(a)
        return {_LEAF: len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"__val__": tree}
    if isinstance(tree, (np.integer, np.floating)):
        return {"__val__": tree.item()}
    raise TypeError(f"unsupported checkpoint leaf type: {type(tree)}")


def _decode(node: Any, leaves: dict[str, np.ndarray]) -> Any:
    if isinstance(node, dict):
        if _LEAF in node:
            a = leaves[f"a{node[_LEAF]}"]
            shape = node.get("__packed_bool__")
            if shape is not None:
                n = int(np.prod(shape, dtype=np.int64))
                a = np.unpackbits(a, count=n).astype(bool).reshape(shape)
            return a
        if "__val__" in node:
            return node["__val__"]
        if "__seq__" in node:
            seq = [_decode(v, leaves) for v in node["items"]]
            return tuple(seq) if node["__seq__"] == "tuple" else seq
        return {k: _decode(v, leaves) for k, v in node.items()}
    raise TypeError(f"corrupt checkpoint node: {node!r}")


def _digest(a: np.ndarray) -> str:
    """SHA-256 over dtype + shape + raw bytes (C-contiguous)."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_pytree(path: str, tree: Any, *, metadata: Optional[dict] = None) -> None:
    """Atomically write ``tree`` (nested dict/list/tuple of arrays/scalars)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    leaves: list[np.ndarray] = []
    skeleton = _encode(tree, leaves)
    tmp = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=parent)
    try:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"skeleton": skeleton, "metadata": metadata or {},
                       "n_leaves": len(leaves),
                       "digests": {f"a{i}": _digest(a)
                                   for i, a in enumerate(leaves)}}, f)
        np.savez_compressed(os.path.join(tmp, "data.npz"),
                            **{f"a{i}": a for i, a in enumerate(leaves)})
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def load_pytree(path: str, *, verify: bool = True) -> tuple[Any, dict]:
    """Load a checkpoint, verifying per-leaf SHA-256 digests when the
    manifest carries them.  Any unreadable, truncated, or
    digest-mismatched state raises :class:`CheckpointIntegrityError`
    (never a silent wrong answer).  Leaves come back as host numpy."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "data.npz")) as z:
            leaves = {k: z[k] for k in z.files}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile,
            zlib.error, EOFError) as e:
        raise CheckpointIntegrityError(
            f"checkpoint {path} is unreadable: {type(e).__name__}: {e}"
        ) from e
    if verify:
        if len(leaves) != manifest.get("n_leaves", len(leaves)):
            raise CheckpointIntegrityError(
                f"checkpoint {path}: payload holds {len(leaves)} leaves, "
                f"manifest promises {manifest.get('n_leaves')}")
        for name, want in manifest.get("digests", {}).items():
            if name not in leaves:
                raise CheckpointIntegrityError(
                    f"checkpoint {path}: leaf {name} missing from payload")
            got = _digest(leaves[name])
            if got != want:
                raise CheckpointIntegrityError(
                    f"checkpoint {path}: leaf {name} digest mismatch "
                    f"(stored {want[:12]}…, loaded {got[:12]}…)")
    tree = _decode(manifest["skeleton"], leaves)
    return tree, manifest["metadata"]


class ChunkCadence:
    """Checkpoint cadence for the device-resident run loop (DESIGN.md
    §13).  The whole-run program checkpoints by RE-INVOCATION: it runs to
    a nearer ``k_stop`` (a chunk) and the host persists state at each
    boundary — "every ``every`` levels, or on loop exit" when ``every``
    is None.  Centralizing the boundary arithmetic keeps the miner and
    its tests agreed on how many boundaries (and therefore how many
    device→host fetches) a run performs: ``1`` wire fetch without
    mid-run checkpoints, at most ``3·n_chunks`` fetches (wire + OL store
    + mask per boundary) with them."""

    def __init__(self, start: int, stop: int, every: Optional[int] = None):
        if stop < start:
            raise ValueError(f"cadence stop={stop} before start={start}")
        self.start = start
        self.stop = stop
        self.every = (every if every and every > 0
                      else max(stop - start, 1))

    def boundaries(self) -> list[int]:
        """Every chunk's ``k_stop``, in order; the last is ``stop``."""
        out, k = [], self.start
        while k < self.stop:
            k = min(k + self.every, self.stop)
            out.append(k)
        return out

    @property
    def n_chunks(self) -> int:
        return len(self.boundaries())

    def max_fetches(self) -> int:
        """Residency budget: one wire fetch per chunk plus the two
        store fetches of each NON-final boundary's checkpoint."""
        n = self.n_chunks
        return n + 2 * max(n - 1, 0)


def save_step(root: str, step: int, tree: Any, *,
              metadata: Optional[dict] = None, keep: int = 3) -> str:
    """Step-numbered checkpoint with retention."""
    path = os.path.join(root, f"step_{step:010d}")
    meta = dict(metadata or {})
    meta["step"] = step
    save_pytree(path, tree, metadata=meta)
    steps = all_steps(root)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:010d}"),
                      ignore_errors=True)
    # chaos hook: scheduled disk corruption of the step just written
    faults.corrupt_checkpoint(path, step)
    return path


def _complete(root: str, name: str) -> bool:
    """Cheap structural check: manifest parses, payload file exists.
    (Payload *content* is digest-verified by ``load_pytree``.)"""
    d = os.path.join(root, name)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return os.path.exists(os.path.join(d, "data.npz"))


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and _complete(root, name):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    """Newest structurally complete step — incomplete step dirs and
    stale ``.tmp.*`` writer spills are reaped, not returned."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            continue
        m = _STEP_RE.match(name)
        if not m:
            continue
        if _complete(root, name):
            steps.append(int(m.group(1)))
        else:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return max(steps) if steps else None


def load_step(root: str, step: Optional[int] = None
              ) -> tuple[Any, dict]:
    """Load a step checkpoint.  With ``step=None``, walks back from the
    newest step until one passes digest verification, reaping each
    corrupt step it skips; raises ``FileNotFoundError`` when no intact
    checkpoint survives.  An explicit ``step`` is loaded strictly
    (corruption raises :class:`CheckpointIntegrityError`)."""
    if step is not None:
        return load_pytree(os.path.join(root, f"step_{step:010d}"))
    while True:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no intact checkpoints under {root}")
        path = os.path.join(root, f"step_{step:010d}")
        try:
            return load_pytree(path)
        except CheckpointIntegrityError:
            # fall back to the previous level's state: strictly better
            # than mining on from corrupt state, and the driver replays
            # the lost level(s) deterministically
            shutil.rmtree(path, ignore_errors=True)
