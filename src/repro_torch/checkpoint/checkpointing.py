"""Checkpoint save and restore: atomic step directories, an async writer
thread, an integrity manifest.

Counterpart of ``repro.checkpoint.checkpointing``, with its layout and
protocol:

  <dir>/step_<N>/shard_0.npz     the flattened leaves
  <dir>/step_<N>/MANIFEST.json   leaf paths, shapes, dtypes, fingerprint
  <dir>/step_<N>/.COMPLETE       commit marker (the directory is renamed
                                 into place only after it is written)

A crash mid-save leaves no .COMPLETE marker, so restore picks the newest
complete step.  One process writes one shard.

The port's state is updated in place, so the tree a step hands to
``save`` changes under a writer thread at the next step: ``save`` copies
every leaf to host memory before it returns, and only the file writing
runs in the background.  numpy has no bf16 or e4m3, so a leaf is stored
as the raw integer view of its bytes (uint8 / uint16 / uint32 / uint64 by
element size) and the manifest keeps its torch dtype.  ``restore`` checks
every leaf's bytes and the fingerprint first, then copies into the live
tensors of the given tree in place; the tree's Python ints (the
optimizer's step) come back as ints.  A tree is nested dicts (walked in
sorted key order), lists, tuples and QTensors over tensors and ints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QTensor

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# the integer views a leaf's bytes cross between torch and numpy through
_SINT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_SINT = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn,
    torch.int32, torch.int64, torch.uint8, torch.bool)}
_FLOATS = ("float32", "bfloat16", "float16", "float8_e4m3fn")
_CHUNK = 1 << 24


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed an integrity check on restore: torn or
    unreadable shard bytes, a leaf whose bytes do not match the MANIFEST,
    or a fingerprint mismatch.  The train loop's rollback ladder catches
    this and falls back to an older complete step."""


class AsyncSaveHandle:
    """Handle of an async save: join() re-raises what the writer thread
    hit, so a failed background write cannot pass for a durable
    checkpoint."""

    def __init__(self, fn):
        self._exc = None

        def _run():
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 -- re-raised on join
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc


def _flatten(tree, path="") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order: sorted dict keys, as
    ``jax.tree.flatten`` walks the reference's trees."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in
                _flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in
                _flatten(v, f"{path}/{i}")]
    if isinstance(tree, QTensor):
        return [(f"{path}.data", tree.data), (f"{path}.scale", tree.scale)]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves replaced, in _flatten order,
    from the iterator `leaves`."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(next(leaves), next(leaves), tree.tile)
    if tree is None:
        return None
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str, list]:
    """(raw unsigned bytes view, dtype name, shape) of one leaf, copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        raw = t.contiguous().view(_SINT[t.element_size()]).to(
            "cpu", copy=True).numpy()
        return (raw.view(_UINT[t.element_size()]).reshape(-1),
                str(t.dtype).removeprefix("torch."), list(t.shape))
    if isinstance(leaf, (bool, int, np.integer)):
        return np.asarray([int(leaf)], np.int64).view(np.uint64), "int", []
    raise TypeError(f"checkpoint: cannot store a {type(leaf).__name__}")


def _values(raw: np.ndarray, dtype: str) -> np.ndarray:
    """Float values of a raw float leaf (f32 arrays), for the
    fingerprint."""
    if dtype == "float32":
        return raw.view(np.float32)
    if dtype == "float16":
        return raw.view(np.float16).astype(np.float32)
    if dtype == "bfloat16":
        return (raw.astype(np.uint32) << 16).view(np.float32)
    return _E4M3_LUT[raw]


def _e4m3_lut() -> np.ndarray:
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    return codes.view(torch.float8_e4m3fn).to(torch.float32).numpy()


_E4M3_LUT = _e4m3_lut()


def _fingerprint(raws, dtypes) -> float:
    """Sum of |value| in f64 over every float leaf, a chunk at a time."""
    total = 0.0
    for raw, dt in zip(raws, dtypes):
        if dt not in _FLOATS:
            continue
        for i in range(0, raw.size, _CHUNK):
            v = _values(raw[i:i + _CHUNK], dt)
            total += float(np.sum(np.abs(v.astype(np.float64))))
    return total


def save(ckpt_dir: str, step: int, tree: Any, *, async_: bool = False,
         max_keep: int = 3):
    """Atomic checkpoint write; with async_ the files are written on a
    background thread (the leaves are on the host before this returns)."""
    leaves = _flatten(tree)
    host = [_to_host(x) for _, x in leaves]

    def _write():
        tmp = os.path.join(ckpt_dir, f"_tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        raws = [h[0] for h in host]
        dtypes = [h[1] for h in host]
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{f"leaf_{i}": r for i, r in enumerate(raws)})
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "paths": [p for p, _ in leaves],
            "shapes": [h[2] for h in host],
            "dtypes": dtypes,
            "fingerprint": _fingerprint(raws, dtypes),
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".COMPLETE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, max_keep)

    if async_:
        return AsyncSaveHandle(_write)
    _write()
    return None


def _gc(ckpt_dir: str, max_keep: int):
    steps = sorted(completed_steps(ckpt_dir))
    for s in steps[:-max_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def completed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, ".COMPLETE")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = completed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _nbytes(shape, dtype: str) -> int:
    size = 8 if dtype == "int" else _DTYPES[dtype].itemsize
    return int(np.prod(shape, dtype=np.int64)) * size


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None):
    """Restore into `tree_like`: its tensors are overwritten in place, its
    ints replaced.  Returns (tree, step).  Every leaf's bytes and the
    fingerprint are checked before anything is copied."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    # a named step must be committed too: a torn directory that never got
    # its .COMPLETE marker is not restorable
    if not os.path.exists(os.path.join(path, ".COMPLETE")):
        raise CheckpointCorruptError(
            f"{path}: no .COMPLETE marker (torn or in-flight save)")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves) or \
            manifest["paths"] != [p for p, _ in leaves]:
        raise ValueError(f"{path}: the checkpoint's tree is not the tree "
                         "restored into")
    raws = []
    try:
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            for i in range(len(leaves)):
                dtype, shape = manifest["dtypes"][i], manifest["shapes"][i]
                raw = data[f"leaf_{i}"]
                if raw.nbytes != _nbytes(shape, dtype):
                    raise CheckpointCorruptError(
                        f"{path}: leaf_{i} holds {raw.nbytes} bytes, "
                        f"manifest says {shape} {dtype}")
                raws.append(raw)
    except CheckpointCorruptError:
        raise
    except Exception as e:   # torn zip, bad CRC, missing member, ...
        raise CheckpointCorruptError(
            f"{path}: unreadable shard bytes ({type(e).__name__}: {e})"
        ) from e
    fp = _fingerprint(raws, manifest["dtypes"])
    want = manifest["fingerprint"]
    if fp != want and not (np.isnan(fp) and np.isnan(want)):
        raise CheckpointCorruptError(
            f"{path}: fingerprint mismatch (manifest {want!r}, "
            f"recomputed {fp!r}): shard bytes were altered after commit")
    new = []
    for (p, live), raw, dtype, shape in zip(leaves, raws, manifest["dtypes"],
                                            manifest["shapes"]):
        if dtype == "int":
            new.append(int(raw.view(np.int64)[0]))
            continue
        if not isinstance(live, torch.Tensor) or \
                str(live.dtype).removeprefix("torch.") != dtype or \
                list(live.shape) != shape:
            raise ValueError(f"{path}: leaf {p} is {shape} {dtype} in the "
                             "checkpoint, not what it is restored into")
        if not live.is_contiguous():
            raise ValueError(f"{path}: leaf {p} is not contiguous")
        isz = _DTYPES[dtype].itemsize
        src = torch.from_numpy(raw.view(_NP_SINT[isz]))
        with torch.no_grad():
            live.view(_SINT[isz]).reshape(-1).copy_(src)
        new.append(live)
    return _unflatten(tree_like, iter(new)), step
