"""Atomic checkpoints of a training state, on the JAX package's disk format.

Port of the JAX package's ``training/checkpoint.py``:

  * the arrays go to ``<dir>/step_<n>/proc_0.npz``, keyed by each leaf's
    path spelled as ``jax.tree_util.keystr`` spells it for dicts and
    tuples (``['params']['blocks']['attn']['q']``, ``[0]``; dict keys in
    sorted order), so either package reads the other's checkpoints;
  * ``manifest.json`` holds ``step``, ``num_processes`` and each array's
    ``shape`` and ``dtype``, and any ``extra`` fields of the save (the
    training launcher's live plan cell), which the reference ignores;
  * everything is written under ``step_<n>.tmp`` and committed by one
    ``os.replace``: a half-written checkpoint is never visible, and
    ``latest_step`` skips ``.tmp`` directories and unreadable manifests.

Two differences, both for a training state that fills the card (qwen1.5-4b's
f32 master weights and AdamW moments are 47.4 GB):

  * ``save`` streams the leaves one by one into the ``.npz``'s zip entries
    (``np.lib.format.write_array``, as ``np.savez`` writes them), so host
    memory stays near the largest leaf, not the whole state;
  * ``restore(ckpt_dir, step, target, device=...)`` takes the place of the
    reference's ``shardings=``: each leaf goes to ``device``, or to the
    target leaf's device, and is cast to the target leaf's dtype.  The
    target may be a tree of ``meta`` tensors (shapes and dtypes only), so a
    caller can free its own state before the checkpoint's is loaded.  A
    stored member is read straight into its array and checked against its
    CRC-32 in one pass (``zipfile`` reads and checks it in small pieces,
    about half as fast).

bf16 leaves are stored widened to f32 (numpy has no bf16), as
``bridge.params_to_jax`` widens them; Python ``int`` leaves (the port's
``step``) as int32 scalars, the reference's step dtype, and they come back
as ``int``.  One process writes ``proc_0.npz`` (``num_processes`` 1);
``restore`` reads every ``proc_<p>.npz`` it finds.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import struct
import zipfile
import zlib

import numpy as np
import torch

STEP_PREFIX = "step_"


def _key(k) -> str:
    return f"[{k!r}]"


def flatten(tree, prefix: str = "") -> dict:
    """``{keystr path: leaf}`` of a tree of dicts, tuples and lists, in
    ``jax.tree_util`` leaf order (dict keys sorted); ``None`` is an empty
    subtree, as in JAX."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + _key(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + _key(i)))
        return out
    return {prefix: tree}


def _unflatten(tree, flat: dict, prefix: str = ""):
    """A tree of ``tree``'s structure whose leaves come from ``flat``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, prefix + _key(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, flat, prefix + _key(i))
                          for i, v in enumerate(tree))
    return flat[prefix]


def _host_array(leaf) -> np.ndarray:
    """One leaf as a host numpy array (bf16 widened to f32, an int as
    int32), without a second host copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step``; returns its directory.

    ``extra`` holds further JSON fields for the manifest (the training
    launcher stores the live plan cell there).  A save that fails (a full
    disk) removes its ``.tmp`` directory before the error propagates."""
    tmp = os.path.join(ckpt_dir, f"{STEP_PREFIX}{step}.tmp")
    final = os.path.join(ckpt_dir, f"{STEP_PREFIX}{step}")
    os.makedirs(tmp, exist_ok=True)
    meta = {}
    try:
        with zipfile.ZipFile(os.path.join(tmp, "proc_0.npz"), "w",
                             compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for name, leaf in flatten(tree).items():
                arr = _host_array(leaf)
                meta[name] = {"shape": list(arr.shape),
                              "dtype": str(arr.dtype)}
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({**(extra or {}), "step": step, "num_processes": 1,
                       "arrays": meta}, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    os.replace(tmp, final)       # atomic commit
    return final


def _steps(ckpt_dir: str) -> list:
    """The committed ``step_<n>`` directory names (no ``.tmp``)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [n for n in os.listdir(ckpt_dir)
            if n.startswith(STEP_PREFIX) and not n.endswith(".tmp")]


def manifest(ckpt_dir: str, step: int) -> dict:
    """Checkpoint ``step``'s manifest: ``step``, ``num_processes``,
    ``arrays`` (each array's ``shape`` and ``dtype`` by key) and the
    ``extra`` fields it was saved with."""
    with open(os.path.join(ckpt_dir, f"{STEP_PREFIX}{step}",
                           "manifest.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step whose manifest reads, or None."""
    steps = []
    for name in _steps(ckpt_dir):
        try:
            with open(os.path.join(ckpt_dir, name, "manifest.json")) as f:
                steps.append(int(json.load(f)["step"]))
        except (OSError, ValueError, KeyError, TypeError):
            continue            # incomplete or corrupt: ignore
    return max(steps) if steps else None


def _read_stored(f, info: zipfile.ZipInfo) -> np.ndarray:
    """The ``.npy`` member ``info`` of an uncompressed zip open as ``f``,
    read straight into its array in one pass and checked against the
    member's CRC-32 (``zipfile`` would read it in small pieces)."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{info.filename}: compressed, not a checkpoint's")
    f.seek(info.header_offset)
    local = f.read(30)                      # the zip local file header
    if local[:4] != b"PK\x03\x04":
        raise ValueError(f"{info.filename}: bad local header")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    start = f.tell()
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    if dtype.hasobject:
        raise ValueError(f"{info.filename}: object arrays are not read")
    header_len = f.tell() - start
    f.seek(start)
    crc = zlib.crc32(f.read(header_len))
    arr = np.empty(shape, dtype=dtype, order="F" if fortran else "C")
    buf = memoryview(arr.reshape(-1, order="A")).cast("B")
    if f.readinto(buf) != arr.nbytes or header_len + arr.nbytes \
            != info.file_size:
        raise ValueError(f"{info.filename}: truncated")
    if zlib.crc32(buf, crc) != info.CRC:
        raise ValueError(f"{info.filename}: CRC-32 mismatch")
    return arr


def _as_tensor(arr: np.ndarray, tgt, device) -> torch.Tensor:
    dev = torch.device(device) if device is not None else tgt.device
    if dev.type == "meta":
        raise ValueError("restore onto meta tensors needs device=")
    if not arr.flags.c_contiguous:     # (np.ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    t = torch.from_numpy(arr)
    return t.to(device=dev, dtype=tgt.dtype)


def restore(ckpt_dir: str, step: int, target, device=None):
    """Checkpoint ``step`` in the structure of ``target``.

    Each leaf is read on its own, cast to the target leaf's dtype and
    placed on ``device`` (default: the target leaf's device).  A missing
    array raises ``KeyError`` naming it; a shape that differs raises
    ``ValueError``.
    """
    path = os.path.join(ckpt_dir, f"{STEP_PREFIX}{step}")
    files = sorted(f for f in os.listdir(path)
                   if f.startswith("proc_") and f.endswith(".npz"))
    with contextlib.ExitStack() as stack:
        where = {}
        for fname in files:
            f = stack.enter_context(open(os.path.join(path, fname), "rb"))
            for info in stack.enter_context(zipfile.ZipFile(f)).infolist():
                where[info.filename.removesuffix(".npy")] = (f, info)
        out = {}
        for name, tgt in flatten(target).items():
            if name not in where:
                raise KeyError(f"checkpoint missing array {name}")
            arr = _read_stored(*where[name])
            shape = tuple(tgt.shape) if isinstance(tgt, torch.Tensor) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                                 f"target {shape}")
            if isinstance(tgt, torch.Tensor):
                out[name] = _as_tensor(arr, tgt, device)
            elif isinstance(tgt, int):
                out[name] = int(arr)
            else:
                raise TypeError(f"{name}: a {type(tgt).__name__} target "
                                "leaf (tensors and ints only)")
            del arr
    return _unflatten(target, out)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    steps = []
    for name in _steps(ckpt_dir):
        try:
            steps.append(int(name.split("_", 1)[1]))
        except ValueError:
            continue
    for s in sorted(steps)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"{STEP_PREFIX}{s}"),
                      ignore_errors=True)
