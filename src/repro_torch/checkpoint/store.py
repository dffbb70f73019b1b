"""Atomic checkpoints of param trees, in the reference's on-disk format.

Layout (the same as ``repro/checkpoint/store.py``, so a checkpoint written
by either package restores in the other):

    <dir>/step_<N>/
        manifest.json   step, tree structure, and per leaf its shape,
                        logical dtype and CRC32 of the payload bytes
        leaf_<i>.npy    one file per leaf; bfloat16 is stored as uint16
                        with the dtype named "bfloat16"

Leaves are numbered in the order of JAX's ``tree_flatten`` of a nested
dict, which is sorted keys at every level, and of a NamedTuple (the
trainer's ``OptState``), which is its fields in order.  Writes go to
``step_<N>.tmp`` and are renamed into place, so a crash mid-save leaves
the previous checkpoint intact; a save keeps the newest ``keep`` steps of
its directory and removes the rest.  A leaf whose bytes do not match its
CRC32 raises :class:`CheckpointCorrupt` instead of loading bad weights.
A restore casts every leaf to the dtype of the tree it restores into.
:class:`AsyncCheckpointer` writes in a background thread from a host copy
taken before the thread starts; its ``wait()`` re-raises a failed write.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import is_namedtuple, tree_map

_NP_OF = {torch.float32: np.float32, torch.float16: np.float16,
          torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_}
_TORCH_OF = {np.dtype(v).name: k for k, v in _NP_OF.items()}


class CheckpointCorrupt(ValueError):
    """A leaf's bytes do not match the manifest checksum (truncated or
    bit-flipped read)."""


def _flatten(tree):
    """Leaves in ``tree_flatten`` order (sorted dict keys) and the
    structure string the reference writes (``PyTreeDef({...})``)."""
    leaves = []
    return leaves, f"PyTreeDef({_walk(tree, leaves)})"


def _walk(node, leaves):
    if isinstance(node, dict):
        inner = ", ".join(f"{k!r}: {_walk(node[k], leaves)}"
                          for k in sorted(node))
        return "{" + inner + "}"
    if is_namedtuple(node):
        inner = ", ".join(_walk(x, leaves) for x in node)
        return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
    leaves.append(node)
    return "*"


def _unflatten(tree, leaves):
    # module-level recursion: a nested recursive closure would be a
    # reference cycle holding every restored tensor until the next
    # garbage collection
    return _build(tree, iter(leaves))


def _build(node, it):
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}          # keep caller's order
    if is_namedtuple(node):
        return type(node)(*(_build(x, it) for x in node))
    return next(it)


def _leaf_crc(arr: np.ndarray) -> int:
    """CRC32 of the leaf's bytes, read in place (no copy of the leaf: a
    MoE model's expert stacks are gigabytes each)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _to_host(t: torch.Tensor):
    """(npy-safe array, logical dtype name) of a tensor."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


_PIECE = 64 << 20           # bytes a piece of a large leaf
_WRITERS = 3                # threads writing a large leaf's pieces


def _pwrite_all(fd: int, view: np.ndarray, offset: int) -> None:
    done = 0
    while done < view.nbytes:
        done += os.pwrite(fd, view[done:], offset + done)


def _write_leaf(path: Path, leaf: torch.Tensor):
    """``leaf`` to ``path`` as ``np.save`` writes it; returns (shape,
    logical dtype name, CRC32 of the payload).  A leaf of ``_PIECE`` bytes
    or more goes in pieces: each copied off the card into one of a ring of
    pinned buffers (or read in place from a host tensor), checksummed in
    order, and written at its offset by a pool of ``_WRITERS`` threads, so
    that the copy, the checksum and the writes overlap: a stage write
    moves each of a MoE model's 15 GB expert stacks this way."""
    t = leaf.detach()
    low = t.dtype == torch.bfloat16
    if t.nbytes < _PIECE or not (low or t.dtype in _NP_OF):
        arr, logical = _to_host(t)
        np.save(path, arr)
        return list(arr.shape), logical, _leaf_crc(arr)
    dtype = np.dtype(np.uint16 if low else _NP_OF[t.dtype])
    # np.save's header, and the file at its full length
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                   shape=tuple(t.shape))
    offset = mm.offset
    del mm
    flat = (t.view(torch.int16) if low else t).contiguous().view(-1)
    flat = flat.view(torch.uint8)
    on_host = flat.device.type == "cpu"
    ring = ([flat.numpy()] if on_host else
            [torch.empty(_PIECE, dtype=torch.uint8, pin_memory=True)
             for _ in range(_WRITERS + 2)])
    writes, crc = [], 0
    fd = os.open(path, os.O_WRONLY)
    try:
        with ThreadPoolExecutor(_WRITERS) as pool:
            for j, start in enumerate(range(0, flat.numel(), _PIECE)):
                n = min(_PIECE, flat.numel() - start)
                if on_host:
                    view = ring[0][start:start + n]
                else:
                    if j >= len(ring):
                        writes[j - len(ring)].result()   # its buffer's
                    buf = ring[j % len(ring)][:n]
                    buf.copy_(flat[start:start + n])
                    view = buf.numpy()
                crc = zlib.crc32(view, crc)
                writes.append(pool.submit(_pwrite_all, fd, view,
                                          offset + start))
            for w in writes:
                w.result()
    finally:
        os.close(fd)
    return (list(t.shape), "bfloat16" if low else dtype.name,
            crc & 0xFFFFFFFF)


def save_checkpoint(ckpt_dir, step: int, tree, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves, treedef = _flatten(tree)
    manifest = {"step": step, "treedef": treedef, "n_leaves": len(leaves),
                "leaves": []}
    for i, leaf in enumerate(leaves):
        shape, logical, crc = _write_leaf(tmp / f"leaf_{i}.npy", leaf)
        manifest["leaves"].append({"i": i, "shape": shape,
                                   "dtype": logical, "crc32": crc})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    """Remove all but the newest ``keep`` committed steps."""
    steps = sorted(p for p in ckpt_dir.glob("step_????????")
                   if not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1])
                   for p in ckpt_dir.glob("step_????????"))
    return steps[-1] if steps else None


def template_of(tree):
    """Shape/dtype-only copy of a tree (tensors on the ``meta`` device):
    what :func:`restore_checkpoint` needs to rebuild it."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.name != logical:
        raise CheckpointCorrupt(f"leaf stored as {arr.dtype}, manifest says "
                                f"{logical}")
    return torch.from_numpy(arr)


def restore_checkpoint(ckpt_dir, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree`` (tensors or a
    :func:`template_of`), cast to its dtypes, on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; raises without a card)."""
    device = resolve_device(device)
    src = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    likes, _ = _flatten(like_tree)
    if manifest["n_leaves"] != len(likes):
        raise ValueError(f"leaf count mismatch: {manifest['n_leaves']} vs "
                         f"{len(likes)}")
    out = []
    for i, like in enumerate(likes):
        arr = np.load(src / f"leaf_{i}.npy")
        entry = manifest["leaves"][i]
        want = entry.get("crc32")          # pre-checksum ckpts: unverified
        if want is not None and _leaf_crc(arr) != want:
            raise CheckpointCorrupt(
                f"{src}/leaf_{i}.npy: payload checksum mismatch "
                f"(expected {want:#010x}, got {_leaf_crc(arr):#010x}) — "
                "truncated or bit-flipped read, refusing to load")
        t = _from_host(arr, entry["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: {tuple(t.shape)} vs "
                             f"{tuple(like.shape)}")
        out.append(t.to(device=device, dtype=like.dtype))
    return _unflatten(like_tree, out)


class AsyncCheckpointer:
    """Background-thread saver: the train loop hands off host copies and
    keeps stepping (compute and I/O overlap).  ``save`` waits for the last
    write, copies the tree to the host (so later in-place updates of the
    params and states cannot reach the write), then starts the thread;
    ``wait`` joins it and re-raises a failed write."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, self.keep)
                self.last_saved = step
            except Exception as e:          # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; re-raises a failed write rather than
        letting the train loop believe the checkpoint is durable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
