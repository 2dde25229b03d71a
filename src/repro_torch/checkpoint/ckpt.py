"""Fault-tolerant checkpointing, the JAX package's
``repro/checkpoint/ckpt.py`` for trees of tensors.

Layout per step:
  <dir>/step_<n>.tmp/          arrays.npz + manifest.json   (staging)
  <dir>/step_<n>/              atomically renamed when complete

Guarantees:
  * atomic visibility (rename after the files are written) — a killed
    writer never leaves a readable-but-corrupt checkpoint; restore picks
    the newest COMPLETE step;
  * keep_k garbage collection;
  * async mode: the save runs on a writer thread while training goes on
    (``wait()`` joins before the next save). The port's AdamW updates
    the params and its state in place, so ``save_async`` copies the tree
    to host memory before it returns: a writer reading live tensors
    during the next step would save a torn checkpoint (the JAX package
    is safe through immutable arrays);
  * arrays are saved whole and restored onto ``device``.

The manifest is JSON (the JAX package writes msgpack, which the card's
Python lacks). Leaves are flattened in ``jax.tree_util``'s order
(``repro_torch.tree``); bfloat16 leaves are stored as their 16-bit
patterns and the manifest names their dtype.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as T

MANIFEST = "manifest.json"


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save(path: str | Path, step: int, tree, keep_k: int = 3):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"step_{step:09d}.tmp"
    final = path / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = T.leaves(tree)
    arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "dtypes": [str(torch.as_tensor(x).dtype).removeprefix("torch.")
                   for x in leaves],
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    _gc(path, keep_k)
    return final


def _gc(path: Path, keep_k: int):
    steps = sorted(p for p in path.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for old in steps[:-keep_k]:
        shutil.rmtree(old)


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in path.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / MANIFEST).exists()]
    return max(steps) if steps else None


def restore(path: str | Path, like_tree, step: int | None = None,
            shardings=None, device="cpu"):
    """Restore into the structure of ``like_tree``, every leaf a tensor
    on ``device``. Returns (tree, step). ``shardings`` (re-sharding onto
    a mesh) is not ported yet (ROADMAP.md, Queue 1: the LM's device
    mesh)."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a device mesh: not ported yet (ROADMAP.md, "
            "Queue 1: the LM's device mesh)")
    path = Path(path)
    step = step if step is not None else latest_step(path)
    assert step is not None, f"no checkpoint under {path}"
    d = path / f"step_{step:09d}"
    manifest = json.loads((d / MANIFEST).read_text())
    with np.load(d / "arrays.npz") as z:
        arrays = [z[f"a{i}"] for i in range(manifest["n_leaves"])]
    leaves = T.leaves(like_tree)
    assert len(leaves) == len(arrays), "checkpoint/tree mismatch"
    out = []
    for a, dtype in zip(arrays, manifest["dtypes"]):
        t = torch.from_numpy(a)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(device))
    return T.unflatten(like_tree, out), step


def host_copy(tree):
    """A copy of ``tree`` in host memory, taken now (a CUDA tensor's copy
    waits for the work that writes it)."""
    return T.tree_map(lambda t: torch.as_tensor(t).detach().to(
        "cpu", copy=True), tree)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (fault-tolerance
    substrate)."""

    def __init__(self, path: str | Path, keep_k: int = 3):
        self.path = Path(path)
        self.keep_k = keep_k
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree):
        """Copy ``tree`` to host memory, then write it on a thread."""
        self.wait()
        host_tree = host_copy(tree)  # before any in-place update
        write = save

        def run():
            try:
                write(self.path, step, host_tree, self.keep_k)
            except BaseException as e:  # wait() raises it
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; raise what it failed with, if it did."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
