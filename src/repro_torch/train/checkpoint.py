"""Checkpoints in the JAX package's own format: one ``.npz`` of the tree's
leaves keyed by their flat paths, and a ``.json`` of metadata.

The port of ``repro.train.checkpoint``, and the bridge's loader for JAX
snapshots: a path joins a leaf's dict keys and ``#i`` sequence indices with
``/`` (``blocks/#0/mixer/wq``), as ``jax.tree_util``'s paths print in
``repro.train.checkpoint._fmt``, so a snapshot either package writes
restores into the other's tree.  Leaves are written as host arrays in
their dtype; a bfloat16 leaf is written as JAX's writer leaves it in the
file, two raw bytes an element (numpy's ``|V2``), and read back by its bits
(the JAX package's own ``restore`` cannot cast such a leaf).  Restoring
casts each array to the dtype of the matching leaf of ``like`` and puts it
on that leaf's device.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

Params = Any
_SEP = "/"


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(flat path, leaf) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _paths(t, prefix + (f"#{i}",))]
    return [(_SEP.join(prefix), tree)]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"a {a.dtype} leaf restores into bfloat16 only, "
                             f"not {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(a)).to(device=like.device,
                                            dtype=like.dtype)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(ckpt_dir: str, step: int, tree: Params,
         extra_meta: Optional[Dict] = None) -> str:
    """Write ``step_<step>.npz`` / ``.json`` under ``ckpt_dir`` (through a
    temporary name, published by rename).  Returns the path stem."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    leaves = _paths(tree)
    flat = {k: (_to_host(v) if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in leaves}
    np.savez(tmp + ".npz", **flat)
    dtypes = {k: (_dtype_name(v) if isinstance(v, torch.Tensor)
                  else str(flat[k].dtype)) for k, v in leaves}
    meta = {"step": step, "keys": sorted(flat), "dtypes": dtypes}
    if extra_meta:
        meta.update(extra_meta)
    with open(tmp + ".json", "w") as f:
        json.dump(meta, f)
    os.replace(tmp + ".npz", path + ".npz")   # atomic publish
    os.replace(tmp + ".json", path + ".json")
    return path


class AsyncCheckpointer:
    """Background saves and retention of the last ``keep``.  A save that
    failed raises from the next ``wait`` (or ``save_async``)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Params,
                   extra_meta: Optional[Dict] = None) -> None:
        # the host snapshot is taken before returning: the caller may update
        # the tensors in place right after
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self.wait()

        def work():
            try:
                save(self.ckpt_dir, step, host, extra_meta)
                self._gc()
            except Exception as e:     # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in list_steps(self.ckpt_dir)[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.ckpt_dir,
                                           f"step_{s:08d}{ext}"))
                except FileNotFoundError:
                    pass


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Params, step: Optional[int] = None
            ) -> Tuple[Params, int]:
    """Restore into the structure of ``like`` (shapes checked; dtypes and
    devices from ``like``).  ``step`` None: the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    keys = iter(k for k, _ in _paths(like))

    def one(leaf):
        key = next(keys)
        a = arrays[key]
        if a.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape}, tree "
                             f"{tuple(leaf.shape)}")
        return _from_host(a, leaf)

    return tree_map(one, like), step
