"""Checkpoints of training state in ``repro.train.checkpoint``'s on-disk
layout::

    <dir>/step_00000042/arrays.npz     a0, a1, ... one array per leaf
    <dir>/step_00000042/MANIFEST.json  {"step", "names", "time", "extra"}

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), lists and tuples of tensors or arrays; a leaf's name is
its path joined by ``/`` (``0/emb``, ``1/mu/layers.0.attn.wq``), so a
plain nested dict of arrays saved by either package restores in the
other.  ``save`` copies every leaf to the host at once (bfloat16 upcast
to float32: npz has no bfloat16) and writes on a background thread, into
a temporary directory that is then renamed into place; ``keep`` bounds
the number of checkpoints kept.  ``restore`` casts each leaf back to the
dtype of the template's leaf and puts it on that leaf's device.  The
extra dict carries the step and the data pipeline's state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

_NPZ_DTYPES = (np.float64, np.float32, np.float16, np.int64, np.int32,
               np.int16, np.int8, np.uint32, np.uint8, np.bool_)


def _flatten_with_names(tree, path=()):
    """(names, leaves) in the reference's order: dict keys sorted, then
    list and tuple items in order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return ["/".join(path)], [tree]
    names, leaves = [], []
    for k, v in items:
        n, lv = _flatten_with_names(v, path + (str(k),))
        names += n
        leaves += lv
    return names, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    h = np.asarray(leaf)
    if h.dtype not in _NPZ_DTYPES:
        h = h.astype(np.float32)
    return h


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and os.path.exists(
                     os.path.join(self.dir, d, "MANIFEST.json"))]
        return max(steps) if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = False):
        """Copy every leaf to the host now, write on a background thread."""
        self.wait()
        names, leaves = _flatten_with_names(tree)
        host = [_to_host(leaf) for leaf in leaves]

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": h for i, h in enumerate(host)})
            manifest = {"step": step, "names": names, "time": time.time(),
                        "extra": extra or {}}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, template, step: Optional[int] = None):
        """The checkpoint at ``step`` (default: the newest) as ``template``'s
        structure, each leaf a tensor of the template leaf's dtype on its
        device.  Returns (tree, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        names, leaves = _flatten_with_names(template)
        if names != manifest["names"]:
            raise ValueError("checkpoint/tree structure mismatch")
        out = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, (name, like) in enumerate(zip(names, leaves)):
                h = data[f"a{i}"]
                like = torch.as_tensor(like)
                if tuple(h.shape) != tuple(like.shape):
                    raise ValueError(f"{name}: {h.shape} != "
                                     f"{tuple(like.shape)}")
                out.append(torch.from_numpy(h).to(like.device, like.dtype))
        return _unflatten(template, iter(out)), manifest.get("extra", {})
