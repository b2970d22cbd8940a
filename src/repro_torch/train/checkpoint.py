"""Checkpointing with atomic publish, in the JAX package's format.

Counterpart of ``repro.train.checkpoint``: one directory per step::

    ckpt_dir/step_000123/
      manifest.json            # leaf index: name -> shape/dtype/file, extras
      arrays/<leaf-name>.npy   # one file per tree leaf

Leaf names are the path strings of ``jax.tree_util.tree_flatten_with_path``
joined by "/": dict keys (sorted), list and tuple indices, and a
NamedTuple's fields as ``.<field>`` (so ``opt/.m/embed/table``); a None
subtree has no leaf.  The two packages therefore read each other's
checkpoints.  Every leaf is saved as a full host array.

Fault-tolerance contract used by the train loop:
* atomic publish — arrays are written into a tmp dir, renamed at the end;
  a crash mid-save never corrupts the latest checkpoint;
* ``latest_step`` scans for the newest complete manifest (restart picks it
  up after a node failure);
* SIGTERM triggers an emergency save at the next step boundary (see
  ``launch/train.py``).

``restore`` puts every leaf on the device of the matching leaf of ``like``:
the single-device form of JAX's elastic restore (shardings on a mesh are
ROADMAP A item 12.3.3).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.param import _map, _walk


def _leaf_names(tree) -> Dict[str, Any]:
    """Leaf name -> leaf, in ``models.param._walk``'s order."""
    return {"/".join(path): leaf for path, leaf in _walk(tree)}


def _to_numpy(name: str, leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    try:
        return leaf.detach().cpu().numpy()
    except TypeError as exc:
        raise TypeError(f"checkpoint leaf {name!r}: {leaf.dtype} has no "
                        f"numpy type ({exc})") from exc


def save(ckpt_dir: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None) -> str:
    """Atomically save a tree (params / opt state / data state bundle)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        arrays_dir = os.path.join(tmp, "arrays")
        os.makedirs(arrays_dir)
        manifest = {"step": step, "leaves": {}, "extras": extras or {}}
        for name, leaf in _leaf_names(tree).items():
            arr = _to_numpy(name, leaf)
            fname = name.replace("/", "__") + ".npy"
            np.save(os.path.join(arrays_dir, fname), arr)
            manifest["leaves"][name] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "file": fname}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``, each leaf in the file's dtype
    on the device of ``like``'s leaf."""
    base = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    loaded = []
    for name, leaf in _leaf_names(like).items():
        entry = manifest["leaves"].get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(base, "arrays", entry["file"]))
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: ckpt shape {arr.shape} != {want}")
        dev = leaf.device if torch.is_tensor(leaf) else torch.device("cpu")
        loaded.append(torch.from_numpy(arr).to(dev))
    it = iter(loaded)
    return _map(like, lambda _: next(it)), manifest["extras"]
