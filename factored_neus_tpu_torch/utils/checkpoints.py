"""Checkpoint save/load in the JAX package's format, so that either
package resumes from the other's file.  Counterpart of
factored_neus_tpu/utils/checkpoints.py (save_checkpoint, load_checkpoint,
latest_checkpoint), written without JAX.

Files are {base_exp_dir}/checkpoints/ckpt_{iter:06d}.npz.  A group that is
a tree of dicts, lists and arrays (a params group in the JAX layout, see
bridge.py) is stored under keys ``<group>/<path>`` with the path's parts
joined by "/", and its structure in the JSON entry ``__spec__``; a group of
``Leaves`` (an optimizer state: the JAX package's optax leaves in tree
order) under ``<group>/__leaf<i>__`` with spec ``{"__leaves__": n}``; a bare
value under the group's own name.  The write goes to a temporary file that
is renamed into place.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np

_SEP = "/"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


class Leaves(list):
    """A group stored as ordered leaves (the JAX package's optimizer
    state), not as a tree."""


def _spec(tree) -> Any:
    """The JAX package's JSON mirror of a tree (None at the leaves; tuples
    tagged)."""
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [_spec(v) for v in tree]}
    if isinstance(tree, list):
        return [_spec(v) for v in tree]
    return None


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix] = np.asarray(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}{_SEP}{k}", out)


def _unflatten(spec, flat: Dict[str, np.ndarray], prefix: str) -> Any:
    if isinstance(spec, dict):
        if set(spec) == {"__tuple__"}:
            return tuple(_unflatten(v, flat, f"{prefix}{_SEP}{i}")
                         for i, v in enumerate(spec["__tuple__"]))
        return {k: _unflatten(v, flat, f"{prefix}{_SEP}{k}")
                for k, v in spec.items()}
    if isinstance(spec, list):
        return [_unflatten(v, flat, f"{prefix}{_SEP}{i}")
                for i, v in enumerate(spec)]
    return flat[prefix]


def save_checkpoint(base_exp_dir: str, iter_step: int,
                    groups: Dict[str, Any]) -> str:
    """groups: name -> tree of numpy arrays, ``Leaves``, or one value."""
    ckpt_dir = os.path.join(base_exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    spec: Dict[str, Any] = {}
    for name, tree in groups.items():
        if isinstance(tree, Leaves):
            spec[name] = {"__leaves__": len(tree)}
            for i, leaf in enumerate(tree):
                arrays[f"{name}{_SEP}__leaf{i}__"] = np.asarray(leaf)
        else:
            spec[name] = _spec(tree)
            _flatten(tree, name, arrays)
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
    path = os.path.join(ckpt_dir, f"ckpt_{iter_step:06d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """name -> tree of arrays, ``Leaves``, or one array."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__spec__"}
    out: Dict[str, Any] = {}
    for name, s in spec.items():
        if isinstance(s, dict) and "__leaves__" in s:
            out[name] = Leaves(flat[f"{name}{_SEP}__leaf{i}__"]
                               for i in range(s["__leaves__"]))
        else:
            out[name] = _unflatten(s, flat, name)
    return out


def latest_checkpoint(base_exp_dir: str,
                      end_iter: Optional[int] = None) -> Optional[str]:
    """Newest stamped checkpoint <= end_iter, or None."""
    ckpt_dir = os.path.join(base_exp_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_it = None, -1
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        it = int(m.group(1))
        if (end_iter is None or it <= end_iter) and it > best_it:
            best, best_it = os.path.join(ckpt_dir, name), it
    return best
