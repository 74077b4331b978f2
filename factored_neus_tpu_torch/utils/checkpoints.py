"""Checkpoint save/load: iter-stamped npz archives with the reference's
directory layout ({base_exp_dir}/checkpoints/ckpt_{iter:06d}.npz).
Counterpart of factored_neus_tpu/utils/checkpoints.py.

Each group (``sdf_network_fine``, ``optimizer``, ``iter_step``, ...) is
stored under keys ``<group>/<name>`` where <name> is a state-dict key of
the group; a group that is a bare value is stored under its own name.  The
write goes to a temporary file that is renamed into place.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np

_SEP = "/"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def save_checkpoint(base_exp_dir: str, iter_step: int,
                    groups: Dict[str, Any]) -> str:
    """groups: name -> dict of arrays, or one array/scalar."""
    ckpt_dir = os.path.join(base_exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    spec: Dict[str, Any] = {}
    for name, tree in groups.items():
        if isinstance(tree, dict):
            spec[name] = sorted(tree)
            for k, v in tree.items():
                arrays[f"{name}{_SEP}{k}"] = np.asarray(v)
        else:
            spec[name] = None
            arrays[name] = np.asarray(tree)
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
    path = os.path.join(ckpt_dir, f"ckpt_{iter_step:06d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"]).decode())
        out: Dict[str, Any] = {}
        for name, keys in spec.items():
            if keys is None:
                out[name] = z[name]
            else:
                out[name] = {k: z[f"{name}{_SEP}{k}"] for k in keys}
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
