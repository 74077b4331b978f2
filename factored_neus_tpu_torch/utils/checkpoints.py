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
is renamed into place.  A leaf may be a torch tensor, on the host or a
CUDA device: it is fetched when the file is written.

``save_checkpoint_async`` (the training loops' save) snapshots every
tensor with a copy on its device, in stream order, and writes the file in
a thread of its own (counterpart of the JAX package's
save_checkpoint_async and wait_for_async_saves).
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import re
import sys
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_SEP = "/"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
# the writer in flight and the error of the last one, by directory
_LOCK = threading.Lock()
_WRITERS: Dict[str, threading.Thread] = {}
_ERRORS: Dict[str, BaseException] = {}


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


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix] = _host(tree)
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


def checkpoint_path(base_exp_dir: str, iter_step: int) -> str:
    return os.path.join(base_exp_dir, "checkpoints",
                        f"ckpt_{iter_step:06d}.npz")


def save_checkpoint(base_exp_dir: str, iter_step: int,
                    groups: Dict[str, Any]) -> str:
    """groups: name -> tree of arrays or tensors, ``Leaves``, or one
    value."""
    path = checkpoint_path(base_exp_dir, iter_step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    spec: Dict[str, Any] = {}
    for name, tree in groups.items():
        if isinstance(tree, Leaves):
            spec[name] = {"__leaves__": len(tree)}
            for i, leaf in enumerate(tree):
                arrays[f"{name}{_SEP}__leaf{i}__"] = _host(leaf)
        else:
            spec[name] = _spec(tree)
            _flatten(tree, name, arrays)
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
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


def _map(tree, fn: Callable[[Any], Any]):
    """tree with fn applied to each leaf (Leaves, dicts, lists and tuples
    kept as they are)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _join(base_exp_dir: Optional[str] = None,
          clear: bool = True) -> Optional[BaseException]:
    """Waits for the writer of base_exp_dir (of every directory when None);
    returns the first error among them (cleared unless ``clear`` is
    False)."""
    with _LOCK:
        keys = ([os.path.abspath(base_exp_dir)] if base_exp_dir is not None
                else list(set(_WRITERS) | set(_ERRORS)))
        threads = [_WRITERS[k] for k in keys if k in _WRITERS]
    for t in threads:
        t.join()
    err = None
    with _LOCK:
        for k in keys:
            e = _ERRORS.pop(k, None) if clear else _ERRORS.get(k)
            err = err or e
    return err


def join_writers() -> None:
    """Waits for every writer in flight; their errors stay for the next
    save or wait to raise (a CUDA graph capture waits here, as a fetch
    from another thread is illegal while it records)."""
    _join(clear=False)


def wait_for_async_saves() -> None:
    """Waits until every checkpoint written in the background is on disk;
    raises RuntimeError from a writer's error (once)."""
    err = _join()
    if err is not None:
        raise RuntimeError("async checkpoint write failed") from err


def save_checkpoint_async(base_exp_dir: str, iter_step: int,
                          groups: Dict[str, Any]) -> str:
    """save_checkpoint without waiting for the device or the disk: every
    tensor is snapshot by a copy on its device, queued on the current
    stream before this returns (so the next training step, queued after
    it, cannot reach the copy), and a writer thread fetches the copies
    only once an event recorded behind them has completed, then writes
    through save_checkpoint's atomic rename.  One writer is in flight per
    directory: a call waits for the directory's previous writer, and
    raises that writer's error after starting its own.  Returns the
    file's path."""
    snap = {name: _map(tree, lambda x: x.detach().clone()
                       if isinstance(x, torch.Tensor) else x)
            for name, tree in groups.items()}
    done = None
    if any(isinstance(x, torch.Tensor) and x.is_cuda for tree in
           snap.values() for x in _leaves_of(tree)):
        done = torch.cuda.Event()
        done.record()
    key = os.path.abspath(base_exp_dir)
    with _LOCK:
        prev = _WRITERS.get(key)
    if prev is not None:
        prev.join()

    def write(before: Optional[threading.Thread]):
        try:
            if before is not None:      # another caller's, started since
                before.join()
            if done is not None:
                done.synchronize()
            save_checkpoint(base_exp_dir, iter_step, snap)
        except Exception as e:     # surfaced at the next call or wait
            logging.getLogger("factored_neus_tpu_torch").error(
                "checkpoint write to %s (iter %d) failed: %s", base_exp_dir,
                iter_step, e)
            with _LOCK:
                _ERRORS[key] = e.with_traceback(None)

    # registered and started under the lock: every writer in _WRITERS has
    # started, and each joins the one before it
    with _LOCK:
        err = _ERRORS.pop(key, None)
        t = threading.Thread(target=write, args=(_WRITERS.get(key),),
                             name=f"ckpt-writer-{iter_step}")
        _WRITERS[key] = t
        t.start()
    if err is not None:
        raise RuntimeError("async checkpoint write failed") from err
    return checkpoint_path(base_exp_dir, iter_step)


def _leaves_of(tree):
    out = []
    _map(tree, out.append)
    return out


@atexit.register
def _unwaited_errors() -> None:
    """At exit, a writer's error that nothing waited for goes to stderr."""
    err = _join(clear=False)
    if err is not None:
        print(f"checkpoint write failed and was never waited for: {err!r}",
              file=sys.stderr)


def latest_checkpoint(base_exp_dir: str,
                      end_iter: Optional[int] = None) -> Optional[str]:
    """Newest stamped checkpoint <= end_iter, or None; waits first for the
    directory's writer in flight (its error stays for the next save or
    wait to raise)."""
    _join(base_exp_dir, clear=False)
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
