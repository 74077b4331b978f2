"""COLMAP MVS fused point cloud I/O: fused.ply + fused.ply.vis.

Format (colmap src/mvs/fusion.cc `WritePointsVisibility`; the upstream
script the reference vendors is ref:colmap/read_write_fused_vis.py):

* fused.ply — binary-LE PLY, per vertex: float32 x y z nx ny nz,
  uint8 red green blue.
* fused.ply.vis — little-endian binary: uint64 point count, then per point
  a uint32 visible-image count followed by that many uint32 image indices.

Implemented on this framework's own PLY reader (meshing/ply.py) — no
pandas/pyntcloud dependency.

The port's own copy of factored_neus_tpu/colmap_tools/fused.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..meshing import ply as PLY


@dataclass
class MeshPoint:
    position: np.ndarray            # [3] float
    normal: np.ndarray              # [3] float
    color: np.ndarray               # [3] uint8
    visible_image_idxs: np.ndarray  # [k] uint32

    @property
    def num_visible_images(self) -> int:
        return int(len(self.visible_image_idxs))


def write_fused_ply(points: List[MeshPoint], path: str) -> None:
    n = len(points)
    z = np.zeros((n, 3), np.float32)
    xyz = np.stack([p.position for p in points]) if n else z
    nrm = np.stack([p.normal for p in points]) if n else z
    rgb = (np.stack([p.color for p in points]) if n
           else np.zeros((n, 3), np.uint8))
    PLY.write_ply(path, xyz, colors=rgb, normals=nrm)


def write_fused_ply_vis(points: List[MeshPoint], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(np.uint64(len(points)).astype("<u8").tobytes())
        for p in points:
            idxs = np.asarray(p.visible_image_idxs, "<u4")
            f.write(np.uint32(len(idxs)).astype("<u4").tobytes())
            f.write(idxs.tobytes())


def write_fused(points: List[MeshPoint], ply_path: str,
                vis_path: str) -> None:
    write_fused_ply(points, ply_path)
    write_fused_ply_vis(points, vis_path)


def read_fused(ply_path: str, vis_path: str, as_arrays: bool = False):
    """List[MeshPoint] by default; as_arrays=True returns the columnar form
    (xyz [N,3], normals [N,3], rgb [N,3] u8, counts [N], flat_idxs) — use
    it for MVS-scale clouds where N MeshPoint objects cost real memory."""
    v = PLY.read_ply(ply_path)["vertex"]
    xyz = np.stack([np.asarray(v[c], np.float32) for c in "xyz"], 1)
    nrm = np.stack([np.asarray(v["n" + c], np.float32) for c in "xyz"], 1)
    rgb = np.stack([np.asarray(v[c], np.uint8)
                    for c in ("red", "green", "blue")], 1)
    with open(vis_path, "rb") as f:
        raw = f.read()
    n = int(np.frombuffer(raw[:8], "<u8")[0])
    if n != len(xyz):
        raise ValueError(
            f".vis point count {n} != PLY vertex count {len(xyz)}")
    # vectorized decode of the [count, idx...]* stream: real MVS clouds have
    # millions of points, a per-point read loop takes minutes
    words = np.frombuffer(raw[8:], "<u4")
    counts = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    # offset scan over a plain-int list: numpy scalar indexing costs ~1 us
    # per element, which is tens of seconds on a 10M-point cloud; python
    # ints are ~10x faster here
    wlist = words.tolist()
    n_words = len(wlist)
    pos = 0
    for i in range(n):
        if pos >= n_words:
            raise ValueError(
                f"truncated .vis data in {vis_path}: point {i}/{n} starts "
                f"past end of stream")
        c = wlist[pos]
        counts[i] = c
        starts[i] = pos + 1
        pos += 1 + c
    if pos != n_words:
        raise ValueError(f"trailing/truncated .vis data in {vis_path}")
    if as_arrays:
        keep = np.ones(len(words), bool)
        keep[starts - 1] = False          # drop the count words
        return xyz, nrm, rgb, counts, words[keep].copy()
    return [MeshPoint(xyz[i], nrm[i], rgb[i],
                      words[starts[i]:starts[i] + counts[i]].copy())
            for i in range(n)]
