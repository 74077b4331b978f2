"""Exporters: COLMAP sparse model -> PLY point cloud, and PLY merging.

Rebuilds the useful parts of the upstream script collection the reference
vendors (ref:colmap/export_to_*.py, merge_ply_files.py) on top of this
framework's own model reader (data/colmap_model.py) and PLY writer
(meshing/ply.py).

The port's own copy of factored_neus_tpu/colmap_tools/export.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np

from ..data import colmap_model as CM
from ..meshing import ply as PLY


def _read_points3D(model_dir: str) -> Dict:
    b = os.path.join(model_dir, "points3D.bin")
    if os.path.exists(b):
        return CM.read_points3D_binary(b)
    return CM.read_points3D_text(os.path.join(model_dir, "points3D.txt"))


def model_to_ply(model_dir: str, out_path: str,
                 min_track_len: int = 0) -> int:
    """Sparse model dir (points3D.bin/.txt) -> colored PLY point cloud.
    Returns the number of exported points."""
    pts3d = _read_points3D(model_dir)
    xyz, rgb = [], []
    for p in pts3d.values():
        if min_track_len and len(p.image_ids) < min_track_len:
            continue
        xyz.append(p.xyz)
        rgb.append(p.rgb)
    if not xyz:
        raise ValueError(f"no points (min_track_len={min_track_len}) "
                         f"in {model_dir}")
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    PLY.write_ply(out_path, xyz, colors=rgb)
    return len(xyz)


def merge_ply_files(paths: Iterable[str], out_path: str) -> int:
    """Concatenate the vertex clouds of several PLYs (colors kept when every
    input has them). Returns total vertex count."""
    all_xyz, all_rgb = [], []
    for p in paths:
        data = PLY.read_ply(p)
        v = data["vertex"]
        all_xyz.append(np.stack([v["x"], v["y"], v["z"]], -1))
        if all(k in v for k in ("red", "green", "blue")):
            all_rgb.append(np.stack([v["red"], v["green"], v["blue"]], -1))
        else:
            all_rgb.append(None)
    xyz = np.concatenate(all_xyz).astype(np.float32)
    rgb = (np.concatenate(all_rgb).astype(np.uint8)
           if all(r is not None for r in all_rgb) else None)
    PLY.write_ply(out_path, xyz, colors=rgb)
    return len(xyz)
