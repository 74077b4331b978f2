"""EPFL point-cloud evaluation.  Counterpart of
factored_neus_tpu/evaltools/epfl.py: 1e6 area-uniform mesh samples,
symmetric distances with a 0.8 cutoff, on the full ground truth and on the
bbox-cropped centre; writes result{suffix}.txt with both rows.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..meshing.ply import read_ply_mesh, read_ply_points
from . import pointcloud as PC


def sample_points_uniformly(vertices, triangles, n: int, seed: int = 0):
    """Area-weighted uniform surface samples (open3d's
    sample_points_uniformly equivalent)."""
    tri = vertices[triangles]
    if len(tri) == 0:
        raise ValueError(
            "mesh has no triangles to sample (after bbox cropping the "
            "mesh may not intersect the evaluation region)")
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(v1, v2), axis=-1)
    if area.sum() <= 0:
        raise ValueError("mesh triangles all have zero area — nothing to "
                         "sample")
    prob = area / area.sum()
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(tri), size=n, p=prob)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return tri[idx, 0] + u * v1[idx] + v * v2[idx]


def _crop_to_bbox(vertices, triangles, bb_points):
    """Keep triangles whose vertices all fall inside the oriented bbox of
    `bb_points` (axis-aligned in the bbox's principal frame)."""
    c = bb_points.mean(0)
    centered = bb_points - c
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    local = centered @ vt.T
    lo, hi = local.min(0), local.max(0)
    vloc = (vertices - c) @ vt.T
    inside = ((vloc >= lo) & (vloc <= hi)).all(-1)
    valid = inside[triangles].all(-1)
    return triangles[valid]


def eval(in_file: str, scene: str, dataset_dir: str, eval_dir: str,
         suffix: str = "") -> Tuple[float, float]:
    sample = int(1e6)
    thresh = 0.8

    vertices, triangles = read_ply_mesh(in_file)
    stl_large = read_ply_points(f"{dataset_dir}/{scene}_dense/gt_full.ply")
    stl_center = read_ply_points(f"{dataset_dir}/{scene}_dense/gt_center.ply")

    in_large = sample_points_uniformly(vertices, triangles, sample)
    bb_np = np.load(f"{dataset_dir}/{scene}_dense/bbox.npy")
    tri_centered = _crop_to_bbox(vertices, triangles, bb_np)
    in_center = sample_points_uniformly(vertices, tri_centered, sample)

    def chamfer_pair(a, b):
        d = PC.nn_distances(a, b)
        return d[d < thresh].mean()

    p2s = chamfer_pair(in_large, stl_large)
    s2p = chamfer_pair(stl_large, in_large)
    p2s_c = chamfer_pair(in_center, stl_center)
    s2p_c = chamfer_pair(stl_center, in_center)

    os.makedirs(eval_dir, exist_ok=True)
    with open(f"{eval_dir}/result{suffix}.txt", "w") as f:
        f.write(f"{p2s} {s2p} {(p2s + s2p) / 2}\n")
        f.write(f"{p2s_c} {s2p_c} {(p2s_c + s2p_c) / 2}")
    return float((p2s + s2p) / 2), float((p2s_c + s2p_c) / 2)
