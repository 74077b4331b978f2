"""Point-cloud machinery of the Chamfer evaluations.  Counterpart of
factored_neus_tpu/evaltools/pointcloud.py (sample_mesh_points, downsample,
nn_distances, error_colors): per-triangle barycentric grid samples,
vectorised by bucketing triangles on their grid sizes, and the greedy
radius downsample and nearest-neighbour distances on the port's native
KD-tree (native/kdtree.cpp).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..native import KDTree, greedy_downsample


def sample_mesh_points(vertices: np.ndarray, triangles: np.ndarray,
                       thresh: float) -> np.ndarray:
    """vertices + barycentric-grid samples at target density `thresh`.

    Per triangle: n1 = floor(l1/thr), n2 = floor(l2/thr) with
    thr = thresh*sqrt(l1*l2/area2); grid points (i+.5)/n1, (j+.5)/n2 with
    sum < 1 (matching ref:dtu_eval.py:19-28,57-76)."""
    tri_vert = vertices[triangles]
    v1 = tri_vert[:, 1] - tri_vert[:, 0]
    v2 = tri_vert[:, 2] - tri_vert[:, 0]
    l1 = np.linalg.norm(v1, axis=-1, keepdims=True)
    l2 = np.linalg.norm(v2, axis=-1, keepdims=True)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1, keepdims=True)
    nz = (area2 > 0)[:, 0]
    l1, l2, area2, v1, v2, tv0 = (l1[nz], l2[nz], area2[nz], v1[nz], v2[nz],
                                  tri_vert[nz, 0])
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr)[:, 0].astype(np.int64)
    n2 = np.floor(l2 / thr)[:, 0].astype(np.int64)

    chunks = [vertices]
    pairs = np.stack([n1, n2], axis=1)
    uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
    for u_idx, (a, b) in enumerate(uniq):
        sel = inverse == u_idx
        if not sel.any():
            continue
        c = np.mgrid[: a + 1, : b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        c = np.transpose(c, (1, 2, 0)).reshape(-1, 2)
        k = c[c.sum(-1) < 1]                       # [m, 2]
        if len(k) == 0:
            continue
        # q = v1*k0 + v2*k1 + tv0 for every selected triangle
        q = (v1[sel][:, None, :] * k[None, :, 0:1]
             + v2[sel][:, None, :] * k[None, :, 1:2]
             + tv0[sel][:, None, :])
        chunks.append(q.reshape(-1, 3))
    return np.concatenate(chunks, axis=0)


def downsample(points: np.ndarray, thresh: float,
               seed: Optional[int] = 0) -> np.ndarray:
    """Shuffle + greedy radius suppression (ref:dtu_eval.py:79-93)."""
    rng = np.random.default_rng(seed)
    pts = points.copy()
    rng.shuffle(pts, axis=0)
    keep = greedy_downsample(pts, thresh)
    return pts[keep]


def nn_distances(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    tree = KDTree(to_pts)
    dist, _ = tree.query(from_pts)
    return dist.astype(np.float64)


def error_colors(n_points: int, active_idx: np.ndarray, dists: np.ndarray,
                 vis_dist: float, max_dist: float) -> np.ndarray:
    """Red-white error ramp with green over-threshold, blue inactive
    (ref:dtu_eval.py:139-155)."""
    R = np.array([1.0, 0.0, 0.0])
    G = np.array([0.0, 1.0, 0.0])
    B = np.array([0.0, 0.0, 1.0])
    W = np.array([1.0, 1.0, 1.0])
    colors = np.tile(B, (n_points, 1))
    alpha = np.clip(dists, None, vis_dist)[:, None] / vis_dist
    colors[active_idx] = R * alpha + W * (1 - alpha)
    colors[active_idx[dists >= max_dist]] = G
    return colors
