"""Headless COLMAP model visualization: export cameras + points to PLY.

The upstream script the reference vendors (ref:colmap/visualize_model.py)
opens an interactive Open3D window with camera frustum line sets
(ref:colmap/visualize_model.py:126-186) plus the track-filtered point
cloud (ref:colmap/visualize_model.py:47-70). This environment is headless
and open3d-free, so the equivalent here is an exporter: the same frustum
geometry (apex + 4 image-plane corners per view, pyramid edges) and the
same min-track-length point filter, written as a single PLY any viewer
(MeshLab, CloudCompare, Open3D) renders.

The port's own copy of factored_neus_tpu/colmap_tools/visualize.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..data import colmap_model as CM

# fx, fy, cx, cy extraction per camera model (param layouts from
# colmap src/base/camera_models.h; cf. CM.CAMERA_MODELS)
_FX_FY_CX_CY = {
    "SIMPLE_PINHOLE": (0, 0, 1, 2),
    "SIMPLE_RADIAL": (0, 0, 1, 2),
    "SIMPLE_RADIAL_FISHEYE": (0, 0, 1, 2),
    "RADIAL": (0, 0, 1, 2),
    "RADIAL_FISHEYE": (0, 0, 1, 2),
    "PINHOLE": (0, 1, 2, 3),
    "OPENCV": (0, 1, 2, 3),
    "OPENCV_FISHEYE": (0, 1, 2, 3),
    "FULL_OPENCV": (0, 1, 2, 3),
    "FOV": (0, 1, 2, 3),
    "THIN_PRISM_FISHEYE": (0, 1, 2, 3),
}


def camera_K(cam: CM.Camera) -> np.ndarray:
    """[3,3] pinhole intrinsics from any supported COLMAP camera model
    (distortion parameters are ignored for frustum display)."""
    layout = _FX_FY_CX_CY.get(cam.model)
    if layout is None:
        raise ValueError(f"unsupported camera model {cam.model!r}")
    need = max(layout) + 1
    if len(cam.params) < need:
        raise ValueError(
            f"camera model {cam.model!r} needs >= {need} params, "
            f"got {len(cam.params)}")
    fx, fy, cx, cy = (cam.params[i] for i in layout)
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def frustum_vertices(K: np.ndarray, R_c2w: np.ndarray, t_c2w: np.ndarray,
                     w: int, h: int, scale: float = 1.0) -> np.ndarray:
    """[5,3] world-space frustum points: apex then the 4 image corners
    unprojected to depth `scale` (the upstream pyramid geometry,
    ref:colmap/visualize_model.py:150-177)."""
    Kinv = np.linalg.inv(K)
    corners_px = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]],
                          np.float64)
    corners_cam = (Kinv @ corners_px.T).T * scale
    pts = np.concatenate([np.zeros((1, 3)), corners_cam], 0)
    return pts @ R_c2w.T + t_c2w[None]


_FRUSTUM_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [0, 4],          # apex -> corners
     [1, 2], [2, 3], [3, 4], [4, 1]], np.int64)  # image-plane rectangle


def model_frustums(cameras: Dict[int, CM.Camera],
                   images: Dict[int, CM.Image],
                   scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [5V,3], edges [8V,2]) for all V registered views.
    Pose inversion world->cam to cam->world as upstream
    (ref:colmap/visualize_model.py:74-82)."""
    verts, edges = [], []
    for img in images.values():
        R_w2c = img.qvec2rotmat()
        t_c2w = -R_w2c.T @ img.tvec
        cam = cameras[img.camera_id]
        base = 5 * len(verts)
        verts.append(frustum_vertices(camera_K(cam), R_w2c.T, t_c2w,
                                      cam.width, cam.height, scale))
        edges.append(_FRUSTUM_EDGES + base)
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 2), np.int64)
    return np.concatenate(verts, 0), np.concatenate(edges, 0)


def _write_ply_with_edges(path: str, verts: np.ndarray,
                          colors: np.ndarray, edges: np.ndarray) -> None:
    from ..meshing.ply import write_ply
    write_ply(path, verts, colors=colors, edges=edges)


def export_model_ply(model_dir: str, out_path: str, ext: str = "",
                     min_track_len: int = 3, frustum_scale: float = 1.0,
                     max_reproj_error: Optional[float] = None) -> dict:
    """Read a COLMAP sparse model and write one PLY holding the filtered
    colored point cloud plus magenta camera frustum wireframes.

    Filters mirror the upstream viewer: track length >= min_track_len
    (ref:colmap/visualize_model.py:54-60); max_reproj_error stands in for
    its statistical outlier removal (which needs a KD-tree pass upstream
    delegates to open3d).  Returns {n_points, n_views, out_path}.
    """
    cameras, images, points3D = CM.read_model(model_dir, ext=ext)
    xyz, rgb = [], []
    for p in points3D.values():
        if len(p.image_ids) < min_track_len:
            continue
        if max_reproj_error is not None and p.error > max_reproj_error:
            continue
        xyz.append(p.xyz)
        rgb.append(p.rgb)
    pts = (np.asarray(xyz, np.float64) if xyz else np.zeros((0, 3)))
    cols = (np.asarray(rgb, np.float64) if rgb else np.zeros((0, 3)))

    fv, fe = model_frustums(cameras, images, scale=frustum_scale)
    fcols = np.tile(np.array([[204, 51, 204]], np.float64), (len(fv), 1))

    verts = np.concatenate([pts, fv], 0)
    colors = np.concatenate([cols, fcols], 0)
    edges = fe + len(pts)
    _write_ply_with_edges(out_path, verts, colors, edges)
    return {"n_points": len(pts), "n_views": len(images),
            "out_path": out_path}
