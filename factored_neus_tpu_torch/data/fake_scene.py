"""Analytic-sphere scenes in each dataset family's on-disk layout,
written with the port's own PNG, TIFF, EXR and PLY writers (no image
library needed):

  write_sphere_scene           DTU: cameras_sphere.npz + image/ + mask/ (the
                               same scene as the JAX package's test fixture
                               tests/make_fake_dtu.py, which writes through
                               cv2)
  write_blender_scene          Synthetic and Shiny Blender in one directory:
                               transforms_{train,test}.json; train frames
                               <f>_rgb.exr + <f>_mask.png (Synthetic) and
                               <f>.png + <f>_disp.tiff (Shiny); test frames
                               <f>_rgba.png, <f>_albedo.png, <f>_rough.png;
                               dense_pcd.ply and test_info.json for the Shiny
                               mesh evaluation
  write_glossy_synthetic_scene NeRO glossy synthetic: {k}.png,
                               {k}-depth.png, {k}-camera.pkl
  write_glossy_real_scene      NeRO glossy real: cache.pkl, images/,
                               images_raw_1024/, object_point_cloud.ply
  write_sk3d_scene             Sk3d: tis_right/ images and cameras.npz with
                               roi_box_<i>

The object is a sphere at the origin: radius 0.5 in the frame the loaders
train in (radius 1.0 in Blender units, which the Blender loaders halve).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Tuple

import numpy as np

from .exr import write_exr
from .images import imwrite, write_tiff

SPHERE_R = 0.5


def write_sphere_scene(out_dir: str, n_views: int = 6, H: int = 128,
                       W: int = 160, radius: float = 3.0,
                       y_range: Tuple[float, float] = (0.4, 0.4)) -> str:
    """Cameras on a ring of ``radius`` around the origin, looking at it;
    their heights run over ``y_range`` in a triangle wave of period 7
    views ((0.2, 1.2) approximates a DTU scan's elevation arc)."""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    focal = 1.1 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    cameras = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        frac = (i % 7) / 6.0 if n_views > 1 else 0.0
        y = y_range[0] + (y_range[1] - y_range[0]) * frac
        c = np.array([radius * np.sin(ang), y, -radius * np.cos(ang)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        pose = np.eye(4)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = \
            right, np.cross(fwd, right), fwd, c
        P = np.eye(4)
        P[:3, :4] = K @ np.linalg.inv(pose)[:3, :4]
        cameras[f"world_mat_{i}"] = P.astype(np.float32)
        cameras[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        ys, xs = np.mgrid[0:H, 0:W]
        p = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
        cam = p @ np.linalg.inv(K).T
        cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
        d = cam @ pose[:3, :3].T
        b = 2 * (d @ c)
        disc = b * b - 4 * ((c @ c) - SPHERE_R ** 2)
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
        n = c[None, None] + t[..., None] * d
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        shade = np.clip(n[..., 1] * 0.5 + 0.5, 0, 1)
        img = np.where(hit[..., None], 0.25 + 0.55 * shade[..., None], 0.05)
        imwrite(os.path.join(out_dir, "image", f"{i:06d}.png"),
                (img * 255).astype(np.uint8).repeat(3, -1))
        imwrite(os.path.join(out_dir, "mask", f"{i:06d}.png"),
                (hit[..., None] * np.ones(3)).astype(np.uint8) * 255)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cameras)
    return out_dir


# -- the other families -----------------------------------------------------

BLENDER_RADIUS = 1.0          # the sphere in Blender units (0.5 loaded)
CAMERA_ANGLE_X = 0.6911112070083618   # NeRF-synthetic's field of view
ALBEDO = np.array([0.7, 0.5, 0.3])
ROUGHNESS = 0.3
_LIGHT = np.array([1.0, 1.0, 2.0]) / np.sqrt(6.0)


def _trace(K, c2w, H: int, W: int, radius: float,
           center=(0.0, 0.0, 0.0)) -> Dict[str, np.ndarray]:
    """The sphere seen by an OpenCV camera (c2w [4, 4], K [3, 3]) at pixel
    centres 0..W-1, 0..H-1: hit [H, W], depth along the ray, unit normal,
    and the view direction."""
    ys, xs = np.mgrid[0:H, 0:W]
    p = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    cam = p @ np.linalg.inv(K).T
    cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
    d = cam @ c2w[:3, :3].T
    o = c2w[:3, 3] - np.asarray(center, np.float64)
    b = 2 * (d @ o)
    disc = b * b - 4 * ((o @ o) - radius ** 2)
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    n = (o[None, None] + t[..., None] * d) / radius
    return {"hit": hit, "depth": np.where(hit, t, 0.0), "normal": n,
            "dir": d}


def _shade(tr: Dict[str, np.ndarray], up_axis: int) -> np.ndarray:
    """Linear RGB [H, W, 3]: ALBEDO lit by an ambient term and one light,
    with a Blinn-Phong highlight; 0 off the sphere."""
    light = np.roll(_LIGHT, up_axis - 2)
    n = tr["normal"]
    lam = np.clip(n @ light, 0, None)
    h = light[None, None] - tr["dir"]
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    spec = 0.5 * np.clip((n * h).sum(-1), 0, None) ** 40
    rgb = ALBEDO * (0.15 + 0.85 * lam[..., None]) + spec[..., None]
    return np.where(tr["hit"][..., None], np.clip(rgb, 0, 1), 0.0)


def _srgb8(lin: np.ndarray) -> np.ndarray:
    return np.round(np.power(np.clip(lin, 0, 1), 1 / 2.2) * 255).astype(
        np.uint8)


def _fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    i = np.arange(n) + 0.5
    z = 1 - 2 * i / n
    phi = np.pi * (1 + 5 ** 0.5) * i
    r = np.sqrt(1 - z * z)
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)


def _blender_pose(azimuth: float, elevation: float, dist: float):
    """A Blender camera (looking down its -z, y up; world z up) at
    ``dist`` from the origin, looking at it."""
    c = dist * np.array([np.cos(elevation) * np.cos(azimuth),
                         np.cos(elevation) * np.sin(azimuth),
                         np.sin(elevation)])
    back = c / np.linalg.norm(c)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = \
        right, np.cross(back, right), back, c
    return pose


def _look_at_w2c(c: np.ndarray, up=(0.0, -1.0, 0.0)):
    """OpenCV world-to-camera (R [3, 3], t [3]) of a camera at c looking at
    the origin."""
    fwd = -c / np.linalg.norm(c)
    right = np.cross(np.asarray(up), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], 0)
    return R, -R @ c


def _c2w(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = R.T, -R.T @ t
    return pose


def _ring(i: int, n: int, dist: float, height: float) -> np.ndarray:
    ang = 2 * np.pi * i / n
    return np.array([dist * np.sin(ang), height, -dist * np.cos(ang)])


def write_blender_scene(out_dir: str, n_train: int = 16, n_test: int = 4,
                        H: int = 800, W: int = 800, dist: float = 4.0
                        ) -> str:
    """The Synthetic and Shiny Blender layouts of one scene in out_dir:
    cameras at ``dist`` Blender units, on a spiral over elevations 15-60
    degrees (test views between the train views), CAMERA_ANGLE_X wide."""
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for split, n, shift in (("train", n_train, 0.0), ("test", n_test, 0.5)):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i in range(n):
            frac = (i + shift) / max(n, 1)
            pose = _blender_pose(2 * np.pi * frac * 2.0 + shift,
                                 np.radians(15 + 45 * frac), dist)
            name = f"{split}/r_{i}"
            frames.append({"file_path": name,
                           "transform_matrix": pose.tolist()})
            tr = _trace(K, pose @ flip, H, W, BLENDER_RADIUS)
            lin = _shade(tr, up_axis=2)
            hit = tr["hit"]
            alpha = (hit * 255).astype(np.uint8)[..., None]
            f = os.path.join(out_dir, name)
            if split == "train":
                write_exr(f + "_rgb.exr", lin.astype(np.float32))
                imwrite(f + "_mask.png", alpha[..., 0])
                imwrite(f + ".png", np.concatenate(
                    [_srgb8(lin)[..., ::-1], alpha], -1))
                write_tiff(f + "_disp.tiff", np.where(
                    hit, 1.0 / np.maximum(tr["depth"], 1e-6), 0.0))
            else:
                imwrite(f + "_rgba.png", np.concatenate(
                    [_srgb8(lin)[..., ::-1], alpha], -1))
                imwrite(f + "_albedo.png",
                        _srgb8(np.where(hit[..., None], ALBEDO,
                                        0.0))[..., ::-1])
                imwrite(f + "_rough.png", _srgb8(
                    np.where(hit[..., None], np.full(3, ROUGHNESS), 0.0)))
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as fp:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames},
                      fp)
    from ..meshing.ply import write_ply
    write_ply(os.path.join(out_dir, "dense_pcd.ply"),
              _fibonacci_sphere(20000, BLENDER_RADIUS))
    # the ground plane lies below the sphere (z = -1.5), so every point
    # counts; the distance cut-offs exceed the scene
    with open(os.path.join(out_dir, "test_info.json"), "w") as fp:
        json.dump({"max_dist_d": 2.0, "max_dist_t": 2.0,
                   "points": [[-1.0, -1.0, -1.5], [1.0, -1.0, -1.5],
                              [0.0, 1.0, -1.5]]}, fp)
    return out_dir


def write_glossy_synthetic_scene(out_dir: str, n_views: int = 6,
                                 H: int = 128, W: int = 128,
                                 dist: float = 2.5) -> str:
    """{k}.png (sRGB), {k}-depth.png (16-bit, NeRO's depth / 15 x 65535,
    65535 off the object) and {k}-camera.pkl ((w2c [3, 4], K [3, 3]),
    float32) for cameras on a ring at height 0.6."""
    os.makedirs(out_dir, exist_ok=True)
    focal = 1.2 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    for k in range(n_views):
        R, t = _look_at_w2c(_ring(k, n_views, dist, 0.6))
        tr = _trace(K.astype(np.float64), _c2w(R, t), H, W, SPHERE_R)
        imwrite(os.path.join(out_dir, f"{k}.png"),
                _srgb8(_shade(tr, up_axis=1))[..., ::-1])
        depth = np.where(tr["hit"], tr["depth"] / 15.0 * 65535, 65535)
        imwrite(os.path.join(out_dir, f"{k}-depth.png"),
                np.round(depth).astype(np.uint16))
        with open(os.path.join(out_dir, f"{k}-camera.pkl"), "wb") as f:
            pickle.dump((np.concatenate([R, t[:, None]], 1).astype(
                np.float32), K), f)
    return out_dir


def write_glossy_real_scene(root: str, name: str = "bear",
                            n_views: int = 4, H: int = 96, W: int = 128,
                            dist: float = 2.5) -> str:
    """<root>/<name>/raw/ (the data_dir returned, with a trailing /):
    cache.pkl (w2c poses [3, 4], K for the originals' size, image names,
    ids), images/ (H x W originals) and images_raw_1024/ (the same views
    rendered with the long side 1024, as the loader expects), and
    object_point_cloud.ply (points on the sphere).  ``name`` must be a
    scene of datasets.GLOSSY_REAL_META."""
    from ..meshing.ply import write_ply
    from .datasets import GLOSSY_REAL_MAX_LEN
    data_dir = os.path.join(root, name, "raw")
    for sub in ("images", "images_raw_1024"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)
    focal = 1.2 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    ratio = GLOSSY_REAL_MAX_LEN / max(H, W)
    th, tw = int(ratio * H), int(ratio * W)
    K_raw = np.diag([tw / W, th / H, 1.0]) @ K
    poses, Ks, names, ids = {}, {}, {}, []
    for i in range(n_views):
        R, t = _look_at_w2c(_ring(i, n_views, dist, 0.4))
        poses[i] = np.concatenate([R, t[:, None]], 1)
        Ks[i], names[i] = K, f"{i:06d}.png"
        ids.append(i)
        for sub, KK, h, w in (("images", K, H, W),
                              ("images_raw_1024", K_raw, th, tw)):
            tr = _trace(KK, _c2w(R, t), h, w, SPHERE_R)
            imwrite(os.path.join(data_dir, sub, names[i]),
                    _srgb8(_shade(tr, up_axis=1))[..., ::-1])
    with open(os.path.join(data_dir, "cache.pkl"), "wb") as f:
        pickle.dump((poses, Ks, names, ids), f)
    write_ply(os.path.join(data_dir, "object_point_cloud.ply"),
              _fibonacci_sphere(2000, SPHERE_R))
    return data_dir + "/"


def write_sk3d_scene(root: str, n_views: int = 4, H: int = 96,
                     W: int = 128, dist: float = 2.5) -> str:
    """tis_right/rgb/undistorted/ambient@best/{i:04d}.png and
    tis_right/idr_input/cameras.npz (world_mat_<i> = K [R | t], identity
    scale_mat_<i>, roi_box_<i> = [left, right, top, bottom] of the
    sphere's silhouette) for cameras on a ring at height 0.3."""
    img_dir = os.path.join(root, "tis_right/rgb/undistorted/ambient@best")
    cam_dir = os.path.join(root, "tis_right/idr_input")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    focal = 1.2 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    K4 = np.eye(4)
    K4[:3, :3] = K
    cams = {}
    for i in range(n_views):
        R, t = _look_at_w2c(_ring(i, n_views, dist, 0.3))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        cams[f"world_mat_{i}"] = (K4 @ w2c).astype(np.float32)
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        tr = _trace(K, _c2w(R, t), H, W, SPHERE_R)
        ys, xs = np.nonzero(tr["hit"])
        cams[f"roi_box_{i}"] = np.array([xs.min(), xs.max() + 1, ys.min(),
                                         ys.max() + 1])
        imwrite(os.path.join(img_dir, f"{i:04d}.png"),
                _srgb8(_shade(tr, up_axis=1))[..., ::-1])
    np.savez(os.path.join(cam_dir, "cameras.npz"), **cams)
    return root
