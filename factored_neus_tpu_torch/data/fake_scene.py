"""The analytic-sphere DTU scene (cameras_sphere.npz + image/ + mask/),
written with the port's PNG writer: a grey sphere of radius 0.5 seen by a
ring of cameras.  The same scene as the JAX package's test fixture
tests/make_fake_dtu.py (make_fake_dtu_scene), which writes through cv2; a
machine without cv2 writes it here."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .images import imwrite

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
