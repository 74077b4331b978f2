"""Mask-based mesh cleaning: project the vertices into every view, keep
those inside every dilated object mask, drop faces that lose a vertex, and
keep the largest connected component.  Counterpart of
factored_neus_tpu/evaltools/clean_mesh.py, without cv2: the masks are read
by the port's PNG reader and dilated here with cv2's elliptic structuring
element (``ellipse_kernel``, ``dilate_ellipse``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..data.images import imread_bgr_u8


def ellipse_kernel(ksize: int) -> np.ndarray:
    """[ksize, ksize] uint8: cv2.getStructuringElement(MORPH_ELLIPSE,
    (ksize, ksize))."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    k = np.zeros((ksize, ksize), np.uint8)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            # cv2 rounds to nearest, ties to even (saturate_cast<int>)
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            k[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1
    return k


def dilate_ellipse(mask: np.ndarray, ksize: int = 25) -> np.ndarray:
    """cv2.dilate(mask, ellipse_kernel(ksize)) of a uint8 [H, W] or
    [H, W, C] image: the maximum over the kernel anchored at its centre,
    pixels outside the image taking no part.  Each kernel row is a
    centred run, so the dilation is a maximum over the rows' horizontal
    running maxima, shifted."""
    from scipy.ndimage import maximum_filter1d
    src = np.asarray(mask, np.uint8)
    k = ellipse_kernel(ksize)
    H = src.shape[0]
    out = np.zeros_like(src)
    runs = {}
    for i in range(ksize):
        width = int(k[i].sum())
        if width == 0:
            continue
        if width not in runs:
            runs[width] = maximum_filter1d(src, width, axis=1,
                                           mode="constant", cval=0)
        dy = i - ksize // 2                  # out[y] takes row y + dy
        lo, hi = max(0, -dy), min(H, H - dy)
        if lo < hi:
            np.maximum(out[lo:hi], runs[width][lo + dy:hi + dy],
                       out=out[lo:hi])
    return out


def clean_points_by_mask(points: np.ndarray, cameras_npz: str,
                         mask_paths: Sequence[str], n_images: int,
                         dilate_ksize: int = 25) -> np.ndarray:
    """Boolean keep-mask of the vertices that project inside every view's
    dilated mask (out-of-frame projections are kept)."""
    cameras = np.load(cameras_npz)
    inside = np.ones(len(points), dtype=bool)
    for i in range(n_images):
        P = cameras[f"world_mat_{i}"]
        pts_img = (P[None, :3, :3] @ points[:, :, None])[..., 0] + \
            P[None, :3, 3]
        pts_img = pts_img / pts_img[:, 2:]
        pts_img = np.round(pts_img).astype(np.int32) + 1

        mask_img = dilate_ellipse(imread_bgr_u8(mask_paths[i])[:, :, 0],
                                  dilate_ksize) > 128
        H, W = mask_img.shape
        # ones border so out-of-frame projections survive
        padded = np.ones((H + 2, W + 2), dtype=bool)
        padded[1:H + 1, 1:W + 1] = mask_img
        ys = pts_img[:, 1].clip(0, H + 1)
        xs = pts_img[:, 0].clip(0, W + 1)
        inside &= padded[ys, xs]
    return inside


def largest_component(vertices: np.ndarray, faces: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the connected component with the most faces (connectivity over
    shared vertices), through scipy's connected_components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(vertices)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    adj = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                     shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    face_roots = labels[faces[:, 0]]
    roots, counts = np.unique(face_roots, return_counts=True)
    best = roots[np.argmax(counts)]
    keep_faces = faces[face_roots == best]

    used = np.zeros(len(vertices), dtype=bool)
    used[keep_faces.ravel()] = True
    remap = np.full(len(vertices), -1, dtype=np.int64)
    remap[used] = np.arange(used.sum())
    return vertices[used], remap[keep_faces]


def clean_mesh(vertices: np.ndarray, faces: np.ndarray, cameras_npz: str,
               mask_paths: Sequence[str], n_images: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole cleaning: mask culling, orphan faces, largest component."""
    keep = clean_points_by_mask(vertices, cameras_npz, mask_paths, n_images)
    remap = np.full(len(vertices), -1, dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    face_keep = keep[faces].all(-1)
    new_faces = remap[faces[face_keep]]
    new_vertices = vertices[keep]
    return largest_component(new_vertices, new_faces)
