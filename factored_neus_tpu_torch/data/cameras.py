"""Camera decomposition utilities (host-side, numpy).

Behavior parity: ref:models/dataset.py:17-38 (load_K_Rt_from_P, built on
cv2.decomposeProjectionMatrix).  We implement the RQ decomposition directly in
numpy so the data layer has no hard OpenCV dependency; when cv2 is available
the results agree to float precision (tested).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rq3(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RQ decomposition of a 3x3 matrix: A = R @ Q with R upper-triangular
    and Q orthonormal (via a flipped QR)."""
    p = np.fliplr(np.eye(3))
    q_t, r_t = np.linalg.qr((p @ a).T)
    r = p @ r_t.T @ p
    q = p @ q_t.T
    # fix signs so diag(R) > 0
    d = np.diag(np.sign(np.diag(r)))
    return r @ d, d @ q


def decompose_projection(P: np.ndarray):
    """Split P[3,4] into (K[3,3], R[3,3], camera center c[3]).

    Matches cv2.decomposeProjectionMatrix semantics: P = K [R | -R c],
    K normalized so K[2,2] = 1, det(R) = +1.
    """
    M = P[:, :3]
    K, R = rq3(M)
    # camera center: P @ [c;1] = 0
    c = -np.linalg.inv(M) @ P[:, 3]
    if np.linalg.det(R) < 0:
        R = -R
        c = c  # center unchanged (both M and P[:,3] flip together)
    K = K / K[2, 2]
    return K, R, c


def load_K_Rt_from_P(P: np.ndarray, filename: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsics[4,4], pose_c2w[4,4]) from a 3x4 projection matrix.
    ref:models/dataset.py:17-38."""
    if P is None:
        lines = open(filename).read().splitlines()
        if len(lines) == 4:
            lines = lines[1:]
        P = np.asarray([[float(w) for w in line.split()] for line in lines],
                       dtype=np.float32).squeeze()

    K, R, c = decompose_projection(np.asarray(P, dtype=np.float64))
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)   # world->cam R, so c2w rot = R^T
    pose[:3, 3] = c.astype(np.float32)
    return intrinsics, pose


def interpolate_pose(pose_0: np.ndarray, pose_1: np.ndarray, ratio: float
                     ) -> np.ndarray:
    """Slerp rotation + lerp translation between two c2w poses (in the
    inverted w2c frame, as the reference does). ref:models/dataset.py:153-181."""
    from scipy.spatial.transform import Rotation, Slerp
    inv0 = np.linalg.inv(pose_0)
    inv1 = np.linalg.inv(pose_1)
    rots = Rotation.from_matrix(np.stack([inv0[:3, :3], inv1[:3, :3]]))
    rot = Slerp([0, 1], rots)(ratio)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot.as_matrix()
    pose[:3, 3] = ((1.0 - ratio) * inv0 + ratio * inv1)[:3, 3]
    return np.linalg.inv(pose).astype(np.float32)
