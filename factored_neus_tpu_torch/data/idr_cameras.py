"""IDR-style camera utilities (quaternion poses, pixel lifting, sphere
intersection, depth).  Counterpart of factored_neus_tpu/data/idr_cameras.py
in torch: batched, no host loops, on the inputs' device.

Behavior parity: ref:models/rend_util.py:37-169.  The reference carries these
for IDR-format datasets; they are not on the active Factored-NeuS training
path (SURVEY.md §2.1 item 11) but are part of the public surface.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize quaternions [N,4] (w,x,y,z) -> rotation matrices
    [N,3,3]. ref:rend_util.py:87-106."""
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qj ** 2 + qk ** 2)
    r01 = 2 * (qj * qi - qk * qr)
    r02 = 2 * (qi * qk + qr * qj)
    r10 = 2 * (qj * qi + qk * qr)
    r11 = 1 - 2 * (qi ** 2 + qk ** 2)
    r12 = 2 * (qj * qk - qi * qr)
    r20 = 2 * (qk * qi - qj * qr)
    r21 = 2 * (qj * qk + qi * qr)
    r22 = 1 - 2 * (qi ** 2 + qj ** 2)
    return torch.stack([
        torch.stack([r00, r01, r02], -1),
        torch.stack([r10, r11, r12], -1),
        torch.stack([r20, r21, r22], -1)], dim=1)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [N,3,3] -> quaternions [N,4] (w-first trace form).
    ref:rend_util.py:109-127."""
    w = torch.sqrt(torch.clamp(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2],
                               min=1e-12)) / 2
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)
    return torch.stack([w, x, y, z], dim=-1)


def lift(x, y, z, intrinsics):
    """Pixels -> homogeneous camera points (IDR's -y/-z convention).
    ref:rend_util.py:69-84."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, -y_lift, -z, torch.ones_like(z)], dim=-1)


def _pose_matrices(pose: torch.Tensor) -> torch.Tensor:
    """[B, 4, 4] camera-to-world matrices of 7-vector (quat + loc) poses."""
    p = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(
        pose.shape[0], 1, 1)
    p[:, :3, :3] = quat_to_rot(pose[:, :4])
    p[:, :3, 3] = pose[:, 4:]
    return p


def get_camera_params(uv, pose, intrinsics):
    """(ray_dirs [B,S,3], cam_loc [B,3]) from pixel uv and either 7-vector
    (quat+loc) or matrix poses. ref:rend_util.py:37-66."""
    if pose.shape[1] == 7:
        cam_loc = pose[:, 4:]
        p = _pose_matrices(pose)
    else:
        cam_loc = pose[:, :3, 3]
        p = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(
            pose.shape[0], 1, 1)
        p[:, :3, :4] = pose[:, :3, :4]

    B, S, _ = uv.shape
    z = torch.ones((B, S), dtype=uv.dtype, device=uv.device)
    pts_cam = lift(uv[:, :, 0], uv[:, :, 1], z, intrinsics)      # [B,S,4]
    world = torch.einsum("bij,bsj->bsi", p, pts_cam)[:, :, :3]
    dirs = world - cam_loc[:, None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=2, keepdim=True)
    return dirs, cam_loc


def get_sphere_intersection(cam_loc, ray_directions, r: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(near/far intersections [B,S,2] clamped to 0.01, hit mask [B,S]) of
    rays with the radius-r origin sphere. ref:rend_util.py:130-152."""
    ray_cam_dot = torch.einsum("bsi,bi->bs", ray_directions, cam_loc)
    under_sqrt = ray_cam_dot ** 2 - (
        torch.sum(cam_loc ** 2, -1)[:, None] - r ** 2)
    mask = under_sqrt > 0
    sq = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    inter = torch.stack([-sq, sq], dim=-1) - ray_cam_dot[..., None]
    inter = torch.where(mask[..., None], inter, torch.zeros_like(inter))
    return torch.clamp(inter, min=0.01), mask


def get_depth(points, pose):
    """Camera-frame depth of world points. ref:rend_util.py:155-169."""
    B, S, _ = points.shape
    pose_m = _pose_matrices(pose) if pose.shape[1] == 7 else pose
    pts_hom = torch.cat([points, torch.ones((B, S, 1), dtype=points.dtype,
                                            device=points.device)], dim=2)
    pts_cam = torch.einsum("bij,bsj->bsi", torch.linalg.inv(pose_m), pts_hom)
    return pts_cam[:, :, 2:3]
