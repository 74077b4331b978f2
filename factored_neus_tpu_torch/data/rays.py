"""Ray generation on the device.  Counterpart of
factored_neus_tpu/data/rays.py (gen_rays_grid, gen_random_rays,
near_far_from_sphere) for the 'c2w' camera convention of DTU scenes.

The random pixel draw (``torch.Generator``) is kept apart from the
deterministic ``rays_from_pixels`` so that a test can hand the same pixels
to both packages.
"""
from __future__ import annotations

from typing import Tuple

import torch


def pixel_to_dir_c2w(intr_inv, pose, p):
    """p [..., 3] homogeneous pixels -> world unit directions."""
    cam = p @ intr_inv[:3, :3].T
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    return cam @ pose[:3, :3].T


def gen_rays_grid(intr_inv, pose, H: int, W: int, level: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid at 1/level resolution: (rays_o, rays_d)
    [H // level, W // level, 3], on the pixel spacing
    linspace(0, W - 1, W // level) of the reference's validation renders."""
    dev = pose.device
    tx = torch.linspace(0.0, W - 1.0, W // level, device=dev)
    ty = torch.linspace(0.0, H - 1.0, H // level, device=dev)
    py, px = torch.meshgrid(ty, tx, indexing="ij")
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    rays_d = pixel_to_dir_c2w(intr_inv, pose, p)
    return pose[:3, 3].expand(rays_d.shape), rays_d


def rays_from_pixels(px, py, images, masks, intr_inv_all, pose_all,
                     img_idx: int):
    """(rays_o, rays_d, color, mask[:, :1]) for integer pixels px, py [B]
    of image img_idx; images/masks [n, H, W, 3] on the rays' device."""
    color = images[img_idx][py, px]
    mask = masks[img_idx][py, px]
    p = torch.stack([px.to(torch.float32), py.to(torch.float32),
                     torch.ones_like(px, dtype=torch.float32)], dim=-1)
    pose = pose_all[img_idx]
    rays_d = pixel_to_dir_c2w(intr_inv_all[img_idx], pose, p)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d, color, mask[:, :1]


def gen_random_rays(gen: torch.Generator, images, masks, intr_inv_all,
                    pose_all, img_idx: int, batch_size: int):
    """One training batch: uniform pixels of image img_idx drawn from gen
    (a generator on the images' device)."""
    _, H, W = images.shape[:3]
    dev = images.device
    px = torch.randint(0, W, (batch_size,), generator=gen, device=dev)
    py = torch.randint(0, H, (batch_size,), generator=gen, device=dev)
    return rays_from_pixels(px, py, images, masks, intr_inv_all, pose_all,
                            img_idx)


def near_far_from_sphere(rays_o, rays_d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chord of the unit sphere along each ray."""
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
