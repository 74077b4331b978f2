"""Ray generation on the device.  Counterpart of
factored_neus_tpu/data/rays.py (gen_rays_grid, gen_random_rays,
near_far_from_sphere) in both camera conventions:

  * 'c2w': pose[:3, :3] rotates camera to world and pose[:3, 3] is the
    origin (DTU, Sk3d, Synthetic, Shiny);
  * 'w2c': pose is [R | t] world to camera ("nero": glossy synthetic and
    glossy real); directions are R^T K^-1 p, normalised after the
    rotation, and the origin is -R^T t.

The random pixel draw (``torch.Generator``) is kept apart from the
deterministic ``rays_from_pixels`` so that a test can hand the same pixels
to both packages.  Sk3d scans draw a share ``roi_prob`` of the pixels from
their region-of-interest box dilated by 10 px; with that share 0 the draw
is the uniform one alone.

The image index may be an int or an integer tensor on the tables' device,
and each image's dilated box is read from a device table
(``roi_table``): a training step captured into a CUDA graph reads both
from device memory, so that every replay draws from its own image.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

ROI_DILATION = 10     # px added around an Sk3d scan's region of interest
MASK_ONES = 255.0 / 256.0   # the constant mask of scans without masks


def pixel_to_dir_c2w(intr_inv, pose, p):
    """p [..., 3] homogeneous pixels -> world unit directions."""
    cam = p @ intr_inv[:3, :3].T
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    return cam @ pose[:3, :3].T


def pixel_to_dir_w2c(intr_inv, pose, p):
    """The 'nero' convention: R^T K^-1 p, normalised after the rotation."""
    world = (p @ intr_inv[:3, :3].T) @ pose[:3, :3]
    return world / torch.linalg.norm(world, dim=-1, keepdim=True)


def origin_c2w(pose):
    return pose[:3, 3]


def origin_w2c(pose):
    return -pose[:3, :3].T @ pose[:3, 3]


def _dirs_origin(intr_inv, pose, p, convention: str):
    if convention == "c2w":
        rays_d = pixel_to_dir_c2w(intr_inv, pose, p)
        return origin_c2w(pose).expand(rays_d.shape), rays_d
    if convention == "w2c":
        rays_d = pixel_to_dir_w2c(intr_inv, pose, p)
        return origin_w2c(pose).expand(rays_d.shape), rays_d
    raise ValueError(f"unknown camera convention {convention!r}")


def gen_rays_grid(intr_inv, pose, H: int, W: int, level: int = 1,
                  convention: str = "c2w"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid at 1/level resolution: (rays_o, rays_d)
    [H // level, W // level, 3], on the pixel spacing
    linspace(0, W - 1, W // level) of the reference's validation renders."""
    dev = pose.device
    tx = torch.linspace(0.0, W - 1.0, W // level, device=dev)
    ty = torch.linspace(0.0, H - 1.0, H // level, device=dev)
    py, px = torch.meshgrid(ty, tx, indexing="ij")
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    return _dirs_origin(intr_inv, pose, p, convention)


def image_index(img_idx, device) -> torch.Tensor:
    """img_idx (an int, or an integer tensor of one element on ``device``)
    as a one-element int64 tensor."""
    if torch.is_tensor(img_idx):
        return img_idx.reshape(1).to(torch.int64)
    return torch.tensor([int(img_idx)], device=device)


def rays_from_pixels(px, py, images, masks, intr_inv_all, pose_all,
                     img_idx, convention: str = "c2w",
                     mask_ones: bool = False):
    """(rays_o, rays_d, color, mask[:, :1]) for integer pixels px, py [B]
    of image img_idx (image_index); images/masks [n, H, W, 3] on the rays'
    device.  With ``mask_ones`` the mask is the constant 255/256 and the
    mask stack is not read."""
    i = image_index(img_idx, images.device)
    color = images[i, py, px]
    if mask_ones:
        mask = torch.full((px.shape[0], 1), MASK_ONES, device=images.device)
    else:
        mask = masks[i, py, px][:, :1]
    p = torch.stack([px.to(torch.float32), py.to(torch.float32),
                     torch.ones_like(px, dtype=torch.float32)], dim=-1)
    rays_o, rays_d = _dirs_origin(intr_inv_all.index_select(0, i)[0],
                                  pose_all.index_select(0, i)[0], p,
                                  convention)
    return rays_o, rays_d, color, mask


def roi_bounds(box: Sequence[int], H: int, W: int) -> Tuple[int, int, int,
                                                            int]:
    """(left, right, top, bottom) of an [l, r, t, b] box dilated by
    ROI_DILATION px and clipped to the image; x in [left, right) and y in
    [top, bottom) (at least one pixel each)."""
    left, right, top, bottom = (int(v) for v in box)
    left, top = max(0, left - ROI_DILATION), max(0, top - ROI_DILATION)
    right = min(W, right + ROI_DILATION)
    bottom = min(H, bottom + ROI_DILATION)
    return left, max(right, left + 1), top, max(bottom, top + 1)


def roi_table(boxes: Sequence[Sequence[int]], H: int, W: int,
              device) -> torch.Tensor:
    """[n, 4] int64 on ``device``: each image's box dilated and clipped
    (roi_bounds: left, right, top, bottom)."""
    return torch.tensor([roi_bounds(b, H, W) for b in boxes],
                        dtype=torch.int64, device=device)


def gen_random_rays(gen: torch.Generator, images, masks, intr_inv_all,
                    pose_all, img_idx, batch_size: int,
                    convention: str = "c2w", mask_ones: bool = False,
                    roi_box: Optional[Sequence[int]] = None,
                    roi_prob: float = 0.0,
                    roi: Optional[torch.Tensor] = None):
    """One training batch: uniform pixels of image img_idx drawn from gen
    (a generator on the images' device); with an ROI and roi_prob > 0,
    each pixel is replaced with probability roi_prob by one drawn
    uniformly from the dilated box, the draws made after the uniform
    ones.  The box is ``roi``, its (left, right, top, bottom) [4] on the
    device (a row of roi_table), or else ``roi_box``, the undilated box
    on the host (roi_bounds)."""
    _, H, W = images.shape[:3]
    dev = images.device
    px = torch.randint(0, W, (batch_size,), generator=gen, device=dev)
    py = torch.randint(0, H, (batch_size,), generator=gen, device=dev)
    if roi is None and roi_box is not None:
        roi = torch.tensor(roi_bounds(roi_box, H, W), device=dev)
    if roi is not None and roi_prob > 0.0:
        lo = roi[0::2, None]                       # left, top
        span = roi[1::2, None] - lo                # width, height
        u = torch.rand((2, batch_size), generator=gen, device=dev)
        inside = lo + torch.minimum((u * span).to(torch.int64), span - 1)
        take = torch.rand(batch_size, generator=gen, device=dev) < roi_prob
        px, py = torch.where(take, inside[0], px), torch.where(
            take, inside[1], py)
    return rays_from_pixels(px, py, images, masks, intr_inv_all, pose_all,
                            img_idx, convention, mask_ones)


def sample_batch(gen: torch.Generator, data: Dict, img_idx,
                 batch_size: int):
    """gen_random_rays on a dataset's training tables (``train_data()`` of
    data.datasets: images, masks, intr_inv, poses and the optional
    convention, mask_ones, roi_boxes and roi_prob; the boxes' roi_table
    under "roi_table" where the caller made it, draw_tables)."""
    roi = None
    if data.get("roi_boxes") is not None and data.get("roi_prob", 0.0) > 0:
        table = data.get("roi_table")
        if table is None:
            table = draw_tables(data)["roi_table"]
        roi = table.index_select(
            0, image_index(img_idx, table.device))[0]
    return gen_random_rays(
        gen, data["images"], data["masks"], data["intr_inv"], data["poses"],
        img_idx, batch_size, convention=data.get("convention", "c2w"),
        mask_ones=data.get("mask_ones", False), roi=roi,
        roi_prob=data.get("roi_prob", 0.0))


def draw_tables(data: Dict) -> Dict:
    """The training tables with the device table of their ROI boxes
    ("roi_table", roi_table) where an ROI draw is on: made once, so that
    no step copies from the host."""
    if data.get("roi_boxes") is None or data.get("roi_prob", 0.0) <= 0:
        return data
    H, W = data["images"].shape[1:3]
    return dict(data, roi_table=roi_table(data["roi_boxes"], H, W,
                                          data["images"].device))


def near_far_from_sphere(rays_o, rays_d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chord of the unit sphere along each ray."""
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
