"""Dataset loaders: host-side I/O, device-resident camera and image tables.
Counterpart of factored_neus_tpu/data/datasets.py; this slice ports the DTU
layout (cameras_sphere.npz + image/*.png + mask/*.png).
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from . import images as I
from .cameras import load_K_Rt_from_P


class DTUDataset:
    """DTU scans: P-matrix decomposition, /256 BGR images, bbox from the
    scale mats."""

    def __init__(self, conf, device: torch.device):
        self.conf = conf
        self.device = device
        self.data_dir = conf["data_dir"]
        cams = np.load(os.path.join(
            self.data_dir, conf.get("render_cameras_name",
                                    "cameras_sphere.npz")))
        self.images_lis = sorted(glob(os.path.join(self.data_dir,
                                                   "image/*.png")))
        self.masks_lis = sorted(glob(os.path.join(self.data_dir,
                                                  "mask/*.png")))
        n = len(self.images_lis)
        if n == 0:
            raise FileNotFoundError(f"no images under {self.data_dir}/image")
        images_np = np.stack([I.imread_bgr_norm256(p)
                              for p in self.images_lis]).astype(np.float32)
        masks_np = np.stack([I.imread_bgr_norm256(p)
                             for p in self.masks_lis]).astype(np.float32)
        world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                      for i in range(n)]
        self.scale_mats_np = [cams[f"scale_mat_{i}"].astype(np.float32)
                              for i in range(n)]
        intr, poses = [], []
        for scale_mat, world_mat in zip(self.scale_mats_np,
                                        world_mats):
            K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intr.append(K)
            poses.append(pose)
        intr = np.stack(intr).astype(np.float32)
        self.images = torch.from_numpy(images_np).to(device)
        self.masks = torch.from_numpy(masks_np).to(device)
        self.intrinsics_all_inv = torch.from_numpy(
            np.linalg.inv(intr).astype(np.float32)).to(device)
        self.pose_all = torch.from_numpy(
            np.stack(poses).astype(np.float32)).to(device)
        self.n_images = n
        self.H, self.W = images_np.shape[1], images_np.shape[2]

        bbox_min = np.array([-1.01, -1.01, -1.01, 1.0])
        bbox_max = np.array([1.01, 1.01, 1.01, 1.0])
        s0 = self.scale_mats_np[0]
        inv0 = np.linalg.inv(s0)
        self.object_bbox_min = (inv0 @ s0 @ bbox_min[:, None])[:3, 0]
        self.object_bbox_max = (inv0 @ s0 @ bbox_max[:, None])[:3, 0]


def make_dataset(kind: str, conf, device: torch.device):
    if kind == "dtu":
        return DTUDataset(conf, device)
    raise NotImplementedError(f"dataset type {kind!r} is not ported yet "
                              "(only 'dtu')")
