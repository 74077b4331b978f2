"""Dataset loaders: host-side I/O, device-resident camera and image tables.
Counterpart of factored_neus_tpu/data/datasets.py, with its six families
and their type names (DATASET_TYPES):

  DTUDataset              cameras_sphere.npz + image/ + mask/ (P-matrix
                          decomposition, /256 BGR images, bbox from the
                          scale mats)
  Sk3dDataset             tis_right/ cameras.npz and images; the constant
                          255/256 mask and the ROI pixel sampler
  SyntheticDataset        transforms_{split}.json: EXR rgb + mask png
                          (train), rgba/albedo/rough png (test); the
                          Blender camera flip, translations / 2
  ShinyDataset            Shiny Blender: png rgb + disparity TIFF (or
                          alpha png) masks; scale_mat for the mesh
                          evaluation
  GlossySyntheticDataset  NeRO: {k}.png, {k}-depth.png (< 0.9 masks),
                          pickled (pose, K); w2c rays
  GlossyRealDataset       NeRO captures: cache.pkl cameras, the object's
                          point cloud normalised into the unit sphere in
                          the scene's gravity frame; w2c rays

Every loader keeps the same interface: n_images, H, W, images and masks
[n, H, W, 3] on the device (a [n, 1, 1, 3] stand-in under mask_ones,
which never reads it), intrinsics_all(_inv), pose_all, the object box,
convention, mask_ones, color_bgr, gen_rays_at, gen_rays_between,
image_at and train_data (the tables of the training draw).
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Dict

import numpy as np
import torch

from . import images as I
from . import rays as R
from .cameras import interpolate_pose, load_K_Rt_from_P


def _read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _box_through(scale_mat: np.ndarray, inv0: np.ndarray):
    """The [-1.01, 1.01]^3 box taken through inv0 @ scale_mat."""
    lo = np.array([-1.01, -1.01, -1.01, 1.0])
    hi = np.array([1.01, 1.01, 1.01, 1.0])
    return ((inv0 @ scale_mat @ lo[:, None])[:3, 0],
            (inv0 @ scale_mat @ hi[:, None])[:3, 0])


class BaseDataset:
    """The tables on the device and the ray grids of validation renders."""

    convention = "c2w"
    mask_ones = False
    sample_roi_prob = 0.0
    roi_boxes = None
    # channel order of the image stack: cv2-read families (DTU, Sk3d,
    # glossy) are BGR, the EXR / Blender families RGB
    color_bgr = True

    def _finalize(self, images_np, masks_np, intrinsics_np, poses_np):
        self.images = torch.from_numpy(
            np.asarray(images_np, np.float32)).to(self.device)
        n = len(images_np)
        if self.mask_ones:
            # the constant-mask draw never reads the stack: a broadcastable
            # stand-in keeps the interface without the memory
            self.masks = torch.ones(n, 1, 1, 3, device=self.device)
        else:
            self.masks = torch.from_numpy(
                np.asarray(masks_np, np.float32)).to(self.device)
        intr = np.asarray(intrinsics_np, np.float32)
        if intr.shape[-1] == 3:          # pad 3x3 K to 4x4
            intr4 = np.tile(np.eye(4, dtype=np.float32), (len(intr), 1, 1))
            intr4[:, :3, :3] = intr
            intr = intr4
        self.intrinsics_all = torch.from_numpy(intr).to(self.device)
        self.intrinsics_all_inv = torch.from_numpy(
            np.linalg.inv(intr).astype(np.float32)).to(self.device)
        self.pose_all = torch.from_numpy(
            np.asarray(poses_np, np.float32)).to(self.device)
        self.focal = float(intr[0, 0, 0])
        self.n_images = n
        self.H, self.W = images_np.shape[1], images_np.shape[2]

    def train_data(self) -> Dict:
        """The tables of the training draw (rays.sample_batch)."""
        roi = self.sample_roi_prob > 0.0 and self.roi_boxes is not None
        return {"images": self.images, "masks": self.masks,
                "intr_inv": self.intrinsics_all_inv, "poses": self.pose_all,
                "convention": self.convention, "mask_ones": self.mask_ones,
                "roi_boxes": self.roi_boxes if roi else None,
                "roi_prob": self.sample_roi_prob if roi else 0.0}

    def gen_rays_at(self, img_idx: int, resolution_level: int = 1):
        """(rays_o, rays_d) [H // l, W // l, 3] of view img_idx."""
        return R.gen_rays_grid(self.intrinsics_all_inv[img_idx],
                               self.pose_all[img_idx], self.H, self.W,
                               resolution_level, self.convention)

    def gen_rays_between(self, idx_0: int, idx_1: int, ratio: float,
                         resolution_level: int = 1):
        """The ray grid of a pose interpolated between views idx_0 and
        idx_1, with view 0's intrinsics, in the c2w convention whatever
        the family's (as the JAX package computes it)."""
        pose = interpolate_pose(self.pose_all[idx_0].cpu().numpy(),
                                self.pose_all[idx_1].cpu().numpy(), ratio)
        return R.gen_rays_grid(self.intrinsics_all_inv[0],
                               torch.from_numpy(pose).to(self.device),
                               self.H, self.W, resolution_level)

    def image_at(self, idx: int, resolution_level: int) -> np.ndarray:
        """View idx of the image stack x256, resized (bilinear) to
        1/resolution_level and clipped to [0, 255]."""
        img = self.images[idx].cpu().numpy()
        return np.clip(I.imresize(img * 256.0,
                                  self.W // resolution_level,
                                  self.H // resolution_level), 0, 255)


class DTUDataset(BaseDataset):
    """DTU scans: P-matrix decomposition, /256 BGR images, bbox from the
    scale mats."""

    def __init__(self, conf, device: torch.device):
        self.conf, self.device = conf, device
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
        for scale_mat, world_mat in zip(self.scale_mats_np, world_mats):
            K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intr.append(K)
            poses.append(pose)
        self._finalize(images_np, masks_np, np.stack(intr), np.stack(poses))
        s0 = self.scale_mats_np[0]
        self.object_bbox_min, self.object_bbox_max = _box_through(
            s0, np.linalg.inv(s0))

    def image_at(self, idx: int, resolution_level: int) -> np.ndarray:
        """View idx re-read from its PNG, x256 and resized (bilinear) to
        1/resolution_level: [H // l, W // l, 3] BGR in [0, 255]."""
        img = I.imread_bgr_norm256(self.images_lis[idx]) * 256.0
        return np.clip(I.imresize(img, self.W // resolution_level,
                                  self.H // resolution_level), 0, 255)


class Sk3dDataset(DTUDataset):
    """Sk3d scans (tis_right/ images and cameras.npz): no masks (the
    constant 255/256), and ROI-weighted pixel sampling at the conf's
    sample_roi_prob."""

    mask_ones = True

    def __init__(self, conf, device: torch.device):
        self.conf, self.device = conf, device
        self.data_dir = conf["data_dir"]
        cams = np.load(os.path.join(self.data_dir,
                                    "tis_right/idr_input/cameras.npz"))
        self.images_lis = sorted(glob(os.path.join(
            self.data_dir, "tis_right/rgb/undistorted/ambient@best/*.png")))
        n = len(self.images_lis)
        if n == 0:
            raise FileNotFoundError(f"no images under {self.data_dir}/"
                                    "tis_right/rgb/undistorted/ambient@best")
        images_np = np.stack([I.imread_bgr_norm256(p)
                              for p in self.images_lis]).astype(np.float32)
        world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                      for i in range(n)]
        self.scale_mats_np = [cams[f"scale_mat_{i}"].astype(np.float32)
                              for i in range(n)]
        intr, poses = [], []
        for scale_mat, world_mat in zip(self.scale_mats_np, world_mats):
            K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intr.append(K)
            poses.append(pose)
        self._finalize(images_np, None, np.stack(intr), np.stack(poses))
        self.object_bbox_min, self.object_bbox_max = _box_through(
            cams["scale_mat_0"], np.linalg.inv(self.scale_mats_np[0]))
        self.roi_boxes = [cams[f"roi_box_{i}"] for i in range(n)]
        self.sample_roi_prob = float(conf.get("sample_roi_prob", 0.0))
        if not 0.0 <= self.sample_roi_prob <= 1.0:
            raise ValueError(f"sample_roi_prob {self.sample_roi_prob} is "
                             "outside [0, 1]")


_BLENDER_CONVERT = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _blender_frames(data_dir: str, split: str):
    """(meta, frame path stems, c2w poses) of transforms_{split}.json."""
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    return (meta, [os.path.join(data_dir, fr["file_path"])
                   for fr in meta["frames"]],
            [fr["transform_matrix"] for fr in meta["frames"]])


def _blender_cameras(meta, poses, img_w: int, img_h: int):
    """(K [n, 3, 3], c2w poses [n, 4, 4]) of Blender frames: the focal
    from camera_angle_x, translations / 2 (the scenes' scale 2; the
    homogeneous row is left alone) and the Blender camera's y and z
    flipped."""
    focal = 0.5 * img_w / np.tan(0.5 * float(meta["camera_angle_x"]))
    poses = np.array(poses)
    poses[..., :3, 3] /= 2.0
    K = np.array([[focal, 0, img_w / 2], [0, focal, img_h / 2], [0, 0, 1]],
                 np.float32)
    poses4 = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
    poses4[:, :poses.shape[1]] = poses
    return np.tile(K, (len(poses), 1, 1)), poses4 @ _BLENDER_CONVERT


class SyntheticDataset(BaseDataset):
    """Blender-layout scenes with transforms_{split}.json: EXR rgb and
    mask png on the train split; rgba png with albedo and roughness
    ground truth on the test split (``albedo``, ``rough``)."""

    color_bgr = False

    def __init__(self, conf, device: torch.device, split: str = "train"):
        self.conf, self.device, self.split = conf, device, split
        self.data_dir = conf["data_dir"]
        meta, files, poses = _blender_frames(self.data_dir, split)
        if split == "train":
            self.images_lis = [f + "_rgb.exr" for f in files]
        else:
            self.images_lis = [f + "_rgba.png" for f in files]
        images_np = np.stack([I.load_rgb(p) for p in self.images_lis])
        if split == "train":
            masks_np = np.stack([I.load_mask(f + "_mask.png")
                                 for f in files])
            masks_np = masks_np.astype(np.float32)[..., None].repeat(3, -1)
        else:
            masks_np = np.ones_like(images_np)
            self.rough = np.stack([I.load_rgb(f + "_rough.png")
                                   for f in files])
            self.albedo = np.stack([I.load_rgb(f + "_albedo.png")
                                    for f in files])
        K, poses4 = _blender_cameras(meta, poses, images_np.shape[2],
                                     images_np.shape[1])
        self._finalize(images_np, masks_np, K, poses4)
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01])
        self.object_bbox_max = np.array([1.01, 1.01, 1.01])

    def image_at(self, idx: int, resolution_level: int) -> np.ndarray:
        """View idx re-read, back in sRGB (** (1 / 2.2)) x255, resized
        (bilinear) to 1/resolution_level: RGB in [0, 255]."""
        img = np.power(I.load_rgb(self.images_lis[idx]), 1.0 / 2.2) * 255
        return np.clip(I.imresize(img, self.W // resolution_level,
                                  self.H // resolution_level), 0, 255)


class ShinyDataset(SyntheticDataset):
    """Shiny Blender scenes: png rgb, masks where the disparity TIFF is
    above 1e-6 (the alpha png above 0.5 for 'ball').  ``scale_mat`` takes
    the unit-sphere frame back to the scene's (x 2) for the mesh
    evaluation."""

    def __init__(self, conf, device: torch.device, split: str = "train"):
        self.conf, self.device, self.split = conf, device, split
        self.data_dir = conf["data_dir"]
        meta, files, poses = _blender_frames(self.data_dir, split)
        ball = "ball" in self.data_dir
        self.images_lis = [f + ".png" for f in files]
        images_np = np.stack([I.load_rgb(p) for p in self.images_lis])
        masks = []
        for f in files:
            if ball:
                alpha = I.imread_bgr_norm256(f + "_alpha.png")
                masks.append((alpha > 0.5).astype(np.float32).mean(-1))
            else:
                disp = np.asarray(I.imread_tiff(f + "_disp.tiff"),
                                  np.float32)
                masks.append((disp > 1e-6).astype(np.float32))
        masks_np = np.stack(masks)[..., None].repeat(3, -1).astype(
            np.float32)
        self.scale_mat = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
        K, poses4 = _blender_cameras(meta, poses, images_np.shape[2],
                                     images_np.shape[1])
        self._finalize(images_np, masks_np, K, poses4)
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01])
        self.object_bbox_max = np.array([1.01, 1.01, 1.01])


class GlossySyntheticDataset(BaseDataset):
    """NeRO glossy synthetic scenes: {k}.png, {k}-depth.png (the object
    where every channel of depth / 256 is below 0.9) and {k}-camera.pkl
    (w2c pose [3, 4], K [3, 3])."""

    convention = "w2c"

    def __init__(self, conf, device: torch.device):
        self.conf, self.device = conf, device
        self.data_dir = conf["data_dir"]
        n = len(glob(f"{self.data_dir}/*.pkl"))
        if n == 0:
            raise FileNotFoundError(f"no *-camera.pkl under {self.data_dir}")
        cams = [_read_pickle(f"{self.data_dir}/{k}-camera.pkl")
                for k in range(n)]
        self.images_lis = [f"{self.data_dir}/{k}.png" for k in range(n)]
        images = [I.imread_bgr_norm256(p)[..., :3] for p in self.images_lis]
        masks = [(I.imread_bgr_norm256(f"{self.data_dir}/{k}-depth.png")
                  [..., :3] < 0.9).astype(np.float32) for k in range(n)]
        poses4 = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        poses4[:, :3, :4] = np.stack([np.asarray(c[0], np.float32)
                                      for c in cams])
        self._finalize(np.stack(images).astype(np.float32), np.stack(masks),
                       np.stack([c[1] for c in cams]), poses4)
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01])
        self.object_bbox_max = np.array([1.01, 1.01, 1.01])


# the gravity frame (up, forward) of each NeRO glossy-real capture
GLOSSY_REAL_META = {
    "bear": {"forward": [0.539944, -0.342791, 0.341446],
             "up": [0.0512875, -0.645326, -0.762183]},
    "coral": {"forward": [0.004226, -0.235523, 0.267582],
              "up": [0.0477973, -0.748313, -0.661622]},
    "maneki": {"forward": [-2.336584, -0.406351, 0.482029],
               "up": [-0.0117387, -0.738751, -0.673876]},
    "bunny": {"forward": [0.437076, -1.672467, 1.436961],
              "up": [-0.0693234, -0.644819, -0.761185]},
    "vase": {"forward": [-0.911907, -0.132777, 0.180063],
             "up": [-0.01911, -0.738918, -0.673524]},
}
GLOSSY_REAL_MAX_LEN = 1024   # the long side of images_raw_1024/


class GlossyRealDataset(BaseDataset):
    """NeRO glossy-real captures: <object>/<dir>/cache.pkl (w2c poses,
    K, image names, ids), images/ (the originals, whose size K is for),
    images_raw_1024/ (what is trained on) and object_point_cloud.ply,
    which is normalised into the unit sphere in the object's gravity frame
    (GLOSSY_REAL_META, keyed by the directory above data_dir)."""

    convention = "w2c"

    def __init__(self, conf, device: torch.device):
        self.conf, self.device = conf, device
        self.data_dir = conf["data_dir"]
        self.object_name = self.data_dir.rstrip("/").split("/")[-2]
        self.poses, self.Ks, self.image_names, self.img_ids = _read_pickle(
            f"{self.data_dir}/cache.pkl")
        self._normalize()
        first = I.imread_bgr_u8(
            f"{self.data_dir}/images/{self.image_names[self.img_ids[0]]}")
        h, w = first.shape[:2]
        ratio = float(GLOSSY_REAL_MAX_LEN) / max(h, w)
        rh, rw = int(ratio * h) / h, int(ratio * w) / w
        images, intr, poses = [], [], []
        self.images_lis = []
        for img_id in self.img_ids:
            path = (f"{self.data_dir}/images_raw_1024/"
                    f"{self.image_names[img_id]}")
            self.images_lis.append(path)
            images.append(I.imread_bgr_norm256(path)[..., :3])
            intr.append(np.diag([rw, rh, 1.0]) @ self.Ks[img_id])
            poses.append(self.poses[img_id])
        poses4 = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
        poses4[:, :3, :4] = np.stack(poses).astype(np.float32)
        images_np = np.stack(images).astype(np.float32)
        self._finalize(images_np, np.ones_like(images_np),
                       np.stack(intr).astype(np.float32), poses4)
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01])
        self.object_bbox_max = np.array([1.01, 1.01, 1.01])

    @staticmethod
    def _compute_rotation(vert, forward):
        y = np.cross(vert, forward)
        x = np.cross(y, vert)
        vert = vert / np.linalg.norm(vert)
        x = x / np.linalg.norm(x)
        y = y / np.linalg.norm(y)
        return np.stack([x, y, vert], 0)

    def _normalize(self):
        from ..meshing.ply import read_ply_points
        ref_points = read_ply_points(
            f"{self.data_dir}/object_point_cloud.ply")
        max_pt, min_pt = np.max(ref_points, 0), np.min(ref_points, 0)
        center = (max_pt + min_pt) * 0.5
        offset = -center
        scale = 1.0 / np.max(np.linalg.norm(ref_points - center[None], 2, 1))
        meta = GLOSSY_REAL_META[self.object_name]
        up = np.asarray(meta["up"], np.float32)
        forward = np.asarray(meta["forward"], np.float32)
        up, forward = up / np.linalg.norm(up), forward / np.linalg.norm(forward)
        R_rec = self._compute_rotation(up, forward)
        self.ref_points = scale * (ref_points + offset) @ R_rec.T
        self.scale_rect, self.offset_rect, self.R_rect = scale, offset, R_rec
        for img_id, pose in self.poses.items():
            Rm, t = pose[:, :3], pose[:, 3]
            self.poses[img_id] = np.concatenate(
                [Rm @ R_rec.T, ((t - Rm @ offset) * scale)[:, None]], -1)


DATASET_TYPES = {
    "dtu": DTUDataset,
    "sk3d": Sk3dDataset,
    "indisg_synthetic": SyntheticDataset,
    "indisg_shiny": ShinyDataset,
    "glossy_synthetic": GlossySyntheticDataset,
    "glossy_real": GlossyRealDataset,
    # the stage-2/3 CLIs' names
    "synthetic": SyntheticDataset,
    "shiny": ShinyDataset,
    # the stage-1 type of the Shiny mesh evaluation (validate_mesh_shiny)
    "shiny_refneus": ShinyDataset,
}

# the types whose stages 2 and 3 render in linear space (tonemap 'none')
LINEAR_SPACE_TYPES = frozenset(
    name for name, cls in DATASET_TYPES.items()
    if cls in (SyntheticDataset, ShinyDataset))


def tonemap_for(type_name: str) -> str:
    """The stage-3 tonemap of a dataset type: 'none' (linear) for the
    synthetic and Shiny families, else 'srgb'."""
    return "none" if type_name in LINEAR_SPACE_TYPES else "srgb"


def make_dataset(type_name: str, conf, device: torch.device) -> BaseDataset:
    try:
        cls = DATASET_TYPES[type_name]
    except KeyError:
        raise ValueError(f"unknown dataset type {type_name!r}; one of "
                         f"{sorted(DATASET_TYPES)}") from None
    return cls(conf, device)
