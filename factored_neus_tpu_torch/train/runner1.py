"""Stage-1 runner: geometry + radiance training from a conf, validation
images, meshes and novel views.  Counterpart of
factored_neus_tpu/train/runner1.py for every dataset family, in the modes
``train``, ``validate_mesh``, ``validate_mesh_shiny``, ``validate_image``,
``validate_synthetic_img``, ``mesh_dtu_shpere2world`` (the CLI's spelling)
and ``interpolate_<i>_<j>``: the loop, reports and TensorBoard scalars
under logs/, checkpoints in the JAX package's format (either package
resumes from the other's), validation panels at ``val_freq`` and meshes at
``val_mesh_freq`` (each chosen by the dataset type, as the JAX runner
chooses); ``train.block_steps`` steps a block (CUDA graphs on the card,
common.BlockStepper), checkpoints written in the background.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..data import images as IMG
from ..data import rays as RAYS
from ..data.datasets import make_dataset
from ..meshing import extract as MEXT
from ..meshing.ply import read_ply_mesh, write_ply
from ..models import renderer as R
from ..utils import checkpoints as CK
from ..utils import config as CFG
from ..utils import schedule
from ..utils.device import resolve_device
from ..utils.video import write_video
from .common import (BlockStepper, Reports, TrainConfig, chunked_render,
                     load_optimizer_leaves, optimizer_leaves,
                     val_chunk_size)
from .stage1 import Stage1Trainer

log = logging.getLogger("factored_neus_tpu_torch")
MODES = ("train", "validate_mesh", "validate_mesh_shiny", "validate_image",
         "validate_synthetic_img", "mesh_dtu_shpere2world",
         "interpolate_<i>_<j>")
# the types whose validation panels and meshes are the DTU runner's (the
# others: validate_synthetic_img, and meshes in the unit sphere's frame)
IMAGE_TYPES = ("dtu", "sk3d", "glossy_synthetic", "glossy_real")
WORLD_MESH_TYPES = ("dtu", "sk3d")
SHINY_EVAL_EVERY = 10000   # validate_mesh_shiny's 512^3 mesh and scores

# checkpoint group names of the reference (model attribute -> group)
CKPT_KEYS = {
    "nerf": "nerf",
    "sdf": "sdf_network_fine",
    "variance": "variance_network_fine",
    "color": "color_network_fine",
    "ref_color": "refColor_network",
}
# groups of the later stages that a JAX stage-1 checkpoint carries; the
# port keeps them as they were read and writes them back
PASS_THROUGH = ("lvis_network", "indiLgt_network", "mateIllu_network")
# TensorBoard tag -> the step's metric, at each report
REPORT_SCALARS = {"Loss/loss": "loss", "Loss/color_loss": "color_loss",
                  "Loss/eikonal_loss": "eikonal_loss",
                  "Statistics/s_val": "s_val", "Statistics/cdf": "cdf",
                  "Statistics/weight_max": "weight_max",
                  "Statistics/psnr": "psnr"}


def check_mode(mode: str) -> None:
    ok = mode in MODES[:-1]
    if mode.startswith("interpolate_"):
        parts = mode.split("_")
        ok = len(parts) == 3 and all(p.isdigit() for p in parts[1:])
    if not ok:
        raise NotImplementedError(f"mode {mode!r} is not ported (ported: "
                                  f"{', '.join(MODES)})")


def _normal_map(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-ray normal [B, 3]: the SDF gradients weighted by the render
    weights inside the unit sphere, reduced on the device."""
    g = out["gradients"]
    w = out["weights"][:, :g.shape[1], None]
    return {"normals": (g * w * out["inside_sphere"][..., None]).sum(1)}


class Runner:
    def __init__(self, conf_path: str, mode: str = "train", case: str = "",
                 is_continue: bool = False, type: str = "dtu",
                 surface_weight: float = 0.1, seed: int = 0, device=None):
        check_mode(mode)
        self.device = resolve_device(device)
        self.conf_path = conf_path
        self.conf = CFG.load(conf_path, case)
        self.base_exp_dir = self.conf["general.base_exp_dir_geo"]
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.type = type
        self.dataset = make_dataset(type, self.conf["dataset"], self.device)
        self.tcfg = TrainConfig.from_conf(self.conf,
                                          surface_weight=surface_weight)
        self.cfg = CFG.renderer_config(self.conf)
        self.model = R.Stage1Model(self.cfg, CFG.variance_init_val(self.conf),
                                   seed=seed, device=self.device)
        self.trainer = Stage1Trainer(
            self.model, self.cfg, self.tcfg, self.dataset.train_data(),
            seed=seed + 1)
        self.iter_step = 0
        self.history: List[Dict[str, float]] = []
        self.passed_through: Dict[str, object] = {}
        self.last_checkpoint: Optional[str] = None
        self.last_mesh: Optional[str] = None
        self.last_video: Optional[str] = None
        self.mesh_times: Dict[str, float] = {}
        self.shiny_scores: Optional[Tuple[float, float, float]] = None
        if is_continue:
            latest = CK.latest_checkpoint(self.base_exp_dir,
                                          self.tcfg.end_iter)
            if latest is not None:
                log.info("resuming from %s", latest)
                self.load_checkpoint(latest)
        if mode == "train":
            self.file_backup()

    def train(self) -> None:
        """The training loop, in blocks of ``train.block_steps`` steps
        (common.BlockStepper: CUDA graphs on the card) that end at every
        report, save, validation and mesh iteration; checkpoints are
        written in the background and waited for at the end."""
        tcfg, n = self.tcfg, self.dataset.n_images
        reports = Reports(os.path.join(self.base_exp_dir, "logs"),
                          tcfg.batch_size, self.history, REPORT_SCALARS,
                          "iter {iter} loss={loss:.5f} psnr={psnr:.2f} "
                          "rays/s={rays_per_sec:.0f}")
        stepper = BlockStepper(self.trainer, tcfg, n, (
            tcfg.report_freq, tcfg.save_freq, tcfg.val_freq,
            tcfg.val_mesh_freq))
        rng = np.random.RandomState(self.iter_step)
        stepper.start(rng, rng.permutation(n))
        while self.iter_step < tcfg.end_iter:
            metrics, k = stepper.advance(self.iter_step)
            self.iter_step += k
            reports.steps(k)
            if self.iter_step % tcfg.report_freq == 0:
                reports.report(self.iter_step, metrics)
            if self.iter_step % tcfg.save_freq == 0:
                self.save_checkpoint(background=True)
            if self.iter_step % tcfg.val_freq == 0:
                if self.type in IMAGE_TYPES:
                    self.validate_image()
                else:
                    self.validate_synthetic_img()
            if self.iter_step % tcfg.val_mesh_freq == 0:
                if self.type == "shiny_refneus":
                    self.validate_mesh_shiny()
                else:
                    self.validate_mesh(
                        world_space=self.type in WORLD_MESH_TYPES)
        reports.close()
        CK.wait_for_async_saves()

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, background: bool = False) -> str:
        """The JAX runner's groups and layout: the params groups as JAX
        trees, the optimizer as its optax leaves, iter_step, and the
        later stages' groups where a loaded checkpoint carried them.
        ``background``: snapshot on the device and write in a thread
        (checkpoints.save_checkpoint_async)."""
        tree = bridge.jax_tree(self.model, host=False)
        groups: Dict[str, object] = {ck: tree[pk]
                                     for pk, ck in CKPT_KEYS.items()}
        groups["optimizer"] = optimizer_leaves(self.model, self.trainer.opt,
                                               host=False)
        groups["iter_step"] = np.asarray(self.iter_step)
        groups.update(self.passed_through)
        save = CK.save_checkpoint_async if background else CK.save_checkpoint
        self.last_checkpoint = save(self.base_exp_dir, self.iter_step, groups)
        return self.last_checkpoint

    def load_checkpoint(self, path: str) -> None:
        """Reads a checkpoint of either package."""
        loaded = CK.load_checkpoint(path)
        for pk, ck in CKPT_KEYS.items():
            bridge.load_jax_group(self.model, pk, loaded[ck])
        if "optimizer" in loaded:
            load_optimizer_leaves(self.model, self.trainer.opt,
                                  loaded["optimizer"])
        self.passed_through = {k: loaded[k] for k in PASS_THROUGH
                               if k in loaded}
        self.iter_step = int(loaded["iter_step"])

    def file_backup(self) -> None:
        rec = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec, exist_ok=True)
        shutil.copyfile(self.conf_path, os.path.join(rec, "config.conf"))

    # -- validation ---------------------------------------------------------

    def _render_image(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      keys: Sequence[str] = ("color_fine",)
                      ) -> Dict[str, np.ndarray]:
        """Chunked no-grad render of a ray grid [H, W, 3]: dict of
        [H, W, ...] arrays, "normals" among them.  One SDF pack and one
        radiance pack serve every chunk."""
        bg = (torch.ones(1, 3, device=self.device)
              if self.tcfg.use_white_bkgd else None)
        anneal = schedule.cos_anneal_ratio(self.iter_step,
                                           self.tcfg.anneal_end)
        with torch.no_grad():
            weights = self.model.kernel_weights(
                self.cfg.core_act_bf16, self.cfg.use_pallas_sampling)

            def fn(o, d, _i):
                near, far = RAYS.near_far_from_sphere(o, d)
                return R.render(self.model, self.cfg, o, d, near, far,
                                background_rgb=bg, cos_anneal_ratio=anneal,
                                perturb_overwrite=0.0, weights=weights)

            res, H, W = chunked_render(fn, rays_o, rays_d,
                                       val_chunk_size(self.tcfg), keys,
                                       post=_normal_map)
        return {k: v.reshape(H, W, -1) for k, v in res.items()}

    def validate_image(self, idx: int = -1, resolution_level: int = -1
                       ) -> Dict[str, np.ndarray]:
        """The JAX runner's DTU validation panels of view idx (random when
        < 0): validations_fine (render above the ground truth), normals,
        diffuse, specular and CdPlusCs.  Returns the rendered arrays."""
        if idx < 0:
            idx = np.random.randint(self.dataset.n_images)
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        res = self._render_image(rays_o, rays_d,
                                 keys=("color_fine", "diffuse_color",
                                       "specular_color", "surface_color"))
        it, out = f"{self.iter_step:08d}_0_{idx}", self.base_exp_dir
        img_fine = (res["color_fine"] * 256).clip(0, 255)
        gt = self.dataset.image_at(idx, resolution_level)
        IMG.imwrite(os.path.join(out, "validations_fine", f"v_{it}.png"),
                    np.concatenate([img_fine, gt]))
        rot = np.linalg.inv(self.dataset.pose_all[idx][:3, :3].cpu().numpy())
        normal = (rot[None, None] @ res["normals"][..., None])[..., 0]
        IMG.imwrite(os.path.join(out, "normals", f"n_{it}.png"),
                    normal * 128 + 128)
        IMG.imwrite(os.path.join(out, "diffuse", f"d_{it}.png"),
                    (res["diffuse_color"] * 256).clip(0, 255))
        IMG.imwrite(os.path.join(out, "specular", f"s_{it}.png"),
                    (res["specular_color"] * 256).clip(0, 255))
        IMG.imwrite(os.path.join(out, "CdPlusCs", f"DPlusS_{it}.png"),
                    (res["surface_color"] * 256).clip(0, 255))
        return res

    def validate_synthetic_img(self, idx: int = -1,
                               resolution_level: int = -1
                               ) -> Dict[str, np.ndarray]:
        """The JAX runner's panels of the synthetic and Shiny families, in
        sRGB (** (1 / 2.2)) of the linear render: validations_fine (render
        above the ground truth), diffuse, specular and normals, named
        {iter}_{idx}.  idx < 0 draws a view; a larger one wraps (the CLI's
        default 57 exceeds small scenes).  Returns the rendered arrays."""
        if idx < 0:
            idx = np.random.randint(self.dataset.n_images)
        idx %= self.dataset.n_images
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        res = self._render_image(rays_o, rays_d,
                                 keys=("color_fine", "diffuse_color",
                                       "specular_color"))
        tonemap = lambda x: np.power(np.clip(x, 0, 1), 1.0 / 2.2)
        it, out = f"{self.iter_step}_{idx}", self.base_exp_dir
        IMG.imwrite(os.path.join(out, "validations_fine", f"v_{it}.png"),
                    np.concatenate([
                        tonemap(res["color_fine"]) * 255,
                        self.dataset.image_at(idx, resolution_level)]))
        IMG.imwrite(os.path.join(out, "diffuse", f"d_{it}.png"),
                    tonemap(res["diffuse_color"]) * 255)
        IMG.imwrite(os.path.join(out, "specular", f"s_{it}.png"),
                    (res["specular_color"] * 255).clip(0, 255))
        IMG.imwrite(os.path.join(out, "normals", f"n_{it}.png"),
                    res["normals"] * 128 + 128)
        return res

    # -- meshes -------------------------------------------------------------

    def validate_mesh(self, world_space: bool = False, resolution: int = 512,
                      threshold: float = 0.0) -> str:
        """Writes meshes/{iter:08d}.ply: the surface -sdf == threshold over
        the object's bounding box, in world space through scale_mats_np[0]
        when ``world_space``; the grid is filled by K2 on the card."""
        ds = self.dataset
        times: Dict[str, float] = {}
        verts, tris = MEXT.extract_geometry(
            ds.object_bbox_min, ds.object_bbox_max, resolution, threshold,
            MEXT.sdf_grid_query(self.model.sdf), self.device, times=times)
        if world_space:
            s = ds.scale_mats_np[0]
            verts = verts * s[0, 0] + s[:3, 3][None]
        out = os.path.join(self.base_exp_dir, "meshes",
                           f"{self.iter_step:08d}.ply")
        write_ply(out, verts, tris)
        self.last_mesh, self.mesh_times = out, times
        log.info("mesh written: %s (%d vertices, %d triangles; %d^3 grid "
                 "fill %.2f s, marching tetrahedra %.2f s)", out, len(verts),
                 len(tris), resolution, times["fill_s"], times["march_s"])
        return out

    def validate_mesh_shiny(self, resolution: int = 64,
                            threshold: float = 0.0) -> str:
        """The Shiny mesh evaluation: a resolution^3 mesh to
        meshes/inter_mesh.ply, and at every SHINY_EVAL_EVERY-th iteration
        the 512^3 mesh (meshes/{iter:08d}.ply), taken to the scene's frame
        through the dataset's scale_mat ({iter:08d}_eval.ply) and scored
        against <data_dir>/dense_pcd.ply with <data_dir>/test_info.json's
        cut-offs and ground plane; "{iter}: d2s s2d overall" is appended
        to result.txt.  Returns the last mesh written."""
        ds, meshes = self.dataset, os.path.join(self.base_exp_dir, "meshes")
        query = MEXT.sdf_grid_query(self.model.sdf)
        verts, tris = MEXT.extract_geometry(
            ds.object_bbox_min, ds.object_bbox_max, resolution, threshold,
            query, self.device)
        self.last_mesh = os.path.join(meshes, "inter_mesh.ply")
        write_ply(self.last_mesh, verts, tris)
        if self.iter_step % SHINY_EVAL_EVERY != 0 or self.iter_step == 0:
            return self.last_mesh
        times: Dict[str, float] = {}
        verts, tris = MEXT.extract_geometry(
            ds.object_bbox_min, ds.object_bbox_max, 512, threshold, query,
            self.device, times=times)
        write_ply(os.path.join(meshes, f"{self.iter_step:08d}.ply"), verts,
                  tris)
        s = ds.scale_mat
        verts_eval = verts @ s[:3, :3].T + s[:3, 3][None]
        self.last_mesh = os.path.join(meshes,
                                      f"{self.iter_step:08d}_eval.ply")
        write_ply(self.last_mesh, verts_eval, tris)
        data_dir = self.conf["dataset.data_dir"]
        with open(os.path.join(data_dir, "test_info.json")) as f:
            info = json.load(f)
        from ..evaltools.shiny import evaluation_shinyblender
        t0 = time.perf_counter()
        scores = evaluation_shinyblender(
            verts_eval, tris, os.path.join(data_dir, "dense_pcd.ply"),
            self.base_exp_dir, max_dist_d=info["max_dist_d"],
            max_dist_t=info["max_dist_t"], points_for_plane=info["points"],
            nonvalid_bbox=info.get("nonvalid_bbox"))
        times["eval_s"] = time.perf_counter() - t0
        self.mesh_times, self.shiny_scores = times, scores
        with open(os.path.join(self.base_exp_dir, "result.txt"), "a") as f:
            f.write(f"{self.iter_step}: {scores[0]} {scores[1]} "
                    f"{scores[2]}\n")
        log.info("Shiny evaluation at iter %d: d2s %.6f s2d %.6f overall "
                 "%.6f (512^3 fill %.2f s, marching %.2f s, scoring "
                 "%.2f s)", self.iter_step, *scores, times["fill_s"],
                 times["march_s"], times["eval_s"])
        return self.last_mesh

    def mesh_dtu_sphere2world(self, mesh_name: str) -> str:
        """meshes/{mesh_name}.ply taken from the unit sphere to world space
        through scale_mats_np[0], written to meshes/00300000.ply."""
        verts, tris = read_ply_mesh(os.path.join(
            self.base_exp_dir, "meshes", f"{mesh_name}.ply"))
        s = self.dataset.scale_mats_np[0]
        verts = verts * s[0, 0] + s[:3, 3][None]
        out = os.path.join(self.base_exp_dir, "meshes", "00300000.ply")
        write_ply(out, verts, tris)
        self.last_mesh = out
        return out

    # -- novel views --------------------------------------------------------

    def render_novel_image(self, idx_0: int, idx_1: int, ratio: float,
                           resolution_level: int) -> np.ndarray:
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio,
                                                       resolution_level)
        res = self._render_image(rays_o, rays_d, keys=("color_fine",))
        return (res["color_fine"] * 256).clip(0, 255).astype(np.uint8)

    def interpolate_view(self, img_idx_0: int, img_idx_1: int,
                         n_frames: int = 60) -> str:
        """Novel views between two cameras, there and back, as a video at
        render/{iter:08d}_{i}_{j}.mp4 (or that name's PNG frame directory
        where no video encoder is installed)."""
        images = []
        for i in range(n_frames):
            ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
            images.append(self.render_novel_image(img_idx_0, img_idx_1,
                                                  ratio, resolution_level=4))
        images += images[::-1]
        self.last_video = write_video(
            os.path.join(self.base_exp_dir, "render",
                         f"{self.iter_step:08d}_{img_idx_0}_{img_idx_1}.mp4"),
            images, fps=30, bgr=self.dataset.color_bgr)
        return self.last_video
