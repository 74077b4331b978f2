"""Stage-3 runner: materials and direct illumination on the frozen stage-1
and stage-2 networks.  Counterpart of factored_neus_tpu/train/runner3.py
for DTU scenes, in the modes ``train``, ``validate_image`` and
``validate_video``: it chains from the newest stage-2 checkpoint under
general.base_exp_dir_lvis, trains EnvmapMaterial with TensorBoard scalars
under logs/, writes checkpoints in the JAX package's format (every params
group, mateIllu_network among them, Adam as the stage-3 optax leaves;
either package resumes from the other's), the decomposition panels and
the learned envmap as env_light/iter_step_<n>.exr.

The synthetic and NeRFactor modes (validate_synthetic_img,
cal_synthetic_psnr, cal_nerfactor_psnr, relgt_synthetic_img,
validate_synthetic_video, relgt_synthetic_video) need the synthetic
loader, which the port does not have yet: the runner raises for them.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import bridge
from ..data import images as IMG
from ..data import rays as RAYS
from ..data.datasets import make_dataset
from ..data.exr import write_exr
from ..models import renderer as R
from ..models.materials import get_light
from ..utils import checkpoints as CK
from ..utils import config as CFG
from ..utils.device import resolve_device
from ..utils.logging import MetricsWriter, ThroughputMeter
from ..utils.video import write_video
from .common import (TrainConfig, chunked_render, load_optimizer_leaves,
                     optimizer_leaves, val_chunk_size)
from .runner2 import STAGE2_KEYS
from .stage3 import Stage3Trainer

log = logging.getLogger("factored_neus_tpu_torch")
MODES = ("train", "validate_image", "validate_video")
SYNTHETIC_MODES = ("validate_synthetic_img", "cal_synthetic_psnr",
                   "cal_nerfactor_psnr", "relgt_synthetic_img",
                   "validate_synthetic_video", "relgt_synthetic_video")
STAGE3_KEYS = dict(STAGE2_KEYS, material="mateIllu_network")
VAL_KEYS = ("rgb", "env_rgb", "indir_rgb", "diffuse_albedo",
            "specular_albedo", "diffuse_rgb", "specular_rgb", "roughness",
            "lvis_mean", "n_out")
VIDEO_KEYS = ("rgb", "specular_rgb", "diffuse_rgb", "diffuse_albedo",
              "indir_rgb", "lvis_mean")


class Runner:
    def __init__(self, conf_path: str, mode: str = "train", case: str = "",
                 is_continue: bool = False, type: str = "dtu", seed: int = 0,
                 device=None):
        if mode in SYNTHETIC_MODES:
            raise NotImplementedError(
                f"mode {mode!r} serves the synthetic and NeRFactor scenes, "
                "which the port does not load yet")
        if mode not in MODES:
            raise NotImplementedError(f"mode {mode!r} is not ported "
                                      f"(ported: {', '.join(MODES)})")
        self.device = resolve_device(device)
        self.conf_path = conf_path
        self.conf = CFG.load(conf_path, case)
        self.base_exp_dir = self.conf["general.base_exp_dir_mateIllu"]
        self.base_exp_dir_lvis = self.conf["general.base_exp_dir_lvis"]
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.type = type
        self.dataset = make_dataset(type, self.conf["dataset"], self.device)
        self.tcfg = TrainConfig.from_conf(self.conf, stage=3)
        self.cfg = CFG.renderer_config(self.conf, "model.lvis_renderer")
        self.model = R.Stage3Model(self.cfg,
                                   CFG.variance_init_val(self.conf),
                                   seed=seed, device=self.device)
        lvis_ckpt = CK.latest_checkpoint(
            self.base_exp_dir_lvis,
            int(self.conf.get("train.lvis.end_iter", 10000)))
        if lvis_ckpt is None:
            raise FileNotFoundError(
                f"no stage-2 checkpoint under {self.base_exp_dir_lvis} "
                "(train stage 2 first)")
        self.load_checkpoint_lvis(lvis_ckpt)
        ds = self.dataset
        self.trainer = Stage3Trainer(
            self.model, self.cfg, self.tcfg,
            {"images": ds.images, "masks": ds.masks,
             "intr_inv": ds.intrinsics_all_inv, "poses": ds.pose_all},
            seed=seed + 3)
        self.iter_step = 0
        self.history: List[Dict[str, float]] = []
        self.last_checkpoint: Optional[str] = None
        self.last_envmap: Optional[str] = None
        self.videos: List[str] = []
        if is_continue:
            latest = CK.latest_checkpoint(self.base_exp_dir,
                                          self.tcfg.end_iter)
            if latest is not None:
                log.info("resuming from %s", latest)
                self.load_checkpoint(latest)
        if mode == "train":
            self.file_backup()

    def train(self) -> None:
        tcfg, n = self.tcfg, self.dataset.n_images
        writer = MetricsWriter(os.path.join(self.base_exp_dir, "logs"))
        rng = np.random.RandomState(self.iter_step)
        perm = rng.permutation(n)
        t_last, steps_since = time.perf_counter(), 0
        meter = ThroughputMeter()
        meter.start()
        while self.iter_step < tcfg.end_iter:
            metrics = self.trainer.step(int(perm[self.iter_step % n]),
                                        self.iter_step)
            self.iter_step += 1
            steps_since += 1
            meter.step(tcfg.batch_size)
            if self.iter_step % tcfg.report_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}  # syncs
                now = time.perf_counter()
                m["rays_per_sec"] = (tcfg.batch_size * steps_since
                                     / (now - t_last))
                m["iter"] = self.iter_step
                t_last, steps_since = now, 0
                self.history.append(m)
                writer.scalars({"Loss/loss": m["rgb_loss"],
                                "Statistics/psnr": m["psnr"],
                                "Perf/rays_per_sec": meter.rays_per_sec},
                               self.iter_step)
                log.info("iter %d rgb=%.5f psnr=%.2f rays/s=%.0f",
                         self.iter_step, m["rgb_loss"], m["psnr"],
                         m["rays_per_sec"])
            if self.iter_step % tcfg.save_freq == 0:
                self.save_checkpoint()
            if self.iter_step % tcfg.val_freq == 0:
                self.validate_image()
            if self.iter_step % n == 0:
                perm = rng.permutation(n)
        writer.close()

    # -- checkpoints --------------------------------------------------------

    def _load_groups(self, loaded, keys) -> None:
        for pk, ck in keys.items():
            bridge.load_jax_group(self.model, pk, loaded[ck])

    def load_checkpoint_lvis(self, path: str) -> None:
        """The frozen stage-1 and stage-2 groups of a stage-2 checkpoint
        (of either package)."""
        self._load_groups(CK.load_checkpoint(path), STAGE2_KEYS)

    def save_checkpoint(self) -> str:
        """The JAX stage-3 runner's groups and layout: every params group
        as a JAX tree, the optimizer as its stage-3 optax leaves and
        iter_step."""
        tree = bridge.jax_tree(self.model)
        groups: Dict[str, object] = {ck: tree[pk]
                                     for pk, ck in STAGE3_KEYS.items()}
        groups["optimizer"] = optimizer_leaves(self.model, self.trainer.opt,
                                               stage=3)
        groups["iter_step"] = np.asarray(self.iter_step)
        self.last_checkpoint = CK.save_checkpoint(self.base_exp_dir,
                                                  self.iter_step, groups)
        return self.last_checkpoint

    def load_checkpoint(self, path: str) -> None:
        """Reads a stage-3 checkpoint of either package."""
        loaded = CK.load_checkpoint(path)
        self._load_groups(loaded, STAGE3_KEYS)
        if "optimizer" in loaded:
            load_optimizer_leaves(self.model, self.trainer.opt,
                                  loaded["optimizer"], stage=3)
        self.iter_step = int(loaded["iter_step"])

    def file_backup(self) -> None:
        rec = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec, exist_ok=True)
        shutil.copyfile(self.conf_path, os.path.join(rec, "config.conf"))

    # -- rendering ----------------------------------------------------------

    def render_decomposition(self, idx: int, resolution_level: int
                             ) -> Dict[str, np.ndarray]:
        """Chunked no-grad mate_illu_render of view idx: VAL_KEYS as
        [H, W, C] arrays.  The visibility draws come from a generator
        seeded with iter_step; the run's SDF pack serves every chunk."""
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        gen = torch.Generator(device=self.device).manual_seed(self.iter_step)
        with torch.no_grad():
            def fn(o, d, _i):
                near, far = RAYS.near_far_from_sphere(o, d)
                return R.mate_illu_render(self.model, self.cfg, o, d, near,
                                          far, generator=gen)

            res, H, W = chunked_render(fn, rays_o, rays_d,
                                       val_chunk_size(self.tcfg), VAL_KEYS)
        return {k: v.reshape(H, W, -1) for k, v in res.items()}

    def validate_image(self, idx: int = -1, resolution_level: int = -1
                       ) -> Dict[str, np.ndarray]:
        """The JAX stage-3 runner's DTU panels of view idx (random when
        < 0), linear 0-255: rgb/ (indirect, direct, render, ground truth;
        and the render alone), diffuse/, specular/, roughness/,
        lvis_mean/, indiLgt/ and normal/; then the envmap's EXR.  Returns
        the rendered arrays."""
        if idx < 0:
            idx = np.random.randint(self.dataset.n_images)
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        r = self.render_decomposition(idx, resolution_level)
        s, d = self.iter_step, self.base_exp_dir
        to255 = lambda x: (x * 255).clip(0, 255)
        panels = {
            ("rgb", f"rgb_{s}_{idx}.png"): np.concatenate(
                [to255(r["indir_rgb"]), to255(r["env_rgb"]), to255(r["rgb"]),
                 self.dataset.image_at(idx, resolution_level)]),
            ("diffuse", f"d_{s}_{idx}.png"): np.concatenate(
                [to255(r["diffuse_rgb"]), to255(r["diffuse_albedo"])]),
            ("specular", f"s_{s}_{idx}.png"): np.concatenate(
                [to255(r["specular_rgb"]), to255(r["specular_albedo"])]),
            ("roughness", f"r_{s}_{idx}.png"): to255(r["roughness"]),
            ("lvis_mean", f"lvis_{s}_{idx}.png"): to255(r["lvis_mean"]),
            ("indiLgt", f"indiLgt_{s}_{idx}.png"): to255(r["indir_rgb"]),
            ("rgb", f"rgbPre_{s}_{idx}.png"): to255(r["rgb"]),
            ("normal", f"n_{s}_{idx}.png"): (r["n_out"] * 128
                                             + 128).clip(0, 255)}
        for (sub, name), img in panels.items():
            IMG.imwrite(os.path.join(d, sub, name), img)
        self.export_envmap()
        return r

    def export_envmap(self) -> str:
        """The learned envmap as env_light/iter_step_<n>.exr (256 x 512,
        float32)."""
        with torch.no_grad():
            env = get_light(self.model.material).cpu().numpy()
        out = os.path.join(self.base_exp_dir, "env_light",
                           f"iter_step_{self.iter_step}.exr")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_exr(out, env.astype(np.float32))
        self.last_envmap = out
        return out

    def validate_video(self, resolution_level: int = 1) -> List[str]:
        """Every view's decomposition, there and back, as videos under
        video/ (cs, cd, albedo, img_pre, img_gt, indiLgt, lvisMean; 40
        fps; PNG frame directories where no video encoder is installed).
        Returns the paths written."""
        ds = self.dataset
        lists: Dict[str, List[np.ndarray]] = {k: [] for k in VIDEO_KEYS}
        gt = []
        for i in range(ds.n_images):
            r = self.render_decomposition(i, resolution_level)
            for k in VIDEO_KEYS:
                lists[k].append(r[k])
            gt.append(ds.images[i].cpu().numpy().clip(0, 1))
        lists = {k: v + v[-2:0:-1] for k, v in lists.items()}
        gt = gt + gt[-2:0:-1]
        v = os.path.join(self.base_exp_dir, "video")
        self.videos = [
            write_video(os.path.join(v, name),
                        [np.clip(f * 255, 0, 255).astype(np.uint8)
                         for f in frames], fps=40, bgr=ds.color_bgr)
            for name, frames in (("cs.mp4", lists["specular_rgb"]),
                                 ("cd.mp4", lists["diffuse_rgb"]),
                                 ("albedo.mp4", lists["diffuse_albedo"]),
                                 ("img_pre.mp4", lists["rgb"]),
                                 ("img_gt.mp4", gt),
                                 ("indiLgt.mp4", lists["indir_rgb"]),
                                 ("lvisMean.mp4", lists["lvis_mean"]))]
        return self.videos
