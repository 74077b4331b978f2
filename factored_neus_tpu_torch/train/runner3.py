"""Stage-3 runner: materials and direct illumination on the frozen stage-1
and stage-2 networks.  Counterpart of factored_neus_tpu/train/runner3.py
for every dataset family, in the modes ``train``, ``validate_image`` and
``validate_video``, and the synthetic and NeRFactor modes
(SYNTHETIC_MODES): it chains from the newest stage-2 checkpoint under
general.base_exp_dir_lvis, trains EnvmapMaterial with TensorBoard scalars
under logs/, writes checkpoints in the JAX package's format (every params
group, mateIllu_network among them, Adam as the stage-3 optax leaves;
either package resumes from the other's), the decomposition panels and
the learned envmap as env_light/iter_step_<n>.exr.  The synthetic and
Shiny types render in linear space (tonemap 'none'), the others in sRGB,
as the JAX runner chooses; the synthetic modes read the scene's test
split (datasets.SyntheticDataset, split "test") where they need ground
truth, and relight with SG envmaps read from <path>/sg_128.npy.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..data import images as IMG
from ..data import rays as RAYS
from ..data.datasets import SyntheticDataset, make_dataset, tonemap_for
from ..data.exr import write_exr
from ..models import renderer as R
from ..models.materials import get_light
from ..ops import sg as SG
from ..utils import checkpoints as CK
from ..utils import config as CFG
from ..utils.device import resolve_device
from ..utils.video import write_video
from .common import (BlockStepper, Reports, TrainConfig, chunked_render,
                     load_optimizer_leaves, optimizer_leaves,
                     val_chunk_size)
from .runner2 import STAGE2_KEYS
from .stage3 import Stage3Trainer

log = logging.getLogger("factored_neus_tpu_torch")
SYNTHETIC_MODES = ("validate_synthetic_img", "cal_synthetic_psnr",
                   "cal_nerfactor_psnr", "relgt_synthetic_img",
                   "validate_synthetic_video", "relgt_synthetic_video")
MODES = ("train", "validate_image", "validate_video") + SYNTHETIC_MODES
ENVMAPS = ("./envmaps/envmap6", "./envmaps/envmap12")   # relighting's
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
        self.cfg = CFG.renderer_config(self.conf, "model.lvis_renderer",
                                       tonemap=tonemap_for(type))
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
        self.trainer = Stage3Trainer(
            self.model, self.cfg, self.tcfg, self.dataset.train_data(),
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
        """The training loop, in blocks of ``train.block_steps`` steps
        (common.BlockStepper: CUDA graphs on the card) that end at every
        report, save and validation iteration; checkpoints are written in
        the background and waited for at the end."""
        tcfg, n = self.tcfg, self.dataset.n_images
        reports = Reports(os.path.join(self.base_exp_dir, "logs"),
                          tcfg.batch_size, self.history,
                          {"Loss/loss": "rgb_loss",
                           "Statistics/psnr": "psnr"},
                          "iter {iter} rgb={rgb_loss:.5f} psnr={psnr:.2f} "
                          "rays/s={rays_per_sec:.0f}")
        stepper = BlockStepper(self.trainer, tcfg, n, (
            tcfg.report_freq, tcfg.save_freq, tcfg.val_freq))
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
                if self.type in ("dtu", "sk3d"):
                    self.validate_image()
                else:
                    self.validate_synthetic_img()
        reports.close()
        CK.wait_for_async_saves()

    # -- checkpoints --------------------------------------------------------

    def _load_groups(self, loaded, keys) -> None:
        for pk, ck in keys.items():
            bridge.load_jax_group(self.model, pk, loaded[ck])

    def load_checkpoint_lvis(self, path: str) -> None:
        """The frozen stage-1 and stage-2 groups of a stage-2 checkpoint
        (of either package)."""
        self._load_groups(CK.load_checkpoint(path), STAGE2_KEYS)

    def save_checkpoint(self, background: bool = False) -> str:
        """The JAX stage-3 runner's groups and layout: every params group
        as a JAX tree, the optimizer as its stage-3 optax leaves and
        iter_step.  ``background``: snapshot on the device and write in a
        thread (checkpoints.save_checkpoint_async)."""
        tree = bridge.jax_tree(self.model, host=False)
        groups: Dict[str, object] = {ck: tree[pk]
                                     for pk, ck in STAGE3_KEYS.items()}
        groups["optimizer"] = optimizer_leaves(self.model, self.trainer.opt,
                                               stage=3, host=False)
        groups["iter_step"] = np.asarray(self.iter_step)
        save = CK.save_checkpoint_async if background else CK.save_checkpoint
        self.last_checkpoint = save(self.base_exp_dir, self.iter_step, groups)
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

    def render_decomposition(self, dataset, idx: int, resolution_level: int
                             ) -> Dict[str, np.ndarray]:
        """Chunked no-grad mate_illu_render of view idx of ``dataset``
        (the training scene or its test split): VAL_KEYS as [H, W, C]
        arrays.  The visibility draws come from a generator seeded with
        iter_step; the run's SDF pack serves every chunk."""
        rays_o, rays_d = dataset.gen_rays_at(idx, resolution_level)
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
        r = self.render_decomposition(self.dataset, idx, resolution_level)
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
            r = self.render_decomposition(ds, i, resolution_level)
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

    # -- the synthetic and NeRFactor modes ---------------------------------

    def test_split(self) -> SyntheticDataset:
        """The scene's test split (transforms_test.json: rgba, albedo and
        roughness ground truth)."""
        return SyntheticDataset(self.conf["dataset"], self.device,
                                split="test")

    def validate_synthetic_img(self, idx: int = -1,
                               resolution_level: int = -1
                               ) -> Dict[str, np.ndarray]:
        """The JAX stage-3 runner's panels of the synthetic and Shiny
        families, in sRGB (** (1 / 2.2), roughness and lvis_mean linear):
        rgb/ (indirect, direct, render, ground truth), diffuse/,
        specular/, roughness/, lvis_mean/ and indi_light/; then the
        envmap's EXR.  idx < 0 draws a view; a larger one wraps."""
        if idx < 0:
            idx = np.random.randint(self.dataset.n_images)
        idx %= self.dataset.n_images
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        r = self.render_decomposition(self.dataset, idx, resolution_level)
        s, d = self.iter_step, self.base_exp_dir
        panels = {
            ("rgb", f"rgb_{s}_{idx}.png"): np.concatenate(
                [_srgb255(r["indir_rgb"]), _srgb255(r["env_rgb"]),
                 _srgb255(r["rgb"]),
                 self.dataset.image_at(idx, resolution_level)]),
            ("diffuse", f"d_{s}_{idx}.png"): np.concatenate(
                [_srgb255(r["diffuse_rgb"]), _srgb255(r["diffuse_albedo"])]),
            ("specular", f"s_{s}_{idx}.png"): np.concatenate(
                [_srgb255(r["specular_rgb"]),
                 _srgb255(r["specular_albedo"])]),
            ("roughness", f"r_{s}_{idx}.png"): (r["roughness"]
                                                * 255).clip(0, 255),
            ("lvis_mean", f"lvis_{s}_{idx}.png"): (r["lvis_mean"]
                                                   * 255).clip(0, 255),
            ("indi_light", f"indiLgt_{s}_{idx}.png"): _srgb255(
                r["indir_rgb"])}
        for (sub, name), img in panels.items():
            IMG.imwrite(os.path.join(d, sub, name), img)
        self.export_envmap()
        return r

    def cal_synthetic_psnr(self, idx: int = -1, resolution_level: int = 1
                           ) -> Tuple[float, float, float]:
        """PSNR of the albedo, the render and the roughness of test view
        idx against the test split's ground truth, over the pixels whose
        predicted albedo is above 1e-6 (each sum / (mask sum x 3), as the
        JAX runner computes them); writes the maps and psnr/albedo.txt.
        An idx past the split wraps.  Returns (albedo, rgb, rough)."""
        test = self.test_split()
        if idx < 0:
            idx = np.random.randint(test.n_images)
        if idx >= test.n_images:
            log.warning("test idx %d out of range for %d test images; "
                        "using %d", idx, test.n_images, idx % test.n_images)
            idx %= test.n_images
        r = self.render_decomposition(test, idx, resolution_level)
        gt_albedo = test.albedo[idx]
        gt_rgb = test.images[idx].cpu().numpy()
        gt_rough = test.rough[idx][..., :1]
        albedo = r["diffuse_albedo"]
        mask = (albedo > 1e-6).astype(np.float64)
        msum = mask.sum()

        def psnr(a, b):
            return 20.0 * np.log10(1.0 / np.sqrt(
                ((a - b) ** 2 * mask).sum() / (msum * 3.0)))

        psnr_albedo = float(psnr(gt_albedo, albedo))
        psnr_rgb = float(psnr(gt_rgb, r["rgb"]))
        psnr_rough = float(20.0 * np.log10(1.0 / np.sqrt(
            ((gt_rough - r["roughness"]) ** 2 * mask[..., :1]).sum()
            / (mask[..., :1].sum() * 3.0))))
        out = os.path.join(self.base_exp_dir, "psnr")
        for name, img in ((f"preRGB_{idx}.png", _srgb255(r["rgb"])),
                          (f"preAlbedo_{idx}.png", _srgb255(albedo)),
                          (f"gtAlbedo_{idx}.png", _srgb255(gt_albedo)),
                          (f"normal_{idx}.png",
                           (r["n_out"] * 128 + 128).clip(0, 255)),
                          (f"mask_{idx}.png", mask * 255),
                          (f"r_{self.iter_step}_{idx}.png",
                           (r["roughness"] * 255).clip(0, 255))):
            IMG.imwrite(os.path.join(out, name), img)
        with open(os.path.join(out, "albedo.txt"), "w") as f:
            f.write(f"psnr_albedo:{psnr_albedo}\npsnr_rgb:{psnr_rgb}\n"
                    f"psnr_rough:{psnr_rough}")
        return psnr_albedo, psnr_rgb, psnr_rough

    def cal_nerfactor_psnr(self, idx: int = -1, resolution_level: int = 1
                           ) -> Dict[str, np.ndarray]:
        """The NeRFactor-style prediction dumps of training view idx under
        psnr/: the render and albedo (sRGB), the normal, the mask and the
        roughness.  Returns the rendered arrays."""
        ds = self.dataset
        if idx < 0:
            idx = np.random.randint(ds.n_images)
        r = self.render_decomposition(ds, idx, resolution_level)
        mask = np.broadcast_to(ds.masks[idx].cpu().numpy(),
                               (ds.H, ds.W, 3))   # [1, 1, 3] under mask_ones
        out = os.path.join(self.base_exp_dir, "psnr")
        for name, img in ((f"preRGB_{idx}.png", _srgb255(r["rgb"])),
                          (f"normal_{idx}.png",
                           (r["n_out"] * 128 + 128).clip(0, 255)),
                          (f"preAlbedo_{idx}.png",
                           _srgb255(r["diffuse_albedo"])),
                          (f"mask_{idx}.png", mask * 255),
                          (f"r_{idx}.png",
                           (r["roughness"] * 255).clip(0, 255))):
            IMG.imwrite(os.path.join(out, name), img)
        return r

    def load_light(self, path: str) -> None:
        """The SG envmap <path>/sg_128.npy [num_lgt_sgs, 7] in place of the
        learned lgtSGs."""
        sgs = np.load(os.path.join(path, "sg_128.npy"))
        lgt = self.model.material.lgtSGs
        with torch.no_grad():
            lgt.copy_(torch.as_tensor(sgs, dtype=torch.float32))
            energy = SG.compute_energy(lgt).sum(0)
        log.info("loaded envmap energy: %s", energy.cpu().numpy())

    def _relit(self, envmap_paths: Sequence[str], render) -> List:
        """render(name) under each envmap in turn; the learned lgtSGs are
        restored afterwards, whatever happens."""
        lgt = self.model.material.lgtSGs
        saved = lgt.detach().clone()
        try:
            out = []
            for path in envmap_paths:
                self.load_light(path)
                out.append(render(os.path.basename(path.rstrip("/"))))
            return out
        finally:
            with torch.no_grad():
                lgt.copy_(saved)

    def relgt_synthetic_img(self, idx: int = 0, resolution_level: int = 1,
                            envmap_paths: Sequence[str] = ENVMAPS
                            ) -> List[np.ndarray]:
        """Test view idx rendered under each SG envmap of envmap_paths, in
        sRGB, to video/reLgtRGB_<envmap>.png.  Returns the linear renders."""
        test = self.test_split()
        out = os.path.join(self.base_exp_dir, "video")

        def render(name):
            rgb = self.render_decomposition(test, idx,
                                            resolution_level)["rgb"]
            IMG.imwrite(os.path.join(out, f"reLgtRGB_{name}.png"),
                        np.power(np.clip(rgb, 0, 1), 1 / 2.2) * 255)
            return rgb

        return self._relit(envmap_paths, render)

    def _video(self, name: str, frames, fps: int = 20) -> str:
        path = write_video(os.path.join(self.base_exp_dir, "video", name),
                           [np.clip(f * 255, 0, 255).astype(np.uint8)
                            for f in frames], fps=fps)
        self.videos.append(path)
        return path

    def validate_synthetic_video(self, resolution_level: int = 1
                                 ) -> List[str]:
        """Every test view's render, albedo, indirect light (sRGB), mean
        visibility and ground truth as videos under video/ (pre_img,
        albedo, lvis, indiLgt, gt_img; 20 fps).  Returns the paths."""
        test = self.test_split()
        tm = lambda x: np.power(np.clip(x, 0, 1), 1 / 2.2)
        lists: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("rgb", "diffuse_albedo", "indir_rgb",
                            "lvis_mean", "gt")}
        for i in range(test.n_images):
            r = self.render_decomposition(test, i, resolution_level)
            for k in ("rgb", "diffuse_albedo", "indir_rgb"):
                lists[k].append(tm(r[k]))
            lists["lvis_mean"].append(np.clip(r["lvis_mean"], 0, 1))
            lists["gt"].append(tm(test.images[i].cpu().numpy()))
        self.videos = []
        for name, k in (("pre_img.mp4", "rgb"),
                        ("albedo.mp4", "diffuse_albedo"),
                        ("lvis.mp4", "lvis_mean"),
                        ("indiLgt.mp4", "indir_rgb"), ("gt_img.mp4", "gt")):
            self._video(name, lists[k])
        return self.videos

    def relgt_synthetic_video(self, envmap_paths: Sequence[str] = ENVMAPS,
                              resolution_level: int = 1) -> List[str]:
        """Every test view rendered under each SG envmap, in sRGB, as
        video/relgt_<envmap>_img.mp4 (20 fps).  Returns the paths."""
        test = self.test_split()
        self.videos = []

        def render(name):
            frames = [np.power(np.clip(self.render_decomposition(
                test, i, resolution_level)["rgb"], 0, 1), 1 / 2.2)
                for i in range(test.n_images)]
            return self._video(f"relgt_{name}_img.mp4", frames)

        return self._relit(envmap_paths, render)


def _srgb255(x: np.ndarray) -> np.ndarray:
    """Linear [0, 1] -> sRGB (** (1 / 2.2)) in [0, 255]."""
    return (np.power(np.clip(x, 0, 1), 1 / 2.2) * 255).clip(0, 255)
