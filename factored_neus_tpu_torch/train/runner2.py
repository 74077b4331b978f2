"""Stage-2 runner: light visibility and indirect light distilled from the
frozen stage-1 networks.  Counterpart of factored_neus_tpu/train/runner2.py
for every dataset family, in the modes ``train`` and ``validate_image``
(``validate_synthetic_img`` is the same panels): it chains
from the newest stage-1 checkpoint under general.base_exp_dir_geo, trains
Lvis and IndirectLight with TensorBoard scalars under logs/, writes
checkpoints in the JAX package's format (the stage-1 groups, lvis_network,
indiLgt_network, Adam as the stage-2 optax leaves; either package resumes
from the other's) and the lvis/ and trace_radiance/ validation panels.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import bridge
from ..data import images as IMG
from ..data import rays as RAYS
from ..data.datasets import make_dataset
from ..models import renderer as R
from ..utils import checkpoints as CK
from ..utils import config as CFG
from ..utils.device import resolve_device
from .common import (BlockStepper, Reports, TrainConfig, chunked_render,
                     load_optimizer_leaves, optimizer_leaves,
                     val_chunk_size)
from .runner1 import CKPT_KEYS
from .stage2 import Stage2Trainer

log = logging.getLogger("factored_neus_tpu_torch")
MODES = ("train", "validate_image", "validate_synthetic_img")
STAGE2_KEYS = dict(CKPT_KEYS, lvis="lvis_network", indirect="indiLgt_network")
# the stage-3 group a loaded checkpoint may carry: written back as read
PASS_THROUGH = ("mateIllu_network",)
PANEL_KEYS = ("gt_lvis", "pre_lvis", "gt_trace_radiance",
              "pre_trace_radiance")


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
        self.base_exp_dir = self.conf["general.base_exp_dir_lvis"]
        self.base_exp_dir_geometry = self.conf["general.base_exp_dir_geo"]
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.type = type
        self.dataset = make_dataset(type, self.conf["dataset"], self.device)
        self.tcfg = TrainConfig.from_conf(self.conf, stage=2)
        self.cfg = CFG.renderer_config(self.conf, "model.lvis_renderer")
        self.model = R.Stage2Model(self.cfg,
                                   CFG.variance_init_val(self.conf),
                                   seed=seed, device=self.device)
        self.passed_through: Dict[str, object] = {}
        geo = CK.latest_checkpoint(self.base_exp_dir_geometry,
                                   int(self.conf.get("train.end_iter",
                                                     300000)))
        if geo is None:
            raise FileNotFoundError(
                f"no stage-1 checkpoint under {self.base_exp_dir_geometry} "
                "(train stage 1 first)")
        self.load_checkpoint_geometry(geo)
        self.trainer = Stage2Trainer(
            self.model, self.cfg, self.tcfg, self.dataset.train_data(),
            seed=seed + 2)
        self.iter_step = 0
        self.history: List[Dict[str, float]] = []
        self.last_checkpoint: Optional[str] = None
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
                          {"Loss/loss": "lvis_loss",
                           "Loss/trace_radiance": "trace_radiance_loss"},
                          "iter {iter} lvis={lvis_loss:.5f} "
                          "trace={trace_radiance_loss:.5f} "
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
                self.validate_image()
        reports.close()
        CK.wait_for_async_saves()

    # -- checkpoints --------------------------------------------------------

    def _load_groups(self, loaded, keys) -> None:
        for pk, ck in keys.items():
            bridge.load_jax_group(self.model, pk, loaded[ck])
        self.passed_through.update({k: loaded[k] for k in PASS_THROUGH
                                    if k in loaded})

    def load_checkpoint_geometry(self, path: str) -> None:
        """The frozen stage-1 groups of a stage-1 checkpoint (of either
        package)."""
        self._load_groups(CK.load_checkpoint(path), CKPT_KEYS)

    def save_checkpoint(self, background: bool = False) -> str:
        """The JAX stage-2 runner's groups and layout: the params groups
        as JAX trees, the optimizer as its stage-2 optax leaves,
        iter_step, and the stage-3 group where a loaded checkpoint carried
        it.  ``background``: snapshot on the device and write in a thread
        (checkpoints.save_checkpoint_async)."""
        tree = bridge.jax_tree(self.model, host=False)
        groups: Dict[str, object] = {ck: tree[pk]
                                     for pk, ck in STAGE2_KEYS.items()}
        groups["optimizer"] = optimizer_leaves(self.model, self.trainer.opt,
                                               stage=2, host=False)
        groups["iter_step"] = np.asarray(self.iter_step)
        groups.update(self.passed_through)
        save = CK.save_checkpoint_async if background else CK.save_checkpoint
        self.last_checkpoint = save(self.base_exp_dir, self.iter_step, groups)
        return self.last_checkpoint

    def load_checkpoint(self, path: str) -> None:
        """Reads a stage-2 checkpoint of either package."""
        loaded = CK.load_checkpoint(path)
        self._load_groups(loaded, STAGE2_KEYS)
        if "optimizer" in loaded:
            load_optimizer_leaves(self.model, self.trainer.opt,
                                  loaded["optimizer"], stage=2)
        self.iter_step = int(loaded["iter_step"])

    def file_backup(self) -> None:
        rec = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec, exist_ok=True)
        shutil.copyfile(self.conf_path, os.path.join(rec, "config.conf"))

    # -- validation ---------------------------------------------------------

    def _render_panels(self, rays_o: torch.Tensor, rays_d: torch.Tensor
                      ) -> Dict[str, np.ndarray]:
        """Chunked no-grad lvis_render of a ray grid [H, W, 3]: the four
        PANEL_KEYS as [H * W, 4, ...] arrays.  The hemisphere draws come
        from a generator seeded with iter_step; one SDF and one K3 pack
        (the run's) serve every chunk."""
        gen = torch.Generator(device=self.device).manual_seed(self.iter_step)
        with torch.no_grad():
            def fn(o, d, _i):
                near, far = RAYS.near_far_from_sphere(o, d)
                return R.lvis_render(self.model, self.cfg, o, d, near, far,
                                     generator=gen)

            res, _, _ = chunked_render(fn, rays_o, rays_d,
                                       val_chunk_size(self.tcfg), PANEL_KEYS)
        return res

    def validate_image(self, idx: int = -1, resolution_level: int = -1
                       ) -> Dict[str, np.ndarray]:
        """The JAX stage-2 runner's panels of view idx (random when < 0),
        each the prediction above the target, averaged over the 4
        secondary rays: lvis/lvis_{iter}_{idx}.png, and
        trace_radiance/trace_radiance{iter}_{idx}.png for DTU and Sk3d,
        else trace_radiance/{iter}/trace_radiance_mean_{iter}_{idx}.png in
        sRGB (** (1 / 2.2)).  Returns the rendered arrays."""
        if idx < 0:
            idx = np.random.randint(self.dataset.n_images)
        if resolution_level < 0:
            resolution_level = self.tcfg.validate_resolution_level
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        H, W = rays_o.shape[:2]
        res = self._render_panels(rays_o, rays_d)
        nsamp = res["gt_lvis"].shape[1]
        lvis = {k: res[k].reshape(H, W, nsamp).mean(-1, keepdims=True)
                for k in ("gt_lvis", "pre_lvis")}
        tr = {k: res[k].reshape(H, W, nsamp, 3).mean(-2)
              for k in ("gt_trace_radiance", "pre_trace_radiance")}
        it, out = self.iter_step, self.base_exp_dir
        if self.type in ("dtu", "sk3d"):
            IMG.imwrite(os.path.join(out, "trace_radiance",
                                     f"trace_radiance{it}_{idx}.png"),
                        np.concatenate([tr["pre_trace_radiance"],
                                        tr["gt_trace_radiance"]]) * 255)
        else:
            tonemap = lambda x: np.power(np.clip(x, 0, 1), 1 / 2.2)
            IMG.imwrite(os.path.join(
                out, "trace_radiance", str(it),
                f"trace_radiance_mean_{it}_{idx}.png"),
                np.concatenate([tonemap(tr["pre_trace_radiance"]),
                                tonemap(tr["gt_trace_radiance"])]) * 255)
        IMG.imwrite(os.path.join(out, "lvis", f"lvis_{it}_{idx}.png"),
                    np.concatenate([lvis["pre_lvis"], lvis["gt_lvis"]])
                    * 255)
        return res

    validate_synthetic_img = validate_image
