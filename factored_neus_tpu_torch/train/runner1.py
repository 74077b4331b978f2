"""Stage-1 runner: geometry + radiance training from a conf, and mesh
extraction.  Counterpart of factored_neus_tpu/train/runner1.py for the
modes ``train`` and ``validate_mesh``: the loop, reports, checkpoints
(groups keep the reference's names) and meshes at ``val_mesh_freq``.
Validation images are not ported yet; their steps are logged and skipped.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import make_dataset
from ..meshing import extract as MEXT
from ..meshing.ply import write_ply
from ..models.renderer import Stage1Model
from ..utils import checkpoints as CK
from ..utils import config as CFG
from ..utils.device import resolve_device
from .common import TrainConfig
from .stage1 import Stage1Trainer

log = logging.getLogger("factored_neus_tpu_torch")
MODES = ("train", "validate_mesh")

# checkpoint group names of the reference (model attribute -> group)
CKPT_KEYS = {
    "nerf": "nerf",
    "sdf": "sdf_network_fine",
    "variance": "variance_network_fine",
    "color": "color_network_fine",
    "ref_color": "refColor_network",
}


def _np_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in
            module.state_dict().items()}


class Runner:
    def __init__(self, conf_path: str, mode: str = "train", case: str = "",
                 is_continue: bool = False, type: str = "dtu",
                 surface_weight: float = 0.1, seed: int = 0, device=None):
        if mode not in MODES:
            raise NotImplementedError(f"mode {mode!r} is not ported yet "
                                      f"(ported: {', '.join(MODES)})")
        self.device = resolve_device(device)
        self.conf_path = conf_path
        self.conf = CFG.load(conf_path, case)
        self.base_exp_dir = self.conf["general.base_exp_dir_geo"]
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.dataset = make_dataset(type, self.conf["dataset"], self.device)
        self.tcfg = TrainConfig.from_conf(self.conf,
                                          surface_weight=surface_weight)
        self.cfg = CFG.renderer_config(self.conf)
        if self.tcfg.block_steps > 1:
            log.info("train.block_steps = %d: steps run one at a time",
                     self.tcfg.block_steps)
        self.model = Stage1Model(self.cfg, CFG.variance_init_val(self.conf),
                                 seed=seed, device=self.device)
        ds = self.dataset
        self.trainer = Stage1Trainer(
            self.model, self.cfg, self.tcfg,
            {"images": ds.images, "masks": ds.masks,
             "intr_inv": ds.intrinsics_all_inv, "poses": ds.pose_all},
            seed=seed + 1)
        self.iter_step = 0
        self.history: List[Dict[str, float]] = []
        self.last_checkpoint: Optional[str] = None
        self.last_mesh: Optional[str] = None
        self.mesh_times: Dict[str, float] = {}
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
        rng = np.random.RandomState(self.iter_step)
        perm = rng.permutation(n)
        skipped_val = False
        t_last, steps_since = time.perf_counter(), 0
        while self.iter_step < tcfg.end_iter:
            metrics = self.trainer.step(int(perm[self.iter_step % n]),
                                        self.iter_step)
            self.iter_step += 1
            steps_since += 1
            if self.iter_step % tcfg.report_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}  # syncs
                now = time.perf_counter()
                m["rays_per_sec"] = (tcfg.batch_size * steps_since
                                     / (now - t_last))
                m["iter"] = self.iter_step
                t_last, steps_since = now, 0
                self.history.append(m)
                log.info("iter %d loss=%.5f psnr=%.2f rays/s=%.0f",
                         self.iter_step, m["loss"], m["psnr"],
                         m["rays_per_sec"])
            if self.iter_step % tcfg.save_freq == 0:
                self.save_checkpoint()
            if self.iter_step % tcfg.val_freq == 0 and not skipped_val:
                log.info("validation images are not ported yet; skipped")
                skipped_val = True
            if self.iter_step % tcfg.val_mesh_freq == 0:
                self.validate_mesh(world_space=True)
            if self.iter_step % n == 0:
                perm = rng.permutation(n)

    def save_checkpoint(self) -> str:
        groups = {ck: _np_state(getattr(self.model, pk))
                  for pk, ck in CKPT_KEYS.items()}
        opt = self.trainer.opt.state_dict()
        groups["optimizer"] = {
            f"{i}.{k}": v.detach().cpu().numpy()
            for i, st in opt["state"].items() for k, v in st.items()}
        groups["iter_step"] = np.asarray(self.iter_step)
        self.last_checkpoint = CK.save_checkpoint(self.base_exp_dir,
                                                  self.iter_step, groups)
        return self.last_checkpoint

    def load_checkpoint(self, path: str) -> None:
        loaded = CK.load_checkpoint(path)
        for pk, ck in CKPT_KEYS.items():
            getattr(self.model, pk).load_state_dict(
                {k: torch.from_numpy(v) for k, v in loaded[ck].items()})
        opt = self.trainer.opt
        sd = opt.state_dict()
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for key, v in loaded.get("optimizer", {}).items():
            i, name = key.split(".", 1)
            state.setdefault(int(i), {})[name] = torch.from_numpy(v)
        sd["state"] = state
        opt.load_state_dict(sd)
        self.iter_step = int(loaded["iter_step"])

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

    def file_backup(self) -> None:
        rec = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec, exist_ok=True)
        shutil.copyfile(self.conf_path, os.path.join(rec, "config.conf"))
