"""Inference on trained checkpoints: novel views, the stage-3
decomposition, relighting under a loaded SG envmap, the learned envmap,
SDF queries and meshes.  Counterpart of factored_neus_tpu/pipeline.py on
one device:

    pipe = Pipeline.from_experiment("confs/wmask.conf", case="dtu_scan97")
    img = pipe.render_view(idx=0, resolution_level=2)        # [H, W, 3]
    maps = pipe.render_decomposition(idx=0)                  # dict of maps
    verts, tris = pipe.extract_mesh(resolution=512)
    relit = pipe.relight("./envmaps/envmap6", idx=0)

Rays go through the renderers in chunks of ``batch_size`` without
gradient, on one SDF pack (and one radiance pack) for the whole call.
The JAX package's ``mesh=`` sharding of the grid fill waits for the
port's multi-GPU path and raises.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import bridge
from .data import rays as RAYS
from .data.datasets import make_dataset, tonemap_for
from .meshing import extract as MEXT
from .models import renderer as R
from .models.materials import get_light
from .train.common import chunked_render
from .train.runner3 import STAGE3_KEYS, VAL_KEYS
from .utils import checkpoints as CK
from .utils import config as CFG
from .utils.device import resolve_device

STAGE1_KEYS = ("color_fine", "surface_color", "diffuse_color",
               "specular_color")
# the groups that each stage's pipeline serves, all from checkpoints
NEEDS = {1: ("sdf", "color", "variance"),
         2: ("sdf", "color", "variance", "lvis", "indirect"),
         3: ("sdf", "color", "variance", "lvis", "indirect", "material")}


def _no_sharding(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh= (sharding across devices) waits for "
                                  "the port's multi-GPU path")


class Pipeline:
    def __init__(self, cfg: R.RendererConfig, model: R.Stage3Model,
                 dataset=None, batch_size: int = 4096, device=None):
        self.cfg, self.model, self.dataset = cfg, model, dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)

    @classmethod
    def from_experiment(cls, conf_path: str, case: str = "",
                        type: str = "dtu", stage: int = 3,
                        batch_size: int = 4096, device=None,
                        mesh=None) -> "Pipeline":
        """The newest checkpoint of each stage up to ``stage`` (the later
        one's groups win); raises unless they provide every group the
        stage serves.  A stage-3 pipeline of the synthetic and Shiny types
        renders in linear space, as stage 3 trained them."""
        _no_sharding(mesh)
        dev = resolve_device(device)
        conf = CFG.load(conf_path, case)
        cfg = CFG.renderer_config(
            conf, "model.lvis_renderer" if stage > 1 else
            "model.neus_renderer",
            tonemap=tonemap_for(type) if stage >= 3 else "srgb")
        model = R.Stage3Model(cfg, CFG.variance_init_val(conf), device=dev)
        dirs = {1: conf.get("general.base_exp_dir_geo"),
                2: conf.get("general.base_exp_dir_lvis"),
                3: conf.get("general.base_exp_dir_mateIllu")}
        loaded = set()
        for s in range(1, stage + 1):
            path = CK.latest_checkpoint(dirs[s]) if dirs.get(s) else None
            if path is None:
                continue
            ckpt = CK.load_checkpoint(path)
            for pk, ck in STAGE3_KEYS.items():
                if ck in ckpt:
                    bridge.load_jax_group(model, pk, ckpt[ck])
                    loaded.add(pk)
        missing = [g for g in NEEDS[stage] if g not in loaded]
        if missing:
            raise FileNotFoundError(
                f"a stage-{stage} pipeline needs the trained groups "
                f"{missing}, which no checkpoint under {dirs} provides: "
                "train the earlier stages first")
        return cls(cfg, model, make_dataset(type, conf["dataset"], dev),
                   batch_size, dev)

    # -- the chunked ray loop ---------------------------------------------

    def _run_chunks(self, rays_o, rays_d, fn, keys: Sequence[str]
                    ) -> Dict[str, np.ndarray]:
        """fn(o, d, near, far) over [H, W, 3] ray grids -> [H, W, C]."""
        with torch.no_grad():
            def call(o, d, _i):
                near, far = RAYS.near_far_from_sphere(o, d)
                return fn(o, d, near, far)
            res, H, W = chunked_render(call, rays_o, rays_d,
                                       self.batch_size, keys)
        return {k: v.reshape(H, W, -1) for k, v in res.items()}

    # -- the public surface -------------------------------------------------

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor
                    ) -> Dict[str, np.ndarray]:
        """The stage-1 render (no jitter, cos_anneal_ratio 1) of a ray
        grid [H, W, 3]: colour, surface, diffuse and specular maps."""
        weights = R.step_weights(self.model, self.cfg)
        return self._run_chunks(
            rays_o, rays_d,
            lambda o, d, n, f: R.render(self.model.stage1, self.cfg, o, d, n,
                                        f, cos_anneal_ratio=1.0,
                                        perturb_overwrite=0.0,
                                        weights=weights),
            STAGE1_KEYS)

    def render_view(self, idx: int, resolution_level: int = 1) -> np.ndarray:
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        return self.render_rays(rays_o, rays_d)["color_fine"]

    def render_between(self, idx_0: int, idx_1: int, ratio: float,
                       resolution_level: int = 1) -> np.ndarray:
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio,
                                                       resolution_level)
        return self.render_rays(rays_o, rays_d)["color_fine"]

    def render_decomposition(self, idx: int, resolution_level: int = 1,
                             seed: int = 0) -> Dict[str, np.ndarray]:
        """The stage-3 maps of view idx (runner3.VAL_KEYS), the visibility
        draws from a generator seeded with ``seed``."""
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._run_chunks(
            rays_o, rays_d,
            lambda o, d, n, f: R.mate_illu_render(self.model, self.cfg, o, d,
                                                  n, f, generator=gen),
            VAL_KEYS)

    def relight(self, envmap_path: str, idx: int,
                resolution_level: int = 1) -> np.ndarray:
        """View idx rendered under the SG envmap <envmap_path>/sg_128.npy
        [num_lgt_sgs, 7] in place of the learned one."""
        lgt = self.model.material.lgtSGs
        saved = lgt.detach().clone()
        sgs = np.load(os.path.join(envmap_path, "sg_128.npy"))
        with torch.no_grad():
            lgt.copy_(torch.as_tensor(sgs, dtype=torch.float32))
        try:
            return self.render_decomposition(idx, resolution_level)["rgb"]
        finally:
            with torch.no_grad():
                lgt.copy_(saved)

    def envmap(self, H: int = 256, W: int = 512) -> np.ndarray:
        """The learned envmap rasterised to [H, W, 3]."""
        with torch.no_grad():
            return get_light(self.model.material, H, W).cpu().numpy()

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        """The sdf [N] of points [N, 3]."""
        x = torch.as_tensor(np.asarray(pts, np.float32), device=self.device)
        return self.model.stage1.sdf.value_sweep(
            x, self.model.kernel_weights()[0]).cpu().numpy()

    def extract_mesh(self, resolution: int = 512, threshold: float = 0.0,
                     world_space: bool = False, mesh=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(vertices, triangles) of the surface over the dataset's object
        box (or [-1.01, 1.01]^3), in world space through its scale_mats
        when ``world_space``; the grid fill runs on K2 on the card."""
        _no_sharding(mesh)
        ds = self.dataset
        box = ((ds.object_bbox_min, ds.object_bbox_max) if ds is not None
               else ([-1.01] * 3, [1.01] * 3))
        verts, tris = MEXT.extract_geometry(
            *box, resolution, threshold,
            MEXT.sdf_grid_query(self.model.stage1.sdf), self.device)
        if world_space and hasattr(ds, "scale_mats_np"):
            s = ds.scale_mats_np[0]
            verts = verts * s[0, 0] + s[:3, 3][None]
        return verts, tris
