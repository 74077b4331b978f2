"""Stage-3 (materials and direct illumination) train step.  Counterpart of
factored_neus_tpu/train/stage3.py on one device: ray generation on the
device -> mate_illu_render on the frozen stage-1 and stage-2 networks ->
the rgb L1 over the hit rays plus the KL encoder loss -> Adam on
EnvmapMaterial with the warmup + cosine schedule (the global
train.warm_up_end, end_iter from train.metaIllu).  The mask is binarised
when mask_weight > 0, else all ones, as in the JAX package."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data import rays as RAYS
from ..models import renderer as R
from . import losses as L
from .common import StepTrainer, TrainConfig


def loss_on_batch(model: R.Stage3Model, cfg: R.RendererConfig,
                  tcfg: TrainConfig, rays_o, rays_d, color, mask,
                  u_theta: Optional[torch.Tensor] = None,
                  u_phi: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """(loss, metrics) of one batch; the visibility draws are u_theta,
    u_phi [num_lgt_sgs, vis_nsamp] when given, else drawn from
    generator."""
    near, far = RAYS.near_far_from_sphere(rays_o, rays_d)
    if tcfg.mask_weight > 0.0:
        mask = (mask > 0.5).to(torch.float32)
    else:
        mask = torch.ones_like(mask)
    out = R.mate_illu_render(model, cfg, rays_o, rays_d, near, far,
                             u_theta=u_theta, u_phi=u_phi,
                             generator=generator)
    return L.stage3_losses(out, color, mask)


class Stage3Trainer(StepTrainer):
    """The stage-3 step on the optimizer of EnvmapMaterial and the
    step's generator."""

    def __init__(self, model: R.Stage3Model, cfg: R.RendererConfig,
                 tcfg: TrainConfig, data: Dict,
                 seed: int = 3):
        super().__init__(model, tcfg, data, stage=3, seed=seed)
        self.cfg = cfg

    def loss(self, step, img_idx, anneal):
        rays_o, rays_d, color, mask = RAYS.sample_batch(
            self.gen, self.data, img_idx, self.tcfg.batch_size)
        return loss_on_batch(self.model, self.cfg, self.tcfg, rays_o, rays_d,
                             color, mask, generator=self.gen)
