"""Stage-2 (light visibility + indirect light distillation) train step.
Counterpart of factored_neus_tpu/train/stage2.py on one device: ray
generation on the device -> lvis_render on the frozen stage-1 networks ->
the L1 lvis and trace-radiance loss -> Adam on Lvis and IndirectLight with
the warmup + cosine schedule of train.lvis.  A batch without a surface hit
has a zero loss and zero gradients, and Adam still counts the step, as in
the JAX package."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data import rays as RAYS
from ..models import renderer as R
from . import losses as L
from .common import StepTrainer, TrainConfig


def loss_on_batch(model: R.Stage2Model, cfg: R.RendererConfig, rays_o,
                  rays_d, u_theta: Optional[torch.Tensor] = None,
                  u_z: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """(loss, metrics) of one batch; the hemisphere draws are u_theta, u_z
    [B, 4] when given, else drawn from generator."""
    near, far = RAYS.near_far_from_sphere(rays_o, rays_d)
    out = R.lvis_render(model, cfg, rays_o, rays_d, near, far,
                        u_theta=u_theta, u_z=u_z, generator=generator)
    return L.stage2_losses(out)


class Stage2Trainer(StepTrainer):
    """The stage-2 step on the optimizer of Lvis and IndirectLight and
    the step's generator."""

    def __init__(self, model: R.Stage2Model, cfg: R.RendererConfig,
                 tcfg: TrainConfig, data: Dict,
                 seed: int = 2):
        super().__init__(model, tcfg, data, stage=2, seed=seed)
        self.cfg = cfg

    def loss(self, step, img_idx, anneal):
        rays_o, rays_d, _, _ = RAYS.sample_batch(
            self.gen, self.data, img_idx, self.tcfg.batch_size)
        return loss_on_batch(self.model, self.cfg, rays_o, rays_d,
                             generator=self.gen)
