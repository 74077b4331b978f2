"""Stage-1 (geometry + radiance) train step.  Counterpart of
factored_neus_tpu/train/stage1.py on one device: ray generation on the
device -> NeuS render -> 4-term loss -> Adam with the warmup + cosine
schedule (common.StepTrainer: eager, or replayed from a CUDA graph)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data import rays as RAYS
from ..models import renderer as R
from ..utils import schedule
from . import losses as L
from .common import StepTrainer, TrainConfig


def loss_on_batch(model: R.Stage1Model, cfg: R.RendererConfig,
                  tcfg: TrainConfig, rays_o, rays_d, color, mask, step: int,
                  t_rand: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  t_rand_out: Optional[torch.Tensor] = None,
                  cos_anneal_ratio=None):
    """(loss, metrics) of one batch; the z jitters are t_rand (and, with
    the background model, t_rand_out) when given, else drawn from
    generator; cos_anneal_ratio (a float or a 0-dim tensor) that of
    ``step`` unless given."""
    if cos_anneal_ratio is None:
        cos_anneal_ratio = schedule.cos_anneal_ratio(step, tcfg.anneal_end)
    near, far = RAYS.near_far_from_sphere(rays_o, rays_d)
    background_rgb = (torch.ones(1, 3, device=rays_o.device)
                      if tcfg.use_white_bkgd else None)
    if tcfg.mask_weight > 0.0:
        mask = (mask > 0.5).to(torch.float32)
    else:
        mask = torch.ones_like(mask)
    out = R.render(model, cfg, rays_o, rays_d, near, far, t_rand=t_rand,
                   generator=generator, t_rand_out=t_rand_out,
                   background_rgb=background_rgb,
                   cos_anneal_ratio=cos_anneal_ratio)
    loss, metrics = L.stage1_losses(out, color, mask, tcfg)
    mask_sum = torch.sum(mask) + 1e-5
    metrics["s_val"] = torch.mean(out["s_val"])
    metrics["cdf"] = torch.sum(out["cdf_fine"][:, :1] * mask) / mask_sum
    metrics["weight_max"] = torch.sum(out["weight_max"] * mask) / mask_sum
    return loss, metrics


class Stage1Trainer(StepTrainer):
    """The stage-1 step on the model's optimizer and generator."""

    def __init__(self, model: R.Stage1Model, cfg: R.RendererConfig,
                 tcfg: TrainConfig, data: Dict,
                 seed: int = 1):
        super().__init__(model, tcfg, data, stage=1, seed=seed)
        self.cfg = cfg

    def loss(self, step, img_idx, anneal):
        rays_o, rays_d, color, mask = RAYS.sample_batch(
            self.gen, self.data, img_idx, self.tcfg.batch_size)
        return loss_on_batch(self.model, self.cfg, self.tcfg, rays_o, rays_d,
                             color, mask, step, generator=self.gen,
                             cos_anneal_ratio=anneal)
