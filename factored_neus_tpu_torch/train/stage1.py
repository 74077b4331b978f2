"""Stage-1 (geometry + radiance) train step.  Counterpart of
factored_neus_tpu/train/stage1.py on one device: ray generation on the
device -> NeuS render -> 4-term loss -> Adam with the warmup + cosine
schedule."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data import rays as RAYS
from ..models import renderer as R
from ..utils import schedule
from . import losses as L
from .common import TrainConfig, make_optimizer, set_lr


def loss_on_batch(model: R.Stage1Model, cfg: R.RendererConfig,
                  tcfg: TrainConfig, rays_o, rays_d, color, mask, step: int,
                  t_rand: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """(loss, metrics) of one batch; the z jitter is t_rand when given,
    else drawn from generator."""
    near, far = RAYS.near_far_from_sphere(rays_o, rays_d)
    background_rgb = (torch.ones(1, 3, device=rays_o.device)
                      if tcfg.use_white_bkgd else None)
    if tcfg.mask_weight > 0.0:
        mask = (mask > 0.5).to(torch.float32)
    else:
        mask = torch.ones_like(mask)
    out = R.render(model, cfg, rays_o, rays_d, near, far, t_rand=t_rand,
                   generator=generator, background_rgb=background_rgb,
                   cos_anneal_ratio=schedule.cos_anneal_ratio(
                       step, tcfg.anneal_end))
    loss, metrics = L.stage1_losses(out, color, mask, tcfg)
    mask_sum = torch.sum(mask) + 1e-5
    metrics["s_val"] = torch.mean(out["s_val"])
    metrics["cdf"] = torch.sum(out["cdf_fine"][:, :1] * mask) / mask_sum
    metrics["weight_max"] = torch.sum(out["weight_max"] * mask) / mask_sum
    return loss, metrics


class Stage1Trainer:
    """Owns the model's optimizer and the step's random generator."""

    def __init__(self, model: R.Stage1Model, cfg: R.RendererConfig,
                 tcfg: TrainConfig, data: Dict[str, torch.Tensor],
                 seed: int = 1):
        self.model, self.cfg, self.tcfg, self.data = model, cfg, tcfg, data
        self.opt = make_optimizer(model, tcfg)
        device = data["images"].device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def step(self, img_idx: int, step: int) -> Dict[str, torch.Tensor]:
        d = self.data
        rays_o, rays_d, color, mask = RAYS.gen_random_rays(
            self.gen, d["images"], d["masks"], d["intr_inv"], d["poses"],
            img_idx, self.tcfg.batch_size)
        loss, metrics = loss_on_batch(self.model, self.cfg, self.tcfg,
                                      rays_o, rays_d, color, mask, step,
                                      generator=self.gen)
        set_lr(self.opt, self.tcfg, step)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}
