"""Stage losses.  Counterpart of factored_neus_tpu/train/losses.py
(stage1_losses, stage2_losses, stage3_losses) on one device:
  stage 1: color L1 / mask_sum + surface-colour L1 / mask_sdf_sum +
           eikonal + BCE(weight_sum, mask);
  stage 2: L1(lvis) / (4 n_hit) + L1(trace radiance) / (12 n_hit);
  stage 3: L1(rgb) over the masked hit rays + the KL encoder loss."""
from __future__ import annotations

from typing import Dict

import torch


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def stage1_losses(out: Dict, true_rgb, mask, tcfg):
    """out: render() dict; mask [B, 1] already binarised or ones."""
    mask_sum = torch.sum(mask) + 1e-5
    color_err = (out["color_fine"] - true_rgb) * mask
    color_loss = torch.sum(torch.abs(color_err)) / mask_sum
    mse = torch.sum((out["color_fine"] - true_rgb) ** 2 * mask) \
        / (mask_sum * 3.0)
    psnr = psnr_from_mse(mse)

    sm = out["sdf_mask"][:, None].to(mask.dtype)
    mask_sdf_sum = torch.sum(mask * sm) + 1e-5
    surf_err = tcfg.surface_weight * (out["surface_color"] - true_rgb) \
        * mask * sm
    surface_loss = torch.sum(torch.abs(surf_err)) / mask_sdf_sum

    eikonal_loss = out["_eik_num"] / (out["_eik_den"] + 1e-5)

    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w) + (1.0 - mask) * torch.log(1.0 - w))
    mask_loss = torch.sum(bce) / float(mask.shape[0])

    loss = (color_loss + surface_loss + eikonal_loss * tcfg.igr_weight
            + mask_loss * tcfg.mask_weight)
    return loss, {
        "loss": loss, "color_loss": color_loss,
        "surface_loss": surface_loss, "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss, "psnr": psnr,
    }


def stage2_losses(out: Dict):
    """out: lvis_render() dict.  The lvis error is summed over every ray
    (unhit rays carry ones on both sides, so zero error) and normalised by
    the hit count x 4, as the reference does."""
    sm = out["sdf_mask"].to(torch.float32)
    n_hit = torch.sum(sm)
    lvis_err = out["gt_lvis"] - out["pre_lvis"]
    lvis_loss = torch.sum(torch.abs(lvis_err)) / (
        n_hit * out["gt_lvis"].shape[1] + 1e-6)
    tr_err = (out["gt_trace_radiance"] - out["pre_trace_radiance"]) \
        * sm[:, None, None]
    trace_loss = torch.sum(torch.abs(tr_err)) / (
        n_hit * out["gt_trace_radiance"].shape[1] * 3 + 1e-6)
    loss = lvis_loss + trace_loss
    return loss, {"loss": loss, "lvis_loss": lvis_loss,
                  "trace_radiance_loss": trace_loss, "n_hit": n_hit}


def stage3_losses(out: Dict, true_rgb, mask):
    """out: mate_illu_render() dict; mask [B, 1] already binarised or
    ones.  The rgb L1 and the PSNR run over the rays that are in the mask
    and hit the surface."""
    sm = out["sdf_mask"][:, None].to(mask.dtype)
    sdf_mask_sum = torch.sum(mask * sm) + 1e-5
    rgb_err = (out["rgb"] - true_rgb) * mask * sm
    rgb_loss = torch.sum(torch.abs(rgb_err)) / sdf_mask_sum
    mse = torch.sum((out["rgb"] - true_rgb) ** 2 * mask * sm) \
        / (sdf_mask_sum * 3.0)
    encoder_loss = out["encoder_loss"]
    loss = rgb_loss + encoder_loss
    return loss, {"loss": loss, "rgb_loss": rgb_loss,
                  "encoder_loss": encoder_loss, "psnr": psnr_from_mse(mse),
                  "n_hit": torch.sum(sm)}
