"""Stage-1 loss.  Counterpart of factored_neus_tpu/train/losses.py
(stage1_losses) on one device: color L1 / mask_sum + surface-colour L1 /
mask_sdf_sum + eikonal + BCE(weight_sum, mask)."""
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
