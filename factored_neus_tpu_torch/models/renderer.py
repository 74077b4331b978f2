"""NeuS stage-1 renderer without the background NeRF (n_outside = 0).
Counterpart of factored_neus_tpu/models/renderer.py (render, render_core).

The surface branch keeps the JAX package's static-shape form: RefColor runs
for every ray at the two samples bracketing the first SDF sign change and
the result is blended in where the ray has a crossing, which gives the
reference's masked-gather results.  SDF value, feature and gradient come
from K1 (ops/geometry_kernel.py); the up-sampling ladder's SDF sweeps from
K2 (ops/sdf_kernel.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops import sampling as S
from . import fields as F
from .secondary import first_crossing


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    sdf: F.SDFConfig = F.SDFConfig()
    rendering: F.RenderingConfig = F.RenderingConfig()
    refcolor: F.RefColorConfig = F.RefColorConfig()

    @property
    def n_total(self) -> int:
        return self.n_samples + self.n_importance


class Stage1Model(nn.Module):
    """The networks stage 1 trains (the JAX params groups sdf, variance,
    color and ref_color)."""

    def __init__(self, cfg: RendererConfig, variance_init_val: float = 0.3,
                 seed: int = 0, device="cpu"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.sdf = F.SDFNetwork(cfg.sdf, gen)
        self.variance = F.SingleVarianceNetwork(variance_init_val)
        self.color = F.RenderingNetwork(cfg.rendering, gen)
        self.ref_color = F.RefColor(cfg.refcolor, gen)
        self.to(device)


def render_core(model: Stage1Model, cfg: RendererConfig, rays_o, rays_d,
                z_vals, sample_dist: float, background_rgb=None,
                cos_anneal_ratio: float = 0.0) -> Dict[str, Any]:
    """SDF + radiance + surface colour over [B, T] samples."""
    B, T = z_vals.shape
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], sample_dist)], -1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)

    sdf, feature, gradients = model.sdf.value_grad_feat(pts_flat)
    sdf = sdf[:, None]
    inv_s = torch.clamp(model.variance.inv_s(), 1e-6, 1e6)

    true_cos = torch.sum(dirs_flat * gradients, -1, keepdim=True)
    alpha, prev_cdf = S.neus_alpha(sdf, true_cos, dists.reshape(-1, 1),
                                   inv_s, cos_anneal_ratio)
    alpha = alpha.reshape(B, T)

    pts_norm = torch.linalg.norm(pts, dim=-1).detach()           # [B, T]
    inside_sphere = (pts_norm < 1.0).to(z_vals.dtype)
    relax_inside = (pts_norm < 1.2).to(z_vals.dtype)
    inside_sphere_mask = torch.sum(inside_sphere, -1) > 0.0

    sampled_color = model.color(pts_flat, gradients, dirs_flat,
                                feature).reshape(B, T, 3)

    # surface branch: first SDF sign change, RefColor at the two bracketing
    # samples, NeuS-weight blend
    sdf_bt = sdf.reshape(B, T)
    min_val, min_idx = first_crossing(sdf_bt)
    sdf_mask = (min_val < 0.0) & (min_idx >= 1) & inside_sphere_mask
    idx = torch.clamp(min_idx, 1, T - 1)[:, None]                # [B, 1]

    def gather2(x_bt):  # [B, T, C] -> low, high [B, C]
        C = x_bt.shape[-1]
        lo = torch.gather(x_bt, 1, (idx - 1)[..., None].expand(B, 1, C))
        hi = torch.gather(x_bt, 1, idx[..., None].expand(B, 1, C))
        return lo[:, 0], hi[:, 0]

    grads_bt = gradients.reshape(B, T, 3)
    p_lo, p_hi = gather2(pts)
    n_lo, n_hi = gather2(grads_bt)
    f_lo, f_hi = gather2(feature.reshape(B, T, -1))
    ref = model.ref_color(torch.cat([p_lo, p_hi], 0),
                          torch.cat([f_lo, f_hi], 0),
                          torch.cat([rays_d, rays_d], 0),
                          torch.cat([n_lo, n_hi], 0))

    weights_inside = S.alpha_to_weights(alpha * inside_sphere)
    w_lo = torch.gather(weights_inside, 1, idx - 1) + 1e-5
    w_hi = torch.gather(weights_inside, 1, idx) + 1e-5
    w_sum = w_lo + w_hi

    def blend(v):  # [2B, 3] stacked low|high -> [B, 3]
        return (v[:B] * w_lo + v[B:] * w_hi) / w_sum

    m = sdf_mask[:, None]
    one = torch.ones((), dtype=z_vals.dtype, device=z_vals.device)
    surface_color = torch.where(m, blend(ref["rgb"]), one)
    specular_color = torch.where(m, blend(ref["specular_rgb"]), one)
    diffuse_color = torch.where(m, blend(ref["diffuse_rgb"]), one)

    weights = S.alpha_to_weights(alpha)
    weights_sum = torch.sum(weights, -1, keepdim=True)
    color = torch.sum(sampled_color * weights[:, :, None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    eik_sq = (torch.linalg.norm(grads_bt, dim=-1) - 1.0) ** 2
    eik_num = torch.sum(relax_inside * eik_sq)
    eik_den = torch.sum(relax_inside)
    return {
        "color": color,
        "surface_color": surface_color,
        "sdf_mask": sdf_mask,
        "sdf": sdf,
        "dists": dists,
        "gradients": grads_bt,
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z,
        "weights": weights,
        "cdf": prev_cdf.reshape(B, T),
        "gradient_error": eik_num / (eik_den + 1e-5),
        "_eik_num": eik_num,
        "_eik_den": eik_den,
        "inside_sphere": inside_sphere,
        "specular_color": specular_color,
        "diffuse_color": diffuse_color,
    }


def render(model: Stage1Model, cfg: RendererConfig, rays_o, rays_d, near,
           far, t_rand: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None, background_rgb=None,
           cos_anneal_ratio: float = 0.0,
           perturb_overwrite: float = -1.0) -> Dict[str, Any]:
    """Stage-1 renderer.  The per-ray z jitter is ``t_rand`` [B, 1] in
    [-0.5, 0.5) when given, else drawn from ``generator`` when given, else
    none (deterministic)."""
    if cfg.n_outside > 0:
        raise NotImplementedError("n_outside > 0 (the background NeRF of "
                                  "womask.conf) is not ported yet")
    B = rays_o.shape[0]
    sample_dist = 2.0 / cfg.n_samples
    z_lin = torch.linspace(0.0, 1.0, cfg.n_samples, device=rays_o.device,
                           dtype=rays_o.dtype)
    z_vals = near + (far - near) * z_lin[None, :]
    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0:
        if t_rand is None and generator is not None:
            t_rand = torch.rand((B, 1), generator=generator,
                                device=rays_o.device) - 0.5
        if t_rand is not None:
            z_vals = z_vals + t_rand * 2.0 / cfg.n_samples

    if cfg.n_importance > 0:
        z_vals = S.hierarchical_z_vals(
            model.sdf.value_sweep, rays_o.detach(), rays_d.detach(),
            z_vals.detach(), cfg.n_importance, cfg.up_sample_steps)

    ret = render_core(model, cfg, rays_o, rays_d, z_vals, sample_dist,
                      background_rgb=background_rgb,
                      cos_anneal_ratio=cos_anneal_ratio)
    weights = ret["weights"]
    return {
        "color_fine": ret["color"],
        "surface_color": ret["surface_color"],
        "sdf_mask": ret["sdf_mask"],
        "s_val": ret["s_val"].expand(B, 1),
        "cdf_fine": ret["cdf"],
        "weight_sum": torch.sum(weights, -1, keepdim=True),
        "weight_max": torch.max(weights, -1, keepdim=True).values,
        "gradients": ret["gradients"],
        "weights": weights,
        "gradient_error": ret["gradient_error"],
        "_eik_num": ret["_eik_num"],
        "_eik_den": ret["_eik_den"],
        "inside_sphere": ret["inside_sphere"],
        "specular_color": ret["specular_color"],
        "diffuse_color": ret["diffuse_color"],
    }
