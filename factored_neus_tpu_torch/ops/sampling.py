"""Ray-sampling primitives: inverse-CDF sampling and the NeuS hierarchical
up-sampling ladder.  Counterpart of factored_neus_tpu/ops/sampling.py.

The JAX package's gather-free forms (one-hot products, masked maxima, a
key/value sort) work around the TPU; here the direct forms are used:
``torch.searchsorted(cdf, u, right=True)`` + ``gather`` (equal to the JAX
``sum(cdf <= u)``) and a stable ``torch.sort`` + ``gather``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_samples: int) -> torch.Tensor:
    """Deterministic (mid-bin) inverse-CDF sampling of ``n_samples`` new
    positions per ray: bins [B, T] sorted positions, weights [B, T-1]
    section weights.  Returns [B, n_samples]."""
    B, T = bins.shape
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       device=bins.device, dtype=bins.dtype)
    u = u.expand(B, n_samples).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=T - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, below)
    bins_a = torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def alpha_to_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = a_i * prod_{j<i}(1 - a_j + 1e-7)."""
    ones = torch.ones_like(alpha[:, :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1),
                          dim=-1)[:, :-1]
    return alpha * trans


def neus_section_weights(z_vals: torch.Tensor, sdf: torch.Tensor,
                         pts_radius: torch.Tensor, inv_s) -> torch.Tensor:
    """Per-section NeuS weights of the up-sampling step, [B, T-1]."""
    inside = ((pts_radius[:, :-1] < 1.0) | (pts_radius[:, 1:] < 1.0)
              ).to(z_vals.dtype)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]),
                          cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside
    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha_to_weights(alpha)


def neus_alpha(sdf, true_cos, dists, inv_s, cos_anneal_ratio: float = 0.0):
    """NeuS section alpha from the SDF and its directional-derivative
    estimate.  Returns (alpha, prev_cdf)."""
    relu = torch.nn.functional.relu
    iter_cos = -(relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                        0.0, 1.0)
    return alpha, prev_cdf


def _points(rays_o, rays_d, z_vals):
    return rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int,
              inv_s) -> torch.Tensor:
    """One NeuS up-sampling step at fixed inv_s: new z [B, n_importance]."""
    radius = torch.linalg.norm(_points(rays_o, rays_d, z_vals), dim=-1)
    weights = neus_section_weights(z_vals, sdf, radius, inv_s)
    return sample_pdf(z_vals, weights, n_importance).detach()


def cat_z_vals(sdf_fn: Callable[[torch.Tensor], torch.Tensor], rays_o,
               rays_d, z_vals, new_z_vals, sdf, last: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the new positions in (stable sort) and, unless last, evaluate
    their SDF.  Returns (z_sorted [B, T+I], sdf_sorted or the input sdf)."""
    B, I = new_z_vals.shape
    z_cat = torch.cat([z_vals, new_z_vals], dim=-1)
    z_sorted, order = torch.sort(z_cat, dim=-1, stable=True)
    if last:
        return z_sorted, sdf
    pts = _points(rays_o, rays_d, new_z_vals)
    new_sdf = sdf_fn(pts.reshape(-1, 3)).reshape(B, I)
    sdf_cat = torch.cat([sdf, new_sdf], dim=-1)
    return z_sorted, torch.gather(sdf_cat, 1, order)


@torch.no_grad()
def hierarchical_z_vals(sdf_fn, rays_o, rays_d, z_vals, n_importance: int,
                        up_sample_steps: int) -> torch.Tensor:
    """The NeuS importance-sampling ladder: ``up_sample_steps`` rounds of
    n_importance // steps new samples at inv_s = 64 * 2^i.  sdf_fn: points
    [N, 3] -> sdf [N]; runs without gradient."""
    B = rays_o.shape[0]
    sdf = sdf_fn(_points(rays_o, rays_d, z_vals).reshape(-1, 3)).reshape(B, -1)
    per_step = n_importance // up_sample_steps
    for i in range(up_sample_steps):
        new_z = up_sample(rays_o, rays_d, z_vals, sdf, per_step, 64.0 * 2 ** i)
        z_vals, sdf = cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z, sdf,
                                 last=(i + 1 == up_sample_steps))
    return z_vals
