"""Spherical-Gaussian (SG) helpers: for the stage-2 secondary rays, sphere
points, the tangent frame and hemisphere directions around a normal, and
per-point SG mixture queries; for stage 3, the envmap raster, the energy
of an SG, the product of two SGs and the cosine-lobe integral.
Counterpart of factored_neus_tpu/ops/sg.py (fibonacci_sphere,
compute_energy, render_envmap_sg, compute_envmap, lambda_trick,
hemisphere_int, integrate_rgb, tangent_frame, sample_dirs,
query_sg_mixture).

An SG is 7 floats: lobe axis (3), sharpness lambda (1), amplitude mu (3),
G(v) = mu * exp(lambda * (dot(v, axis) - 1)).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

TINY = 1e-6


def fibonacci_sphere(samples: int) -> np.ndarray:
    """Near-uniform points on the unit sphere [samples, 3], float64 on the
    host."""
    i = np.arange(samples, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - (i / float(samples - 1)) * 2.0
    radius = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = golden * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius], -1)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + TINY)


def tangent_frame(axis: torch.Tensor, x_ref_axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal (U, V) spanning the plane orthogonal to ``axis`` [..., 3]:
    U = norm(cross(e, axis)), V = norm(cross(axis, U)), e the unit vector
    of coordinate ``x_ref_axis``."""
    e = torch.zeros_like(axis)
    e[..., x_ref_axis] = 1.0
    axis = _normalize(axis)
    u = _normalize(torch.linalg.cross(e, axis, dim=-1))
    v = _normalize(torch.linalg.cross(axis, u, dim=-1))
    return u, v


def sample_dirs(axis: torch.Tensor, r_theta: torch.Tensor,
                r_phi: torch.Tensor, x_ref_axis: int = 0) -> torch.Tensor:
    """Directions at angle r_theta around ``axis`` and r_phi from it: axis
    [..., 1, 3] against r_theta, r_phi [..., S] -> [..., S, 3]."""
    u, v = tangent_frame(axis, x_ref_axis)
    axis = _normalize(axis)
    st, ct = torch.sin(r_theta)[..., None], torch.cos(r_theta)[..., None]
    sp, cp = torch.sin(r_phi)[..., None], torch.cos(r_phi)[..., None]
    return u * ct * sp + v * st * sp + axis * cp


def query_sg_mixture(lgt_sgs: torch.Tensor, dirs: torch.Tensor
                     ) -> torch.Tensor:
    """Per-point SG mixtures [N, L, 7] evaluated at dirs [N, S, 3] ->
    radiance [N, S, 3]."""
    lobes = lgt_sgs[:, None, :, :3]
    lobes = lobes / torch.linalg.norm(lobes, dim=-1, keepdim=True)
    lam = lgt_sgs[:, None, :, 3:4]
    mu = lgt_sgs[:, None, :, -3:]
    d = dirs[:, :, None, :]
    rad = mu * torch.exp(lam * (torch.sum(d * lobes, dim=-1, keepdim=True)
                                - 1.0))
    return torch.sum(rad, dim=2)


# -- stage 3: the envmap, the SG product and the cosine-lobe integral --------

def compute_energy(lgt_sgs: torch.Tensor) -> torch.Tensor:
    """Total energy of each SG [M, 7] -> [M, 3]."""
    lam = torch.abs(lgt_sgs[:, 3:4])
    mu = torch.abs(lgt_sgs[:, 4:])
    return mu * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))


def render_envmap_sg(lgt_sgs: torch.Tensor, viewdirs: torch.Tensor
                     ) -> torch.Tensor:
    """An SG mixture [M, 7] evaluated along viewdirs [..., 3] -> rgb
    [..., 3].  The lobes are normalised without an epsilon."""
    v = viewdirs[..., None, :]
    lobes = lgt_sgs[..., :3] / torch.linalg.norm(lgt_sgs[..., :3], dim=-1,
                                                 keepdim=True)
    lam = torch.abs(lgt_sgs[..., 3:4])
    mu = torch.abs(lgt_sgs[..., -3:])
    rgb = mu * torch.exp(lam * (torch.sum(v * lobes, dim=-1, keepdim=True)
                                - 1.0))
    return torch.sum(rgb, dim=-2)


def compute_envmap(lgt_sgs: torch.Tensor, H: int, W: int,
                   upper_hemi: bool = False) -> torch.Tensor:
    """The SG mixture rasterised to an [H, W, 3] lat-long envmap (Blender's
    convention)."""
    phi_max = math.pi / 2.0 if upper_hemi else math.pi
    kw = {"dtype": lgt_sgs.dtype, "device": lgt_sgs.device}
    phi, theta = torch.meshgrid(torch.linspace(0.0, phi_max, H, **kw),
                                torch.linspace(math.pi, -math.pi, W, **kw),
                                indexing="ij")
    viewdirs = torch.stack([torch.cos(theta) * torch.sin(phi),
                            torch.sin(theta) * torch.sin(phi),
                            torch.cos(phi)], -1)
    return render_envmap_sg(lgt_sgs, viewdirs)


def lambda_trick(lobe1, lambda1, mu1, lobe2, lambda2, mu2):
    """The product of two SGs as one SG (lambda1 << lambda2): (lobes,
    lambdas, mus).  The lobes are normalised with TINY."""
    ratio = lambda1 / (lambda2 + TINY)
    lobe1 = _normalize(lobe1)
    lobe2 = _normalize(lobe2)
    dot = torch.sum(lobe1 * lobe2, dim=-1, keepdim=True)
    tmp = torch.sqrt(ratio * ratio + 1.0 + 2.0 * ratio * dot + TINY)
    tmp = torch.minimum(tmp, ratio + 1.0)
    lambda3 = lambda2 * tmp
    l1_over_l3 = ratio / (tmp + TINY)
    l2_over_l3 = 1.0 / (tmp + TINY)
    diff = lambda2 * (tmp - ratio - 1.0)
    final_lobes = l1_over_l3 * lobe1 + l2_over_l3 * lobe2
    final_mus = mu1 * mu2 * torch.exp(diff)
    return final_lobes, lambda3, final_mus


def hemisphere_int(lambda_val: torch.Tensor, cos_beta: torch.Tensor
                   ) -> torch.Tensor:
    """Closed-form integral over the upper hemisphere of an SG whose lobe
    makes angle beta with the normal."""
    lambda_val = torch.clamp(lambda_val, min=TINY)
    inv_l = 1.0 / (lambda_val + TINY)
    t = torch.sqrt(lambda_val + TINY) * (1.6988 + 10.8438 * inv_l) / (
        1.0 + 6.2201 * inv_l + 10.2415 * inv_l * inv_l + TINY)
    inv_a = torch.exp(-t)
    mask = (cos_beta >= 0).to(lambda_val.dtype)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    s1 = (1.0 - inv_a * inv_b) / (1.0 - inv_a + inv_b - inv_a * inv_b + TINY)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    s2 = (b - inv_a) / ((1.0 - inv_a) * (b + 1.0) + TINY)
    s = mask * s1 + (1.0 - mask) * s2
    a_b = 2.0 * math.pi / lambda_val * (torch.exp(-lambda_val)
                                        - torch.exp(-2.0 * lambda_val))
    a_u = 2.0 * math.pi / lambda_val * (1.0 - torch.exp(-lambda_val))
    return a_b * (1.0 - s) + a_u * s


def integrate_rgb(normal, final_lobes, final_lambdas, final_mus
                  ) -> torch.Tensor:
    """The cosine-lobe integral summed over the lobes, clipped to [0, 1]:
    sum of mu' H(lambda', <lobe', n>) - mu alpha_cos H(lambda, <lobe, n>)."""
    mu_cos, lambda_cos, alpha_cos = 32.7080, 0.0315, 31.7003
    lobe_p, lambda_p, mu_p = lambda_trick(normal, lambda_cos, mu_cos,
                                          final_lobes, final_lambdas,
                                          final_mus)
    dot1 = torch.clamp(torch.sum(lobe_p * normal, dim=-1, keepdim=True),
                       min=0.0)
    dot2 = torch.clamp(torch.sum(final_lobes * normal, dim=-1, keepdim=True),
                       min=0.0)
    rgb = (mu_p * hemisphere_int(lambda_p, dot1)
           - final_mus * alpha_cos * hemisphere_int(final_lambdas, dot2))
    return torch.clamp(torch.sum(rgb, dim=-2), 0.0, 1.0)
