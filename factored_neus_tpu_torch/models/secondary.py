"""Secondary-ray tracing against the frozen stage-1 SDF: the ground-truth
light visibility (occlusion) and first-hit radiance that stage 2 distils
into Lvis and IndirectLight, and the surface crossing of the stage-1
surface branch.  Counterpart of factored_neus_tpu/models/secondary.py.

Every primary ray is traced at static shape and callers mask with the
``sdf_mask`` of surface localisation, as in the JAX package.  The
functions take the networks as closures over points [N, 3]:
  sdf_fwd         -> sdf [N]                      (K2 on the card)
  sdf_fwd_coarse  -> sdf [N], the coarse sweep's  (K2-bf16 on the card
                                                   under sweep_act_bf16)
  sdf_apply_full  -> [sdf | feature] [N, 1 + F]   (K1-fwd)
  sdf_grad        -> dsdf/dx [N, 3]               (K1-fwd)
  sdf_vgf         -> (sdf [N], feature, grad)     (K1-fwd, one launch)
  color_fn(pts, normals, dirs, feature) -> rgb    (K3-fwd)
The targets are computed without gradient.  On the card each sweep is
one call over all its rows; on the CPU the twins run it in chunks of
``chunk`` rows (ops/chunk.py).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import sampling as S
from ..ops import sg as SG
from ..ops.chunk import chunked_apply, chunked_apply_tree

# secondary-ray sampling budget
N_HEMI_DIRS = 4
N_COARSE = 512
N_FINE = 32
SECONDARY_SAMPLE_DIST = (1.0 - 0.1) / 32.0


def section_geometry(rays_o, rays_d, z_vals, sample_dist: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dists [B, T], mid_z [B, T], pts [B, T, 3]) of the sections of a z
    ladder."""
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], sample_dist)], -1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    return dists, mid_z, pts


def _sweep(fn: Callable, x: torch.Tensor, chunk: int,
           apply: Callable = chunked_apply):
    """fn over the rows of x: one call on the card, chunks on the CPU
    (``apply``: chunked_apply_tree for a fn that returns a tuple)."""
    return fn(x) if x.is_cuda else apply(fn, x, chunk)


def first_crossing(sdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the first +-to- sign change along the sample axis, as the
    reference's ``min(sign(sdf) * arange(T, 0, -1))``: (min_val [B],
    min_idx [B]); ties resolve to the first index like jnp.argmin."""
    T = sdf.shape[1]
    ramp = torch.arange(T, 0, -1, dtype=sdf.dtype, device=sdf.device)[None]
    tmp = torch.sign(sdf) * ramp
    min_val, min_idx = torch.min(tmp, dim=-1)
    return min_val, torch.argmin(tmp, dim=-1)


def surface_localize(mid_z: torch.Tensor, sdf: torch.Tensor,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     inside_mask: torch.Tensor):
    """The linear SDF root between the two samples bracketing the first
    crossing: (pts_surf [B, 3], z_surf [B, 1], sdf_mask [B])."""
    T = sdf.shape[1]
    min_val, min_idx = first_crossing(sdf)
    sdf_mask = (min_val < 0.0) & (min_idx >= 1) & inside_mask
    idx = torch.clamp(min_idx, 1, T - 1)[:, None]
    z_lo = torch.gather(mid_z, 1, idx - 1)
    z_hi = torch.gather(mid_z, 1, idx)
    s_lo = torch.gather(sdf, 1, idx - 1)
    s_hi = torch.gather(sdf, 1, idx)
    z_surf = (s_lo * z_hi - s_hi * z_lo) / (s_lo - s_hi + 1e-10)
    return rays_o + rays_d * z_surf, z_surf, sdf_mask


def _weights_inside(sdf, grads, dirs, dists, pts, inv_s):
    """NeuS weights along each secondary ray, and those inside the unit
    sphere: ([B, T], [B, T])."""
    alpha, _ = S.neus_alpha(sdf, torch.sum(dirs * grads, -1), dists, inv_s)
    weights = S.alpha_to_weights(alpha)
    inside = (torch.linalg.norm(pts, dim=-1) < 1.0).to(sdf.dtype)
    return weights, weights * inside


@torch.no_grad()
def compute_weight(sdf_fwd, sdf_grad, inv_s, rays_o, rays_d, z_vals,
                   chunk: int = 65536):
    """NeuS weights along secondary rays: (weights [B, T], weights_inside
    [B, T]), without gradient."""
    B, T = z_vals.shape
    dists, _, pts = section_geometry(rays_o, rays_d, z_vals,
                                     SECONDARY_SAMPLE_DIST)
    pts_flat = pts.reshape(-1, 3)
    sdf = _sweep(sdf_fwd, pts_flat, chunk).reshape(B, T)
    grads = _sweep(sdf_grad, pts_flat, chunk).reshape(B, T, 3)
    return _weights_inside(sdf, grads, rays_d[:, None, :], dists, pts, inv_s)


def _first_hit(sdf, mid_z, pts, rays_o, rays_d, surface_fn, color_fn):
    """First-hit radiance [B, 3] (zeros where no hit) and hit_mask [B];
    surface_fn: pts_surf -> (feature, normal)."""
    inside_mask = torch.sum(torch.linalg.norm(pts, dim=-1) < 1.0, -1) > 0
    pts_surf, _, hit_mask = surface_localize(mid_z, sdf, rays_o, rays_d,
                                             inside_mask)
    f_surf, n_surf = surface_fn(pts_surf)
    rgb = color_fn(pts_surf, n_surf, rays_d, f_surf)
    return torch.where(hit_mask[:, None], rgb, torch.zeros_like(rgb)), \
        hit_mask


@torch.no_grad()
def cal_fir_hit_rgb(sdf_apply_full, sdf_grad, color_fn, rays_o, rays_d,
                    z_vals, chunk: int = 65536):
    """First-hit surface radiance per secondary ray: (rgb [B, 3], zeros
    where there is no hit, hit_mask [B])."""
    B, T = z_vals.shape
    _, mid_z, pts = section_geometry(rays_o, rays_d, z_vals,
                                     SECONDARY_SAMPLE_DIST)
    sdf = _sweep(sdf_apply_full, pts.reshape(-1, 3), chunk)[:, 0]
    return _first_hit(sdf.reshape(B, T), mid_z, pts, rays_o, rays_d,
                      lambda p: (sdf_apply_full(p)[:, 1:], sdf_grad(p)),
                      color_fn)


@torch.no_grad()
def fine_sweep_targets(sdf_vgf, color_fn, inv_s, rays_o, rays_d, z_vals,
                       chunk: int = 65536):
    """Both fine-sweep targets (compute_weight's and cal_fir_hit_rgb's)
    from ONE geometry sweep over the fine mid-points, and one more over the
    surface points: (rgb [B, 3], hit_mask [B], weights [B, T],
    weights_inside [B, T])."""
    B, T = z_vals.shape
    dists, mid_z, pts = section_geometry(rays_o, rays_d, z_vals,
                                         SECONDARY_SAMPLE_DIST)
    sdf, _, grads = _sweep(sdf_vgf, pts.reshape(-1, 3), chunk,
                           chunked_apply_tree)
    sdf = sdf.reshape(B, T)
    weights, weights_inside = _weights_inside(
        sdf, grads.reshape(B, T, 3), rays_d[:, None, :], dists, pts, inv_s)
    rgb, hit_mask = _first_hit(sdf, mid_z, pts, rays_o, rays_d,
                               lambda p: sdf_vgf(p)[1:], color_fn)
    return rgb, hit_mask, weights, weights_inside


@torch.no_grad()
def _trace_targets(surf_flat, dirs_flat, z_coarse, sdf_fwd, sdf_apply_full,
                   sdf_grad, inv_s, color_fn, chunk, sdf_vgf,
                   sdf_fwd_coarse=None):
    """(occupancy [R], first-hit rgb [R, 3]) of secondary rays from
    surf_flat along dirs_flat [R, 3]: the coarse sweep over z_coarse
    [R, N_COARSE] (through sdf_fwd_coarse, sdf_fwd when None), N_FINE
    up-sampled positions, then the fine sweep."""
    R = surf_flat.shape[0]
    pts = surf_flat[:, None, :] + dirs_flat[:, None, :] * z_coarse[:, :, None]
    coarse_sdf = _sweep(sdf_fwd_coarse or sdf_fwd, pts.reshape(-1, 3),
                        chunk).reshape(R, -1)
    z_fine = S.up_sample(surf_flat, dirs_flat, z_coarse, coarse_sdf, N_FINE,
                         inv_s)
    if sdf_vgf is not None:
        rgb, _, _, weights_inside = fine_sweep_targets(
            sdf_vgf, color_fn, inv_s, surf_flat, dirs_flat, z_fine, chunk)
    else:
        rgb, _ = cal_fir_hit_rgb(sdf_apply_full, sdf_grad, color_fn,
                                 surf_flat, dirs_flat, z_fine, chunk)
        _, weights_inside = compute_weight(sdf_fwd, sdf_grad, inv_s,
                                           surf_flat, dirs_flat, z_fine,
                                           chunk)
    return torch.sum(weights_inside, -1), rgb


def cal_indi_lgt(surf, normal, sdf_fwd, sdf_apply_full, sdf_grad, inv_s,
                 color_fn, lvis_fn, indirect_fn, u_theta=None, u_z=None,
                 generator: Optional[torch.Generator] = None,
                 chunk: int = 131072, sdf_fwd_coarse=None, sdf_vgf=None
                 ) -> Dict[str, torch.Tensor]:
    """Distillation targets of N_HEMI_DIRS cosine-hemisphere secondary rays
    per surface point: gt / pre lvis [P, 4] and trace radiance [P, 4, 3].
    The draws are u_theta, u_z [P, 4] in [0, 1) when given, else drawn
    from ``generator``: theta = 2 pi u_theta, phi = asin(0.95 u_z) from
    the normal.  ``sdf_fwd_coarse`` (sdf_fwd when None) serves the coarse
    sweep only, which places the fine samples (stage 2's bf16 sweep);
    the targets go through sdf_fwd and sdf_vgf.  With ``sdf_vgf`` the two
    fine-sample passes share one sweep (fine_sweep_targets), else
    compute_weight and cal_fir_hit_rgb run apart.  Only pre_lvis and
    pre_trace_radiance carry gradient (of lvis_fn and indirect_fn)."""
    P = surf.shape[0]
    if u_theta is None:
        u_theta, u_z = (torch.rand((P, N_HEMI_DIRS), generator=generator,
                                   device=surf.device) for _ in range(2))
    r_theta = u_theta * (2.0 * math.pi)
    r_phi = torch.arcsin(u_z * 0.95)
    dirs = SG.sample_dirs(normal[:, None, :], r_theta, r_phi, x_ref_axis=0)
    surf_flat = surf[:, None, :].expand(P, N_HEMI_DIRS, 3).reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)
    # the coarse sweep on [0, 1] along the secondary ray
    z_coarse = torch.linspace(0.0, 1.0, N_COARSE, device=surf.device,
                              dtype=surf.dtype).expand(P * N_HEMI_DIRS,
                                                       N_COARSE)
    occu, rgb = _trace_targets(surf_flat, dirs_flat, z_coarse, sdf_fwd,
                               sdf_apply_full, sdf_grad, inv_s, color_fn,
                               chunk, sdf_vgf, sdf_fwd_coarse)
    pre_sgs = indirect_fn(surf)                                # [P, L, 7]
    return {
        "gt_lvis": (1.0 - occu).reshape(P, N_HEMI_DIRS),
        "pre_lvis": lvis_fn(surf_flat, dirs_flat).reshape(P, N_HEMI_DIRS),
        "gt_trace_radiance": rgb.reshape(P, N_HEMI_DIRS, 3),
        "pre_trace_radiance": SG.query_sg_mixture(pre_sgs, dirs),
    }


def compute_light_visibility(surf, normal, sdf_fwd, sdf_apply_full,
                             sdf_grad, inv_s, color_fn, lvis_fn, indirect_fn,
                             n_lights: int = 64, chunk: int = 131072,
                             sdf_vgf=None) -> Dict[str, torch.Tensor]:
    """The other stage-2 target: n_lights fixed fibonacci-sphere light
    directions per point, every pair traced, the back-lit ones masked to
    zero.  Returns the keys of cal_indi_lgt with n_lights in place of 4."""
    P = surf.shape[0]
    lobes = torch.as_tensor(SG.fibonacci_sphere(n_lights), device=surf.device
                            ).to(surf.dtype)
    surf2l = lobes[None].expand(P, n_lights, 3)
    surf2l = surf2l / torch.linalg.norm(surf2l, dim=-1, keepdim=True)
    fl = (torch.einsum("ijk,ik->ij", surf2l, normal) > 0).to(surf.dtype)
    surf_flat = surf[:, None, :].expand(P, n_lights, 3).reshape(-1, 3)
    dirs_flat = surf2l.reshape(-1, 3)
    z_coarse = torch.linspace(0.1, 0.9, N_COARSE, device=surf.device,
                              dtype=surf.dtype).expand(P * n_lights,
                                                       N_COARSE)
    occu, rgb = _trace_targets(surf_flat, dirs_flat, z_coarse, sdf_fwd,
                               sdf_apply_full, sdf_grad, inv_s, color_fn,
                               chunk, sdf_vgf)
    occu = occu.reshape(P, n_lights)
    pre_lvis = lvis_fn(surf_flat, dirs_flat).reshape(P, n_lights) * fl
    return {
        "gt_lvis": torch.clamp((1.0 - occu) * fl, 0.0, 1.0),
        "pre_lvis": pre_lvis,
        "gt_trace_radiance": torch.clamp(
            rgb.reshape(P, n_lights, 3) * fl[..., None], 0.0, 1.0),
        "pre_trace_radiance": SG.query_sg_mixture(indirect_fn(surf), surf2l),
    }
