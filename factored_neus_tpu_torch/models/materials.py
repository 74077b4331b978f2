"""Stage-3 materials and direct illumination: SG rendering with a learned
envmap.  Counterpart of factored_neus_tpu/models/materials.py:

  get_diffuse_visibility   Monte-Carlo visibility of each envmap lobe at
                           each point, from the frozen Lvis (its
                           factorised sweep, fields.Lvis.outer), no grad
  get_specular_visibility  the same around each point's BRDF lobe (kept
                           for parity: the stage-3 path does not call it)
  render_with_sg           the GGX NDF as a warped SG, Fresnel and Smith
                           G, the light SGs weighted by visibility
  render_with_all_sg       direct (the envmap) + indirect (per-point SGs)
  kl_divergence            the sparsity loss of the BRDF latent
  EnvmapMaterial           the 128-SG envmap, the BRDF auto-encoder and
                           the specular-albedo head; forward is the JAX
                           package's envmap_material_apply
  get_light                the envmap as an [H, W, 3] raster

The visibility draws are (u_theta, u_phi), each [M, nsamp] in [0, 1),
when given, else drawn from a torch.Generator.  Every network here is a
plain MLP on cuBLAS, as the JAX package leaves them to XLA.  State-dict
names follow the reference network (``lgtSGs``, ``brdf_encoder_layer``,
``brdf_decoder_layer``, ``net_cs``, the linears at even indices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops import math as U
from ..ops import sg as SG
from ..ops.embedder import positional_encoding
from ..ops import mlp as M
from ..ops.mlp import dense_init_
from .fields import Lvis

TINY = 1e-6


@dataclasses.dataclass(frozen=True)
class EnvmapMaterialConfig:
    num_lgt_sgs: int = 128
    specular_albedo: float = 0.02        # Fresnel F0
    latent_dim: int = 32
    multires_pts: int = 10
    multires_view: int = 4
    kl_rho: float = 0.05
    kl_weight: float = 0.01
    tonemap: str = "srgb"                # 'srgb' for DTU, 'none' linear
    vis_nsamp: int = 32

    @property
    def d_pts_enc(self) -> int:
        return 3 * (1 + 2 * self.multires_pts)

    @property
    def d_view_enc(self) -> int:
        return 3 * (1 + 2 * self.multires_view)


def _tonemap(x: torch.Tensor, mode: str) -> torch.Tensor:
    return U.linear_to_srgb(x) if mode == "srgb" else x


def _uniforms(shape, u_theta, u_phi, generator, device):
    if u_theta is None:
        u_theta = torch.rand(shape, generator=generator, device=device)
        u_phi = torch.rand(shape, generator=generator, device=device)
    return u_theta, u_phi


# -- Monte-Carlo visibility from the frozen Lvis ------------------------------

@torch.no_grad()
def get_diffuse_visibility(points: torch.Tensor, normals: torch.Tensor,
                           lvis: Lvis, lgt_sg_lobes: torch.Tensor,
                           lgt_sg_lambdas: torch.Tensor, nsamp: int = 8,
                           u_theta: Optional[torch.Tensor] = None,
                           u_phi: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """SG-weighted mean visibility of each lobe [M, 3] (sharpness [M, 1])
    at each point [P, 3] with normal [P, 3]: [M, P].  nsamp directions a
    lobe, within an angle of its axis that shrinks with its sharpness; a
    direction below a point's horizon counts as occluded."""
    n_lobe, n_points = lgt_sg_lobes.shape[0], points.shape[0]
    light_dirs = lgt_sg_lobes.detach()[:, None, :]                 # [M,1,3]
    lambdas = lgt_sg_lambdas.detach()[:, None, :]                  # [M,1,1]
    sharpness = lambdas[:, :, 0]                                   # [M,1]
    r_phi_range = torch.arccos(torch.clamp(
        (-1.95 * torch.min(sharpness)) / sharpness + 1.0, -1.0, 1.0))
    u_theta, u_phi = _uniforms((n_lobe, nsamp), u_theta, u_phi, generator,
                               points.device)
    r_theta = u_theta * 2.0 * math.pi
    r_phi = u_phi * r_phi_range
    sample_dir = SG.sample_dirs(light_dirs, r_theta, r_phi, x_ref_axis=2)
    flat = sample_dir.reshape(-1, 3)                               # [M S,3]
    pred = lvis.outer(points, flat)                                # [M S,P]
    cos_term = torch.matmul(flat, normals.T) > TINY
    vis = torch.where(cos_term, pred, torch.zeros((), device=pred.device))
    vis = vis.reshape(n_lobe, nsamp, n_points)
    weight = torch.exp(lambdas * (torch.sum(sample_dir * light_dirs, -1,
                                            keepdim=True) - 1.0))  # [M,S,1]
    return torch.sum(vis * weight, dim=1) / (torch.sum(weight, dim=1) + TINY)


@torch.no_grad()
def get_specular_visibility(points: torch.Tensor, normals: torch.Tensor,
                            viewdirs: torch.Tensor, lvis: Lvis,
                            sg_lobes: torch.Tensor, sg_lambdas: torch.Tensor,
                            nsamp: int = 24,
                            u_theta: Optional[torch.Tensor] = None,
                            u_phi: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Visibility of each point's BRDF lobe [P] (draws [P, nsamp]) around
    its reflected view direction.  A point whose weights sum to nothing
    (or overflow) keeps only its best-aligned sample."""
    n_points = points.shape[0]
    light_dirs = sg_lobes[:, None, :]
    lambdas = sg_lambdas[:, None, :]
    n_dot_v = torch.clamp(U.dot(normals, viewdirs), min=0.0)
    ref_dir = (-viewdirs + 2.0 * n_dot_v * normals)[:, None, :]
    sharpness = torch.clamp(lambdas[:, :, 0], 0.1, 50.0)
    r_phi_range = torch.arccos(torch.clamp(
        (-1.90 * torch.min(sharpness)) / sharpness + 1.0, -1.0, 1.0))
    u_theta, u_phi = _uniforms((n_points, nsamp), u_theta, u_phi, generator,
                               points.device)
    r_theta = u_theta * 2.0 * math.pi
    r_phi = u_phi * r_phi_range
    sample_dir = SG.sample_dirs(ref_dir, r_theta, r_phi, x_ref_axis=2)
    input_p = points[:, None].expand(n_points, nsamp, 3)
    cos_term = torch.sum(normals[:, None] * sample_dir, dim=-1) > TINY
    pred = lvis(input_p.reshape(-1, 3),
                sample_dir.reshape(-1, 3)).reshape(n_points, nsamp)
    vis = torch.where(cos_term, pred, torch.zeros((), device=pred.device))
    logw = sharpness * (torch.sum(sample_dir * light_dirs, -1) - 1.0)
    weight = torch.exp(logw)
    wsum = torch.sum(weight, dim=-1)
    degenerate = ~torch.isfinite(wsum) | (wsum <= TINY)
    onehot = nn.functional.one_hot(torch.argmax(logw, dim=-1),
                                   logw.shape[-1]).to(weight.dtype)
    weight = torch.where(degenerate[:, None], onehot, weight)
    return torch.sum(vis * weight, dim=-1) / (torch.sum(weight, dim=-1)
                                              + TINY)


# -- the SG rendering equation ------------------------------------------------

def render_with_sg(points, normal, viewdirs, lgt_sgs, specular_reflectance,
                   specular_albedo, roughness, diffuse_albedo,
                   comp_vis: bool = True, lvis: Optional[Lvis] = None,
                   vis_nsamp: int = 32, tonemap: str = "srgb",
                   u_theta: Optional[torch.Tensor] = None,
                   u_phi: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """SG shading of one light mixture per point, lgt_sgs [P, M, 7] (the
    envmap broadcast over the points, or per-point SGs); with comp_vis the
    light SGs are weighted by get_diffuse_visibility of the first point's
    mixture (the envmap's)."""
    P, Mn = normal.shape[0], lgt_sgs.shape[1]
    lobes = U.norm_axis(lgt_sgs[..., :3])
    lambdas = torch.abs(lgt_sgs[..., 3:4])
    origin_mus = torch.abs(lgt_sgs[..., -3:])

    normal_e = normal[:, None, :].expand(P, Mn, 3)
    viewdirs_e = viewdirs[:, None, :].expand(P, Mn, 3).detach()

    # the GGX NDF as an SG, warped about the view direction
    brdf_lobes = normal_e
    inv_r4 = 2.0 / (roughness ** 4)                               # [P,1]
    brdf_lambdas = inv_r4[:, None, :].expand(P, Mn, 1)
    brdf_mus = (inv_r4 / math.pi).expand(P, 3)[:, None, :].expand(P, Mn, 3)

    v_dot_lobe = torch.clamp(torch.sum(brdf_lobes * viewdirs_e, -1,
                                       keepdim=True), min=0.0)
    warp_lobes = U.norm_axis(2.0 * v_dot_lobe * brdf_lobes - viewdirs_e)
    warp_lambdas = brdf_lambdas / (4.0 * v_dot_lobe + TINY)

    new_half = U.norm_axis(warp_lobes + viewdirs_e)
    v_dot_h = torch.clamp(torch.sum(viewdirs_e * new_half, -1, keepdim=True),
                          min=0.0)
    spec_refl = specular_reflectance[:, None, :].expand(P, Mn, 3)
    fresnel = spec_refl + (1.0 - spec_refl) * torch.pow(
        2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)

    dot1 = torch.clamp(torch.sum(warp_lobes * normal_e, -1, keepdim=True),
                       min=0.0)
    dot2 = torch.clamp(torch.sum(viewdirs_e * normal_e, -1, keepdim=True),
                       min=0.0)
    k_g = ((roughness + 1.0) ** 2 / 8.0)[:, None, :]
    g1 = dot1 / (dot1 * (1.0 - k_g) + k_g + TINY)
    g2 = dot2 / (dot2 * (1.0 - k_g) + k_g + TINY)
    moi = fresnel * g1 * g2 / (4.0 * dot1 * dot2 + TINY)
    warp_mus = specular_albedo[:, None, :] * brdf_mus * moi

    vis_shadow = torch.zeros((P, 3), dtype=normal.dtype, device=normal.device)
    if comp_vis:
        light_vis = get_diffuse_visibility(
            points, normal, lvis, lobes[0], lambdas[0], nsamp=vis_nsamp,
            u_theta=u_theta, u_phi=u_phi, generator=generator)     # [M,P]
        light_vis = light_vis.T[:, :, None].expand(P, Mn, 3)
        lgt_mus = origin_mus * light_vis
        vis_shadow = torch.mean(light_vis, dim=1)
    else:
        lgt_mus = origin_mus

    final_lobes, final_lambdas, final_mus = SG.lambda_trick(
        lobes, lambdas, lgt_mus, warp_lobes, warp_lambdas, warp_mus)
    specular_linear = SG.integrate_rgb(normal_e, final_lobes, final_lambdas,
                                       final_mus)
    diffuse = (diffuse_albedo / math.pi)[:, None, :].expand(P, Mn, 3)
    diffuse_linear = SG.integrate_rgb(normal_e, lobes, lambdas,
                                      lgt_mus * diffuse)

    zero = torch.zeros((), dtype=normal.dtype, device=normal.device)
    clip = lambda x: torch.clamp(x, 0.0, 1.0)
    return {
        "specular_loss": zero,
        "diffuse_loss": zero,
        "env_rgb": clip(specular_linear + diffuse_linear),
        "diffuse_rgb": clip(_tonemap(diffuse_linear, tonemap)),
        "specular_rgb": clip(_tonemap(specular_linear, tonemap)),
        "lvis_mean": vis_shadow,
    }


def render_with_all_sg(points, normal, viewdirs, lgt_sgs,
                       specular_reflectance, specular_albedo, roughness,
                       diffuse_albedo, lvis: Optional[Lvis] = None,
                       indir_lgt_sgs: Optional[torch.Tensor] = None,
                       vis_nsamp: int = 32, tonemap: str = "srgb",
                       u_theta: Optional[torch.Tensor] = None,
                       u_phi: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """Direct light (the envmap lgt_sgs [M, 7], with visibility) plus
    indirect light (per-point SGs [P, L, 7], none when not given)."""
    P, Mn = normal.shape[0], lgt_sgs.shape[0]
    ret = render_with_sg(points, normal, viewdirs,
                         lgt_sgs[None].expand(P, Mn, 7),
                         specular_reflectance, specular_albedo, roughness,
                         diffuse_albedo, comp_vis=True, lvis=lvis,
                         vis_nsamp=vis_nsamp, tonemap=tonemap,
                         u_theta=u_theta, u_phi=u_phi, generator=generator)
    indir_rgb = torch.zeros_like(points)
    if indir_lgt_sgs is not None:
        indir_rgb = render_with_sg(
            points, normal, viewdirs, indir_lgt_sgs, specular_reflectance,
            specular_albedo, roughness, diffuse_albedo, comp_vis=False,
            tonemap=tonemap)["env_rgb"]
    env_rgb = ret["env_rgb"]
    clip = lambda x: torch.clamp(_tonemap(x, tonemap), 0.0, 1.0)
    ret.update({"rgb": clip(env_rgb + indir_rgb), "indir_rgb": clip(indir_rgb),
                "env_rgb": clip(env_rgb)})
    return ret


def kl_divergence(rho: float, raw_latent: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL sparsity loss on the mean sigmoid activation of each latent; with
    ``mask`` [N] the mean runs over the hit rays only, and a batch without
    a hit gives 0."""
    act = torch.sigmoid(raw_latent)
    if mask is None:
        rho_hat = torch.mean(act, dim=0)
        n_hit = torch.ones((), dtype=act.dtype, device=act.device)
    else:
        m = mask.to(act.dtype)[:, None]
        n_hit = torch.sum(m)
        rho_hat = torch.sum(act * m, dim=0) / torch.clamp(n_hit, min=1.0)
    # a saturated latent would take log(0)
    rho_hat = torch.clamp(rho_hat, 1e-6, 1.0 - 1e-6)
    kl = torch.mean(rho * torch.log(rho / rho_hat)
                    + (1.0 - rho) * torch.log((1.0 - rho) / (1.0 - rho_hat)))
    return torch.where(n_hit > 0, kl, torch.zeros_like(kl))


# -- EnvmapMaterial -----------------------------------------------------------

def _leaky_mlp(dims: List[int], gen: torch.Generator,
               last: Optional[nn.Module] = None) -> nn.Sequential:
    """Linears dims[0] -> ... -> dims[-1] at the even indices (their
    products in the matmul mode, ops/mlp.py), leaky ReLU (0.2) between
    them and ``last`` after the last one."""
    mods: List[nn.Module] = []
    for i in range(len(dims) - 1):
        lin = M.Linear(dims[i], dims[i + 1])
        dense_init_(lin, gen)
        mods.append(lin)
        if i < len(dims) - 2:
            mods.append(nn.LeakyReLU(0.2))
    if last is not None:
        mods.append(last)
    return nn.Sequential(*mods)


def init_lgt_sgs(num_lgt_sgs: int, gen: torch.Generator) -> torch.Tensor:
    """The envmap's init [M, 7]: white amplitudes scaled so that the total
    energy is 0.8 x 2 pi, sharpness 10 + |20 N(0, 1)|, and the Fibonacci
    sphere's M / 2 points as the lobes of both halves."""
    sgs = torch.randn(num_lgt_sgs, 7, generator=gen)
    sgs[:, -2:] = sgs[:, -3:-2]
    sgs[:, 3:4] = 10.0 + torch.abs(sgs[:, 3:4] * 20.0)
    energy = SG.compute_energy(sgs)
    sgs[:, 4:] = (torch.abs(sgs[:, 4:]) / torch.sum(energy, 0, keepdim=True)
                  * 2.0 * math.pi * 0.8)
    lobes = torch.from_numpy(SG.fibonacci_sphere(num_lgt_sgs // 2)).float()
    sgs[:num_lgt_sgs // 2, :3] = lobes
    sgs[num_lgt_sgs // 2:, :3] = lobes
    return sgs


class EnvmapMaterial(nn.Module):
    """The stage-3 network: ``lgtSGs`` [M, 7], the BRDF encoder (PE(10) of
    the point -> 4 x 512 -> latent 32, leaky ReLU), the decoder (sigmoid
    latent -> 2 x 128 -> 4: diffuse albedo and roughness) and ``net_cs``
    (PE of the point and of the reflected view direction -> 4 x 256 -> 1,
    sigmoid: the specular albedo)."""

    def __init__(self, cfg: EnvmapMaterialConfig = EnvmapMaterialConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.lgtSGs = nn.Parameter(init_lgt_sgs(cfg.num_lgt_sgs, gen))
        self.brdf_encoder_layer = _leaky_mlp(
            [cfg.d_pts_enc, 512, 512, 512, 512, cfg.latent_dim], gen)
        self.brdf_decoder_layer = _leaky_mlp([cfg.latent_dim, 128, 128, 4],
                                             gen)
        self.net_cs = _leaky_mlp([cfg.d_pts_enc + cfg.d_view_enc, 256, 256,
                                  256, 256, 1], gen, nn.Sigmoid())

    def forward(self, points: torch.Tensor, ray_dirs: torch.Tensor,
                n: torch.Tensor, indi_lgt_sgs: Optional[torch.Tensor],
                lvis: Lvis, hit_mask: Optional[torch.Tensor] = None,
                u_theta: Optional[torch.Tensor] = None,
                u_phi: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The stage-3 forward of P surface points seen along ray_dirs
        with normals n: the shading maps, the BRDF maps and the KL
        encoder loss (over ``hit_mask``'s rays)."""
        cfg = self.cfg
        n = U.norm_axis(n)
        view_dirs = -U.norm_axis(ray_dirs)
        ref_dirs = U.reflect(view_dirs, n)
        pts_enc = positional_encoding(points, cfg.multires_pts)
        ref_enc = positional_encoding(ref_dirs, cfg.multires_view)

        raw_latent = self.brdf_encoder_layer(pts_enc)
        brdf = torch.sigmoid(self.brdf_decoder_layer(torch.sigmoid(
            raw_latent)))
        roughness = brdf[..., 3:] * 0.9 + 0.09
        diffuse_albedo = brdf[..., :3]
        encoder_loss = cfg.kl_weight * kl_divergence(cfg.kl_rho, raw_latent,
                                                     mask=hit_mask)
        specular_albedo = self.net_cs(torch.cat([pts_enc, ref_enc], -1)
                                      ).repeat(1, 3)
        spec_refl = torch.full((points.shape[0], 3), cfg.specular_albedo,
                               dtype=points.dtype, device=points.device)

        ret = render_with_all_sg(points, n, view_dirs, self.lgtSGs, spec_refl,
                                 specular_albedo, roughness, diffuse_albedo,
                                 lvis=lvis, indir_lgt_sgs=indi_lgt_sgs,
                                 vis_nsamp=cfg.vis_nsamp, tonemap=cfg.tonemap,
                                 u_theta=u_theta, u_phi=u_phi,
                                 generator=generator)
        clip = lambda x: torch.clamp(_tonemap(x, cfg.tonemap), 0.0, 1.0)
        ret.update({
            "roughness": roughness,
            "diffuse_albedo": clip(diffuse_albedo),
            "specular_albedo": clip(specular_albedo),
            "encoder_loss": encoder_loss,
            "smooth_loss": torch.zeros((), dtype=points.dtype,
                                       device=points.device),
        })
        return ret


def get_light(material: EnvmapMaterial, H: int = 256, W: int = 512
              ) -> torch.Tensor:
    """The learned envmap rasterised to [H, W, 3]."""
    return SG.compute_envmap(material.lgtSGs, H, W)
