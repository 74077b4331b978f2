"""NeuS stage-1 renderer, with the NeRF++ background model when
n_outside > 0 (the womask configs), the stage-2 light-visibility renderer
on the frozen stage-1 networks and the stage-3 material renderer on the
frozen stage-1 and stage-2 networks.  Counterpart of
factored_neus_tpu/models/renderer.py (render, render_core,
render_core_outside, _stage23_util, lvis_render, mate_illu_render).

The surface branch keeps the JAX package's static-shape form: RefColor runs
for every ray at the two samples bracketing the first SDF sign change and
the result is blended in where the ray has a crossing, which gives the
reference's masked-gather results.  SDF value, feature and gradient come
from K1 (ops/geometry_kernel.py), or from its HBM-stash pair under
FNEUS_PG_HBM_STASH=1; the up-sampling ladder's SDF sweeps from K2
(ops/sdf_kernel.py); the radiance MLP from K3 (ops/radiance_kernel.py).
Under FNEUS_CORE_ACT_BF16=1 (``RendererConfig.core_act_bf16``; the render
core only, as in the JAX package) K1 and K3 run in their bf16 operand
mode.  The background NeRF is a plain MLP on cuBLAS, as the JAX package
leaves it to XLA.

Stage 2 runs every SDF, geometry and radiance evaluation without gradient
on the frozen stage-1 networks (one set of packs a run,
``Stage2Model.kernel_weights``): per step K2 five times (the ladder's four
sweeps and the localisation sweep), the secondary coarse sweep once, on
K2-bf16 under ``sweep_act_bf16`` (the default, as in the JAX package) and
on K2 otherwise, K1-fwd three times (the surface normals, the secondary
fine sweep, the secondary surface points) and K3-fwd once (the first-hit
colour).  Lvis and IndirectLight, the networks it trains, are plain MLPs
on cuBLAS.

Stage 3 runs K2 five times a step (the ladder's four sweeps and the
localisation sweep) and K1-fwd once (the surface points' feature and
normal), on the same frozen packs, and no backward kernel: the gradient
reaches only EnvmapMaterial, through cuBLAS MLPs and the SG shading.

``use_pallas_sampling`` (off by default, as in the JAX package) puts every
sweep that the JAX package's _sdf_fwd_sampling serves on K2-bf16: the
ladder's four in every stage and stage 2's coarse sweep.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import math as U
from ..ops import sampling as S
from . import fields as F
from . import secondary as SEC
from .materials import EnvmapMaterial, EnvmapMaterialConfig
from .secondary import first_crossing, section_geometry


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
    nerf: F.NeRFConfig = F.NeRFConfig()
    lvis: F.LvisConfig = F.LvisConfig()
    indirect: F.IndirectLightConfig = F.IndirectLightConfig()
    material: EnvmapMaterialConfig = EnvmapMaterialConfig()
    # rows of a chunk of the CPU twins' secondary sweeps (one launch on the
    # card)
    secondary_chunk: int = 131072
    # route the no-grad SDF sweeps (the ladder's, in every stage, and stage
    # 2's secondary coarse sweep) through K2-bf16, the port of the JAX
    # package's Pallas sweep (pallas_sdf, single-pass bf16 products: the
    # sdf error only nudges where importance samples land); off by
    # default, as in the JAX package.  FNEUS_PALLAS_SAMPLING=1 turns it on
    # for a CLI run (the port's switch, read at import: no conf sets it)
    use_pallas_sampling: bool = os.environ.get("FNEUS_PALLAS_SAMPLING",
                                               "0") == "1"
    # stage 2's secondary coarse sweep (1,048,576 rows a step, which only
    # places the fine samples) on bf16 operands, on K2-bf16, as the JAX
    # package's stage-2 step runs it by default (its XLA path stores the
    # sweep's activations in bf16, rounding the skip input twice where
    # the kernel rounds it once).  FNEUS_SWEEP_ACT_BF16=0 turns it off for
    # a CLI run (the port's switch, read at import)
    sweep_act_bf16: bool = os.environ.get("FNEUS_SWEEP_ACT_BF16",
                                          "1") == "1"
    # one geometry sweep for both stage-2 fine-sample targets (else
    # compute_weight and cal_fir_hit_rgb sweep apart)
    fused_fine_sweep: bool = True
    # the stage-1 render core in the bf16 operand mode, as the JAX
    # package's core_act_bf16: K1 (the SDF, feature and gradient, and its
    # backward) on pallas_geometry's bf16 bodies and K3 (the radiance MLP
    # and its backward) where the JAX step rounds the radiance MLP's
    # activations (act_dtype); read from FNEUS_CORE_ACT_BF16 like the JAX
    # package's.  The ladder's sweeps stay as use_pallas_sampling says
    core_act_bf16: bool = os.environ.get("FNEUS_CORE_ACT_BF16", "0") == "1"

    @property
    def n_total(self) -> int:
        return self.n_samples + self.n_importance


class Stage1Model(nn.Module):
    """The networks stage 1 trains (the JAX params groups nerf, sdf,
    variance, color and ref_color).  The background NeRF is always held, as
    in the JAX package, so checkpoints of every conf carry its group; where
    n_outside = 0 it gets no gradient and Adam leaves it as it is."""

    GROUPS = ("sdf", "color", "variance", "ref_color", "nerf")

    def __init__(self, cfg: RendererConfig, variance_init_val: float = 0.3,
                 seed: int = 0, device="cpu"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.sdf = F.SDFNetwork(cfg.sdf, gen)
        self.variance = F.SingleVarianceNetwork(variance_init_val)
        self.color = F.RenderingNetwork(cfg.rendering, gen)
        self.ref_color = F.RefColor(cfg.refcolor, gen)
        self.nerf = F.NeRF(cfg.nerf, gen)
        self.to(device)

    def kernel_weights(self, bf16: bool = False, sweep_bf16: bool = False
                       ) -> Tuple[F.KernelWeights, F.KernelWeights]:
        """The SDF network's and the radiance MLP's kernel weights, with
        the packs that their kernels read on a CUDA device: ``bf16``, the
        render core in its bf16 mode (K1's and K3's bf16 packs); with
        ``sweep_bf16`` the ladder's sweeps on K2-bf16 (the SDF network's
        bf16 slab pack, sweep16), else on K2 (its f32 slab pack, sweep32);
        with ``bf16``, with or without grad, K1-fwd-bf16's and
        K1-bwd-bf16's two bf16 slab packs (geometry_kernel.make_bwd_slabs,
        sweep16 and rev16: K2-bf16 reads the first,
        fields.SDFNetwork.kernel_weights) and K3-fwd-bf16's
        (radiance_kernel.make_fwd_pack(bf16=True), sweep16) and, where a
        backward can follow, K3-bwd-bf16's (radiance_kernel.make_bwd_slabs,
        whose first is K3-fwd-bf16's,
        fields.RenderingNetwork.kernel_weights); without ``bf16``, K1-fwd's
        and K1-bwd's two f32 slab packs (geometry_kernel.make_bwd_slabs(
        bf16=False), sweep32 and rev32, with or without grad: K1-fwd and K2
        read the first), K3-fwd's (radiance_kernel.make_fwd_pack, sweep32)
        and, where a backward can follow, K3-bwd's
        (radiance_kernel.make_bwd_slabs(bf16=False), whose first is
        K3-fwd's).  Every K1 kernel, the stash pair included, reads the
        mode's two slab packs; no mma.sync pack exists.  Built once a step
        by ``render``, or once a validation image by its caller."""
        return (self.sdf.kernel_weights(bf16, f32=not (bf16 and sweep_bf16),
                                        sweep_bf16=sweep_bf16),
                self.color.kernel_weights(bf16, f32=not bf16))


def sampling_sweep(sdf_net: F.SDFNetwork, cfg: RendererConfig,
                   weights: F.KernelWeights, coarse: bool = False):
    """sdf_fwd for a no-grad sampling sweep, with the JAX package's
    precedence (_sdf_fwd_sampling): K2-bf16 under use_pallas_sampling;
    else K2-bf16 for the stage-2 coarse sweep (``coarse``) under
    sweep_act_bf16; else K2."""
    bf16 = cfg.use_pallas_sampling or (coarse and cfg.sweep_act_bf16)
    return lambda p: sdf_net.value_sweep(p, weights, bf16)


def render_core_outside(model: Stage1Model, cfg: RendererConfig, rays_o,
                        rays_d, z_vals, sample_dist: float,
                        background_rgb=None) -> Dict[str, Any]:
    """NeRF++ inverted-sphere background over [B, T] samples."""
    B, T = z_vals.shape
    dists, _, pts = section_geometry(rays_o, rays_d, z_vals, sample_dist)
    dis_to_center = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True),
                                1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], -1)
    dirs = rays_d[:, None, :].expand(B, T, 3)
    density, color = model.nerf(pts4.reshape(-1, 4), dirs.reshape(-1, 3))
    sampled_color = torch.sigmoid(color).reshape(B, T, 3)
    alpha = 1.0 - torch.exp(
        -torch.nn.functional.softplus(density.reshape(B, T)) * dists)
    weights = S.alpha_to_weights(alpha)
    color_out = torch.sum(weights[:, :, None] * sampled_color, dim=1)
    if background_rgb is not None:
        color_out = color_out + background_rgb * (
            1.0 - torch.sum(weights, -1, keepdim=True))
    return {"color": color_out, "sampled_color": sampled_color,
            "alpha": alpha, "weights": weights}


def render_core(model: Stage1Model, cfg: RendererConfig, rays_o, rays_d,
                z_vals, sample_dist: float, background_alpha=None,
                background_sampled_color=None, background_rgb=None,
                cos_anneal_ratio: float = 0.0,
                sdf_weights: Optional[F.KernelWeights] = None,
                color_weights: Optional[F.KernelWeights] = None
                ) -> Dict[str, Any]:
    """SDF + radiance + surface colour over [B, T] samples, composited
    with the background model's [B, T + n_outside] alpha and colour when
    they are given; ``sdf_weights`` and ``color_weights``: the SDF
    network's and the radiance MLP's kernel_weights(), when the caller
    already has them."""
    B, T = z_vals.shape
    dists, mid_z, pts = section_geometry(rays_o, rays_d, z_vals, sample_dist)
    dirs = rays_d[:, None, :].expand(pts.shape)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)

    sdf, feature, gradients = model.sdf.value_grad_feat(
        pts_flat, sdf_weights, bf16=cfg.core_act_bf16)
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

    sampled_color = model.color(pts_flat, gradients, dirs_flat, feature,
                                color_weights, cfg.core_act_bf16
                                ).reshape(B, T, 3)

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

    if background_alpha is not None:
        outside = 1.0 - inside_sphere
        alpha = torch.cat([alpha * inside_sphere
                           + background_alpha[:, :T] * outside,
                           background_alpha[:, T:]], -1)
        sampled_color = torch.cat(
            [sampled_color * inside_sphere[:, :, None]
             + background_sampled_color[:, :T] * outside[:, :, None],
             background_sampled_color[:, T:]], 1)

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
           cos_anneal_ratio: float = 0.0, perturb_overwrite: float = -1.0,
           t_rand_out: Optional[torch.Tensor] = None,
           weights: Optional[Tuple[F.KernelWeights, F.KernelWeights]] = None
           ) -> Dict[str, Any]:
    """Stage-1 renderer.  The per-ray z jitter is ``t_rand`` [B, 1] in
    [-0.5, 0.5) when given, else drawn from ``generator`` when given, else
    none (deterministic); with n_outside > 0 the background samples'
    stratified jitter is ``t_rand_out`` [B, n_outside] in [0, 1), drawn in
    the same way.  ``weights``: model.kernel_weights(), when the caller
    renders many chunks on one set of weights; built here if not."""
    B, n_out = rays_o.shape[0], cfg.n_outside
    if t_rand_out is not None and tuple(t_rand_out.shape) != (B, n_out):
        raise ValueError(f"t_rand_out must be [{B}, {n_out}] (n_outside), "
                         f"got {tuple(t_rand_out.shape)}")
    dev, dt = rays_o.device, rays_o.dtype
    sample_dist = 2.0 / cfg.n_samples
    z_lin = torch.linspace(0.0, 1.0, cfg.n_samples, device=dev, dtype=dt)
    z_vals = near + (far - near) * z_lin[None, :]
    if n_out > 0:
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out,
                               device=dev, dtype=dt)
        z_vals_outside = z_out[None].expand(B, n_out)
    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0:
        if t_rand is None and generator is not None:
            t_rand = torch.rand((B, 1), generator=generator, device=dev) - 0.5
        if t_rand is not None:
            z_vals = z_vals + t_rand * 2.0 / cfg.n_samples
        if n_out > 0:
            if t_rand_out is None and generator is not None:
                t_rand_out = torch.rand((B, n_out), generator=generator,
                                        device=dev)
            if t_rand_out is not None:
                mids = 0.5 * (z_out[1:] + z_out[:-1])
                upper = torch.cat([mids, z_out[-1:]])
                lower = torch.cat([z_out[:1], mids])
                z_vals_outside = lower[None] + (upper - lower)[None] * \
                    t_rand_out
    if n_out > 0:
        z_vals_outside = (far / torch.flip(z_vals_outside, [-1])
                          + 1.0 / cfg.n_samples)

    # the SDF weight packs, for the ladder's sweeps (K2) and K1, and the
    # radiance pack for K3, once a step (or a validation image)
    sdf_weights, color_weights = weights or model.kernel_weights(
        cfg.core_act_bf16, cfg.use_pallas_sampling)
    if cfg.n_importance > 0:
        z_vals = S.hierarchical_z_vals(
            sampling_sweep(model.sdf, cfg, sdf_weights), rays_o.detach(),
            rays_d.detach(), z_vals.detach(), cfg.n_importance,
            cfg.up_sample_steps)

    background_alpha = background_sampled_color = None
    if n_out > 0:
        z_feed, _ = torch.sort(torch.cat([z_vals, z_vals_outside], -1), -1)
        ret_out = render_core_outside(model, cfg, rays_o, rays_d, z_feed,
                                      sample_dist)
        background_alpha = ret_out["alpha"]
        background_sampled_color = ret_out["sampled_color"]

    ret = render_core(model, cfg, rays_o, rays_d, z_vals, sample_dist,
                      background_alpha=background_alpha,
                      background_sampled_color=background_sampled_color,
                      background_rgb=background_rgb,
                      cos_anneal_ratio=cos_anneal_ratio,
                      sdf_weights=sdf_weights, color_weights=color_weights)
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


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------

class Stage2Model(nn.Module):
    """The stage-1 networks, frozen (``stage1``, requires_grad off), and
    the two networks stage 2 trains: Lvis and IndirectLight (the JAX
    params groups lvis and indirect)."""

    GROUPS = Stage1Model.GROUPS + ("lvis", "indirect")

    def __init__(self, cfg: RendererConfig, variance_init_val: float = 0.3,
                 seed: int = 0, device="cpu"):
        super().__init__()
        self.stage1 = Stage1Model(cfg, variance_init_val, seed=seed,
                                  device=device)
        self.stage1.requires_grad_(False)
        gen = torch.Generator().manual_seed(seed + 1)
        self.lvis = F.Lvis(cfg.lvis, gen)
        self.indirect = F.IndirectLight(cfg.indirect, gen)
        self.to(device)
        self._packs: Optional[Tuple[Any, Tuple]] = None

    def kernel_weights(self, bf16: bool = False, sweep_bf16: bool = False
                       ) -> Tuple[F.KernelWeights, F.KernelWeights]:
        """The frozen SDF network's and radiance MLP's kernel weights
        (Stage1Model.kernel_weights' packs; ``sweep_bf16``: with the SDF
        network's slab pack, for the sweeps on K2-bf16), built once and
        kept until a stage-1 parameter changes (a checkpoint or bridge load
        writes into them) or moves, or other packs are asked for."""
        key = (tuple((p.data_ptr(), p._version)
                     for p in self.stage1.parameters()), bf16, sweep_bf16)
        if self._packs is None or self._packs[1] != key:
            with torch.no_grad():
                self._packs = (self.stage1.kernel_weights(bf16, sweep_bf16),
                               key)
        return self._packs[0]


def _stage23_util(model: Stage1Model, cfg: RendererConfig, rays_o, rays_d,
                  near, far, sdf_weights: F.KernelWeights):
    """The ladder without jitter, then the sdf at its mid-points for surface
    localisation: (mid_z [B, T], sdf [B, T], inside_mask [B])."""
    B = rays_o.shape[0]
    z_lin = torch.linspace(0.0, 1.0, cfg.n_samples, device=rays_o.device,
                           dtype=rays_o.dtype)
    z_vals = near + (far - near) * z_lin[None, :]
    if cfg.n_importance > 0:
        z_vals = S.hierarchical_z_vals(
            sampling_sweep(model.sdf, cfg, sdf_weights), rays_o, rays_d,
            z_vals, cfg.n_importance, cfg.up_sample_steps)
    _, mid_z, pts = section_geometry(rays_o, rays_d, z_vals,
                                     2.0 / cfg.n_samples)
    # the localisation sweep stays f32 in every mode, as in the JAX package
    sdf = model.sdf.value_sweep(pts.reshape(-1, 3),
                                sdf_weights).reshape(B, -1)
    inside_mask = torch.sum(torch.linalg.norm(pts, dim=-1) < 1.0, -1) > 0
    return mid_z, sdf, inside_mask


def lvis_render(model: Stage2Model, cfg: RendererConfig, rays_o, rays_d,
                near, far, u_theta: Optional[torch.Tensor] = None,
                u_z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """Stage 2: the surface point of each ray, then the distillation
    targets of its secondary rays (secondary.cal_indi_lgt) and the
    predictions of Lvis and IndirectLight, which alone carry gradient.
    Rays without a surface hit carry ones on both sides.  The hemisphere
    draws are u_theta, u_z [B, 4] in [0, 1) when given, else drawn from
    ``generator``."""
    geo = model.stage1
    sdf_w, color_w = model.kernel_weights(
        sweep_bf16=cfg.use_pallas_sampling or cfg.sweep_act_bf16)
    with torch.no_grad():
        mid_z, sdf, inside_mask = _stage23_util(geo, cfg, rays_o, rays_d,
                                                near, far, sdf_w)
        pts_surf, _, sdf_mask = SEC.surface_localize(mid_z, sdf, rays_o,
                                                     rays_d, inside_mask)
        n_surf = geo.sdf.value_grad_feat(pts_surf, sdf_w)[2]
        inv_s = torch.clamp(geo.variance.inv_s(), 1e-6, 1e6)

    def vgf(p):
        return geo.sdf.value_grad_feat(p, sdf_w)

    def full(p):
        s, f, _ = vgf(p)
        return torch.cat([s[:, None], f], -1)

    res = SEC.cal_indi_lgt(
        pts_surf, n_surf, sampling_sweep(geo.sdf, cfg, sdf_w), full,
        lambda p: vgf(p)[2], inv_s,
        lambda p, n, d, f: geo.color(p, n, d, f, color_w),
        lambda p, d: model.lvis(p, d), model.indirect, u_theta=u_theta,
        u_z=u_z, generator=generator, chunk=cfg.secondary_chunk,
        sdf_fwd_coarse=sampling_sweep(geo.sdf, cfg, sdf_w, coarse=True),
        sdf_vgf=vgf if cfg.fused_fine_sweep else None)
    one = torch.ones((), dtype=rays_o.dtype, device=rays_o.device)
    m1, m2 = sdf_mask[:, None], sdf_mask[:, None, None]
    return {
        "gt_lvis": torch.where(m1, res["gt_lvis"], one),
        "pre_lvis": torch.where(m1, res["pre_lvis"], one),
        "gt_trace_radiance": torch.where(m2, res["gt_trace_radiance"], one),
        "pre_trace_radiance": torch.where(m2, res["pre_trace_radiance"],
                                          one),
        "sdf_mask": sdf_mask,
    }


# ---------------------------------------------------------------------------
# Stage 3
# ---------------------------------------------------------------------------

class Stage3Model(Stage2Model):
    """The stage-1 networks and Lvis and IndirectLight, all frozen
    (requires_grad off), and the network stage 3 trains: EnvmapMaterial
    (the JAX params group material)."""

    GROUPS = Stage2Model.GROUPS + ("material",)

    def __init__(self, cfg: RendererConfig, variance_init_val: float = 0.3,
                 seed: int = 0, device="cpu"):
        super().__init__(cfg, variance_init_val, seed=seed, device=device)
        self.lvis.requires_grad_(False)
        self.indirect.requires_grad_(False)
        gen = torch.Generator().manual_seed(seed + 2)
        self.material = EnvmapMaterial(cfg.material, gen).to(device)


def mate_illu_render(model: Stage3Model, cfg: RendererConfig, rays_o,
                     rays_d, near, far,
                     u_theta: Optional[torch.Tensor] = None,
                     u_phi: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Any]:
    """Stage 3: the surface point of each ray on the frozen geometry (the
    ladder's four K2 sweeps and the localisation sweep, then K1-fwd once
    for its feature and normal), RefColor's specular map in linear space
    (the supervision maps), IndirectLight's SGs there, and EnvmapMaterial's
    forward, which alone carries gradient.  Rays without a surface hit
    carry ones in every map.  The visibility draws are u_theta, u_phi
    [num_lgt_sgs, vis_nsamp] in [0, 1) when given, else drawn from
    ``generator``."""
    geo = model.stage1
    sdf_w, _ = model.kernel_weights(sweep_bf16=cfg.use_pallas_sampling)
    with torch.no_grad():
        mid_z, sdf, inside_mask = _stage23_util(geo, cfg, rays_o, rays_d,
                                                near, far, sdf_w)
        pts_surf, _, sdf_mask = SEC.surface_localize(mid_z, sdf, rays_o,
                                                     rays_d, inside_mask)
        _, f_surf, n_surf = geo.sdf.value_grad_feat(pts_surf, sdf_w)
        ref = geo.ref_color(pts_surf, f_surf, rays_d, n_surf)
        diffuse_srgb = ref["diffuse_rgb"]
        specular_linear = U.srgb_to_linear(ref["specular_rgb"])
        indi = model.indirect(pts_surf)
    out = model.material(pts_surf, rays_d, n_surf, indi, model.lvis,
                         hit_mask=sdf_mask, u_theta=u_theta, u_phi=u_phi,
                         generator=generator)
    m = sdf_mask[:, None]
    one = torch.ones((), dtype=rays_o.dtype, device=rays_o.device)
    mask1 = lambda x: torch.where(m, x, one)
    ret = {k: mask1(out[k]) for k in (
        "rgb", "env_rgb", "indir_rgb", "diffuse_albedo", "specular_albedo",
        "diffuse_rgb", "specular_rgb", "roughness", "lvis_mean")}
    ret.update({k: out[k] for k in ("diffuse_loss", "specular_loss",
                                    "encoder_loss", "smooth_loss")})
    ret.update(sdf_mask=sdf_mask,
               gt_specular_linear=mask1(specular_linear),
               gt_diffuse_srgb=mask1(diffuse_srgb), n_out=mask1(n_surf))
    return ret
