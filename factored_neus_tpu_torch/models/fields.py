"""Stage-1 neural fields as ``nn.Module``s with torch-native parameter
shapes.  Counterpart of factored_neus_tpu/models/fields.py:

  SDFNetwork              value_sweep (K2) and value_grad_feat (K1), on
                          the weight packs of a step (kernel_weights),
                          each also in the bf16 operand mode
  RenderingNetwork        IDR-mode radiance MLP (K3, also in the bf16
                          operand mode), on the packs of a step
                          (kernel_weights)
  SingleVarianceNetwork   inv_s = exp(10 * variance)
  RefColor                surface reflection colour (diffuse + specular)
  NeRF                    NeRF++ background model of the womask configs
  Lvis                    stage-2 light visibility of (point, direction),
                          and its factorised sweep over every (direction,
                          point) pair for stage 3 (outer)
  IndirectLight           stage-2 per-point mixture of SGs

State-dict names follow the reference networks (``lin{l}.weight_g`` ...,
``net_cd.{0,2,4,6,8}``, ``viewdir_mlp.{i}``, ``net_cs.0``,
``pts_linears.{i}``, ``views_linears.0``, ``lvis.{0,2,4,6,8}``,
``indi.{0,2,4,6,8}``), so a reference ``.pth`` maps on
directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops import geometry_kernel as GK
from ..ops import math as U
from ..ops import radiance_kernel as RK
from ..ops import sdf_kernel as SK
from ..ops import tc_pack as TP
from ..ops.embedder import positional_encoding
from ..ops import mlp as M
from ..ops.mlp import (WNLinear, dense_init_, sdf_geometric_init_,
                       softplus_beta)


def _on_card(t: torch.Tensor) -> bool:
    """Whether kernel_weights builds the kernels' packs for weights on
    t's device (a CUDA device; the CPU twins read none)."""
    return t.is_cuda


_Slabs = Optional[Tuple[torch.Tensor, TP.SweepLayout]]


class KernelWeights(NamedTuple):
    """kernel_weights' result: the effective weights and biases, and the
    packs the kernels read, each None where it was not built.  Who reads
    which:
      sweep16  the forward bf16 slab pack: K2-bf16 and every bf16 K1
               kernel (SDF), K3-fwd-bf16 and K3-bwd-bf16 (radiance)
      rev16    the reverse bf16 slab pack: every bf16 K1 kernel,
               K3-bwd-bf16
      sweep32  the forward f32 slab pack: K2 and every f32 K1 kernel
               (SDF), K3-fwd and K3-bwd (radiance)
      rev32    the reverse f32 slab pack: every f32 K1 kernel, K3-bwd
    (every K1 kernel: K1-fwd, K1-bwd, K1-bwd-split, K1-fwd-stash and
    K1-bwd-stash, or their bf16 variants)"""
    ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    sweep16: _Slabs = None     # the forward bf16 slab pack
    rev16: _Slabs = None       # the reverse bf16 slab pack
    sweep32: _Slabs = None     # the forward f32 slab pack
    rev32: _Slabs = None       # the reverse f32 slab pack


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def d_embed(self) -> int:
        return (self.d_in * (1 + 2 * self.multires) if self.multires > 0
                else self.d_in)

    @property
    def dims(self) -> Tuple[int, ...]:
        return ((self.d_embed,) + (self.d_hidden,) * self.n_layers
                + (self.d_out,))


class _WNLayers(nn.Module):
    """A stack of weight-normed layers lin0 .. lin{num_layers - 2}, handed
    to the kernels as effective weights."""

    def layers(self) -> List[WNLinear]:
        return [getattr(self, f"lin{l}") for l in range(self.num_layers - 1)]

    def effective_weights(self) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
        """Per-layer [out, in] weights (weight norm applied, differentiable
        in g and v) and biases."""
        ls = self.layers()
        return [l.effective_weight() for l in ls], [l.bias for l in ls]

    def kernel_weights(self) -> KernelWeights:
        """KernelWeights: the effective weights and biases, differentiable
        in g, v and b; the subclasses add, on a CUDA device, the packs
        their kernels read (SDFNetwork.kernel_weights,
        RenderingNetwork.kernel_weights).  Built once a step, or once a
        validation image, a stage-2/3 run or a mesh, they serve every
        launch on these weights."""
        ws, bs = self.effective_weights()
        return KernelWeights(ws, bs)


def sweep_pack(weights: KernelWeights, bf16: bool):
    """The slab pack that K2 (bf16: K2-bf16) reads: sweep32 (sweep16)."""
    return weights.sweep16 if bf16 else weights.sweep32


def bwd_slabs(weights: KernelWeights, bf16: bool):
    """The two slab packs that the operand mode's wgmma kernels read
    (every bf16 K1 kernel or K3-bwd-bf16: sweep16, rev16; every f32 K1
    kernel or K3-bwd: sweep32, rev32), or None where they were not
    built."""
    if bf16:
        return ((weights.sweep16, weights.rev16)
                if weights.rev16 is not None else None)
    return ((weights.sweep32, weights.rev32)
            if weights.rev32 is not None else None)


class SDFNetwork(_WNLayers):
    """PE -> softplus(beta=100) MLP with skip concat / sqrt(2) -> [sdf | feat].

    Layer l maps dims[l] -> dims[l+1], minus d_embed when layer l+1 is a
    skip layer, so the concat with the encoding lands back at dims[l+1]."""

    def __init__(self, cfg: SDFConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.weight_norm:
            raise NotImplementedError("the port's SDF network is weight-normed")
        self.cfg = cfg
        dims = cfg.dims
        self.num_layers = len(dims)
        for l in range(len(dims) - 1):
            out_dim = dims[l + 1] - (dims[0] if (l + 1) in cfg.skip_in else 0)
            setattr(self, f"lin{l}", WNLinear(dims[l], out_dim))
        if cfg.geometric_init:
            sdf_geometric_init_(self.layers(), dims, skip_in=cfg.skip_in,
                                d_in_raw=cfg.d_in, bias=cfg.bias,
                                inside_outside=cfg.inside_outside,
                                multires=cfg.multires, gen=gen)
        else:
            for lin in self.layers():
                dense_init_(lin, gen)

    def forward(self, x: torch.Tensor, act_bf16: bool = False
                ) -> torch.Tensor:
        """[N, 3] -> [N, d_out] = [sdf / scale | feature] in plain PyTorch,
        differentiable twice: the JAX package's sdf_apply, its products in
        the matmul mode (ops/mlp.py); ``act_bf16``: its act_dtype bf16
        (each product's operands rounded to bf16, the hidden activations
        stored in bf16, the skip input rounded again after the
        1/sqrt(2))."""
        cfg = self.cfg
        ws, bs = self.effective_weights()
        lin = M.linear_act_bf16 if act_bf16 else M.linear
        enc = x * cfg.scale
        if cfg.multires > 0:
            enc = positional_encoding(enc, cfg.multires)
        h = enc
        inv_sqrt2 = 1.0 / math.sqrt(2.0)
        for l, (w, b) in enumerate(zip(ws, bs)):
            if l in cfg.skip_in:
                h = torch.cat([h, enc], dim=-1) * inv_sqrt2
            h = lin(h, w, b)
            if l < len(ws) - 1:
                h = softplus_beta(h, 100.0)
                if act_bf16:
                    h = M.round_bf16(h)
        return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)

    def value_grad_feat_autograd(self, x: torch.Tensor,
                                 act_bf16: bool = False):
        """(sdf [N], feature [N, d_out-1], grad [N, 3]) from ``forward``
        with the input gradient by torch.autograd.grad, kept
        differentiable where grad is enabled (the eikonal loss): the JAX
        package's XLA path, sdf_value_and_grad_feat, which
        FNEUS_PALLAS_GEOMETRY=0 selects in place of K1 on either device.
        Not K1's twin (geometry_kernel.geometry_plain)."""
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            out = self.forward(x, act_bf16)
            (grad,) = torch.autograd.grad(out[:, 0].sum(), x,
                                          create_graph=create)
        if not create:
            out = out.detach()
        return out[:, 0], out[:, 1:], grad

    def kernel_weights(self, bf16: bool = False, f32: bool = True,
                       sweep_bf16: bool = False, k1: bool = True
                       ) -> KernelWeights:
        """_WNLayers.kernel_weights and on a CUDA device, without grad, the
        packs of the kernels that will run on these weights (``bf16``: K1
        in the bf16 operand mode):
        - sweep32 (sdf_kernel.make_sweep_pack(bf16=False),
          tc_pack.pack_sweep_f32) wherever K2 runs in f32 (``f32``: the
          ladder outside use_pallas_sampling, the localisation sweep, the
          grid fill; in either operand mode of the core) or K1 does;
        - rev32 (tc_pack.pack_rev_f32; with sweep32
          geometry_kernel.make_bwd_slabs(bf16=False)) wherever K1 runs in
          f32 (``k1`` in the f32 mode), with or without grad and under
          either switch: every f32 K1 kernel reads both;
        - sweep16 (make_sweep_pack, tc_pack.pack_sweep_bf16) for K2-bf16
          (``sweep_bf16``) and, with rev16 (tc_pack.pack_rev_bf16;
          geometry_kernel.make_bwd_slabs), wherever K1 runs in the bf16
          mode (``k1`` with ``bf16``), with or without grad and under
          either switch: every bf16 K1 kernel reads both.
        ``k1`` False: for the sweeps alone (value_sweep, the grid fill)."""
        kw = super().kernel_weights()
        if not _on_card(kw.ws[0]):
            return kw
        ws, cfg = kw.ws, self.cfg
        wg16, wg32 = bf16 and k1, not bf16 and k1
        with torch.no_grad():
            if wg32:
                sweep32, rev32 = GK.make_bwd_slabs(cfg, ws, bf16=False)
                kw = kw._replace(sweep32=sweep32, rev32=rev32)
            elif f32:
                kw = kw._replace(
                    sweep32=SK.make_sweep_pack(cfg, ws, bf16=False))
            if sweep_bf16 or wg16:
                kw = kw._replace(sweep16=SK.make_sweep_pack(cfg, ws))
            if wg16:
                kw = kw._replace(rev16=TP.pack_rev_bf16(ws, cfg.d_embed))
        return kw

    def value_sweep(self, x: torch.Tensor,
                    weights: Optional[KernelWeights] = None,
                    bf16: bool = False) -> torch.Tensor:
        """sdf [N] for the no-grad sampling sweeps and the grid fill,
        through K2 (``bf16``: K2-bf16) with the last layer narrowed to the
        sdf column (weight norm is per output row, so the narrowed row
        computes the same sdf); ``weights``: kernel_weights(), when the
        caller already has them (the pack of the mode is built here when
        theirs has none)."""
        with torch.no_grad():
            weights = weights or self.kernel_weights(f32=not bf16,
                                                     sweep_bf16=bf16,
                                                     k1=False)
            ws, bs = weights.ws, weights.bs
            ws = list(ws[:-1]) + [ws[-1][:1]]
            bs = list(bs[:-1]) + [bs[-1][:1]]
            return SK.sdf_forward(ws, bs, self.cfg, x,
                                  sweep_pack(weights, bf16), bf16)[:, 0]

    def value_grad_feat(self, x: torch.Tensor,
                        weights: Optional[KernelWeights] = None,
                        bf16: bool = False):
        """(sdf [N], feature [N, d_out-1], grad [N, 3]) through K1, in its
        bf16 operand mode when ``bf16``; ``weights``: kernel_weights(bf16),
        when the caller already has them."""
        weights = weights or self.kernel_weights(bf16, f32=not bf16)
        out, grad = GK.geometry(weights.ws, weights.bs, x, self.cfg,
                                bf16=bf16, slabs=bwd_slabs(weights, bf16))
        return out[:, 0], out[:, 1:], grad


@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    d_feature: int = 256
    mode: str = "idr"
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True

    @property
    def d_view(self) -> int:
        return (3 * (1 + 2 * self.multires_view) if self.multires_view > 0
                else 3)

    @property
    def dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            d0 += self.d_view - 3
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


class RenderingNetwork(_WNLayers):
    def __init__(self, cfg: RenderingConfig,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.weight_norm:
            raise NotImplementedError("the port's radiance MLP is weight-normed")
        self.cfg = cfg
        dims = cfg.dims
        self.num_layers = len(dims)
        for l in range(len(dims) - 1):
            lin = WNLinear(dims[l], dims[l + 1])
            dense_init_(lin, gen)
            setattr(self, f"lin{l}", lin)

    def forward(self, points, normals, view_dirs, feature_vectors,
                weights: Optional[KernelWeights] = None, bf16: bool = False):
        """rgb [N, d_out] through K3 (ops/radiance_kernel.py), in its bf16
        operand mode (K3-fwd-bf16, K3-bwd-bf16) when ``bf16``; ``weights``:
        kernel_weights(bf16, f32=not bf16), when the caller already has
        them."""
        weights = weights or self.kernel_weights(bf16, f32=not bf16)
        return RK.radiance(weights.ws, weights.bs, self.cfg, points,
                           normals, view_dirs, feature_vectors,
                           sweep_pack(weights, bf16), bf16,
                           slabs=bwd_slabs(weights, bf16))

    def kernel_weights(self, bf16: bool = False, f32: bool = True
                       ) -> KernelWeights:
        """_WNLayers.kernel_weights and, on a CUDA device in mode 'idr',
        without grad, the slab packs of the radiance kernels: the mode's
        forward pack (radiance_kernel.make_fwd_pack), with or without grad:
        in the bf16 mode K3-fwd-bf16's (sweep16), with ``f32`` in the f32
        mode K3-fwd's (sweep32); where a backward can follow (grad enabled
        and, in the f32 mode, a parameter requiring it) the two of the
        mode's wgmma backward (radiance_kernel.make_bwd_slabs, whose first
        is the forward pack): K3-bwd's (sweep32, rev32) or K3-bwd-bf16's
        (sweep16, rev16)."""
        kw = super().kernel_weights()
        if self.cfg.mode != "idr" or not _on_card(kw.ws[0]):
            return kw
        grad = torch.is_grad_enabled() and (bf16 or any(
            p.requires_grad for p in self.parameters()))
        with torch.no_grad():
            if grad and bf16:
                sweep16, rev16 = RK.make_bwd_slabs(self.cfg, kw.ws, True)
                kw = kw._replace(sweep16=sweep16, rev16=rev16)
            elif bf16:
                kw = kw._replace(
                    sweep16=RK.make_fwd_pack(self.cfg, kw.ws, bf16=True))
            elif grad and f32:
                sweep32, rev32 = RK.make_bwd_slabs(self.cfg, kw.ws, False)
                kw = kw._replace(sweep32=sweep32, rev32=rev32)
            elif f32 and not bf16:
                kw = kw._replace(sweep32=RK.make_fwd_pack(self.cfg, kw.ws))
        return kw


class SingleVarianceNetwork(nn.Module):
    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val)))

    def inv_s(self) -> torch.Tensor:
        """inv_s = exp(10 * variance), a scalar."""
        return torch.exp(self.variance * 10.0)


@dataclasses.dataclass(frozen=True)
class RefColorConfig:
    d_feature: int = 256
    multires_view: int = 4

    @property
    def d_view_enc(self) -> int:
        return 3 * (1 + 2 * self.multires_view)

    @property
    def d_cd_in(self) -> int:       # [pts(3), PE(n), feat]
        return 3 + self.d_view_enc + self.d_feature

    @property
    def d_cs_in(self) -> int:       # [n(3), pts(3), PE(ref), feat]
        return 6 + self.d_view_enc + self.d_feature


def _linear(d_in: int, d_out: int, gen) -> nn.Linear:
    """A Linear whose product follows the matmul mode (ops/mlp.py)."""
    lin = M.Linear(d_in, d_out)
    dense_init_(lin, gen)
    return lin


class RefColor(nn.Module):
    """(pts, feat, dirs, n) -> {rgb, specular_rgb, diffuse_rgb} in sRGB,
    clipped.  The reference's viewdir re-concat branch never fires with 4
    layers, so viewdir_mlp is the effective straight 4-layer ReLU stack."""

    def __init__(self, cfg: RefColorConfig = RefColorConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        cd = [cfg.d_cd_in, 256, 256, 256, 256, 3]
        mods: List[nn.Module] = []
        for i in range(5):
            mods.append(_linear(cd[i], cd[i + 1], gen))
            mods.append(nn.ReLU() if i < 4 else nn.Sigmoid())
        self.net_cd = nn.Sequential(*mods)
        vd = [cfg.d_cs_in, 256, 256, 256, 256]
        self.viewdir_mlp = nn.ModuleList(
            [_linear(vd[i], vd[i + 1], gen) for i in range(4)])
        self.net_cs = nn.Sequential(_linear(256, 1, gen))

    def forward(self, pts, feat, dirs, n) -> Dict[str, torch.Tensor]:
        mv = self.cfg.multires_view
        normals = U.l2_normalize(n)
        n_enc = positional_encoding(n, mv)
        ref_enc = positional_encoding(U.reflect(-dirs, normals), mv)
        diffuse = self.net_cd(torch.cat([pts, n_enc, feat], -1))
        x = torch.cat([n, pts, ref_enc, feat], -1)
        for layer in self.viewdir_mlp:
            x = torch.relu(layer(x))
        specular = torch.sigmoid(self.net_cs(x)).repeat(1, 3)
        brdf = specular + diffuse
        srgb = lambda v: torch.clamp(U.linear_to_srgb(v), 0.0, 1.0)
        return {"rgb": srgb(brdf), "specular_rgb": srgb(specular),
                "diffuse_rgb": srgb(diffuse)}


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: Tuple[int, ...] = (4,)

    @property
    def input_ch(self) -> int:
        # multires = 0 is the identity encoding: d_in channels
        return (self.d_in * (1 + 2 * self.multires) if self.multires > 0
                else self.d_in)

    @property
    def input_ch_view(self) -> int:
        return (self.d_in_view * (1 + 2 * self.multires_view)
                if self.multires_view > 0 else self.d_in_view)


class NeRF(nn.Module):
    """(pts4 [N, 4], dirs [N, 3]) -> (density [N, 1], rgb [N, 3]), both raw
    (the renderer applies softplus and sigmoid).  A plain ReLU MLP on
    cuBLAS, as the JAX package leaves it to XLA, its products in the
    matmul mode.  The skip is the reference NeRF's: after layer i in
    ``skips``, relu then concat [encoded pts, h], with no 1/sqrt(2)
    (unlike the SDF network's).  ``act_bf16``: the JAX package's
    act_dtype bf16 (nerf_apply; FNEUS_NERF_ACT_BF16 under core_act_bf16):
    the hidden layers' operands and activations in bf16, the density and
    rgb heads on f32 operands."""

    def __init__(self, cfg: NeRFConfig = NeRFConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        W, c = cfg.W, cfg.input_ch
        self.pts_linears = nn.ModuleList(
            [_linear(c, W, gen)] +
            [_linear(W + c if i in cfg.skips else W, W, gen)
             for i in range(cfg.D - 1)])
        self.views_linears = nn.ModuleList(
            [_linear(cfg.input_ch_view + W, W // 2, gen)])
        self.feature_linear = _linear(W, W, gen)
        self.alpha_linear = _linear(W, 1, gen)
        self.rgb_linear = _linear(W // 2, 3, gen)

    def forward(self, input_pts, input_views, act_bf16: bool = False):
        pts_e = positional_encoding(input_pts, self.cfg.multires)
        views_e = positional_encoding(input_views, self.cfg.multires_view)
        if act_bf16:
            store = M.round_bf16
            apply = lambda l, h: M.linear_act_bf16(h, l.weight, l.bias)
        else:
            store = lambda h: h
            apply = lambda l, h: l(h)
        h = pts_e
        for i, lin in enumerate(self.pts_linears):
            h = store(torch.relu(apply(lin, h)))
            if i in self.cfg.skips:
                h = torch.cat([store(pts_e), h], -1)
        alpha = self.alpha_linear(h)
        h = torch.cat([apply(self.feature_linear, h), views_e], -1)
        h = store(torch.relu(apply(self.views_linears[0], h)))
        return alpha, self.rgb_linear(h)


def _relu_mlp(dims: Tuple[int, ...], gen, last: Optional[nn.Module] = None
              ) -> nn.Sequential:
    """Linear layers dims[0] -> ... -> dims[-1] with ReLU between them and
    ``last`` after the last one; the linears sit at the even indices."""
    mods: List[nn.Module] = []
    for i in range(len(dims) - 1):
        mods.append(_linear(dims[i], dims[i + 1], gen))
        if i < len(dims) - 2:
            mods.append(nn.ReLU())
    if last is not None:
        mods.append(last)
    return nn.Sequential(*mods)


@dataclasses.dataclass(frozen=True)
class LvisConfig:
    multires_pts: int = 10
    multires_view: int = 4

    @property
    def d_in(self) -> int:
        return 3 * (1 + 2 * self.multires_pts) + 3 * (1 + 2 * self.multires_view)


class Lvis(nn.Module):
    """(pts [N, 3], dirs [N, 3]) -> visibility [N, 1]: the two encodings,
    a 4x256 ReLU MLP, then 256 -> 1 and the sigmoid.  A plain MLP on
    cuBLAS, as the JAX package leaves it to XLA, its products in the
    matmul mode."""

    def __init__(self, cfg: LvisConfig = LvisConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.lvis = _relu_mlp((cfg.d_in, 256, 256, 256, 256, 1), gen,
                              nn.Sigmoid())

    def forward(self, pts: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
        return self.lvis(torch.cat(
            [positional_encoding(pts, self.cfg.multires_pts),
             positional_encoding(view, self.cfg.multires_view)], -1))

    def outer(self, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """Visibility of every (direction, point) pair: pts [P, 3], dirs
        [D, 3] -> [D, P].  The encodings and the first layer run on the
        two factors, split by the first layer's input columns, and meet in
        a broadcast add, bias and ReLU as [D P, 256]; layers 2-5 and the
        sigmoid run on that.  The same function as the flat forward on
        the D P pairs, up to the order of the first layer's sums.  Every
        product follows the matmul mode; in a bf16 mode the two halves of
        the first layer's weight and the two encodings are rounded apart,
        as the JAX package's lvis_apply_outer rounds them."""
        with torch.autograd.profiler.record_function("Lvis.outer"):
            lins = [m for m in self.lvis if isinstance(m, nn.Linear)]
            pe_p = positional_encoding(pts, self.cfg.multires_pts)
            pe_d = positional_encoding(dirs, self.cfg.multires_view)
            dp = pe_p.shape[-1]
            w1 = lins[0].weight
            a_p = M.matmul(pe_p, w1[:, :dp].T)                  # [P, H]
            a_d = M.matmul(pe_d, w1[:, dp:].T)                  # [D, H]
            x = torch.relu(a_d[:, None, :] + a_p[None, :, :] + lins[0].bias)
            x = x.reshape(-1, x.shape[-1])
            for lin in lins[1:-1]:
                x = M.linear(x, lin.weight, lin.bias).relu_()
            x = M.linear(x, lins[-1].weight, lins[-1].bias)
            return torch.sigmoid(x).reshape(dirs.shape[0], pts.shape[0])


@dataclasses.dataclass(frozen=True)
class IndirectLightConfig:
    num_lgt_sgs: int = 24
    multires_pts: int = 10

    @property
    def d_in(self) -> int:
        return 3 * (1 + 2 * self.multires_pts)


class IndirectLight(nn.Module):
    """pts [N, 3] -> num_lgt_sgs SGs [N, L, 7] (axis 3, sharpness 1,
    amplitude 3): the encoding, a 4x512 ReLU MLP, then 512 -> 6 L; the
    axis from two sigmoid angles, sharpness 30 sigmoid + 0.1, amplitude
    ReLU.  A plain MLP on cuBLAS, its products in the matmul mode."""

    def __init__(self, cfg: IndirectLightConfig = IndirectLightConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.indi = _relu_mlp((cfg.d_in, 512, 512, 512, 512,
                               cfg.num_lgt_sgs * 6), gen)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        out = self.indi(positional_encoding(pts, self.cfg.multires_pts))
        out = out.reshape(-1, self.cfg.num_lgt_sgs, 6)
        angles = torch.sigmoid(out[..., :2]) * (2.0 * math.pi)
        theta, phi = angles[..., 0:1], angles[..., 1:2]
        axis = torch.cat([torch.cos(theta) * torch.sin(phi),
                          torch.sin(theta) * torch.sin(phi),
                          torch.cos(phi)], -1)
        sharpness = torch.sigmoid(out[..., 2:3]) * 30.0 + 0.1
        amplitude = torch.relu(out[..., 3:6])
        return torch.cat([axis, sharpness, amplitude], -1)
