"""Stage-1 neural fields as ``nn.Module``s with torch-native parameter
shapes.  Counterpart of factored_neus_tpu/models/fields.py:

  SDFNetwork              value_sweep (K2) and value_grad_feat (K1)
  RenderingNetwork        IDR-mode radiance MLP
  SingleVarianceNetwork   inv_s = exp(10 * variance)
  RefColor                surface reflection colour (diffuse + specular)

State-dict names follow the reference networks (``lin{l}.weight_g`` ...,
``net_cd.{0,2,4,6,8}``, ``viewdir_mlp.{i}``, ``net_cs.0``), so a reference
``.pth`` maps on directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops import geometry_kernel as GK
from ..ops import math as U
from ..ops import sdf_kernel as SK
from ..ops.embedder import positional_encoding
from ..ops.mlp import WNLinear, dense_init_, sdf_geometric_init_


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


class SDFNetwork(nn.Module):
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

    def layers(self) -> List[WNLinear]:
        return [getattr(self, f"lin{l}") for l in range(self.num_layers - 1)]

    def effective_weights(self) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
        """Per-layer [out, in] weights (weight norm applied, differentiable
        in g and v) and biases."""
        ls = self.layers()
        return [l.effective_weight() for l in ls], [l.bias for l in ls]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, d_out] = [sdf / scale | feature] (plain PyTorch)."""
        ws, bs = self.effective_weights()
        return SK.sdf_forward_plain(ws, bs, self.cfg, x)

    def value_sweep(self, x: torch.Tensor) -> torch.Tensor:
        """sdf [N] for the no-grad sampling sweeps, through K2 with the last
        layer narrowed to the sdf column (weight norm is per output row, so
        the narrowed row computes the same sdf)."""
        with torch.no_grad():
            ws, bs = self.effective_weights()
            ws = ws[:-1] + [ws[-1][:1]]
            bs = bs[:-1] + [bs[-1][:1]]
            return SK.sdf_forward(ws, bs, self.cfg, x)[:, 0]

    def value_grad_feat(self, x: torch.Tensor):
        """(sdf [N], feature [N, d_out-1], grad [N, 3]) through K1."""
        ws, bs = self.effective_weights()
        out, grad = GK.geometry(ws, bs, x, self.cfg)
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


class RenderingNetwork(nn.Module):
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

    def forward(self, points, normals, view_dirs, feature_vectors):
        cfg = self.cfg
        if cfg.multires_view > 0:
            view_dirs = positional_encoding(view_dirs, cfg.multires_view)
        if cfg.mode == "idr":
            x = torch.cat([points, view_dirs, normals, feature_vectors], -1)
        elif cfg.mode == "no_view_dir":
            x = torch.cat([points, normals, feature_vectors], -1)
        elif cfg.mode == "no_normal":
            x = torch.cat([points, view_dirs, feature_vectors], -1)
        else:
            raise ValueError(cfg.mode)
        n = self.num_layers - 1
        for l in range(n):
            x = getattr(self, f"lin{l}")(x)
            if l < n - 1:
                x = torch.relu(x)
        return torch.sigmoid(x) if cfg.squeeze_out else x


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
    lin = nn.Linear(d_in, d_out)
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
