"""MLP building blocks.  Counterpart of factored_neus_tpu/ops/mlp.py.

Layers keep torch-native parameter shapes so reference ``.pth`` state dicts
map on directly:
  * plain dense: ``nn.Linear`` (weight [out, in], bias [out]);
  * weight-normed dense: ``WNLinear`` with ``weight_g`` [out, 1],
    ``weight_v`` [out, in] and ``bias`` [out], W = g v / ||v|| with the norm
    over the input axis (``nn.utils.weight_norm(dim=0)``'s parametrisation
    and state-dict names).

Initialisers take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class WNLinear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.in_features, self.out_features = d_in, d_out
        self.weight_g = nn.Parameter(torch.ones(d_out, 1))
        self.weight_v = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def set_weight(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """Weight-norm parameters that reproduce weight ``w`` [out, in]."""
        with torch.no_grad():
            self.weight_v.copy_(w)
            self.weight_g.copy_(torch.linalg.norm(w, dim=1, keepdim=True))
            self.bias.copy_(b)

    def effective_weight(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.weight_v * self.weight_v, dim=1,
                                    keepdim=True))
        return self.weight_v * (self.weight_g / torch.clamp(norm, min=1e-12))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.effective_weight(), self.bias)


def dense_init_(lin: nn.Module, gen: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias (the JAX
    package's dense_init; torch's nn.Linear default has the same bounds)."""
    d_out, d_in = lin.out_features, lin.in_features
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand(d_out, d_in, generator=gen) * 2 - 1) * bound
    b = (torch.rand(d_out, generator=gen) * 2 - 1) * bound
    if isinstance(lin, WNLinear):
        lin.set_weight(w, b)
    else:
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)


class _SoftplusBeta(torch.autograd.Function):
    """logaddexp(0, beta x) / beta with the derivative sigmoid(beta x)
    written out: torch's own logaddexp double backward gives inf/inf = NaN
    for large beta x, and the eikonal loss differentiates twice."""

    @staticmethod
    def forward(ctx, x, beta: float):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return torch.logaddexp(torch.zeros_like(x), beta * x) / beta

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.sigmoid(ctx.beta * x), None


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """logaddexp(0, beta x) / beta: stable for all x, no torch threshold."""
    return _SoftplusBeta.apply(x, beta)


def sdf_geometric_init_(layers: Sequence[WNLinear], dims: Sequence[int],
                        skip_in=(4,), d_in_raw: int = 3, bias: float = 0.5,
                        inside_outside: bool = False, multires: int = 6,
                        gen: Optional[torch.Generator] = None) -> None:
    """NeuS sphere initialisation of the SDF MLP (torch layout [out, in]):
      * last layer: N(+-sqrt(pi)/sqrt(fan_in), 1e-4), bias -+bias;
      * first layer with PE: raw-coordinate columns N(0, sqrt(2)/sqrt(out)),
        PE columns zero;
      * skip layers with PE: N(0, sqrt(2)/sqrt(out)) with the PE part of the
        concatenated input (its last dims[0]-d_in_raw columns) zeroed;
      * other layers: N(0, sqrt(2)/sqrt(out)), bias 0.
    """
    n_layers = len(layers)
    for l, lin in enumerate(layers):
        out_dim, in_dim = lin.out_features, lin.in_features
        if l == n_layers - 1:
            mean = math.sqrt(math.pi) / math.sqrt(in_dim)
            if inside_outside:
                mean = -mean
            w = mean + 1e-4 * torch.randn(out_dim, in_dim, generator=gen)
            b = torch.full((out_dim,), bias if inside_outside else -bias)
        else:
            std = math.sqrt(2.0) / math.sqrt(out_dim)
            if multires > 0 and l == 0:
                w = torch.zeros(out_dim, in_dim)
                w[:, :d_in_raw] = std * torch.randn(out_dim, d_in_raw,
                                                    generator=gen)
            else:
                w = std * torch.randn(out_dim, in_dim, generator=gen)
                if multires > 0 and l in skip_in:
                    w[:, -(dims[0] - d_in_raw):] = 0.0
            b = torch.zeros(out_dim)
        lin.set_weight(w, b)
