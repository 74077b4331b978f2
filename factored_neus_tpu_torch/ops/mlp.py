"""MLP building blocks.  Counterpart of factored_neus_tpu/ops/mlp.py.

Layers keep torch-native parameter shapes so reference ``.pth`` state dicts
map on directly:
  * plain dense: ``nn.Linear`` (weight [out, in], bias [out]);
  * weight-normed dense: ``WNLinear`` with ``weight_g`` [out, 1],
    ``weight_v`` [out, in] and ``bias`` [out], W = g v / ||v|| with the norm
    over the input axis (``nn.utils.weight_norm(dim=0)``'s parametrisation
    and state-dict names).

Initialisers take an explicit ``torch.Generator``.

The matmul mode (``FNEUS_MATMUL_PRECISION``, the JAX package's
``MATMUL_PRECISION``) sets the arithmetic of the field MLPs' products that
run on cuBLAS (``linear``, ``matmul``, ``Linear``), forward and backward:
  * unset, ``highest`` or ``float32``: f32, the port's default: plain
    ``torch.nn.functional.linear`` / ``torch.matmul``.
    (Unset in the JAX package means ``default``: one bf16 pass on a TPU.
    The port keeps f32 because its quality rule holds its default.)
  * ``default`` or ``bfloat16``: one bf16 pass, as a TPU runs XLA's
    DEFAULT precision: both operands rounded to bf16, the exact products
    summed in f32, an f32 output (JAX's ``preferred_element_type=f32``).
  * ``high``: three bf16 passes, as a TPU runs HIGH: each operand split
    into hi = bf16(x) and lo = bf16(x - hi), and hi hi + hi lo + lo hi
    summed in f32.
The rounded operands stay f32 tensors, so the products are f32 GEMMs on
bf16 values: exact whatever the TF32 flags say (a bf16 value is exact in
TF32), which this module never changes.  The backward's products take the
same mode, as XLA keeps a dot's precision in its transposes.  The mode is
read once at import; ``set_matmul_precision`` changes it in a process
(a captured step graph keeps the mode it was captured in, so
train.common.StepTrainer recaptures after a change).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
from torch import nn

from .tc_pack import bf16_round as round_bf16

# accepted FNEUS_MATMUL_PRECISION values -> the mode they select
MATMUL_MODES = {"highest": "f32", "float32": "f32", "default": "bf16",
                "bfloat16": "bf16", "high": "bf16x3"}


def matmul_mode_of(value: Optional[str]) -> str:
    """The mode ('f32', 'bf16' or 'bf16x3') that a FNEUS_MATMUL_PRECISION
    value selects; None (unset) selects f32.  Raises for any other value."""
    if value is None:
        return "f32"
    if value not in MATMUL_MODES:
        raise ValueError(f"FNEUS_MATMUL_PRECISION={value!r}: expected one of "
                         f"{', '.join(sorted(MATMUL_MODES))} (or unset)")
    return MATMUL_MODES[value]


MATMUL_PRECISION: Optional[str] = os.environ.get("FNEUS_MATMUL_PRECISION")
_MODE = matmul_mode_of(MATMUL_PRECISION)


def set_matmul_precision(p: Optional[str]) -> None:
    """Sets the matmul mode from a FNEUS_MATMUL_PRECISION value (None:
    unset, f32)."""
    global MATMUL_PRECISION, _MODE
    _MODE = matmul_mode_of(p)
    MATMUL_PRECISION = p


def matmul_mode() -> str:
    """The current matmul mode: 'f32', 'bf16' (one pass) or 'bf16x3'."""
    return _MODE


def one_pass() -> bool:
    """Whether the field MLPs' products run in one bf16 pass (the JAX
    step's arithmetic on a TPU), which also routes the ladder's sweeps to
    K2-bf16 and the radiance MLP to K3's bf16 operand mode."""
    return _MODE == "bf16"


def _mode_mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a [M, K] @ b [K, N] in ``mode`` ('bf16' or 'bf16x3'), f32 sums."""
    with torch.no_grad():
        ah, bh = round_bf16(a), round_bf16(b)
        if mode == "bf16":
            return ah @ bh
        al, bl = round_bf16(a - ah), round_bf16(b - bh)
        return (ah @ bl + al @ bh) + ah @ bh


class _ModeMM(torch.autograd.Function):
    """a @ b in a bf16 mode, with the backward's two products in the same
    mode; differentiable again (the eikonal loss differentiates the SDF's
    input gradient)."""

    @staticmethod
    def forward(ctx, a, b, mode: str):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return _mode_mm(a, b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _ModeMM.apply(g, b.t(), ctx.mode)
        if ctx.needs_input_grad[1]:
            gb = _ModeMM.apply(a.t(), g, ctx.mode)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] in the matmul mode (f32: torch.matmul)."""
    if _MODE == "f32":
        return torch.matmul(a, b)
    y = _ModeMM.apply(a.reshape(-1, a.shape[-1]), b, _MODE)
    return y.reshape(*a.shape[:-1], b.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T + b, w [out, in], in the matmul mode (f32:
    torch.nn.functional.linear)."""
    if _MODE == "f32":
        return nn.functional.linear(x, w, b)
    y = matmul(x, w.t())
    return y if b is None else y + b


def linear_act_bf16(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``dense_apply_act`` with act_dtype bf16: x and w
    rounded to bf16 (their gradients too), the product in the matmul
    mode, an f32 output."""
    return linear(round_bf16(x), round_bf16(w), b)


class Linear(nn.Linear):
    """nn.Linear whose product follows the matmul mode (``linear``); the
    same parameters and state-dict names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


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
        return linear(x, self.effective_weight(), self.bias)


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
