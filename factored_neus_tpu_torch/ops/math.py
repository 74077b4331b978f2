"""Vector math primitives of the stage-1 surface branch.  Counterpart of
factored_neus_tpu/ops/math.py (linear_to_srgb, reflect, l2_normalize)."""
from __future__ import annotations

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def l2_normalize(x: torch.Tensor, eps: float = F32_EPS) -> torch.Tensor:
    return x * torch.sqrt(1.0 / torch.clamp(
        torch.sum(x * x, dim=-1, keepdim=True), min=eps))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2.0 * dot(d, n) * n - d


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """sRGB OETF; input assumed in [0, 1]."""
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=F32_EPS) ** (5.0 / 12.0)
             - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)
