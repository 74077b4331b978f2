"""Vector math primitives of the surface branch and the SG shading of
stage 3: the sRGB curves, reflection, Smith G1, RGB to HSV and the
integrated directional encoding.  Counterpart of
factored_neus_tpu/ops/math.py (dot, l2_normalize, norm_axis, reflect,
smith_g1, linear_to_srgb, srgb_to_linear, rgb_to_hsv, generate_ide_fn)."""
from __future__ import annotations

import functools
import math as _pymath
from typing import Callable, Tuple

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
TINY = 1e-6


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


def norm_axis(x: torch.Tensor) -> torch.Tensor:
    """Normalise along the last axis with an additive epsilon (the SG
    convention)."""
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + TINY)


def smith_g1(cos_theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Smith G1 shadowing-masking term."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tan_theta = sin_theta / (cos_theta + 1e-10)
    root = alpha * tan_theta
    return 2.0 / (1.0 + torch.hypot(root, torch.ones_like(root)))


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB EOTF; input assumed in [0, 1]."""
    linear0 = 25.0 / 323.0 * srgb
    linear1 = torch.clamp((200.0 * srgb + 11.0) / 211.0,
                          min=F32_EPS) ** (12.0 / 5.0)
    return torch.where(srgb <= 0.04045, linear0, linear1)


def rgb_to_hsv(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RGB -> (h, s, v), each [..., 1].  Where channels tie at the maximum
    the later channel's hue wins (the selects run r, g, b)."""
    c_max = torch.amax(x, dim=-1, keepdim=True)
    c_min = torch.amin(x, dim=-1, keepdim=True)
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    v = c_max
    zero = torch.zeros_like(v)
    s = torch.where(v > 0, (v - c_min) / (v + 1e-6), zero)
    denom = v - c_min + 1e-6
    h = zero
    h = torch.where(v == r, 60.0 * (g - b) / denom, h)
    h = torch.where(v == g, 120.0 + 60.0 * (b - r) / denom, h)
    h = torch.where(v == b, 240.0 + 60.0 * (r - g) / denom, h)
    return h, s, v


# -- integrated directional encoding (Ref-NeRF) -------------------------------
# The coefficient tables are built in float64 with numpy and kept in f32; the
# complex Vandermonde product runs in real arithmetic.

def _generalized_binomial_coeff(a, k):
    return np.prod(a - np.arange(k)) / max(float(_pymath.factorial(k)), 1e-7)


def _assoc_legendre_coeff(l, m, k):
    return ((-1.0) ** m * 2.0 ** l * _pymath.factorial(l)
            / max(float(_pymath.factorial(k)), 1e-7)
            / max(float(_pymath.factorial(l - k - m)), 1e-7)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l, m, k):
    return (np.sqrt((2.0 * l + 1.0) * _pymath.factorial(l - m)
                    / max(4.0 * np.pi * _pymath.factorial(l + m), 1e-7))
            * _assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view: int) -> np.ndarray:
    """All (m, l) pairs of the encoding, [2, n]: l = 2^i for i < deg_view,
    m = 0 .. l."""
    ml = [(m, 2 ** i) for i in range(deg_view) for m in range(2 ** i + 1)]
    return np.array(ml).T


@functools.lru_cache(maxsize=None)
def ide_tables(deg_view: int):
    """(ml_array [2, n] int32, the Legendre coefficients [l_max + 1, n]
    f32, sigma [n] f32, l_max)."""
    ml_array = get_ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]), dtype=np.float64)
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    sigma = 0.5 * ml_array[1, :] * (ml_array[1, :] + 1)
    return (ml_array.astype(np.int32), mat.astype(np.float32),
            sigma.astype(np.float32), l_max)


def generate_ide_fn(deg_view: int
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Integrated directional encoding: fn(xyz [..., 3], kappa_inv [..., 1])
    -> [..., 2 n].  All of it in f32: the l = 8 Legendre columns cancel from
    O(100) coefficients down to O(0.1), so the z product is a plain f32
    matmul with TF32 off."""
    ml_array, mat, sigma, l_max = ide_tables(deg_view)

    def integrated_dir_enc_fn(xyz: torch.Tensor,
                              kappa_inv: torch.Tensor) -> torch.Tensor:
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        vmz = torch.cat([z ** i for i in range(l_max + 1)], -1)
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(y, x)
        m_f = torch.as_tensor(ml_array[0], dtype=xyz.dtype,
                              device=xyz.device)
        r_pow = r ** m_f
        vmxy_re = r_pow * torch.cos(m_f * theta)
        vmxy_im = r_pow * torch.sin(m_f * theta)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            zcomp = torch.matmul(vmz, torch.as_tensor(mat, dtype=xyz.dtype,
                                                      device=xyz.device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        atten = torch.exp(-torch.as_tensor(sigma, dtype=xyz.dtype,
                                           device=xyz.device) * kappa_inv)
        return torch.cat([vmxy_re * zcomp * atten, vmxy_im * zcomp * atten],
                         -1)

    return integrated_dir_enc_fn
