"""Spherical-Gaussian (SG) helpers of the stage-2 secondary rays: sphere
points, the tangent frame and hemisphere directions around a normal, and
per-point SG mixture queries.  Counterpart of factored_neus_tpu/ops/sg.py
(fibonacci_sphere, tangent_frame, sample_dirs, query_sg_mixture).

An SG is 7 floats: lobe axis (3), sharpness lambda (1), amplitude mu (3),
G(v) = mu * exp(lambda * (dot(v, axis) - 1)).
"""
from __future__ import annotations

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
