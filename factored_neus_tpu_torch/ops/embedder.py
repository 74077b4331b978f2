"""NeRF positional (frequency) encoding, ordered
``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`` with each block
covering all input dims.  Counterpart of factored_neus_tpu/ops/embedder.py.
"""
from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Encode the last axis of ``x`` with ``multires`` octaves;
    returns [..., d * (1 + 2 multires)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                  # [..., m, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
