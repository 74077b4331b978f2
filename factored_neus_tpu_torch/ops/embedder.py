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


def positional_encoding_vjp(x: torch.Tensor, r: torch.Tensor,
                            multires: int) -> torch.Tensor:
    """The cotangent of ``x`` [N, d] from that of its encoding, ``r``
    [N, d * (1 + 2 multires)]: r's identity block plus, per octave f,
    f (r_sin cos(f x) - r_cos sin(f x))."""
    d = x.shape[-1]
    ct = r[..., :d]
    for i in range(multires):
        f = 2.0 ** i
        o = d * (1 + 2 * i)
        ct = ct + f * (r[..., o:o + d] * torch.cos(f * x)
                       - r[..., o + d:o + 2 * d] * torch.sin(f * x))
    return ct
