"""K2: fused positional encoding + SDF MLP forward without gradient
(csrc/sdf_fwd.cu), and its plain PyTorch twin.

Counterpart of factored_neus_tpu/ops/pallas_sdf.py (sdf_forward_pallas).
It serves the no-grad SDF sweeps of the up-sampling ladder, where the
caller narrows the last layer to the sdf column (fields.SDFNetwork.
value_sweep).  The wrapper runs the plain twin for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.

The kernels take EFFECTIVE weights in torch layout ([out, in], weight norm
already applied) and biases; the layer structure comes from the weights'
shapes and the SDF config (positional encoding, skip layers, scale).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from . import _cuda
from .embedder import positional_encoding
from .mlp import softplus_beta

SDF_FWD = _cuda.CudaKernel("sdf_fwd", "sdf_fwd.cu", "sdf_fwd")
TILE = 64
ENC_LD = 64
MAX_WIDTH = 288


def layer_dims(cfg, ws: Sequence[torch.Tensor]
               ) -> Tuple[List[int], List[int], int]:
    """(ins, outs, skip_mask) of the network, checked against the shapes
    the kernels can run."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    skip_mask = 0
    for l in cfg.skip_in:
        if 0 <= l < len(ws):
            skip_mask |= 1 << l
    if cfg.d_in != 3 or ins[0] != cfg.d_embed or skip_mask & 1:
        raise ValueError("SDF kernels take 3-d points, a positional "
                         "encoding and no skip into layer 0")
    for l in range(1, len(ws)):
        want = outs[l - 1] + (cfg.d_embed if (skip_mask >> l) & 1 else 0)
        if ins[l] != want:
            raise ValueError(f"layer {l}: input {ins[l]} != {want}")
    if max(ins + outs) > MAX_WIDTH or cfg.d_embed > ENC_LD:
        raise ValueError(f"SDF kernels take widths <= {MAX_WIDTH}")
    return ins, outs, skip_mask


def kernel_iargs(cfg, ws, n: int, grid: int) -> Tuple[List[int], int]:
    ins, outs, skip_mask = layer_dims(cfg, ws)
    ld = int(math.ceil(max(ins + outs) / 4.0) * 4)
    iargs = [len(ws), cfg.multires, cfg.d_embed, ld, skip_mask, n, grid,
             *ins, *outs]
    return iargs, ld


def sdf_forward_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                      cfg, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, d_out] = [sdf / scale | feature], the kernels' math in
    plain PyTorch (fields.sdf_apply of the JAX package)."""
    enc = x * cfg.scale
    if cfg.multires > 0:
        enc = positional_encoding(enc, cfg.multires)
    h = enc
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in cfg.skip_in:
            h = torch.cat([h, enc], dim=-1) * inv_sqrt2
        h = torch.nn.functional.linear(h, w, b)
        if l < len(ws) - 1:
            h = softplus_beta(h, 100.0)
    return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)


def _launch(ws, bs, cfg, x: torch.Tensor) -> torch.Tensor:
    dev = x.device
    x = x.detach().contiguous()
    wT = [w.detach().t().contiguous() for w in ws]
    bs = [b.detach().contiguous() for b in bs]
    _cuda.check_cuda_tensors("sdf_forward", [x, *wT, *bs])
    n = x.shape[0]
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"sdf_forward: x must be [N, 3], got {tuple(x.shape)}")
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n == 0:
        return out
    iargs, _ = kernel_iargs(cfg, ws, n, 0)
    SDF_FWD.launch(iargs, [x, out, *wT, *bs], cfg.scale, dev)
    return out


def sdf_forward(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
                x: torch.Tensor) -> torch.Tensor:
    """No-grad SDF forward: K2 on a CUDA tensor, the plain twin on a CPU
    tensor.  The result carries no gradient."""
    if x.is_cuda:
        return _launch(ws, bs, cfg, x)
    if x.device.type == "cpu":
        with torch.no_grad():
            return sdf_forward_plain(ws, bs, cfg, x)
    raise ValueError(f"sdf_forward: unsupported device {x.device}")
