"""K1: the fused SDF geometry core and its backward (csrc/geometry_fwd.cu,
csrc/geometry_bwd.cu), with their plain PyTorch twin.

Counterpart of factored_neus_tpu/ops/pallas_geometry.py
(sdf_value_grad_feat_pallas).  ``geometry(ws, bs, x, cfg)`` returns
(out [N, d_out] = [sdf / scale | feature], grad [N, 3] = dsdf/dx).  On a CUDA
tensor both the forward and the backward are the hand-written kernels,
joined by one ``torch.autograd.Function`` whose backward takes the
cotangents of (out, grad) at once: the eikonal loss then needs no double
backward through the kernel.  The weights it takes are the EFFECTIVE ones
(weight norm applied outside in autograd), so gradients still reach g and v.
On a CPU tensor the wrapper runs the plain twin: the SDF forward plus
``torch.autograd.grad(create_graph=True)``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from .sdf_kernel import TILE, kernel_iargs, sdf_forward_plain

K1_FWD = _cuda.CudaKernel("geometry_fwd", "geometry_fwd.cu", "geometry_fwd")
K1_BWD = _cuda.CudaKernel("geometry_bwd", "geometry_bwd.cu", "geometry_bwd")


def geometry_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: (out, grad) from one forward and one autograd VJP that
    stays differentiable when gradients are enabled."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        out = sdf_forward_plain(ws, bs, cfg, xg)
        (grad,) = torch.autograd.grad(out[:, 0].sum(), xg,
                                      create_graph=create)
    if not create:
        return out.detach(), grad.detach()
    return out, grad


def _weights(ws, bs):
    wt = [w.detach().contiguous() for w in ws]
    wT = [w.t().contiguous() for w in wt]
    return wT, wt, [b.detach().contiguous() for b in bs]


def launch_forward(cfg, x, ws, bs):
    dev = x.device
    wT, wt, bs = _weights(ws, bs)
    x = x.detach().contiguous()
    _cuda.check_cuda_tensors("geometry forward", [x, *wT, *wt, *bs])
    n, L = x.shape[0], len(ws)
    out = torch.empty(n, wt[-1].shape[0], device=dev, dtype=torch.float32)
    grad = torch.empty(n, 3, device=dev, dtype=torch.float32)
    if n == 0:
        return out, grad
    grid = min(math.ceil(n / TILE), _cuda.sm_count(dev))
    iargs, ld = kernel_iargs(cfg, ws, n, grid)
    stash = torch.empty(grid * L * TILE * ld, device=dev, dtype=torch.float32)
    K1_FWD.launch(iargs, [x, out, grad, stash, *wT, *wt, *bs], cfg.scale,
                  dev)
    return out, grad


def launch_backward(cfg, x, ws, bs, ct_out, ct_grad
                    ) -> Tuple[torch.Tensor, List[torch.Tensor],
                               List[torch.Tensor]]:
    """(ct_x [N, 3], dW per layer [out, in], db per layer [out])."""
    dev = x.device
    wT, wt, bs_c = _weights(ws, bs)
    x = x.detach().contiguous()
    ct_out = ct_out.contiguous()
    ct_grad = ct_grad.contiguous()
    _cuda.check_cuda_tensors("geometry backward",
                             [x, ct_out, ct_grad, *wT, *wt, *bs_c])
    n, L = x.shape[0], len(ws)
    ins = [w.shape[1] for w in wt]
    outs = [w.shape[0] for w in wt]
    sizes = [i * o + o for i, o in zip(ins, outs)]
    P = sum(sizes)
    ct_x = torch.empty(n, 3, device=dev, dtype=torch.float32)
    grads = torch.zeros(P, device=dev, dtype=torch.float32)
    if n > 0:
        half = TILE // 2
        grid = min(math.ceil(n / half), _cuda.sm_count(dev))
        iargs, ld = kernel_iargs(cfg, ws, n, grid)
        stash = torch.empty(grid * L * TILE * ld, device=dev,
                            dtype=torch.float32)
        part = torch.empty(grid * P, device=dev, dtype=torch.float32)
        K1_BWD.launch(iargs, [x, ct_out, ct_grad, ct_x, stash, part, grads,
                              *wT, *wt, *bs_c], cfg.scale, dev)
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return ct_x, dws, dbs


class GeometryFn(torch.autograd.Function):
    """(x, *ws, *bs) -> (out, grad) through K1-fwd; backward through
    K1-bwd with both cotangents."""

    @staticmethod
    def forward(ctx, cfg, x, *params):
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        out, grad = launch_forward(cfg, x, ws, bs)
        ctx.cfg = cfg
        ctx.save_for_backward(x, *params)
        return out, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_out, ct_grad):
        x, *params = ctx.saved_tensors
        L = len(params) // 2
        ct_x, dws, dbs = launch_backward(ctx.cfg, x, params[:L], params[L:],
                                         ct_out, ct_grad)
        return (None, ct_x, *dws, *dbs)


def geometry(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
             x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [N, d_out], grad [N, 3]), differentiable in x, ws and bs."""
    if x.is_cuda:
        return GeometryFn.apply(cfg, x, *ws, *bs)
    if x.device.type == "cpu":
        return geometry_plain(ws, bs, x, cfg)
    raise ValueError(f"geometry: unsupported device {x.device}")
