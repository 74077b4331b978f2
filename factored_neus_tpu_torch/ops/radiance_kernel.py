"""K3: the fused IDR radiance MLP and its backward (csrc/radiance_fwd.cu,
csrc/radiance_bwd.cu), with their plain PyTorch twin.

Counterpart of factored_neus_tpu/ops/pallas_radiance.py
(rendering_apply_pallas).  ``radiance(ws, bs, cfg, pts, normals, dirs,
feat)`` returns rgb [N, d_out]: PE(dirs), the concat [pts | PE(dirs) |
normals | feat], the ReLU MLP and, with squeeze_out, the sigmoid.  On a
CUDA tensor the forward and the backward are the hand-written kernels,
joined by one ``torch.autograd.Function`` over the EFFECTIVE weights
(weight norm applied outside in autograd, so gradients reach g and v); the
backward returns dW, db and the cotangents of all four inputs, the view
directions' through the encoding's Jacobian.  The kernels cover
``mode='idr'``, as the TPU kernel does; on a CUDA tensor another mode
raises.  On a CPU tensor the wrapper runs the plain twin, in every mode.

Both kernels multiply on the tensor cores in 3xTF32 (csrc/tc_mma.cuh),
from one weight pack (tc_pack.pack_weights), built once a step or once a
validation image (``fields.RenderingNetwork.kernel_weights``), which
``RadianceFn`` hands from the forward to the backward; they take one
argument layout (``kernel_iargs``) and the same shared-memory count.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from . import tc_pack as TP
from .embedder import positional_encoding
from .sdf_kernel import MAX_WIDTH, TILE

K3_FWD = _cuda.CudaKernel("radiance_fwd", "radiance_fwd.cu", "radiance_fwd")
K3_BWD = _cuda.CudaKernel("radiance_bwd", "radiance_bwd.cu", "radiance_bwd")


def radiance_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   cfg, pts, normals, dirs, feat) -> torch.Tensor:
    """The radiance MLP in plain PyTorch (fields.rendering_apply of the JAX
    package), in any of its modes."""
    if cfg.multires_view > 0:
        dirs = positional_encoding(dirs, cfg.multires_view)
    if cfg.mode == "idr":
        x = torch.cat([pts, dirs, normals, feat], -1)
    elif cfg.mode == "no_view_dir":
        x = torch.cat([pts, normals, feat], -1)
    elif cfg.mode == "no_normal":
        x = torch.cat([pts, dirs, feat], -1)
    else:
        raise ValueError(cfg.mode)
    for l, (w, b) in enumerate(zip(ws, bs)):
        x = torch.nn.functional.linear(x, w, b)
        if l < len(ws) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if cfg.squeeze_out else x


MAX_HIDDEN = 256    # widest hidden layer the kernels take (radiance_mlp.cuh)


def kernel_iargs(cfg, ws, n: int, grid: int, lay: TP.PackLayout
                 ) -> Tuple[List[int], int]:
    """The kernels' integer arguments [L, multires, d_view, ld,
    squeeze_out, n, grid, ins[L], outs[L], then the pack's layout] and the
    row stride ld, the widest layer rounded up to 8, plus 4; raises for a
    network the kernels cannot hold."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    d_view = cfg.d_view
    if cfg.d_in != 9 or ins[0] != 6 + d_view + cfg.d_feature or len(ws) < 2:
        raise ValueError("radiance kernels take [pts | PE(dirs) | normals | "
                         "feature] and at least one hidden layer")
    for l in range(1, len(ws)):
        if ins[l] != outs[l - 1]:
            raise ValueError(f"layer {l}: input {ins[l]} != {outs[l - 1]}")
    if lay != TP.pack_layout(ins, outs):
        raise ValueError("radiance kernels: the pack's layout is not the "
                         "network's")
    if max(ins[1:]) > MAX_HIDDEN or outs[-1] > MAX_WIDTH:
        raise ValueError(f"radiance kernels take hidden widths <= "
                         f"{MAX_HIDDEN} and outputs <= {MAX_WIDTH}")
    ld = TP.round8(max(ins + outs)) + 4
    if smem_bytes(lay, outs, ld) > TP.SMEM_MAX:
        raise ValueError("radiance kernels: the network's tiles and weight "
                         "ring do not fit in shared memory")
    return [len(ws), cfg.multires_view, d_view, ld, int(cfg.squeeze_out), n,
            grid, *ins, *outs, *TP.layout_iargs(lay)], ld


def smem_bytes(lay: TP.PackLayout, outs, ld: int) -> int:
    """Shared memory of K3-fwd and K3-bwd alike: two tiles of stride ld and
    the weight ring (no tile of its own for x0)."""
    return TP.smem_bytes(lay, outs, 2 * TILE * ld)


def _inputs(name, pts, normals, dirs, feat):
    t = [v.detach().contiguous() for v in (pts, normals, dirs, feat)]
    n = t[0].shape[0]
    if any(v.dim() != 2 or v.shape[0] != n for v in t) or \
            any(v.shape[1] != 3 for v in t[:3]):
        raise ValueError(f"{name}: expects pts, normals, dirs [N, 3] and "
                         f"feat [N, d_feature], got "
                         f"{[tuple(v.shape) for v in t]}")
    return t


def launch_forward(cfg, ws, bs, pts, normals, dirs, feat, pack=None
                   ) -> torch.Tensor:
    """K3-fwd: rgb [N, d_out]; ``pack``: TP.pack_weights(ws), when the
    caller already has it."""
    dev = pts.device
    pts, normals, dirs, feat = _inputs("radiance forward", pts, normals,
                                       dirs, feat)
    bs = [b.detach().contiguous() for b in bs]
    pack, lay = pack if pack is not None else TP.pack_weights(ws)
    _cuda.check_cuda_tensors("radiance forward",
                             [pts, normals, dirs, feat, pack, *bs])
    n = pts.shape[0]
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n > 0:
        grid = min(math.ceil(n / TILE), _cuda.sm_count(dev))
        iargs, _ = kernel_iargs(cfg, ws, n, grid, lay)
        K3_FWD.launch(iargs, [pts, normals, dirs, feat, out, pack, *bs], 1.0,
                      dev)
    return out


def launch_backward(cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                    scratch=None, pack=None):
    """K3-bwd: (ct_pts, ct_normals, ct_dirs, ct_feat, dW per layer
    [out, in], db per layer [out]).  ``scratch``: the kernel's per-block
    buffer [grid, L - 1, TILE, ld] (grid = min(tiles, SMs), ld from
    kernel_iargs), where each block leaves h = relu(a) of the hidden
    layers of the last tile it took; a fresh one when None.  ``pack``:
    TP.pack_weights(ws), when the caller already has it."""
    dev = pts.device
    pts, normals, dirs, feat = _inputs("radiance backward", pts, normals,
                                       dirs, feat)
    bs = [b.detach().contiguous() for b in bs]
    ct_rgb = ct_rgb.contiguous()
    pack, lay = pack if pack is not None else TP.pack_weights(ws)
    _cuda.check_cuda_tensors("radiance backward", [pts, normals, dirs, feat,
                                                   ct_rgb, pack, *bs])
    n, L = pts.shape[0], len(ws)
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    P = sum(i * o + o for i, o in zip(ins, outs))
    cts = [torch.empty_like(v) for v in (pts, normals, dirs, feat)]
    grads = torch.zeros(P, device=dev, dtype=torch.float32)
    if n > 0:
        grid = min(math.ceil(n / TILE), _cuda.sm_count(dev))
        iargs, ld = kernel_iargs(cfg, ws, n, grid, lay)
        shape = (grid, L - 1, TILE, ld)
        if scratch is None:
            scratch = torch.empty(shape, device=dev, dtype=torch.float32)
        elif tuple(scratch.shape) != shape:
            raise ValueError(f"radiance backward: scratch must be {shape}, "
                             f"got {tuple(scratch.shape)}")
        _cuda.check_cuda_tensors("radiance backward", [pts, scratch])
        part = torch.empty(grid * P, device=dev, dtype=torch.float32)
        K3_BWD.launch(iargs, [pts, normals, dirs, feat, ct_rgb, *cts,
                              scratch, part, grads, pack, *bs], 1.0, dev)
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return (*cts, dws, dbs)


class RadianceFn(torch.autograd.Function):
    """(pts, normals, dirs, feat, *ws, *bs) -> rgb through K3-fwd; backward
    through K3-bwd, both on ``pack`` (pack_weights(ws), built without grad
    by the caller)."""

    @staticmethod
    def forward(ctx, cfg, pack, pts, normals, dirs, feat, *params):
        L = len(params) // 2
        ctx.cfg, ctx.layout = cfg, pack[1]
        ctx.save_for_backward(pts, normals, dirs, feat, pack[0], *params)
        return launch_forward(cfg, params[:L], params[L:], pts, normals,
                              dirs, feat, pack)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_rgb):
        pts, normals, dirs, feat, pack, *params = ctx.saved_tensors
        L = len(params) // 2
        *cts, dws, dbs = launch_backward(ctx.cfg, params[:L], params[L:],
                                         pts, normals, dirs, feat, ct_rgb,
                                         pack=(pack, ctx.layout))
        grads = [None, None, *cts, *dws, *dbs]
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def radiance(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
             pts, normals, dirs, feat,
             pack: Optional[Tuple[torch.Tensor, TP.PackLayout]] = None
             ) -> torch.Tensor:
    """rgb [N, d_out], differentiable in every input, ws and bs: K3 on a
    CUDA tensor, the plain twin on a CPU tensor.  ``pack``:
    TP.pack_weights(ws), when the caller already has it (on a CUDA
    tensor; built here if not)."""
    if pts.is_cuda:
        if cfg.mode != "idr":
            raise NotImplementedError(
                f"the radiance kernels run mode 'idr' only, not "
                f"{cfg.mode!r}")
        if pack is None:
            with torch.no_grad():
                pack = TP.pack_weights(ws)
        return RadianceFn.apply(cfg, pack, pts, normals, dirs, feat, *ws,
                                *bs)
    if pts.device.type == "cpu":
        return radiance_plain(ws, bs, cfg, pts, normals, dirs, feat)
    raise ValueError(f"radiance: unsupported device {pts.device}")
