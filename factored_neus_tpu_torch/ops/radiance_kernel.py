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

The bf16 operand mode (``bf16=True``; the stage-1 render core under
``RendererConfig.core_act_bf16``, as the JAX step rounds the radiance
MLP's activations there) is rendering_apply_pallas(bf16=True)'s
``_mm_fns(True)``: every product of the forward, of the backward's
recompute, of its weight gradients and of its input cotangents takes
bf16-rounded operands and sums in f32; everything elementwise stays f32.
K3-fwd-bf16 and K3-bwd-bf16 run it on bf16 ``mma.sync`` from
tc_pack.pack_weights_bf16's pack.  Their twins compute the same products
explicitly (``radiance_plain(bf16=True)``, ``radiance_bwd_plain(
bf16=True)``): autograd through a rounding would run the backward's
products on unrounded cotangents.  On a CPU tensor the autograd Function
runs them.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from . import tc_pack as TP
from .embedder import positional_encoding, positional_encoding_vjp
from .sdf_kernel import MAX_WIDTH, TILE

K3_FWD = _cuda.CudaKernel("radiance_fwd", "radiance_fwd.cu", "radiance_fwd")
K3_BWD = _cuda.CudaKernel("radiance_bwd", "radiance_bwd.cu", "radiance_bwd")
# the bf16 operand mode's entry points
K3_FWD_BF16 = _cuda.CudaKernel("radiance_fwd_bf16", "radiance_fwd.cu",
                               "radiance_fwd_bf16")
K3_BWD_BF16 = _cuda.CudaKernel("radiance_bwd_bf16", "radiance_bwd_bf16.cu",
                               "radiance_bwd_bf16")
# the kernel of each (entry, operand mode)
KERNELS = {("fwd", False): K3_FWD, ("fwd", True): K3_FWD_BF16,
           ("bwd", False): K3_BWD, ("bwd", True): K3_BWD_BF16}

# the first layer's input of each mode: which of (pts, PE(dirs), normals,
# feat) it concatenates
MODE_INPUTS = {"idr": (0, 1, 2, 3), "no_view_dir": (0, 2, 3),
               "no_normal": (0, 1, 3)}


def _mode_inputs(cfg) -> Tuple[int, ...]:
    if cfg.mode not in MODE_INPUTS:
        raise ValueError(cfg.mode)
    return MODE_INPUTS[cfg.mode]


def _x0(cfg, pts, normals, dirs, feat) -> torch.Tensor:
    if cfg.multires_view > 0:
        dirs = positional_encoding(dirs, cfg.multires_view)
    parts = (pts, dirs, normals, feat)
    return torch.cat([parts[i] for i in _mode_inputs(cfg)], -1)


def radiance_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   cfg, pts, normals, dirs, feat, bf16: bool = False
                   ) -> torch.Tensor:
    """The radiance MLP in plain PyTorch (fields.rendering_apply of the JAX
    package), in any of its modes.  ``bf16``: the bf16 operand mode's
    forward, each product on bf16-rounded operands (tc_pack.mm_bf16)."""
    x = _x0(cfg, pts, normals, dirs, feat)
    for l, (w, b) in enumerate(zip(ws, bs)):
        x = (TP.mm_bf16(x, w.t()) + b if bf16
             else torch.nn.functional.linear(x, w, b))
        if l < len(ws) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if cfg.squeeze_out else x


def radiance_bwd_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                       cfg, pts, normals, dirs, feat, ct_rgb,
                       bf16: bool = False,
                       masks: Optional[Sequence[torch.Tensor]] = None):
    """Explicit twin of K3-bwd (bf16: K3-bwd-bf16), pallas_radiance's
    _build_bwd_kernel: the forward recomputed, the seed through the
    sigmoid, then per layer dW = r^T x_l, db = sum r and r W through the
    ReLU masks a > 0; ``bf16``: every product on bf16-rounded operands.
    ``masks``: the hidden layers' masks to differentiate with in place of
    the recompute's own (a kernel's, to hold it on the function it
    computes where a pre-activation lies within rounding of 0).  Returns
    launch_backward's (ct_pts, ct_normals, ct_dirs, ct_feat, dW per layer
    [out, in], db per layer), in pts' dtype; a cotangent of an input that
    the mode does not read is zero."""
    mm = TP.mm_bf16 if bf16 else torch.matmul
    L = len(ws)
    with torch.no_grad():
        xs = [_x0(cfg, pts, normals, dirs, feat)]
        for l in range(L):
            a = mm(xs[-1], ws[l].t()) + bs[l]
            xs.append(torch.relu(a) if l < L - 1 else a)
        r = ct_rgb
        if cfg.squeeze_out:
            y = torch.sigmoid(xs[-1])
            r = ct_rgb * y * (1.0 - y)
        dws: List[torch.Tensor] = [None] * L
        dbs: List[torch.Tensor] = [None] * L
        for l in range(L - 1, -1, -1):
            dws[l] = mm(r.t(), xs[l])
            dbs[l] = r.sum(0)
            r_in = mm(r, ws[l])
            if l > 0:
                mask = xs[l] > 0 if masks is None else masks[l - 1]
                r = torch.where(mask, r_in, torch.zeros_like(r_in))
        # r_in is x0's cotangent: split it back into the mode's inputs
        used = _mode_inputs(cfg)
        widths = (3, cfg.d_view, 3, feat.shape[1])
        cts = [torch.zeros_like(v) for v in (pts, dirs, normals, feat)]
        for i, p in zip(used, torch.split(r_in, [widths[i] for i in used],
                                          -1)):
            cts[i] = p
        if 1 in used:
            cts[1] = positional_encoding_vjp(dirs, cts[1],
                                             cfg.multires_view)
        ct_pts, ct_dirs, ct_normals, ct_feat = cts
    return ct_pts, ct_normals, ct_dirs, ct_feat, dws, dbs


MAX_HIDDEN = 256    # widest hidden layer the kernels take (radiance_mlp.cuh)


def kernel_iargs(cfg, ws, n: int, grid: int, lay: TP.PackLayout
                 ) -> Tuple[List[int], int]:
    """The kernels' integer arguments [L, multires, d_view, ld,
    squeeze_out, n, grid, ins[L], outs[L], then the pack's layout] and the
    row stride ld, the widest layer rounded up to 8, plus 4; raises for a
    network the kernels cannot hold.  Both operand modes take the same
    arguments and ld (a bf16 product's last k16 step of the 296-deep first
    layer is a half step, which reads no column past 296); the pack's
    layout, of either operand type, sizes the ring."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    d_view = cfg.d_view
    if cfg.d_in != 9 or ins[0] != 6 + d_view + cfg.d_feature or len(ws) < 2:
        raise ValueError("radiance kernels take [pts | PE(dirs) | normals | "
                         "feature] and at least one hidden layer")
    for l in range(1, len(ws)):
        if ins[l] != outs[l - 1]:
            raise ValueError(f"layer {l}: input {ins[l]} != {outs[l - 1]}")
    if lay != TP.pack_layout(ins, outs, lay.operand):
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


def launch_forward(cfg, ws, bs, pts, normals, dirs, feat, pack=None,
                   bf16: bool = False) -> torch.Tensor:
    """K3-fwd (bf16: K3-fwd-bf16): rgb [N, d_out]; ``pack``:
    tc_pack.make_pack(ws, bf16), when the caller already has it."""
    kernel = KERNELS["fwd", bf16]
    dev = pts.device
    pts, normals, dirs, feat = _inputs(kernel.name, pts, normals, dirs,
                                       feat)
    bs = [b.detach().contiguous() for b in bs]
    pack, lay = TP.pack_for(kernel, ws, pack, bf16)
    _cuda.check_cuda_tensors(kernel.name,
                             [pts, normals, dirs, feat, pack, *bs])
    n = pts.shape[0]
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n > 0:
        grid = min(math.ceil(n / TILE), _cuda.sm_count(dev))
        iargs, _ = kernel_iargs(cfg, ws, n, grid, lay)
        kernel.launch(iargs, [pts, normals, dirs, feat, out, pack, *bs], 1.0,
                      dev)
    return out


def launch_backward(cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                    scratch=None, pack=None, bf16: bool = False):
    """K3-bwd (bf16: K3-bwd-bf16): (ct_pts, ct_normals, ct_dirs, ct_feat,
    dW per layer [out, in], db per layer [out]).  ``scratch``: the
    kernel's per-block buffer [grid, L - 1, TILE, ld] (grid = min(tiles,
    SMs), ld from kernel_iargs), where each block leaves h = relu(a) of
    the hidden layers of the last tile it took; a fresh one when None.
    ``pack``: tc_pack.make_pack(ws, bf16), when the caller already has
    it."""
    kernel = KERNELS["bwd", bf16]
    dev = pts.device
    pts, normals, dirs, feat = _inputs(kernel.name, pts, normals, dirs,
                                       feat)
    bs = [b.detach().contiguous() for b in bs]
    ct_rgb = ct_rgb.contiguous()
    pack, lay = TP.pack_for(kernel, ws, pack, bf16)
    _cuda.check_cuda_tensors(kernel.name, [pts, normals, dirs, feat,
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
            raise ValueError(f"{kernel.name}: scratch must be {shape}, "
                             f"got {tuple(scratch.shape)}")
        _cuda.check_cuda_tensors(kernel.name, [pts, scratch])
        part = torch.empty(grid * P, device=dev, dtype=torch.float32)
        kernel.launch(iargs, [pts, normals, dirs, feat, ct_rgb, *cts,
                              scratch, part, grads, pack, *bs], 1.0, dev)
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return (*cts, dws, dbs)


class RadianceFn(torch.autograd.Function):
    """(pts, normals, dirs, feat, *ws, *bs) -> rgb through K3-fwd; backward
    through K3-bwd, both on ``pack`` (tc_pack.make_pack(ws, bf16), built
    without grad by the caller); ``bf16``: through K3-fwd-bf16 and
    K3-bwd-bf16.
    On a CPU tensor (``pack`` None) the bf16 mode runs the explicit twins;
    the f32 mode does not come here on the CPU (radiance_plain
    differentiates itself)."""

    @staticmethod
    def forward(ctx, cfg, bf16, pack, pts, normals, dirs, feat, *params):
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if pts.is_cuda:
            rgb = launch_forward(cfg, ws, bs, pts, normals, dirs, feat, pack,
                                 bf16)
            ctx.layout, pack = pack[1], pack[0]
        else:
            rgb = radiance_plain(ws, bs, cfg, pts, normals, dirs, feat, bf16)
        ctx.cfg, ctx.bf16 = cfg, bf16
        ctx.save_for_backward(pts, normals, dirs, feat, pack, *params)
        return rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_rgb):
        pts, normals, dirs, feat, pack, *params = ctx.saved_tensors
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if pts.is_cuda:
            *cts, dws, dbs = launch_backward(
                ctx.cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                pack=(pack, ctx.layout), bf16=ctx.bf16)
        else:
            *cts, dws, dbs = radiance_bwd_plain(ws, bs, ctx.cfg, pts,
                                                normals, dirs, feat, ct_rgb,
                                                ctx.bf16)
        grads = [None, None, None, *cts, *dws, *dbs]
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def radiance(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
             pts, normals, dirs, feat,
             pack: Optional[Tuple[torch.Tensor, TP.PackLayout]] = None,
             bf16: bool = False) -> torch.Tensor:
    """rgb [N, d_out], differentiable in every input, ws and bs: K3 on a
    CUDA tensor, the plain twin on a CPU tensor; ``bf16``: in the bf16
    operand mode, through K3-fwd-bf16 and K3-bwd-bf16 or their twins.
    ``pack``: tc_pack.make_pack(ws, bf16), when the caller already has it
    (on a CUDA tensor; built here if not)."""
    if pts.is_cuda:
        if cfg.mode != "idr":
            raise NotImplementedError(
                f"the radiance kernels run mode 'idr' only, not "
                f"{cfg.mode!r}")
        if pack is None:
            with torch.no_grad():
                pack = TP.make_pack(ws, bf16)
        return RadianceFn.apply(cfg, bf16, pack, pts, normals, dirs, feat,
                                *ws, *bs)
    if pts.device.type == "cpu":
        if bf16:
            return RadianceFn.apply(cfg, True, None, pts, normals, dirs,
                                    feat, *ws, *bs)
        return radiance_plain(ws, bs, cfg, pts, normals, dirs, feat)
    raise ValueError(f"radiance: unsupported device {pts.device}")
