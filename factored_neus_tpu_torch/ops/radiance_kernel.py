"""K3: the fused IDR radiance MLP and its backward (csrc/radiance_fwd_wg.cu,
csrc/radiance_bwd_wg.cu; in the bf16 mode csrc/radiance_fwd_bf16_wg.cu,
csrc/radiance_bwd_bf16_wg.cu), with their plain PyTorch twin.

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

K3-fwd and K3-bwd run on Hopper's warpgroup ``wgmma`` in 3xTF32
(csrc/radiance_fwd_wg.cu, csrc/radiance_bwd_wg.cu, on the f32 engine of
csrc/wgf.cuh that K1 and K2 share), their weights streamed as TF32 big
and small slabs: K3-fwd the forward pack ``make_fwd_pack(cfg, ws)``
(tc_pack.pack_rad_sweep_f32's, X W, built once a step, a validation image
or a stage-2 run by ``fields.RenderingNetwork.kernel_weights``,
``sweep32``), in K3-bwd's order, so the forward of a step and the one
K3-bwd recomputes sum alike (``fwd_wg_plan`` is its launch,
``radiance_plain(mm=sweep_mm_f32)`` its arithmetic); K3-bwd both packs of
``make_bwd_slabs(cfg, ws, bf16=False)`` (the forward pack and
pack_rad_rev_f32's for r W, ``rev32``, built where a backward can
follow): a sweep which keeps the ReLU masks in registers and writes each
layer's f32 X_l and R_l, then a split-K ``wgmma`` pass dW_l = X_l^T R_l
and a fixed-order reduce (``weight_grad_pass_plain(f32=True)`` is that
pass in plain PyTorch).  No launch builds a pack: on a CUDA tensor each
raises without its own.

The bf16 operand mode (``bf16=True``; the stage-1 render core under
``RendererConfig.core_act_bf16``, as the JAX step rounds the radiance
MLP's activations there) is rendering_apply_pallas(bf16=True)'s
``_mm_fns(True)``: every product of the forward, of the backward's
recompute, of its weight gradients and of its input cotangents takes
bf16-rounded operands and sums in f32; everything elementwise stays f32.
Both kernels run it on Hopper's warpgroup ``wgmma``, their weights streamed
as bf16 slabs: K3-fwd-bf16 (csrc/radiance_fwd_bf16_wg.cu) the forward pack
``make_fwd_pack(cfg, ws, bf16=True)`` (tc_pack.pack_rad_sweep_bf16's, X W,
built once a step or a validation image, with or without grad, by
``fields.RenderingNetwork.kernel_weights(bf16=True)``, ``sweep16``), the
forward half of K3-bwd-bf16's sweep in its order (``fwd_wg16_plan`` is
its launch); K3-bwd-bf16 (csrc/radiance_bwd_bf16_wg.cu) both packs of
``make_bwd_slabs`` (the forward pack and pack_rad_rev_bf16's for r W,
``rev16``, built where a backward can follow): a sweep which keeps the
ReLU masks in registers and writes each layer's bf16 X_l and R_l, then
the split-K ``wgmma`` pass dW_l = X_l^T R_l that K1-bwd-bf16 shares
(csrc/wg_bwd.cuh).  Their twins compute the same products
explicitly (``radiance_plain(bf16=True)``, ``radiance_bwd_plain(
bf16=True)``; ``weight_grad_pass_plain``, the pass's split-K sums):
autograd through a rounding would run the backward's products on
unrounded cotangents.  On a CPU tensor the autograd Function runs them.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from . import geometry_kernel as GK
from . import tc_pack as TP
from .embedder import positional_encoding, positional_encoding_vjp
# K3-bwd's pass runs on K1's f32 engine (csrc/wgf.cuh): a rounded add
# every 32-row stage
from .geometry_kernel import WGF_PASS_STAGE

K3_FWD = _cuda.CudaKernel("radiance_fwd", "radiance_fwd_wg.cu",
                          "radiance_fwd")
K3_BWD = _cuda.CudaKernel("radiance_bwd", "radiance_bwd_wg.cu",
                          "radiance_bwd")
# the bf16 operand mode's entry points
K3_FWD_BF16 = _cuda.CudaKernel("radiance_fwd_bf16",
                               "radiance_fwd_bf16_wg.cu", "radiance_fwd_bf16")
K3_BWD_BF16 = _cuda.CudaKernel("radiance_bwd_bf16",
                               "radiance_bwd_bf16_wg.cu", "radiance_bwd_bf16")
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
                   cfg, pts, normals, dirs, feat, bf16: bool = False,
                   mm=None) -> torch.Tensor:
    """The radiance MLP in plain PyTorch (fields.rendering_apply of the JAX
    package), in any of its modes.  ``bf16``: the bf16 operand mode's
    forward, each product on bf16-rounded operands (tc_pack.mm_bf16).
    ``mm``: the products (a, b) -> a @ b, as radiance_bwd_plain's
    (sweep_mm_f32, with ``narrow`` for layer 0's, emulates K3-fwd's),
    without gradient."""
    x = _x0(cfg, pts, normals, dirs, feat)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if mm is not None:
            x = mm(x, w.t()) + b
        elif bf16:
            x = TP.mm_bf16(x, w.t()) + b
        else:
            x = torch.nn.functional.linear(x, w, b)
        if l < len(ws) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if cfg.squeeze_out else x


def radiance_bwd_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                       cfg, pts, normals, dirs, feat, ct_rgb,
                       bf16: bool = False,
                       masks: Optional[Sequence[torch.Tensor]] = None,
                       operands: Optional[dict] = None, mm=None):
    """Explicit twin of K3-bwd (bf16: K3-bwd-bf16), pallas_radiance's
    _build_bwd_kernel: the forward recomputed, the seed through the
    sigmoid, then per layer dW = r^T x_l, db = sum r and r W through the
    ReLU masks a > 0; ``bf16``: every product on bf16-rounded operands.
    ``masks``: the hidden layers' masks to differentiate with in place of
    the recompute's own (a kernel's, to hold it on the function it
    computes where a pre-activation lies within rounding of 0).
    ``operands``: receives, for each layer l, the weight gradient's
    operands (x_l, r_l) (weight_grad_pass_plain).  ``mm``: the products
    (a, b) -> a @ b, in place of the operand mode's (sweep_mm_f32
    emulates K3-bwd's sweep).  Returns
    launch_backward's (ct_pts, ct_normals, ct_dirs, ct_feat, dW per layer
    [out, in], db per layer), in pts' dtype; a cotangent of an input that
    the mode does not read is zero."""
    mm = mm or (TP.mm_bf16 if bf16 else torch.matmul)
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
            if operands is not None:
                operands[l] = (xs[l], r)
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


def weight_grad_pass_plain(operands: dict, tiles_per_chunk: int,
                           f32: bool = False
                           ) -> Tuple[List[torch.Tensor],
                                      List[torch.Tensor]]:
    """A wgmma radiance backward's weight-gradient pass in plain PyTorch, on
    the operands radiance_bwd_plain(operands=...) recorded: (dW per layer
    [out, in], db per layer).  The rows are cut into chunks of
    ``tiles_per_chunk`` tiles of WG_TILE rows; dW_l is the sum, chunk
    after chunk, of x_l^T r_l over the chunk's rows: on bf16-rounded
    operands with an f32 sum (K3-bwd-bf16, pallas_radiance's dot_at), or
    (``f32``: K3-bwd's) in 3xTF32 on both operands as the tensor core
    reads them from the images, each 32-row stage into a fresh accumulator
    added to the chunk's sum with a rounded add; db_l the f32 sum of r_l,
    rounded to nothing."""
    dws, dbs = [], []
    step = WG_TILE * tiles_per_chunk
    for l in range(len(operands)):
        x, r = operands[l]
        dw = None
        for c0 in range(0, x.shape[0], step):
            c = slice(c0, c0 + step)
            part = (TP.mm_3xtf32(x[c].t(), r[c], WGF_PASS_STAGE, "trunc",
                                 "trunc").t() if f32
                    else TP.mm_bf16(r[c].t(), x[c]))
            dw = part if dw is None else dw + part
        dws.append(dw)
        dbs.append(r.sum(0))
    return dws, dbs


def sweep_mm_f32(a: torch.Tensor, b: torch.Tensor,
                 narrow: int = 0) -> torch.Tensor:
    """a @ b as K3-bwd's sweep computes a product (radiance_bwd_plain's
    ``mm``): K1's engine, geometry_kernel.sweep_mm_f32.  ``narrow``: a is
    layer 0's input in the twin's order [narrow (that many columns) |
    feature], summed in the kernel's k order: the feature's columns from k
    = 0, zero up to 256, the narrow ones from k = 256 on."""
    if narrow:
        pad = TP.HIDDEN_COLS - (a.shape[1] - narrow)
        a = torch.cat([a[:, narrow:], a.new_zeros(a.shape[0], pad),
                       a[:, :narrow]], 1)
        b = torch.cat([b[narrow:], b.new_zeros(pad, b.shape[1]),
                       b[:narrow]], 0)
    return GK.sweep_mm_f32(a, b)


def _inputs(name, pts, normals, dirs, feat):
    t = [v.detach().contiguous() for v in (pts, normals, dirs, feat)]
    n = t[0].shape[0]
    if any(v.dim() != 2 or v.shape[0] != n for v in t) or \
            any(v.shape[1] != 3 for v in t[:3]):
        raise ValueError(f"{name}: expects pts, normals, dirs [N, 3] and "
                         f"feat [N, d_feature], got "
                         f"{[tuple(v.shape) for v in t]}")
    return t


def make_fwd_pack(cfg, ws: Sequence[torch.Tensor], bf16: bool = False
                  ) -> Tuple[torch.Tensor, TP.SweepLayout]:
    """K3-fwd's slab pack of ws: tc_pack.pack_rad_sweep_f32's, the first of
    make_bwd_slabs(cfg, ws, bf16=False); with ``bf16`` K3-fwd-bf16's,
    tc_pack.pack_rad_sweep_bf16's, the first of make_bwd_slabs(cfg, ws)."""
    if bf16:
        return TP.pack_rad_sweep_bf16(ws, _narrow(cfg))
    return TP.pack_rad_sweep_f32(ws, _narrow(cfg))


# K3-fwd (csrc/radiance_fwd_wg.cu): the sweep's shared memory (its ring of
# two 64 KB slab stages, the 80 KB A tile, the narrow tile, the barriers)
WGF_FWD_SMEM = 1024 + 2 * 65536 + 64 * 320 * 4 + 64 * 48 * 4 + 32


def fwd_wg_plan(cfg, ws, n: int, lay, sms: int) -> dict:
    """K3-fwd's launch: its integer arguments (``iargs``,
    csrc/radiance_fwd_wg.cu), tiles of WG_TILE rows, one persistent block a
    tile up to one a SM.  Raises unless ``lay`` is make_fwd_pack's layout
    for ws (tc_pack.rad_sweep_layout_f32)."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    if cfg.mode != "idr" or cfg.d_in != 9 or \
            ins[0] != _narrow(cfg) + cfg.d_feature:
        raise ValueError("K3-fwd takes [pts | PE(dirs) | normals | "
                         "feature]")
    if getattr(lay, "operand", None) != "wgmma-f32-rad":
        raise ValueError("K3-fwd multiplies on wgmma: it takes the f32 slab "
                         "pack (make_fwd_pack)")
    if lay != TP.rad_sweep_layout_f32(ins, outs, _narrow(cfg)):
        raise ValueError("K3-fwd: the slab pack's layout does not match the "
                         "network's widths")
    tiles = -(-n // WG_TILE)
    grid = min(tiles, sms)
    return {"iargs": [len(ws), cfg.multires_view, cfg.d_view, n, grid,
                      tiles, int(cfg.squeeze_out), *ins, *outs, *lay.off],
            "grid": grid, "tiles": tiles, "sweep_smem": WGF_FWD_SMEM}


def fwd_wg16_plan(cfg, ws, n: int, lay, sms: int) -> dict:
    """K3-fwd-bf16's launch: its integer arguments (``iargs``,
    csrc/radiance_fwd_bf16_wg.cu) and its shared memory a block (the
    source's count).  Tiles of WG_TILE rows, two consumer warpgroups a
    block when there are more tiles than SMs, else one; one persistent
    block a pass up to one a SM (``grid``, ``nc``, ``n_pass``: block b
    takes passes b, b + grid, ..., consumer w of pass p tile nc p + w).
    Raises unless ``lay`` is make_fwd_pack(cfg, ws, bf16=True)'s layout
    (tc_pack.rad_sweep_layout)."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    if cfg.mode != "idr" or cfg.d_in != 9 or \
            ins[0] != _narrow(cfg) + cfg.d_feature:
        raise ValueError("K3-fwd-bf16 takes [pts | PE(dirs) | normals | "
                         "feature]")
    if getattr(lay, "operand", None) != "wgmma-bf16-rad":
        raise ValueError("K3-fwd-bf16 multiplies on wgmma: it takes the bf16 "
                         "slab pack (make_fwd_pack(cfg, ws, bf16=True))")
    if lay != TP.rad_sweep_layout(ins, outs, _narrow(cfg)):
        raise ValueError("K3-fwd-bf16: the slab pack's layout does not match "
                         "the network's widths")
    L = len(ws)
    tiles = -(-n // WG_TILE)
    nc = 2 if tiles > sms else 1
    n_pass = -(-tiles // nc)
    grid = min(n_pass, sms)
    return {"iargs": [L, cfg.multires_view, cfg.d_view, n, nc, grid, n_pass,
                      int(cfg.squeeze_out), *ins, *outs, *lay.off],
            "grid": grid, "nc": nc, "n_pass": n_pass, "tiles": tiles,
            "sweep_smem": _sweep16_smem(nc, L)}


def launch_forward(cfg, ws, bs, pts, normals, dirs, feat, pack=None,
                   bf16: bool = False) -> torch.Tensor:
    """K3-fwd (bf16: K3-fwd-bf16): rgb [N, d_out].  ``pack``:
    make_fwd_pack(cfg, ws, bf16), the slab pack the kernel reads; it raises
    without one, before any CUDA call."""
    kernel = KERNELS["fwd", bf16]
    dev = pts.device
    if pack is None:
        raise ValueError(f"{kernel.name} reads make_fwd_pack(cfg, ws, "
                         f"bf16={bf16})'s pack, built by "
                         f"RenderingNetwork.kernel_weights: none was given")
    pack, lay = pack
    want = "wgmma-bf16-rad" if bf16 else "wgmma-f32-rad"
    if getattr(lay, "operand", None) != want:
        raise ValueError(f"{kernel.name} multiplies on {want} slabs: it "
                         f"takes no other pack")
    pts, normals, dirs, feat = _inputs(kernel.name, pts, normals, dirs,
                                       feat)
    bs = [b.detach().contiguous() for b in bs]
    _cuda.check_cuda_tensors(kernel.name,
                             [pts, normals, dirs, feat, pack, *bs])
    n = pts.shape[0]
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n > 0:
        plan = (fwd_wg16_plan if bf16 else fwd_wg_plan)(
            cfg, ws, n, lay, _cuda.sm_count(dev))
        kernel.launch(plan["iargs"], [pts, normals, dirs, feat, out, pack,
                                      *bs], 1.0, dev)
    return out


def _unpack_grads(grads, ins, outs):
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return dws, dbs


def launch_backward(cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                    pack=None, bf16: bool = False,
                    masks: Optional[list] = None):
    """K3-bwd (bf16: K3-bwd-bf16): (ct_pts, ct_normals, ct_dirs, ct_feat,
    dW per layer [out, in], db per layer [out]).  ``pack``:
    make_bwd_slabs(cfg, ws, bf16), the two slab packs the kernel reads
    (it raises without them).  ``masks``: a list that receives the ReLU
    masks a_l > 0 [N, outs[l]] of the kernel's own forward, one a hidden
    layer (decode_mask_bits)."""
    return _launch_backward_wg(cfg, ws, bs, pts, normals, dirs, feat,
                               ct_rgb, pack, masks, bf16)


# K3-bwd-bf16 (csrc/radiance_bwd_bf16_wg.cu) and K3-bwd
# (csrc/radiance_bwd_wg.cu): a tile (RW_TILE, RF_TILE rows), the float4
# rows of a bf16 weight-gradient slot (GW_PQ), the bytes of a 64-column
# block of a bf16 tile image (GW_XB), a db slot's row (GW_BW), the row of a
# bf16 consumer's narrow-column tile (RW_EW); K3-bwd's weight-gradient slot
# row (FW_SN) and sweep shared memory (its ring of two 64 KB slab stages,
# the 80 KB A tile, the narrow tile, the barriers)
WG_TILE = 64
WG_SLOT_ROWS = 40
WG_BLOCK = 8192
WG_DB_ROW = 264
WG_NARROW_ROW = 52
WGF_SLOT_COLS = 136
WGF_SWEEP_SMEM = 1024 + 2 * 65536 + 64 * 320 * 4 + 64 * 48 * 4 + 32


def _sweep16_smem(nc: int, n_layers: int) -> int:
    """Shared memory a block of K3-fwd-bf16's or K3-bwd-bf16's sweep (the
    sources' count): alignment slack, nc narrow tiles, the biases, and as
    many 32 KB slab stages (with their two mbarriers) as fit, at most 8."""
    fixed = 1024 + nc * WG_TILE * WG_NARROW_ROW * 4 + n_layers * WG_DB_ROW * 4
    stage = 32768 + 16
    return fixed + min(8, (TP.SMEM_MAX - fixed) // stage) * stage


def _narrow(cfg) -> int:
    """The narrow columns of x0: [pts | PE(dirs) | normals]."""
    return 6 + cfg.d_view


def make_bwd_slabs(cfg, ws: Sequence[torch.Tensor], bf16: bool = True):
    """The two slab packs of ws that a wgmma radiance backward reads:
    K3-bwd-bf16's (pack_rad_sweep_bf16's, the forward X W;
    pack_rad_rev_bf16's, the reverse r W), or with ``bf16`` False K3-bwd's
    (pack_rad_sweep_f32's, pack_rad_rev_f32's: TF32 big and small
    halves)."""
    if not bf16:
        return make_fwd_pack(cfg, ws), TP.pack_rad_rev_f32(ws, _narrow(cfg))
    return (TP.pack_rad_sweep_bf16(ws, _narrow(cfg)),
            TP.pack_rad_rev_bf16(ws, _narrow(cfg)))


def _bwd_wgf_plan(cfg, ws, n: int, slabs, sms: int,
                  masks: bool = False) -> dict:
    """K3-bwd's launch (bwd_wg_plan for make_bwd_slabs(bf16=False)'s
    packs): the sweep, a block of two consumer warpgroups a tile of
    WG_TILE rows, one persistent block a tile up to one a SM; the
    weight-gradient pass, ``units`` (a layer, a 128-column X pair, an R
    half: layer 0 three pairs, the last layer one 8-column half) times
    ``chunks`` of ``per`` tiles."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    (_, flay), (_, rlay) = slabs
    if flay != TP.rad_sweep_layout_f32(ins, outs, _narrow(cfg)) or \
            rlay != TP.rad_rev_layout_f32(ins, outs, _narrow(cfg)):
        raise ValueError("K3-bwd: the slab packs' layouts do not match the "
                         "network's widths")
    L = len(ws)
    tiles = -(-n // WG_TILE)
    grid = min(tiles, sms)
    cx = [320] + [256] * (L - 1)
    cr = [256] * (L - 1) + [8]
    halves = [2 if r > 128 else 1 for r in cr]
    units = sum(-(-x // 128) * h for x, h in zip(cx, halves))
    per = -(-tiles // max(1, sms // units))
    chunks = -(-tiles // per)
    img = tiles * 4 * sum(2 * 32 * (x + r) for x, r in zip(cx, cr))
    stage = max(2 * (min(r, 128) if h == 0 else r - 128) * 128
                + min(128, x - 128 * p) * 128
                for x, r, hs in zip(cx, cr, halves)
                for p in range(-(-x // 128)) for h in range(hs))
    stage = -(-stage // 1024) * 1024
    wns = min(8, (TP.SMEM_MAX - 1024) // (stage + 24))
    iargs = [L, cfg.multires_view, cfg.d_view, n, grid, tiles, chunks, per,
             int(cfg.squeeze_out), int(masks), *ins, *outs, *flay.off,
             *rlay.off]
    return {"iargs": iargs, "grid": grid, "nc": 2, "n_pass": tiles,
            "units": units, "chunks": chunks, "per": per,
            "sweep_smem": WGF_SWEEP_SMEM,
            "wgrad_smem": 1024 + wns * (stage + 24), "tiles": tiles,
            "image_bytes": img,
            "db_floats": grid * 4 * L * WG_DB_ROW,
            "slot_floats": units * chunks * 2 * 64 * WGF_SLOT_COLS,
            "mask_words": tiles * 256 * (L - 1) * 2 if masks else 0,
            "mask_layout": (256, 2)}


def bwd_wg_plan(cfg, ws, n: int, slabs, sms: int,
                masks: bool = False) -> dict:
    """A wgmma radiance backward's launch: its integer arguments
    (``iargs``, radiance_bwd_bf16_wg.cu, or for K3-bwd's f32 slab packs
    radiance_bwd_wg.cu, _bwd_wgf_plan) and the sizes of what the wrapper
    allocates.  K3-bwd-bf16's sweep: tiles of WG_TILE rows, two consumer warpgroups a block when
    there are more tiles than SMs, else one; one persistent block a pass
    up to one a SM; its weight-gradient pass: ``units`` (a layer and a
    pair of 64-row blocks of its dW; layer 0 has five blocks, the
    feature's four and the narrow columns') times ``chunks`` of ``per``
    tiles, at most one block a SM where the tiles allow.  ``masks``: the
    sweep also writes its ReLU masks' bits (``mask_words`` int32, in
    ``mask_layout``: threads a tile, words a thread a layer).  Raises
    unless ``slabs`` holds make_bwd_slabs' layouts for ws."""
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    if cfg.mode != "idr" or cfg.d_in != 9 or \
            ins[0] != _narrow(cfg) + cfg.d_feature:
        raise ValueError("K3-bwd and K3-bwd-bf16 take [pts | PE(dirs) | "
                         "normals | feature]")
    (_, flay), (_, rlay) = slabs
    ops = tuple(getattr(lay, "operand", None) for lay in (flay, rlay))
    if ops == ("wgmma-f32-rad", "wgmma-f32-rad-rev"):
        return _bwd_wgf_plan(cfg, ws, n, slabs, sms, masks)
    if not (isinstance(flay, TP.SweepLayout)
            and flay.operand == "wgmma-bf16-rad"
            and isinstance(rlay, TP.SweepLayout)
            and rlay.operand == "wgmma-bf16-rad-rev"):
        raise ValueError("K3-bwd and K3-bwd-bf16 multiply on wgmma: they "
                         "take make_bwd_slabs' two slab packs")
    if flay != TP.rad_sweep_layout(ins, outs, _narrow(cfg)) or \
            rlay != TP.rad_rev_layout(ins, outs, _narrow(cfg)):
        raise ValueError("K3-bwd-bf16: the slab packs' layouts do not match "
                         "the network's widths")
    L = len(ws)
    tiles = -(-n // WG_TILE)
    nc = 2 if tiles > sms else 1
    n_pass = -(-tiles // nc)
    grid = min(n_pass, sms)
    nmb = [5] + [-(-i // 64) for i in ins[1:]]
    units = sum((b + 1) // 2 for b in nmb)
    per = -(-tiles // max(1, sms // units))
    chunks = -(-tiles // per)
    img = n_pass * nc * WG_BLOCK * (5 + 4 * (L - 1) + 4 * (L - 1) + 1)
    iargs = [L, cfg.multires_view, cfg.d_view, n, nc, grid, n_pass, chunks,
             per, int(cfg.squeeze_out), int(masks), *ins, *outs, *flay.off,
             *rlay.off]
    # shared memory a block (the source's count): the pass's ring of R and
    # X images
    rblocks = [4] * (L - 1) + [1]
    stage = -(-max((r + min(2, b)) * WG_BLOCK for r, b in zip(rblocks, nmb))
              // 1024) * 1024
    wns = min(8, (TP.SMEM_MAX - 1024) // (stage + 16))
    return {"iargs": iargs, "grid": grid, "nc": nc, "n_pass": n_pass,
            "units": units, "chunks": chunks, "per": per,
            "sweep_smem": _sweep16_smem(nc, L),
            "wgrad_smem": 1024 + wns * (stage + 16),
            "tiles": tiles, "image_bytes": img,
            "db_floats": grid * nc * 4 * L * WG_DB_ROW,
            "slot_floats": units * chunks * 2 * WG_SLOT_ROWS * 128 * 4,
            "mask_words": n_pass * nc * 128 * (L - 1) * 4 if masks else 0,
            "mask_layout": (128, 4)}


@functools.lru_cache(maxsize=8)
def _mask_places(device: torch.device, threads: int,
                 words: int) -> Tuple[torch.Tensor, ...]:
    """For thread tid of a tile's ``threads`` (consumer tid / 128, its
    output columns from 128 (tid / 128) on) and accumulator index i = 4 q
    + e < 32 words: the row (16 w + g + 8 (e >= 2)) and column (8 q + 2 t
    + e % 2 past the consumer's first) of its value in the tile, and the
    word (i / 32) and bit (i % 32) of its mask."""
    tid = torch.arange(threads)[:, None]
    i = torch.arange(32 * words)[None, :]
    lane = tid % 32
    row = 16 * ((tid % 128) // 32) + lane // 4 + 8 * (i % 4 >= 2)
    col = 128 * (tid // 128) + 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return tuple(v.to(device) for v in (row, col, (i // 32)[0],
                                        (i % 32)[0]))


def decode_mask_bits(bits: torch.Tensor, n: int,
                     outs: Sequence[int]) -> List[torch.Tensor]:
    """The ReLU masks a_l > 0 [n, outs[l]] of each hidden layer from a
    wgmma radiance backward's mask words ([tiles, threads, hidden layers,
    words] int32: K3-bwd-bf16's 128 threads of 4 words, K3-bwd's two
    consumers' 256 of 2; bit i % 32 of word i / 32 is accumulator index i
    of the thread)."""
    tiles, threads, H, words = bits.shape
    row, col, word, bit = _mask_places(bits.device, threads, words)
    out = []
    for l in range(H):
        b = (bits[:, :, l, word] >> bit) & 1           # [tiles, threads, i]
        m = torch.zeros(tiles, WG_TILE, 256, dtype=torch.bool,
                        device=bits.device)
        m[:, row, col] = b.bool()
        out.append(m.view(-1, 256)[:n, :outs[l]])
    return out


def _launch_backward_wg(cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                        slabs, masks: Optional[list] = None,
                        bf16: bool = True):
    """K3-bwd-bf16 (``bf16``) or K3-bwd on make_bwd_slabs' packs of the
    mode."""
    kernel = KERNELS["bwd", bf16]
    dev = pts.device
    if slabs is None:
        raise ValueError(f"{kernel.name} reads make_bwd_slabs' packs, built "
                         f"once a step by RenderingNetwork.kernel_weights: "
                         f"none was given")
    want = "wgmma-bf16-rad" if bf16 else "wgmma-f32-rad"
    if getattr(slabs[0][1], "operand", None) != want:
        raise ValueError(f"{kernel.name} multiplies on {want} slabs: it "
                         f"takes no other pack")
    (fp, _), (rp, _) = slabs
    pts, normals, dirs, feat = _inputs(kernel.name, pts, normals, dirs,
                                       feat)
    bs = [b.detach().contiguous() for b in bs]
    ct_rgb = ct_rgb.contiguous()
    _cuda.check_cuda_tensors(kernel.name, [pts, normals, dirs, feat, ct_rgb,
                                           fp, rp, *bs])
    n = pts.shape[0]
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    P = sum(i * o + o for i, o in zip(ins, outs))
    cts = [torch.empty_like(v) for v in (pts, normals, dirs, feat)]
    if n > 0:
        plan = bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev),
                           masks is not None)
        grads = torch.empty(P, device=dev, dtype=torch.float32)
        f32 = lambda k: torch.empty(k, device=dev, dtype=torch.float32)
        img = torch.empty(plan["image_bytes"], device=dev, dtype=torch.uint8)
        bits = torch.empty(max(1, plan["mask_words"]), device=dev,
                           dtype=torch.int32)
        kernel.launch(plan["iargs"],
                      [pts, normals, dirs, feat, ct_rgb, *cts, img,
                       f32(plan["db_floats"]), f32(plan["slot_floats"]),
                       grads, fp, rp, bits, *bs], 1.0, dev)
        if masks is not None:
            threads, words = plan["mask_layout"]
            masks.extend(decode_mask_bits(
                bits.view(-1, threads, len(ws) - 1, words), n, outs))
    else:
        grads = torch.zeros(P, device=dev, dtype=torch.float32)
    return (*cts, *_unpack_grads(grads, ins, outs))


class RadianceFn(torch.autograd.Function):
    """(pts, normals, dirs, feat, *ws, *bs) -> rgb through K3-fwd (on
    ``pack``, make_fwd_pack(cfg, ws, bf16), built without grad by the
    caller); backward through K3-bwd on
    ``slabs`` (make_bwd_slabs(cfg, ws, bf16), saved here for the
    backward); ``bf16``: through K3-fwd-bf16 and K3-bwd-bf16.  On a CPU
    tensor (``pack`` None) the bf16 mode runs the explicit twins; the f32
    mode does not come here on the CPU (radiance_plain differentiates
    itself)."""

    @staticmethod
    def forward(ctx, cfg, bf16, pack, slabs, pts, normals, dirs, feat,
                *params):
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if pts.is_cuda:
            rgb = launch_forward(cfg, ws, bs, pts, normals, dirs, feat, pack,
                                 bf16)
        else:
            rgb = radiance_plain(ws, bs, cfg, pts, normals, dirs, feat, bf16)
        ctx.cfg, ctx.bf16, ctx.slabs = cfg, bf16, slabs
        ctx.save_for_backward(pts, normals, dirs, feat, *params)
        return rgb

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_rgb):
        pts, normals, dirs, feat, *params = ctx.saved_tensors
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if pts.is_cuda:
            *cts, dws, dbs = launch_backward(
                ctx.cfg, ws, bs, pts, normals, dirs, feat, ct_rgb,
                pack=ctx.slabs, bf16=ctx.bf16)
        else:
            *cts, dws, dbs = radiance_bwd_plain(ws, bs, ctx.cfg, pts,
                                                normals, dirs, feat, ct_rgb,
                                                ctx.bf16)
        grads = [None, None, None, None, *cts, *dws, *dbs]
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def radiance(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
             pts, normals, dirs, feat,
             pack: Optional[Tuple[torch.Tensor, TP.SweepLayout]] = None,
             bf16: bool = False, slabs=None) -> torch.Tensor:
    """rgb [N, d_out], differentiable in every input, ws and bs: K3 on a
    CUDA tensor, the plain twin on a CPU tensor; ``bf16``: in the bf16
    operand mode, through K3-fwd-bf16 and K3-bwd-bf16 or their twins.
    ``pack``: the pack K3-fwd reads, make_fwd_pack(cfg, ws, bf16); on a
    CUDA tensor it raises without it.
    ``slabs``: make_bwd_slabs(cfg, ws, bf16), which a backward through
    K3-bwd or K3-bwd-bf16 reads (on a CUDA tensor, where a backward can
    follow, i.e. with grad enabled and an input or a weight requiring it,
    it raises without them)."""
    if pts.is_cuda:
        if cfg.mode != "idr":
            raise NotImplementedError(
                f"the radiance kernels run mode 'idr' only, not "
                f"{cfg.mode!r}")
        if (slabs is None and torch.is_grad_enabled()
                and any(t.requires_grad for t in (pts, normals, dirs, feat,
                                                  *ws, *bs))):
            raise ValueError("radiance: the backward reads make_bwd_slabs' "
                             "packs (slabs=)")
        if pack is None:
            raise ValueError("radiance: K3-fwd reads its pack (pack=)")
        return RadianceFn.apply(cfg, bf16, pack, slabs, pts, normals, dirs,
                                feat, *ws, *bs)
    if pts.device.type == "cpu":
        if bf16:
            return RadianceFn.apply(cfg, True, None, None, pts, normals,
                                    dirs, feat, *ws, *bs)
        return radiance_plain(ws, bs, cfg, pts, normals, dirs, feat)
    raise ValueError(f"radiance: unsupported device {pts.device}")
