"""K1: the fused SDF geometry core and its backward (csrc/geometry_fwd_wg.cu,
csrc/geometry_bwd_wg.cu; in the bf16 mode csrc/geometry_fwd_bf16_wg.cu,
csrc/geometry_bwd_bf16_wg.cu; the switch-only backwards in
csrc/geometry_bwd_chains_wg.cu and csrc/geometry_bwd_chains_bf16_wg.cu),
with their plain PyTorch twins.

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

The HBM-stash pair (``stash=True``, default from ``FNEUS_PG_HBM_STASH`` as
in the JAX package): K1-fwd-stash also returns the hidden layers'
pre-activations in bf16 [N, sum of their widths], and K1-bwd-stash takes
the primal activations from them and recomputes only the tangent forward.
Its twins are ``geometry_fwd_stash_plain`` and ``geometry_bwd_stash_plain``;
on a CPU tensor the same autograd Function runs them.

K1-bwd-split (``stacked=False``, default from ``FNEUS_PG_STACKED`` as in
the JAX package) computes K1-bwd's function with the primal and tangent
chains as separate half-tile products; its twin is K1-bwd's.  The stash
switch takes precedence over it, as in the JAX package.

Every K1 kernel runs on Hopper's warpgroup ``wgmma`` and reads the two
slab packs of its operand mode, ``make_bwd_slabs(cfg, ws, bf16)``, built
once a step, once a validation image or once a stage-2/3 run by
``fields.SDFNetwork.kernel_weights`` wherever K1 runs; a launch raises
without them, before any CUDA call.  In f32 they run in 3xTF32
(csrc/wgf.cuh's engine, which K3-bwd shares) on the TF32 big and small
slabs of tc_pack.pack_sweep_f32 (X W) and pack_rev_f32 (r W): K1-fwd is
the primal forward through all nine layers and the reverse sweep from e0
/ scale (``geometry_explicit(mm=sweep_mm_f32)`` emulates its arithmetic),
and K1-fwd-stash the same sweep with the bf16 stash stored from its
hidden layers' epilogues (``fwd_wg_plan(stash=True)``), so its out and
grad are K1-fwd's bit for bit; K1-bwd a stacked sweep that writes each
layer's f32 X_l and R_l, then a split-K ``wgmma`` pass dW_l = X_l^T R_l
and a fixed-order reduce (``weight_grad_pass_plain(f32=True)`` is that
pass in plain PyTorch, ``sweep_mm_f32`` the sweep's products).  K2 reads
the first of those packs too (sdf_kernel).  K1-bwd-split and
K1-bwd-stash (csrc/geometry_bwd_chains_wg.cu, ``chains_wg_plan``): tiles
of 64 points, each chain's 64 rows one product, K1-bwd's pass over images
in K1-bwd's row order (``geometry_bwd_plain(mm=sweep_mm_f32)`` emulates
their arithmetic).

The bf16 operand mode (``bf16=True``; the stage-1 renderer's
``RendererConfig.core_act_bf16``, ``FNEUS_CORE_ACT_BF16``, as in the JAX
package) is pallas_geometry's ``_mm_fns(bf16=True)``: every product of
the forward, of its reverse sweep and of the backward (the stacked
primal and tangent rows, the weight gradients and the input cotangents)
takes both operands rounded to bf16 and sums in f32; everything
elementwise stays f32.  Each entry point has a bf16 twin kernel
(K1-fwd-bf16, K1-bwd-bf16, K1-bwd-split-bf16, K1-fwd-stash-bf16,
K1-bwd-stash-bf16), each on the two bf16 slab packs (tc_pack.pack_sweep_bf16's
for X W and pack_rev_bf16's for r W): K1-fwd-bf16
(csrc/geometry_fwd_bf16_wg.cu) is K2-bf16's forward with the full output,
sigma(100 a) kept in an f32 scratch, and the reverse sweep from e0 /
scale (``fwd_wg16_plan`` is its launch), K1-fwd-stash-bf16 the same sweep
with the bf16 stash stored from its hidden layers' epilogues; K1-bwd-bf16
(csrc/geometry_bwd_bf16_wg.cu) a stacked sweep which writes each layer's
bf16 X_l and R_l, then a split-K ``wgmma`` pass dW_l = X_l^T R_l and a
fixed-order reduce (``weight_grad_pass_plain`` is that pass in plain
PyTorch).  K1-bwd-split-bf16 and K1-bwd-stash-bf16
(csrc/geometry_bwd_chains_bf16_wg.cu, ``chains_wg16_plan``): tiles of 64
points, in the forward a consumer warpgroup a chain, each chain's 64 rows
one product (the stash's tangent forward alone, beside the softplus of
K1-fwd-stash-bf16's bf16 stash), then K1-bwd-bf16's stacked reverse,
pass and reduce.  The plain twins compute the same products explicitly
(``geometry_plain(bf16=True)``, ``geometry_bwd_plain(bf16=True)``):
autograd through a rounding would run the backward's products on
unrounded cotangents.  On a CPU tensor the autograd Function runs them.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from . import tc_pack as TP
from .mlp import softplus_beta
from .embedder import positional_encoding
from .sdf_kernel import (SW_ENC_STRIDE, WG_ROWS, layer_dims,
                         make_sweep_pack, sdf_forward_plain, skip_layers,
                         sweep_iargs, sweep_smem)
from .tc_pack import mm_bf16

K1_FWD = _cuda.CudaKernel("geometry_fwd", "geometry_fwd_wg.cu",
                          "geometry_fwd")
K1_BWD = _cuda.CudaKernel("geometry_bwd", "geometry_bwd_wg.cu",
                          "geometry_bwd")
K1_FWD_STASH = _cuda.CudaKernel("geometry_fwd_stash", "geometry_fwd_wg.cu",
                                "geometry_fwd_stash")
K1_BWD_STASH = _cuda.CudaKernel("geometry_bwd_stash",
                                "geometry_bwd_chains_wg.cu",
                                "geometry_bwd_stash")
K1_BWD_SPLIT = _cuda.CudaKernel("geometry_bwd_split",
                                "geometry_bwd_chains_wg.cu",
                                "geometry_bwd_split")
# the bf16 operand mode's entry points
K1_FWD_BF16 = _cuda.CudaKernel("geometry_fwd_bf16",
                               "geometry_fwd_bf16_wg.cu", "geometry_fwd_bf16")
K1_BWD_BF16 = _cuda.CudaKernel("geometry_bwd_bf16",
                               "geometry_bwd_bf16_wg.cu", "geometry_bwd_bf16")
K1_FWD_STASH_BF16 = _cuda.CudaKernel("geometry_fwd_stash_bf16",
                                     "geometry_fwd_bf16_wg.cu",
                                     "geometry_fwd_stash_bf16")
K1_BWD_STASH_BF16 = _cuda.CudaKernel("geometry_bwd_stash_bf16",
                                     "geometry_bwd_chains_bf16_wg.cu",
                                     "geometry_bwd_stash_bf16")
K1_BWD_SPLIT_BF16 = _cuda.CudaKernel("geometry_bwd_split_bf16",
                                     "geometry_bwd_chains_bf16_wg.cu",
                                     "geometry_bwd_split_bf16")
# the kernel of each (entry, operand mode)
KERNELS = {("fwd", False): K1_FWD, ("fwd", True): K1_FWD_BF16,
           ("bwd", False): K1_BWD, ("bwd", True): K1_BWD_BF16,
           ("fwd_stash", False): K1_FWD_STASH,
           ("fwd_stash", True): K1_FWD_STASH_BF16,
           ("bwd_stash", False): K1_BWD_STASH,
           ("bwd_stash", True): K1_BWD_STASH_BF16,
           ("bwd_split", False): K1_BWD_SPLIT,
           ("bwd_split", True): K1_BWD_SPLIT_BF16}
# the HBM-stash pair instead of K1-fwd / K1-bwd, and K1-bwd-split instead
# of K1-bwd, when ``geometry`` is not told otherwise; read once, at import,
# like the JAX package's switches
STASH_BWD = os.environ.get("FNEUS_PG_HBM_STASH", "0") == "1"
STACKED_BWD = os.environ.get("FNEUS_PG_STACKED", "1") == "1"


def _skip_layers(cfg, L: int):
    return {l for l in cfg.skip_in if 0 <= l < L}


def geometry_explicit(ws, bs, x: torch.Tensor, cfg, mm=None,
                      preacts: Optional[List[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, grad) written out as pallas_geometry's _build_fwd_kernel
    computes them, without gradient: the forward, then the reverse sweep
    from e0 / scale, each product by ``mm``: mm_bf16 (the default; the
    bf16 mode's, whose first reverse step rounds e0 / scale and W_last's
    row 0 to bf16 as JAX's dot does), or another, e.g. sweep_mm_f32 (K1-fwd's
    3xTF32 products, whose first reverse step is W_last's row 0 / scale
    read exactly, with no product)."""
    bf16 = mm is None
    mm = mm or mm_bf16
    ins, _, _ = layer_dims(cfg, ws)
    L, skip = len(ws), _skip_layers(cfg, len(ws))
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    s = cfg.scale
    with torch.no_grad():
        u = x * s
        enc = positional_encoding(u, cfg.multires)
        h, pre = enc, []
        for l in range(L):
            if l in skip:
                h = torch.cat([h, enc], -1) * inv_sqrt2
            a = mm(h, ws[l].t()) + bs[l]
            if l < L - 1:
                pre.append(a)
                h = softplus_beta(a, 100.0)
        col = torch.ones(a.shape[1], dtype=a.dtype, device=a.device)
        col[0] = 1.0 / s
        out = a * col
        r = torch.zeros_like(a)
        r[:, 0] = 1.0 / s
        r_enc = torch.zeros_like(enc)
        for l in range(L - 1, -1, -1):
            if l == L - 1 and not bf16:
                r_in = (ws[l][0] * (1.0 / s)).expand(x.shape[0], -1)
            else:
                r_in = mm(r, ws[l])
            if l in skip:
                hw = ins[l] - cfg.d_embed
                r_in = r_in * inv_sqrt2
                r_enc = r_enc + r_in[:, hw:]
                r_in = r_in[:, :hw]
            if l == 0:
                r_enc = r_enc + r_in
            else:
                r = r_in * torch.sigmoid(100.0 * pre[l - 1])
        zero = torch.zeros_like(u)
        grad = _encode_backward(u, zero, r_enc, torch.zeros_like(r_enc),
                                cfg.multires) * s
    if preacts is not None:
        preacts.extend(pre)
    return out, grad


def geometry_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   x: torch.Tensor, cfg,
                   preacts: Optional[List[torch.Tensor]] = None,
                   bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: (out, grad) from one forward and one autograd VJP that
    stays differentiable when gradients are enabled.  The hidden layers'
    pre-activations are appended to ``preacts`` when it is given.
    ``bf16``: the bf16 mode's (out, grad), without gradient (its backward
    is geometry_bwd_plain(bf16=True); ``geometry`` joins the two)."""
    if bf16:
        return geometry_explicit(ws, bs, x, cfg, preacts=preacts)
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        out = sdf_forward_plain(ws, bs, cfg, xg, preacts)
        (grad,) = torch.autograd.grad(out[:, 0].sum(), xg,
                                      create_graph=create)
    if not create:
        return out.detach(), grad.detach()
    return out, grad


def geometry_fwd_stash_plain(ws, bs, x: torch.Tensor, cfg, bf16: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Twin of K1-fwd-stash (bf16: K1-fwd-stash-bf16): (out, grad, stash),
    the stash being the hidden pre-activations [N, sum of outs[:-1]]
    rounded to bf16."""
    pre: List[torch.Tensor] = []
    with torch.no_grad():
        out, grad = geometry_plain(ws, bs, x, cfg, pre, bf16)
    stash = torch.cat([a.detach() for a in pre], -1).to(torch.bfloat16)
    return out, grad, stash


def _encode_with_tangent(u, v, multires: int):
    """The positional encoding of u and its tangent along v."""
    enc, denc = [u], [v]
    for i in range(multires):
        f = 2.0 ** i
        s, c = torch.sin(f * u), torch.cos(f * u)
        enc += [s, c]
        denc += [c * (f * v), -s * (f * v)]
    return torch.cat(enc, -1), torch.cat(denc, -1)


def _encode_backward(u, v, r, rd, multires: int):
    """Cotangent of u from those of the encoding (r) and of its tangent
    along v (rd)."""
    ct = r[:, :3]
    for i in range(multires):
        f = 2.0 ** i
        o = 3 + 6 * i
        s, c = torch.sin(f * u), torch.cos(f * u)
        ct = (ct + f * (r[:, o:o + 3] * c - r[:, o + 3:o + 6] * s)
              - f * f * v * (rd[:, o:o + 3] * s + rd[:, o + 3:o + 6] * c))
    return ct


def geometry_bwd_plain(ws: Sequence[torch.Tensor],
                       bs: Optional[Sequence[torch.Tensor]], x: torch.Tensor,
                       ct_out: torch.Tensor, ct_grad: torch.Tensor, cfg,
                       bf16: bool = False,
                       stash: Optional[torch.Tensor] = None,
                       operands: Optional[dict] = None, mm=None
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]:
    """Explicit twin of the K1 backward (pallas_geometry's
    _build_bwd_kernel_stacked, or with ``stash`` _build_bwd_kernel_from_stash):
    (ct_x, dW per layer [out, in], db per layer) from the primal forward
    (recomputed with the biases, or taken from the bf16 ``stash``, which
    reads no bias) and the tangent forward along ct_grad, then the reverse
    sweep of both chains.  ``bf16``: every product on bf16-rounded
    operands, as the bf16 kernels compute them.  ``operands``: receives,
    for each layer l, the weight gradient's operands (x_l, xd_l, r_l, rd_l)
    (weight_grad_pass_plain).  ``mm``: the products of the sweep (a, b)
    -> a @ b, in place of the operand mode's (sweep_mm_f32 emulates the
    f32 wgmma kernels': each chain's rows one product, as K1-bwd-split and
    K1-bwd-stash run them; K1-bwd's stacked rows give each row the same
    products).  Computes in x's dtype."""
    dt = x.dtype
    mm = mm or (mm_bf16 if bf16 else torch.matmul)
    ins, _, _ = layer_dims(cfg, ws)
    L, skip = len(ws), _skip_layers(cfg, len(ws))
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    s = cfg.scale
    with torch.no_grad():
        u, v = x * s, ct_grad * s
        enc, denc = _encode_with_tangent(u, v, cfg.multires)
        if stash is None:
            a, h = [], enc
            for l in range(L - 1):
                if l in skip:
                    h = torch.cat([h, enc], -1) * inv_sqrt2
                a.append(mm(h, ws[l].t()) + bs[l])
                h = softplus_beta(a[l], 100.0)
        else:
            a = torch.split(stash.to(dt), [w.shape[0] for w in ws[:-1]],
                            dim=1)
        sig = [torch.sigmoid(100.0 * al) for al in a]
        ad, xd = [], denc
        for l in range(L - 1):
            if l in skip:
                xd = torch.cat([xd, denc], -1) * inv_sqrt2
            ad.append(mm(xd, ws[l].t()))
            xd = sig[l] * ad[l]

        r = ct_out.clone()
        r[:, 0] = r[:, 0] / s
        rd = torch.zeros_like(r)
        rd[:, 0] = 1.0 / s
        r_enc, r_denc = torch.zeros_like(enc), torch.zeros_like(enc)
        dws: List[torch.Tensor] = [None] * L
        dbs: List[torch.Tensor] = [None] * L
        for l in range(L - 1, -1, -1):
            if l == 0:
                xl, xdl = enc, denc
            else:
                xl, xdl = softplus_beta(a[l - 1], 100.0), sig[l - 1] * ad[l - 1]
                if l in skip:
                    xl = torch.cat([xl, enc], -1) * inv_sqrt2
                    xdl = torch.cat([xdl, denc], -1) * inv_sqrt2
            dws[l] = mm(r.t(), xl) + mm(rd.t(), xdl)
            dbs[l] = r.sum(0)
            if operands is not None:
                operands[l] = (xl, xdl, r, rd)
            r_in, rd_in = mm(r, ws[l]), mm(rd, ws[l])
            if l in skip:
                hw = ins[l] - cfg.d_embed
                r_in, rd_in = r_in * inv_sqrt2, rd_in * inv_sqrt2
                r_enc = r_enc + r_in[:, hw:]
                r_denc = r_denc + rd_in[:, hw:]
                r_in, rd_in = r_in[:, :hw], rd_in[:, :hw]
            if l == 0:
                r_enc, r_denc = r_enc + r_in, r_denc + rd_in
            else:
                sg = sig[l - 1]
                ds = 100.0 * sg * (1.0 - sg)
                r, rd = r_in * sg + rd_in * ds * ad[l - 1], rd_in * sg
        ct_x = _encode_backward(u, v, r_enc, r_denc, cfg.multires) * s
    return ct_x, dws, dbs


# K1-bwd's sweep (csrc/geometry_bwd_wg.cu): each slab of 32 k summed into
# a fresh wgmma accumulator (toward zero), then added to the running sum
# with a rounded add; its pass: each 32-row stage the same way
WGF_SWEEP_STAGE = 32
WGF_PASS_STAGE = 32


def sweep_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K1-bwd's sweep computes a product (geometry_bwd_plain's
    ``mm``): a, the layer input from the A tile, split by the tensor core's
    truncation (small made beside it); b, the weights, pre-split by the
    packer (rounded); 3xTF32 a k-step, a rounded add every slab."""
    return TP.mm_3xtf32(a, b, WGF_SWEEP_STAGE, "trunc", "round")


def _tile_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stacked rows of a (primal) and b (tangent) [n, C] in the order
    of K1-bwd's tiles: tile after tile of WG_POINTS points, in each warp's
    16 rows its 8 points' primal rows, then their tangent rows; the points
    padded with zero rows to whole tiles."""
    n, T = a.shape[0], -(-a.shape[0] // WG_POINTS)
    pad = lambda v: torch.cat([v, v.new_zeros(T * WG_POINTS - n, v.shape[1])])
    return torch.stack([pad(a).view(T, 4, 8, -1), pad(b).view(T, 4, 8, -1)],
                       2).reshape(T * 2 * WG_POINTS, -1)


def weight_grad_pass_plain(operands: dict, tiles_per_chunk: int,
                           f32: bool = False
                           ) -> Tuple[List[torch.Tensor],
                                      List[torch.Tensor]]:
    """A wgmma backward's weight-gradient pass in plain PyTorch, on the
    operands geometry_bwd_plain(operands=...) recorded: (dW per layer
    [out, in], db per layer).  The points are cut into chunks of
    ``tiles_per_chunk`` tiles of WG_POINTS; dW_l is the sum, chunk after
    chunk, of [x_l; xd_l]^T [r_l; rd_l] over the chunk's stacked rows: on
    bf16-rounded operands with an f32 sum (K1-bwd-bf16, pallas_geometry's
    stacked dot_at), or (``f32``: K1-bwd's) in 3xTF32 on both operands as
    the tensor core reads them from the images, the rows in the tiles'
    order, each 32-row stage into a fresh accumulator added to the chunk's
    sum with a rounded add; db_l the f32 sum of r_l."""
    L = len(operands)
    dws, dbs = [], []
    for l in range(L):
        xl, xdl, r, rd = operands[l]
        if f32:
            x2, r2 = _tile_rows(xl, xdl), _tile_rows(r, rd)
        step = (2 if f32 else 1) * WG_POINTS * tiles_per_chunk
        dw = None
        for c0 in range(0, (x2 if f32 else xl).shape[0], step):
            c = slice(c0, c0 + step)
            if f32:
                part = TP.mm_3xtf32(x2[c].t(), r2[c], WGF_PASS_STAGE,
                                    "trunc", "trunc").t()
            else:
                part = mm_bf16(torch.cat([r[c], rd[c]]).t(),
                               torch.cat([xl[c], xdl[c]]))
            dw = part if dw is None else dw + part
        dws.append(dw)
        dbs.append(r.sum(0))
    return dws, dbs


def geometry_bwd_stash_plain(ws: Sequence[torch.Tensor], x: torch.Tensor,
                             stash: torch.Tensor, ct_out: torch.Tensor,
                             ct_grad: torch.Tensor, cfg, bf16: bool = False
                             ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                        List[torch.Tensor]]:
    """Twin of K1-bwd-stash (bf16: K1-bwd-stash-bf16): geometry_bwd_plain
    with the primal h and sigma(100 a) taken from the bf16 stash and the
    tangent forward along ct_grad recomputed; biases are not read."""
    return geometry_bwd_plain(ws, None, x, ct_out, ct_grad, cfg, bf16,
                              stash)


def stash_columns(ws: Sequence[torch.Tensor]) -> int:
    """Width of a stash row: the hidden layers' widths summed."""
    return sum(int(w.shape[0]) for w in ws[:-1])


def launch_forward(cfg, x, ws, bs, pack=None, bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-fwd (bf16: K1-fwd-bf16): (out [N, d_out], grad [N, 3]).
    ``pack``: make_bwd_slabs(cfg, ws, bf16), the two slab packs the kernel
    reads (it raises without them)."""
    return _launch_forward_wg(cfg, x, ws, bs, pack, bf16)[:2]


def launch_forward_stash(cfg, x, ws, bs, slabs=None, bf16: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1-fwd-stash (bf16: K1-fwd-stash-bf16): (out, grad, bf16 stash
    [N, stash_columns(ws)]).  ``slabs``: make_bwd_slabs(cfg, ws, bf16), the
    two slab packs the kernel reads (it raises without them)."""
    return _launch_forward_wg(cfg, x, ws, bs, slabs, bf16, stash=True)


# K1-bwd-bf16 (csrc/geometry_bwd_bf16_wg.cu): a consumer warpgroup's tile
# of points (GW_PTS; 64 stacked rows), the float4 rows of a weight-gradient
# slot (GW_PQ), the bytes of a 64-column block of a tile image (GW_XB), a
# db slot's row (GW_BW)
WG_POINTS = 32
WG_SLOT_ROWS = 40
WG_BLOCK = 8192
WG_DB_ROW = 264


def make_bwd_slabs(cfg, ws: Sequence[torch.Tensor], bf16: bool = True):
    """The two slab packs of ws that K1's wgmma kernels read: K1-bwd-bf16's
    (pack_sweep_bf16's, the forward X W, also K2-bf16's; pack_rev_bf16's,
    the reverse r W), or with ``bf16`` False K1-fwd's and K1-bwd's
    (pack_sweep_f32's, also K2's; pack_rev_f32's: TF32 big and small
    halves)."""
    rev = TP.pack_rev_bf16 if bf16 else TP.pack_rev_f32
    return make_sweep_pack(cfg, ws, bf16), rev(ws, cfg.d_embed)


# K1-bwd (csrc/geometry_bwd_wg.cu): a weight-gradient slot row (FW_SN), the
# sweep's shared memory (its ring of two 64 KB slab stages, the 64 KB A
# tile, the encoding tiles, the barriers)
WGF_SLOT_COLS = 136
WGF_SWEEP_SMEM = 1024 + 2 * 65536 + 65536 + 2 * WG_POINTS * 2 * 48 * 4 + 32


def _bwd_wgf_plan(cfg, ws, n: int, slabs, sms: int) -> dict:
    """K1-bwd's launch (bwd_wg_plan for make_bwd_slabs(bf16=False)'s
    packs): the sweep, a block of two consumer warpgroups a tile, one
    persistent block a tile up to one a SM; the weight-gradient pass,
    ``units`` (a layer, a pair of 64-column X blocks, a 128-column R half)
    times ``chunks`` of ``per`` tiles."""
    ins, outs, _ = layer_dims(cfg, ws)
    (_, flay), (_, rlay) = slabs
    if flay != TP.sweep_layout_f32(ins, outs, skip_layers(cfg, len(ws)),
                                   cfg.d_embed) or \
            rlay != TP.rev_layout_f32(ins, outs, cfg.d_embed):
        raise ValueError("K1-bwd: the slab packs' layouts do not match the "
                         "network's widths")
    L = len(ws)
    tiles = -(-n // WG_POINTS)
    grid = min(tiles, sms)
    cx = [64] + [256] * (L - 1)
    cr = [264 if o > 256 else 256 for o in outs]
    units = sum(2 * -(-c // 128) for c in cx)
    per = -(-tiles // max(1, sms // units))
    chunks = -(-tiles // per)
    img = tiles * 4 * sum(2 * x * 32 + 2 * r * 32 for x, r in zip(cx, cr))
    stage = max(2 * (r - 128 if h else 128) * 128 + min(128, x - 128 * p) * 128
                for x, r in zip(cx, cr) for p in range(-(-x // 128))
                for h in (0, 1))
    stage = -(-stage // 1024) * 1024
    wns = min(8, (TP.SMEM_MAX - 1024) // (stage + 24))
    iargs = [L, cfg.multires, cfg.d_embed, n, grid, tiles, chunks, per,
             *ins, *outs, *flay.enc[:-1], 0, *flay.off[:-1], 0, *rlay.off,
             *rlay.cols]
    return {"iargs": iargs, "grid": grid, "nc": 2, "n_pass": tiles,
            "units": units, "chunks": chunks, "per": per,
            "sweep_smem": WGF_SWEEP_SMEM,
            "wgrad_smem": 1024 + wns * (stage + 24), "tiles": tiles,
            "scratch_floats": grid * (L - 1) * 16 * 256 * 4,
            "image_bytes": img,
            "db_floats": grid * 4 * L * WG_DB_ROW,
            "slot_floats": units * chunks * 2 * 64 * WGF_SLOT_COLS}


# K1-fwd (csrc/geometry_fwd_wg.cu): a tile's points (GF_TILE), the sweep's
# shared memory (its ring of two 66 KB slab stages, the 64 KB A tile, the
# encoding tiles, the barriers)
WGF_FWD_POINTS = 64
WGF_FWD_SMEM = 1024 + 2 * 67584 + 65536 + 2 * 64 * 48 * 4 + 32


def fwd_wg_plan(cfg, ws, n: int, slabs, sms: int,
                stash: bool = False) -> dict:
    """K1-fwd's launch (``stash``: K1-fwd-stash's): its integer arguments
    (``iargs``, geometry_fwd_wg.cu; K1-fwd-stash's end with the stash's
    columns, ``stash_columns``) and the sizes of what the wrapper
    allocates: tiles of WGF_FWD_POINTS points, one persistent block a tile
    up to one a SM, each with its f32 scratch of sigma(100 a)
    (``scratch_floats``).  Raises unless ``slabs`` holds
    make_bwd_slabs(bf16=False)'s layouts for ws."""
    name = "K1-fwd-stash" if stash else "K1-fwd"
    ins, outs, _ = layer_dims(cfg, ws)
    (_, flay), (_, rlay) = slabs
    if getattr(flay, "operand", None) != "wgmma-f32" or \
            getattr(rlay, "operand", None) != "wgmma-f32-rev":
        raise ValueError(f"{name} multiplies on wgmma: it takes "
                         f"make_bwd_slabs(bf16=False)'s two slab packs")
    if flay != TP.sweep_layout_f32(ins, outs, skip_layers(cfg, len(ws)),
                                   cfg.d_embed) or \
            rlay != TP.rev_layout_f32(ins, outs, cfg.d_embed):
        raise ValueError(f"{name}: the slab packs' layouts do not match "
                         f"the network's widths")
    L = len(ws)
    tiles = -(-n // WGF_FWD_POINTS)
    grid = min(tiles, sms)
    cols = stash_columns(ws) if stash else 0
    iargs = [L, cfg.multires, cfg.d_embed, n, grid, tiles, *ins, *outs,
             *flay.enc, *flay.off, *rlay.off, *rlay.cols, flay.cols[-1]]
    return {"iargs": iargs + ([cols] if stash else []), "grid": grid,
            "tiles": tiles, "sweep_smem": WGF_FWD_SMEM,
            "scratch_floats": grid * (L - 1) * 16 * 256 * 4,
            "stash_columns": cols}


def fwd_wg16_plan(cfg, ws, n: int, slabs, sms: int,
                  stash: bool = False) -> dict:
    """K1-fwd-bf16's launch (``stash``: K1-fwd-stash-bf16's): its integer
    arguments (``iargs``, geometry_fwd_bf16_wg.cu: K2-bf16's for the
    forward pack, sdf_kernel.sweep_iargs, then the reverse pack's layer
    offsets and slab widths; K1-fwd-stash-bf16's then the stash's columns,
    ``stash_columns``) and the sizes of what the wrapper allocates.  Tiles
    of sdf_kernel.WG_ROWS points (K2-bf16's), two consumer warpgroups a
    block when there are more tiles than SMs, else one; one persistent
    block a pass up to one a SM (``grid``, ``nc``, ``n_pass``: block b
    takes passes b, b + grid, ..., consumer w of pass p tile nc p + w),
    each consumer with its f32 scratch of sigma(100 a)
    (``scratch_floats``).  Raises unless ``slabs`` holds
    make_bwd_slabs(bf16=True)'s layouts for ws, the forward pack's last
    layer at full width."""
    name = "K1-fwd-stash-bf16" if stash else "K1-fwd-bf16"
    ins, outs, _ = layer_dims(cfg, ws)
    (_, flay), (_, rlay) = slabs
    if getattr(flay, "operand", None) != "wgmma-bf16" or \
            getattr(rlay, "operand", None) != "wgmma-bf16-rev":
        raise ValueError(f"{name} multiplies on wgmma: it takes "
                         f"make_bwd_slabs(bf16=True)'s two slab packs")
    if flay != TP.sweep_layout(ins, outs, skip_layers(cfg, len(ws)),
                               cfg.d_embed) or \
            rlay != TP.rev_layout(ins, outs, cfg.d_embed):
        raise ValueError(f"{name}: the slab packs' layouts do not match "
                         f"the network's widths")
    iargs, grid = sweep_iargs(cfg, ws, n, flay, sms)
    L, nc, n_pass = len(ws), iargs[4], iargs[6]
    # shared memory a block (the source's count): K2-bf16's and the
    # encoding cotangents' tiles, as wide as the encoding's
    ns, smem = sweep_smem(L, nc, TP.SLAB_ROW * max(flay.cols),
                          nc * WG_ROWS * SW_ENC_STRIDE * 4)
    if ns < max(flay.nslab):
        raise ValueError(f"{name}: a layer's slabs do not fit in the ring")
    cols = stash_columns(ws) if stash else 0
    return {"iargs": iargs + [*rlay.off, *rlay.cols]
            + ([cols] if stash else []), "grid": grid,
            "nc": nc, "n_pass": n_pass, "tiles": -(-n // WG_ROWS),
            "sweep_smem": smem,
            "scratch_floats": grid * nc * (L - 1) * 32 * 128 * 4,
            "stash_columns": cols}


def _launch_forward_wg(cfg, x, ws, bs, slabs, bf16: bool = False,
                       stash: bool = False):
    """K1-fwd-bf16 (``bf16``) or K1-fwd on make_bwd_slabs' packs of the
    mode, or with ``stash`` their stash variants: (out, grad, stash or
    None).  Raises without the packs before any CUDA call."""
    kernel = KERNELS["fwd_stash" if stash else "fwd", bf16]
    dev = x.device
    if slabs is None:
        raise ValueError(f"{kernel.name} reads make_bwd_slabs(bf16={bf16})'s "
                         f"packs, built by SDFNetwork.kernel_weights: none "
                         f"was given")
    want = "wgmma-bf16" if bf16 else "wgmma-f32"
    if getattr(slabs[0][1], "operand", None) != want:
        raise ValueError(f"{kernel.name} multiplies on {want} slabs: it "
                         f"takes no other pack")
    (fp, _), (rp, _) = slabs
    n = x.shape[0]
    st = torch.empty(n, stash_columns(ws), device=dev,
                     dtype=torch.bfloat16) if stash else None
    x = x.detach().contiguous()
    bs = [b.detach().contiguous() for b in bs]
    _cuda.check_cuda_tensors(kernel.name, [x, fp, rp, *bs])
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    grad = torch.empty(n, 3, device=dev, dtype=torch.float32)
    if n > 0:
        plan = (fwd_wg16_plan if bf16 else fwd_wg_plan)(
            cfg, ws, n, slabs, _cuda.sm_count(dev), stash)
        scratch = torch.empty(plan["scratch_floats"], device=dev,
                              dtype=torch.float32)
        side = [st] if stash else []
        kernel.launch(plan["iargs"],
                      [x, out, grad, scratch, *side, fp, rp, *bs],
                      cfg.scale, dev)
    return out, grad, st


def bwd_wg_plan(cfg, ws, n: int, slabs, sms: int) -> dict:
    """A wgmma backward's launch: its integer arguments (``iargs``,
    geometry_bwd_bf16_wg.cu, or for K1-bwd's f32 slab packs
    geometry_bwd_wg.cu, _bwd_wgf_plan) and the sizes of what the wrapper
    allocates.
    The sweep: tiles of WG_POINTS points, two consumer warpgroups a block
    when there are more tiles than SMs, else one; one persistent block a
    pass up to one a SM.  The weight-gradient pass: ``units`` (a layer
    and a pair of 64-row blocks of its dW) times ``chunks`` of ``per``
    tiles, at most one block a SM where the tiles allow.  Raises unless
    ``slabs`` holds make_bwd_slabs' layouts for ws."""
    ins, outs, _ = layer_dims(cfg, ws)
    (_, flay), (_, rlay) = slabs
    ops = tuple(getattr(lay, "operand", None) for lay in (flay, rlay))
    if ops == ("wgmma-f32", "wgmma-f32-rev"):
        return _bwd_wgf_plan(cfg, ws, n, slabs, sms)
    if ops != ("wgmma-bf16", "wgmma-bf16-rev"):
        raise ValueError("K1-bwd and K1-bwd-bf16 multiply on wgmma: they "
                         "take make_bwd_slabs' two slab packs")
    want = TP.sweep_layout(ins, outs, skip_layers(cfg, len(ws)), cfg.d_embed)
    if (flay.enc, flay.nslab, flay.off, flay.cols[:-1]) != (
            want.enc, want.nslab, want.off, want.cols[:-1]) or \
            rlay != TP.rev_layout(ins, outs, cfg.d_embed):
        raise ValueError("K1-bwd-bf16: the slab packs' layouts do not match "
                         "the network's widths")
    L = len(ws)
    tiles = -(-n // WG_POINTS)
    nc = 2 if tiles > sms else 1
    n_pass = -(-tiles // nc)
    grid = min(n_pass, sms)
    units = sum((-(-i // 64) + 1) // 2 for i in ins)   # 64-row blocks, 2 a unit
    per = -(-tiles // max(1, sms // units))
    chunks = -(-tiles // per)
    img = n_pass * nc * WG_BLOCK * sum(
        (4 if l else 1) + (5 if o > 256 else 4) for l, o in enumerate(outs))
    iargs = [L, cfg.multires, cfg.d_embed, n, nc, grid, n_pass, chunks, per,
             *ins, *outs, *flay.enc, *flay.nslab[:-1], 0, *flay.off[:-1], 0,
             *rlay.nslab, *rlay.off, *rlay.cols]
    # shared memory a block (the source's count): the sweep's encoding
    # tiles, biases and slab ring; the pass's ring of R and X images
    fixed = 1024 + nc * 2 * WG_POINTS * 2 * 48 * 4 + L * WG_DB_ROW * 4
    ns = min(8, (TP.SMEM_MAX - fixed) // (32768 + 16))
    stage = -(-max((5 if o > 256 else 4) * WG_BLOCK + min(2, -(-i // 64))
                   * WG_BLOCK for i, o in zip(ins, outs)) // 1024) * 1024
    wns = min(8, (TP.SMEM_MAX - 1024) // (stage + 16))
    return {"iargs": iargs, "grid": grid, "nc": nc, "n_pass": n_pass,
            "units": units, "chunks": chunks, "per": per,
            "sweep_smem": fixed + ns * (32768 + 16),
            "wgrad_smem": 1024 + wns * (stage + 16),
            "tiles": tiles,
            "scratch_floats": grid * nc * (L - 1) * 32 * 128 * 4,
            "image_bytes": img,
            "db_floats": grid * nc * 4 * L * WG_DB_ROW,
            "slot_floats": units * chunks * 2 * WG_SLOT_ROWS * 128 * 4}


def _launch_backward_wg(cfg, x, ws, bs, ct_out, ct_grad, slabs,
                        bf16: bool = True):
    """K1-bwd-bf16 (``bf16``) or K1-bwd on make_bwd_slabs' packs of the
    mode."""
    kernel = K1_BWD_BF16 if bf16 else K1_BWD
    dev = x.device
    if slabs is None:
        raise ValueError(f"{kernel.name} reads make_bwd_slabs' packs, built "
                         f"once a step by SDFNetwork.kernel_weights: none "
                         f"was given")
    want = "wgmma-bf16" if bf16 else "wgmma-f32"
    if getattr(slabs[0][1], "operand", None) != want:
        raise ValueError(f"{kernel.name} multiplies on {want} slabs: it "
                         f"takes no other pack")
    (fp, _), (rp, _) = slabs
    bs_c = [b.detach().contiguous() for b in bs]
    x = x.detach().contiguous()
    ct_out = ct_out.contiguous()
    ct_grad = ct_grad.contiguous()
    _cuda.check_cuda_tensors(kernel.name,
                             [x, ct_out, ct_grad, fp, rp, *bs_c])
    n = x.shape[0]
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    P = sum(i * o + o for i, o in zip(ins, outs))
    ct_x = torch.empty(n, 3, device=dev, dtype=torch.float32)
    if n > 0:
        plan = bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
        grads = torch.empty(P, device=dev, dtype=torch.float32)
        f32 = lambda k: torch.empty(k, device=dev, dtype=torch.float32)
        img = torch.empty(plan["image_bytes"], device=dev, dtype=torch.uint8)
        kernel.launch(plan["iargs"],
                      [x, ct_out, ct_grad, ct_x, f32(plan["scratch_floats"]),
                       img, f32(plan["db_floats"]), f32(plan["slot_floats"]),
                       grads, fp, rp, *bs_c], cfg.scale, dev)
    else:
        grads = torch.zeros(P, device=dev, dtype=torch.float32)
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return ct_x, dws, dbs


# K1-bwd-split and K1-bwd-stash (csrc/geometry_bwd_chains_wg.cu): a tile's
# points (FC_PTS: each chain's 64 rows one product), the scratch float4s a
# thread a hidden layer (FC_SQ: sigma(100 a) and ad), the sweep's shared
# memory (K1-bwd's ring and A tile, one encoding tile of 64 points)
WGF_CHAIN_POINTS = 64
WGF_CHAIN_SQ = 32
WGF_CHAIN_SMEM = 1024 + 2 * 65536 + 65536 + 64 * 2 * 48 * 4 + 32


def chains_wg_plan(cfg, ws, n: int, slabs, sms: int,
                   stash: bool = False) -> dict:
    """K1-bwd-split's launch (``stash``: K1-bwd-stash's): its integer
    arguments (``iargs``, geometry_bwd_chains_wg.cu) and the sizes of what
    the wrapper allocates.  The sweep: tiles of WGF_CHAIN_POINTS points,
    one persistent block a tile up to one a SM, each with its f32 scratch
    (``scratch_floats``), writing each tile's images as two of K1-bwd's
    32-point image tiles; the weight-gradient pass and the reduce: K1-bwd's
    (_bwd_wgf_plan), with its units and chunks over the image tiles that
    hold a point.  Raises unless ``slabs`` holds make_bwd_slabs(bf16=False)'s
    layouts for ws."""
    name = "K1-bwd-stash" if stash else "K1-bwd-split"
    (_, flay), (_, rlay) = slabs
    if (getattr(flay, "operand", None), getattr(rlay, "operand", None)) != (
            "wgmma-f32", "wgmma-f32-rev"):
        raise ValueError(f"{name} multiplies on wgmma: it takes "
                         f"make_bwd_slabs(bf16=False)'s two slab packs")
    wgf = _bwd_wgf_plan(cfg, ws, n, slabs, sms)
    L = len(ws)
    tiles = -(-n // WGF_CHAIN_POINTS)
    grid = min(tiles, sms)
    per_img = wgf["image_bytes"] // wgf["tiles"]
    iargs = list(wgf["iargs"])
    iargs[4:6] = [grid, tiles]
    iargs.insert(8, stash_columns(ws) if stash else 0)
    return {**wgf, "iargs": iargs, "grid": grid, "tiles": tiles,
            "n_pass": tiles, "nc": 2, "sweep_smem": WGF_CHAIN_SMEM,
            "image_tiles": 2 * tiles, "image_bytes": 2 * tiles * per_img,
            "scratch_floats": grid * ((L - 1) * WGF_CHAIN_SQ + 16) * 256 * 4,
            "db_floats": grid * 4 * L * WG_DB_ROW}


def chains_wg16_plan(cfg, ws, n: int, slabs, sms: int,
                     stash: bool = False) -> dict:
    """K1-bwd-split-bf16's launch (``stash``: K1-bwd-stash-bf16's): its
    integer arguments (``iargs``, geometry_bwd_chains_bf16_wg.cu) and the
    sizes of what the wrapper allocates.  The sweep: tiles of
    WGF_CHAIN_POINTS points, one persistent block a tile up to one a SM,
    its two consumer warpgroups a chain each in the forward and 32 points
    each in the reverse, each with K1-bwd-bf16's f32 scratch
    (``scratch_floats``), writing each tile's images as two of
    K1-bwd-bf16's 32-point image tiles; the weight-gradient pass and the
    reduce: K1-bwd-bf16's (bwd_wg_plan: the same units, chunks and slots
    over the image tiles that hold a point).  Raises unless ``slabs`` holds
    make_bwd_slabs(bf16=True)'s layouts for ws."""
    name = "K1-bwd-stash-bf16" if stash else "K1-bwd-split-bf16"
    (_, flay), (_, rlay) = slabs
    if (getattr(flay, "operand", None), getattr(rlay, "operand", None)) != (
            "wgmma-bf16", "wgmma-bf16-rev"):
        raise ValueError(f"{name} multiplies on wgmma: it takes "
                         f"make_bwd_slabs(bf16=True)'s two slab packs")
    k1 = bwd_wg_plan(cfg, ws, n, slabs, sms)
    L = len(ws)
    tiles = -(-n // WGF_CHAIN_POINTS)
    grid = min(tiles, sms)
    per_img = k1["image_bytes"] // (k1["n_pass"] * k1["nc"])
    # the sweep's shared memory (the source's count): the encoding tile
    # (its cotangents' after the forward), the biases, the slab ring
    fixed = 1024 + WGF_CHAIN_POINTS * 2 * 48 * 4 + L * WG_DB_ROW * 4
    ns = min(8, (TP.SMEM_MAX - fixed) // (32768 + 16))
    iargs = [L, cfg.multires, cfg.d_embed, n, grid, tiles, k1["chunks"],
             k1["per"], stash_columns(ws) if stash else 0, *k1["iargs"][9:]]
    return {**k1, "iargs": iargs, "grid": grid, "tiles": tiles,
            "n_pass": tiles, "nc": 2, "sweep_smem": fixed + ns * (32768 + 16),
            "image_tiles": 2 * tiles, "image_bytes": 2 * tiles * per_img,
            "scratch_floats": grid * 2 * (L - 1) * 32 * 128 * 4,
            "db_floats": grid * 2 * 4 * L * WG_DB_ROW}


def _launch_backward_chains(cfg, x, ws, bs, stash, ct_out, ct_grad, slabs,
                            bf16: bool = False):
    """K1-bwd-split (``stash`` None) or K1-bwd-stash on make_bwd_slabs'
    packs of the mode (``bf16``: their bf16 variants); raises without them,
    before any CUDA call."""
    kernel = KERNELS["bwd_stash" if stash is not None else "bwd_split", bf16]
    dev = x.device
    if slabs is None:
        raise ValueError(f"{kernel.name} reads make_bwd_slabs(bf16={bf16})'s "
                         f"packs, built by SDFNetwork.kernel_weights: none "
                         f"was given")
    want = "wgmma-bf16" if bf16 else "wgmma-f32"
    if getattr(slabs[0][1], "operand", None) != want:
        raise ValueError(f"{kernel.name} multiplies on {want} slabs: it "
                         f"takes no other pack")
    (fp, _), (rp, _) = slabs
    bs_c = [b.detach().contiguous() for b in bs]
    x = x.detach().contiguous()
    ct_out = ct_out.contiguous()
    ct_grad = ct_grad.contiguous()
    _cuda.check_cuda_tensors(kernel.name,
                             [x, ct_out, ct_grad, fp, rp, *bs_c])
    n = x.shape[0]
    _check_stash(kernel, stash, n, ws, dev)
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    P = sum(i * o + o for i, o in zip(ins, outs))
    ct_x = torch.empty(n, 3, device=dev, dtype=torch.float32)
    if n > 0:
        plan = (chains_wg16_plan if bf16 else chains_wg_plan)(
            cfg, ws, n, slabs, _cuda.sm_count(dev), stash is not None)
        grads = torch.empty(P, device=dev, dtype=torch.float32)
        f32 = lambda k: torch.empty(k, device=dev, dtype=torch.float32)
        img = torch.empty(plan["image_bytes"], device=dev, dtype=torch.uint8)
        tail = [stash] if stash is not None else bs_c
        kernel.launch(plan["iargs"],
                      [x, ct_out, ct_grad, ct_x, f32(plan["scratch_floats"]),
                       img, f32(plan["db_floats"]), f32(plan["slot_floats"]),
                       grads, fp, rp, *tail], cfg.scale, dev)
    else:
        grads = torch.zeros(P, device=dev, dtype=torch.float32)
    dws, dbs, off = [], [], 0
    for i, o in zip(ins, outs):
        dws.append(grads[off:off + i * o].view(i, o).t())
        dbs.append(grads[off + i * o:off + i * o + o])
        off += i * o + o
    return ct_x, dws, dbs


def _check_stash(kernel, stash, n: int, ws, dev) -> None:
    """Raises unless ``stash`` (where given) is a contiguous bf16 [n,
    stash_columns(ws)] tensor on dev."""
    if stash is not None and (stash.device != dev or
                              stash.dtype != torch.bfloat16 or
                              not stash.is_contiguous() or
                              tuple(stash.shape) != (n, stash_columns(ws))):
        raise ValueError(f"{kernel.name}: expects a contiguous bf16 stash "
                         f"[{n}, {stash_columns(ws)}] on {dev}, got "
                         f"{stash.dtype} {tuple(stash.shape)} on "
                         f"{stash.device}")


def launch_backward(cfg, x, ws, bs, ct_out, ct_grad, pack=None,
                    bf16: bool = False
                    ) -> Tuple[torch.Tensor, List[torch.Tensor],
                               List[torch.Tensor]]:
    """K1-bwd (bf16: K1-bwd-bf16): (ct_x [N, 3], dW per layer [out, in],
    db per layer [out]).  ``pack``: make_bwd_slabs(cfg, ws, bf16), the two
    slab packs the kernel reads (it raises without them)."""
    return _launch_backward_wg(cfg, x, ws, bs, ct_out, ct_grad, pack, bf16)


def launch_backward_split(cfg, x, ws, bs, ct_out, ct_grad, slabs=None,
                          bf16: bool = False
                          ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                     List[torch.Tensor]]:
    """K1-bwd-split (bf16: K1-bwd-split-bf16): launch_backward's result,
    the primal and tangent chains run as separate row sets.  ``slabs``:
    make_bwd_slabs(cfg, ws, bf16), the two slab packs the kernel reads (it
    raises without them)."""
    return _launch_backward_chains(cfg, x, ws, bs, None, ct_out, ct_grad,
                                   slabs, bf16)


def launch_backward_stash(cfg, x, ws, stash, ct_out, ct_grad, slabs=None,
                          bf16: bool = False
                          ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                     List[torch.Tensor]]:
    """K1-bwd-stash (bf16: K1-bwd-stash-bf16): as launch_backward, the
    primal taken from ``stash`` (biases are not needed).  ``slabs``:
    make_bwd_slabs(cfg, ws, bf16), the two slab packs the kernel reads (it
    raises without them)."""
    return _launch_backward_chains(cfg, x, ws, [], stash, ct_out, ct_grad,
                                   slabs, bf16)


class GeometryFn(torch.autograd.Function):
    """(x, *ws, *bs) -> (out, grad) through K1-fwd; backward with both
    cotangents through K1-bwd, or K1-bwd-split when not ``stacked``; in
    the bf16 mode through their bf16 kernels.  ``slabs``:
    make_bwd_slabs(cfg, ws, bf16), the packs all of them read.  On a CPU
    tensor the bf16 mode runs the explicit twins; the f32 mode does not
    come here on the CPU (geometry_plain differentiates itself)."""

    @staticmethod
    def forward(ctx, cfg, stacked, bf16, slabs, x, *params):
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if x.is_cuda:
            out, grad = launch_forward(cfg, x, ws, bs, slabs, bf16)
        else:
            out, grad = geometry_plain(ws, bs, x, cfg, bf16=bf16)
        ctx.cfg, ctx.stacked, ctx.bf16, ctx.slabs = cfg, stacked, bf16, slabs
        ctx.save_for_backward(x, *params)
        return out, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_out, ct_grad):
        x, *params = ctx.saved_tensors
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if x.is_cuda and ctx.stacked:
            ct_x, dws, dbs = _launch_backward_wg(ctx.cfg, x, ws, bs, ct_out,
                                                 ct_grad, ctx.slabs, ctx.bf16)
        elif x.is_cuda:
            ct_x, dws, dbs = launch_backward_split(
                ctx.cfg, x, ws, bs, ct_out, ct_grad, ctx.slabs, ctx.bf16)
        else:
            ct_x, dws, dbs = geometry_bwd_plain(ws, bs, x, ct_out, ct_grad,
                                                ctx.cfg, ctx.bf16)
        return (None, None, None, None, ct_x, *dws, *dbs)


class GeometryStashFn(torch.autograd.Function):
    """(x, *ws, *bs) -> (out, grad) through K1-fwd-stash, which also keeps
    the bf16 stash for the backward through K1-bwd-stash (bf16: their bf16
    kernels); on a CPU tensor through their twins (``slabs`` None there).
    ``slabs``: make_bwd_slabs(cfg, ws, bf16), which both read."""

    @staticmethod
    def forward(ctx, cfg, bf16, slabs, x, *params):
        L = len(params) // 2
        ws, bs = params[:L], params[L:]
        if x.is_cuda:
            out, grad, stash = launch_forward_stash(cfg, x, ws, bs, slabs,
                                                    bf16)
        else:
            out, grad, stash = geometry_fwd_stash_plain(ws, bs, x, cfg, bf16)
        ctx.cfg, ctx.bf16, ctx.slabs = cfg, bf16, slabs
        ctx.save_for_backward(x, stash, *ws)
        return out, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_out, ct_grad):
        x, stash, *ws = ctx.saved_tensors
        if x.is_cuda:
            ct_x, dws, dbs = launch_backward_stash(
                ctx.cfg, x, ws, stash, ct_out, ct_grad, ctx.slabs, ctx.bf16)
        else:
            ct_x, dws, dbs = geometry_bwd_stash_plain(ws, x, stash, ct_out,
                                                      ct_grad, ctx.cfg,
                                                      ctx.bf16)
        return (None, None, None, ct_x, *dws, *dbs)


def geometry(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
             x: torch.Tensor, cfg, stash: Optional[bool] = None,
             stacked: Optional[bool] = None, bf16: bool = False, slabs=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [N, d_out], grad [N, 3]), differentiable in x, ws and bs;
    through the HBM-stash pair when ``stash`` (default STASH_BWD), else
    through K1-fwd with the backward through K1-bwd when ``stacked``
    (default STACKED_BWD) and K1-bwd-split when not; ``bf16``: in the bf16
    operand mode, each through its bf16 kernel.  ``slabs``:
    make_bwd_slabs(cfg, ws, bf16), which every K1 kernel reads (on a CUDA
    tensor it raises without them)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"geometry: unsupported device {x.device}")
    stash = STASH_BWD if stash is None else stash
    stacked = STACKED_BWD if stacked is None else bool(stacked)
    if x.is_cuda and slabs is None:
        name = KERNELS["fwd_stash" if stash else "fwd", bf16].name
        raise ValueError(f"geometry: {name} reads make_bwd_slabs' packs "
                         f"(slabs=)")
    if stash:
        return GeometryStashFn.apply(cfg, bf16, slabs, x, *ws, *bs)
    if x.is_cuda or bf16:
        return GeometryFn.apply(cfg, stacked, bf16, slabs, x, *ws, *bs)
    return geometry_plain(ws, bs, x, cfg)
