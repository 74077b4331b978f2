"""K2: fused positional encoding + SDF MLP forward without gradient
(csrc/sdf_fwd_wg.cu), and its plain PyTorch twin.

Counterpart of factored_neus_tpu/ops/pallas_sdf.py (sdf_forward_pallas).
It serves the no-grad SDF sweeps of the up-sampling ladder, stages 2-3's
localisation sweep and the mesh grid fill, where the caller narrows the
last layer to the sdf column (fields.SDFNetwork.value_sweep), and full
[sdf | feature] evaluations.  The wrapper runs the plain twin for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.

The kernels take EFFECTIVE weights in torch layout ([out, in], weight norm
already applied) and biases; the layer structure comes from the weights'
shapes and the SDF config (positional encoding, skip layers, scale).  K2
multiplies on Hopper's warpgroup ``wgmma`` in 3xTF32 (the f32 engine of
csrc/wgf.cuh that K1-fwd, K1-bwd and K3 share) from the f32 slab pack
``make_sweep_pack(cfg, ws, bf16=False)`` (tc_pack.pack_sweep_f32: TF32
big and small halves), the one a step, a validation image, a stage-2/3
run or a mesh builds (fields.SDFNetwork.kernel_weights, ``sweep32``; K1-fwd
and K1-bwd read it too): for a narrowed last layer it reads the first 8
columns of each of that pack's last-layer slabs.  ``sweep_wg_plan`` is its
launch; ``sdf_forward_plain(mm=geometry_kernel.sweep_mm_f32)`` emulates its
arithmetic.

K2-bf16 (``bf16=True``, csrc/sdf_fwd_bf16.cu) is
sdf_forward_pallas(bf16_matmul=True): every layer's operands rounded to
bf16 and summed in f32, on Hopper's warpgroup ``wgmma`` from
tc_pack.pack_sweep_bf16's slab pack (make_sweep_pack: the one a run or
step builds, fields.SDFNetwork.kernel_weights(sweep_bf16=True), which may
hold the full last layer).  It serves the sweeps of the renderer's
``use_pallas_sampling`` and stage 2's secondary coarse sweep under
``sweep_act_bf16`` (models/renderer.py).  Its twin is
``sdf_forward_plain(bf16=True)``, each product explicit on bf16-rounded
operands (tc_pack.mm_bf16); ``sdf_forward_slabs`` is the kernel's own
arithmetic over its pack in plain PyTorch.

Neither kernel builds a pack: a launch on a CUDA tensor without one
raises.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from . import _cuda
from . import tc_pack as TP
from .embedder import positional_encoding
from .mlp import softplus_beta

SDF_FWD = _cuda.CudaKernel("sdf_fwd", "sdf_fwd_wg.cu", "sdf_fwd")
SDF_FWD_BF16 = _cuda.CudaKernel("sdf_fwd_bf16", "sdf_fwd_bf16.cu",
                                "sdf_fwd_bf16")
# the kernel of each operand mode (bf16 or not)
KERNELS = {False: SDF_FWD, True: SDF_FWD_BF16}
ENC_LD = 64               # widest positional encoding (TC_MAX_ENC)
MAX_WIDTH = 288           # widest layer a tensor-core product covers
WG_ROWS = 64              # rows of a K2 or K2-bf16 warpgroup's tile
SW_ENC_STRIDE = 48        # K2-bf16's encoding tile row (floats, SW_EW)
SW_MAX_STAGES = 8         # most stages of K2-bf16's slab ring


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


def skip_layers(cfg, n_layers: int) -> Tuple[int, ...]:
    return tuple(l for l in cfg.skip_in if 0 <= l < n_layers)


def make_sweep_pack(cfg, ws: Sequence[torch.Tensor], bf16: bool = True
                    ) -> Tuple[torch.Tensor, TP.SweepLayout]:
    """K2-bf16's slab pack of ws (tc_pack.pack_sweep_bf16), or with
    ``bf16`` False K2's (tc_pack.pack_sweep_f32, the forward pack of K1-fwd
    and K1-bwd too)."""
    skip = skip_layers(cfg, len(ws))
    if not bf16:
        return TP.pack_sweep_f32(ws, sorted(skip), cfg.d_embed)
    return TP.pack_sweep_bf16(ws, skip, cfg.d_embed)


# K2 (csrc/sdf_fwd_wg.cu): the sweep's shared memory (its ring of two
# 66 KB slab stages, the 64 KB A tile, the encoding tile, the barriers)
WGF_SMEM = 1024 + 2 * 67584 + 64 * 256 * 4 + 64 * 48 * 4 + 32


def sweep_wg_plan(cfg, ws, n: int, lay, sms: int) -> dict:
    """K2's launch: its integer arguments (``iargs``, csrc/sdf_fwd_wg.cu),
    tiles of WG_ROWS rows, one persistent block a tile up to one a SM.
    Raises unless ``lay`` is tc_pack.sweep_layout_f32 of ws, or of the same
    network with a wider last layer (the full network's pack, read
    narrowed to at most 8 outputs: the first 8 columns of each slab of
    its last layer)."""
    ins, outs, _ = layer_dims(cfg, ws)
    if getattr(lay, "operand", None) != "wgmma-f32":
        raise ValueError("K2 multiplies on wgmma: it takes the f32 slab pack "
                         "(make_sweep_pack(cfg, ws, bf16=False))")
    want = TP.sweep_layout_f32(ins, outs, skip_layers(cfg, len(ws)),
                               cfg.d_embed)
    if (lay.enc, lay.nslab, lay.off, lay.cols[:-1]) != (
            want.enc, want.nslab, want.off, want.cols[:-1]) or \
            lay.cols[-1] < want.cols[-1]:
        raise ValueError("K2: the slab pack's layout does not match the "
                         "network's widths")
    tiles = -(-n // WG_ROWS)
    grid = min(tiles, sms)
    return {"iargs": [len(ws), cfg.multires, cfg.d_embed, n, grid, tiles,
                      lay.cols[-1], *ins, *outs, *lay.enc, *lay.off],
            "grid": grid, "tiles": tiles, "sweep_smem": WGF_SMEM}


def sweep_iargs(cfg, ws, n: int, lay, sms: int) -> Tuple[List[int], int]:
    """K2-bf16's integer arguments (csrc/sdf_fwd_bf16.cu) and its grid:
    64-row tiles, two consumer warpgroups a block (128 rows a pass) when
    there are more tiles than SMs, else one, so that a small call still
    spreads over the SMs; one persistent block a pass up to one a SM.
    Raises unless ``lay`` is the slab layout of ws, or of the same network
    with a wider last layer (the full network's pack, read narrowed: the
    first 8 columns of each slab of its last layer)."""
    ins, outs, _ = layer_dims(cfg, ws)
    if getattr(lay, "operand", None) != "wgmma-bf16":
        raise ValueError(f"K2-bf16 multiplies on wgmma: it takes no "
                         f"{getattr(lay, 'operand', None)} pack")
    want = TP.sweep_layout(ins, outs, skip_layers(cfg, len(ws)),
                           cfg.d_embed)
    if (lay.enc, lay.nslab, lay.off, lay.cols[:-1]) != (
            want.enc, want.nslab, want.off, want.cols[:-1]) or \
            lay.cols[-1] < want.cols[-1]:
        raise ValueError("K2-bf16: the pack's slab layout does not match "
                         "the network's widths")
    tiles = -(-n // WG_ROWS)
    nc = 2 if tiles > sms else 1
    n_pass = -(-tiles // nc)
    grid = min(n_pass, sms)
    L = len(ws)
    widest = TP.SLAB_ROW * max(want.cols)
    if sweep_smem(L, nc, widest)[0] < max(want.nslab):
        raise ValueError("K2-bf16: a layer's slabs do not fit in the ring")
    stride = [TP.SLAB_ROW * c for c in lay.cols]
    return [L, cfg.multires, cfg.d_embed, n, nc, grid, n_pass, *lay.enc,
            *stride, *lay.off, *outs], grid


def sweep_smem(n_layers: int, nc: int, widest_copy: int,
               extra: int = 0) -> Tuple[int, int]:
    """(stages, bytes) of K2-bf16's shared memory (the mirror of
    sdf_fwd_bf16's launcher): alignment slack, nc encoding tiles, the
    biases, ``extra`` bytes (K1-fwd-bf16's encoding cotangents), and as
    many ring stages of the widest slab copy (rounded to 1024 bytes, with
    its two mbarriers) as fit, at most SW_MAX_STAGES."""
    stage = -(-widest_copy // 1024) * 1024
    fixed = 1024 + nc * WG_ROWS * SW_ENC_STRIDE * 4 + n_layers * 264 * 4 + \
        extra
    ns = min(SW_MAX_STAGES, (TP.SMEM_MAX - fixed) // (stage + 16))
    return ns, fixed + ns * (stage + 16)


def sdf_forward_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                      cfg, x: torch.Tensor,
                      preacts: Optional[List[torch.Tensor]] = None,
                      bf16: bool = False, mm=None) -> torch.Tensor:
    """[N, 3] -> [N, d_out] = [sdf / scale | feature], the kernels' math in
    plain PyTorch (fields.sdf_apply of the JAX package).  The hidden
    layers' pre-activations are appended to ``preacts`` when it is given.
    ``bf16``: K2-bf16's, each product on bf16-rounded operands
    (tc_pack.mm_bf16), the skip input rounded once, after the 1/sqrt(2).
    ``mm``: the products (a, b) -> a @ b (geometry_kernel.sweep_mm_f32
    emulates K2's), without gradient."""
    enc = x * cfg.scale
    if cfg.multires > 0:
        enc = positional_encoding(enc, cfg.multires)
    h = enc
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in cfg.skip_in:
            h = torch.cat([h, enc], dim=-1) * inv_sqrt2
        if mm is not None or bf16:
            h = (mm or TP.mm_bf16)(h, w.t()) + b
        else:
            h = torch.nn.functional.linear(h, w, b)
        if l < len(ws) - 1:
            if preacts is not None:
                preacts.append(h)
            h = softplus_beta(h, 100.0)
    return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)


def sdf_forward_slabs(pack: Tuple[torch.Tensor, TP.SweepLayout],
                      bs: Sequence[torch.Tensor], cfg, x: torch.Tensor,
                      out_dim: int) -> torch.Tensor:
    """K2-bf16's arithmetic in plain PyTorch, read from its slab pack: the
    encoding and h padded to the pack's k-steps (a hidden layer 256 wide,
    softplus(0) in its padding, which meets zero weight rows), each
    product a float32 sum of the slabs' products in order, the skip input
    / sqrt 2 rounded once; [N, out_dim], out_dim the last layer's width
    (at most the pack's)."""
    pack, lay = pack
    L = len(lay.enc)
    enc = x * cfg.scale
    if cfg.multires > 0:
        enc = positional_encoding(enc, cfg.multires)
    enc = torch.nn.functional.pad(enc, (0, TP.ENC_COLS - enc.shape[1]))
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    h = None
    for l in range(L):
        parts = [] if l == 0 else [h]
        if lay.enc[l]:
            parts.append(TP.bf16_round(enc * (1.0 if l == 0 else inv_sqrt2)))
        blk = TP.sweep_block(pack, lay, l)
        a = torch.cat(parts, -1)
        a = torch.nn.functional.pad(a, (0, blk.shape[0] - a.shape[1]))
        acc = torch.zeros(x.shape[0], blk.shape[1], dtype=torch.float32,
                          device=x.device)
        for k0 in range(0, blk.shape[0], TP.SLAB_K):
            acc = acc + a[:, k0:k0 + TP.SLAB_K] @ blk[k0:k0 + TP.SLAB_K]
        b = torch.nn.functional.pad(bs[l].float(),
                                    (0, blk.shape[1] - bs[l].shape[0]))
        y = acc + b
        if l < L - 1:
            y = softplus_beta(y, 100.0)
            h = TP.bf16_round(y * inv_sqrt2 if lay.enc[l + 1] else y)
    y = y[:, :out_dim]
    return torch.cat([y[:, :1] / cfg.scale, y[:, 1:]], dim=-1)


def _launch(ws, bs, cfg, x: torch.Tensor, pack, bf16: bool
            ) -> torch.Tensor:
    kernel = KERNELS[bf16]
    dev = x.device
    if pack is None:
        raise ValueError(f"{kernel.name} reads make_sweep_pack(cfg, ws, "
                         f"bf16={bf16})'s slab pack, built by "
                         f"SDFNetwork.kernel_weights: none was given")
    x = x.detach().contiguous()
    bs = [b.detach().contiguous() for b in bs]
    pack, lay = pack
    _cuda.check_cuda_tensors(kernel.name, [x, pack, *bs])
    n = x.shape[0]
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"sdf_forward: x must be [N, 3], got {tuple(x.shape)}")
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n == 0:
        return out
    if bf16:
        iargs, _ = sweep_iargs(cfg, ws, n, lay, _cuda.sm_count(dev))
    else:
        iargs = sweep_wg_plan(cfg, ws, n, lay, _cuda.sm_count(dev))["iargs"]
    kernel.launch(iargs, [x, out, pack, *bs], cfg.scale, dev)
    return out


def sdf_forward(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
                x: torch.Tensor,
                pack: Optional[Tuple[torch.Tensor, TP.SweepLayout]] = None,
                bf16: bool = False) -> torch.Tensor:
    """No-grad SDF forward: K2 (bf16: K2-bf16) on a CUDA tensor, the plain
    twin on a CPU tensor.  The result carries no gradient.  ``pack``:
    make_sweep_pack(cfg, ws, bf16) of ws, or of the same network with the
    full last layer (the step's pack); a launch raises without it."""
    if x.is_cuda:
        with torch.no_grad():
            return _launch(ws, bs, cfg, x, pack, bf16)
    if x.device.type == "cpu":
        with torch.no_grad():
            return sdf_forward_plain(ws, bs, cfg, x, bf16=bf16)
    raise ValueError(f"sdf_forward: unsupported device {x.device}")
