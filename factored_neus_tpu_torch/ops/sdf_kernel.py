"""K2: fused positional encoding + SDF MLP forward without gradient
(csrc/sdf_fwd.cu), and its plain PyTorch twin.

Counterpart of factored_neus_tpu/ops/pallas_sdf.py (sdf_forward_pallas).
It serves the no-grad SDF sweeps of the up-sampling ladder and the mesh
grid fill, where the caller narrows the last layer to the sdf column
(fields.SDFNetwork.value_sweep).  The wrapper runs the plain twin for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.

The kernels take EFFECTIVE weights in torch layout ([out, in], weight norm
already applied) and biases; the layer structure comes from the weights'
shapes and the SDF config (positional encoding, skip layers, scale).  K2
multiplies on the tensor cores in 3xTF32 (csrc/tc_mma.cuh) from a weight
pack (tc_pack.pack_weights): its own, or K1's pack of the same step, whose
last W^T block starts with the narrowed layer's column.

K2-bf16 (``bf16=True``) is sdf_forward_pallas(bf16_matmul=True): every
layer's operands rounded to bf16 and summed in f32, on bf16 ``mma.sync``
from tc_pack.pack_weights_bf16's pack (its own, or the step's bf16 pack of
the full network).  It serves the sweeps of the renderer's
``use_pallas_sampling`` and stage 2's secondary coarse sweep under
``sweep_act_bf16`` (models/renderer.py).  Its twin is
``sdf_forward_plain(bf16=True)``, each product explicit on bf16-rounded
operands (tc_pack.mm_bf16).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from . import _cuda
from . import tc_pack as TP
from .embedder import positional_encoding
from .mlp import softplus_beta

SDF_FWD = _cuda.CudaKernel("sdf_fwd", "sdf_fwd.cu", "sdf_fwd")
SDF_FWD_BF16 = _cuda.CudaKernel("sdf_fwd_bf16", "sdf_fwd.cu", "sdf_fwd_bf16")
# the kernel of each operand mode (bf16 or not)
KERNELS = {False: SDF_FWD, True: SDF_FWD_BF16}
TILE = TP.TILE
ENC_LD = 64               # widest positional encoding (TC_MAX_ENC)
MAX_WIDTH = 288           # widest layer a tensor-core product covers


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


def enc_stride(cfg) -> int:
    """Shared-memory row stride of the encoding tile: round8 + 4."""
    return TP.round8(cfg.d_embed) + 4


def kernel_iargs(cfg, ws, n: int, grid: int, lay: TP.PackLayout,
                 bf16: bool = False) -> Tuple[List[int], int]:
    """K2's (bf16: K2-bf16's) integer arguments (tc_dims_from_args: the
    layers, then the pack's layout) and the activation row stride ld, the
    widest layer rounded up to 8, plus 4; raises for a pack of the other
    operand type, or a network whose tiles and weight ring do not fit in a
    block's shared memory."""
    ins, outs, skip_mask = layer_dims(cfg, ws)
    if lay.operand != ("bf16" if bf16 else "3xtf32"):
        raise ValueError(f"K2{'-bf16' if bf16 else ''} multiplies in "
                         f"{'bf16' if bf16 else '3xTF32'}: it takes no "
                         f"{lay.operand} pack")
    TP.check_layout(lay, ins, outs)
    ld = TP.round8(max(ins + outs)) + 4
    if smem_bytes(cfg, lay, outs, ld) > TP.SMEM_MAX:
        raise ValueError("K2: the network's tiles and weight ring do not "
                         "fit in shared memory")
    return [len(ws), cfg.multires, cfg.d_embed, ld, skip_mask, n, grid,
            *ins, *outs, *TP.layout_iargs(lay)], ld


def smem_bytes(cfg, lay: TP.PackLayout, outs: Sequence[int], ld: int) -> int:
    """K2's shared memory: the encoding tile, two activation tiles and the
    weight ring."""
    return TP.smem_bytes(lay, outs, TILE * (enc_stride(cfg) + 2 * ld))


def sdf_forward_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                      cfg, x: torch.Tensor,
                      preacts: Optional[List[torch.Tensor]] = None,
                      bf16: bool = False) -> torch.Tensor:
    """[N, 3] -> [N, d_out] = [sdf / scale | feature], the kernels' math in
    plain PyTorch (fields.sdf_apply of the JAX package).  The hidden
    layers' pre-activations are appended to ``preacts`` when it is given.
    ``bf16``: K2-bf16's, each product on bf16-rounded operands
    (tc_pack.mm_bf16), the skip input rounded once, after the 1/sqrt(2)."""
    enc = x * cfg.scale
    if cfg.multires > 0:
        enc = positional_encoding(enc, cfg.multires)
    h = enc
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in cfg.skip_in:
            h = torch.cat([h, enc], dim=-1) * inv_sqrt2
        h = (TP.mm_bf16(h, w.t()) + b if bf16
             else torch.nn.functional.linear(h, w, b))
        if l < len(ws) - 1:
            if preacts is not None:
                preacts.append(h)
            h = softplus_beta(h, 100.0)
    return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)


def _launch(ws, bs, cfg, x: torch.Tensor, pack, bf16: bool
            ) -> torch.Tensor:
    kernel = KERNELS[bf16]
    dev = x.device
    x = x.detach().contiguous()
    bs = [b.detach().contiguous() for b in bs]
    pack, lay = pack if pack is not None else TP.make_pack(ws, bf16)
    _cuda.check_cuda_tensors(kernel.name, [x, pack, *bs])
    n = x.shape[0]
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"sdf_forward: x must be [N, 3], got {tuple(x.shape)}")
    out = torch.empty(n, ws[-1].shape[0], device=dev, dtype=torch.float32)
    if n == 0:
        return out
    grid = min(-(-n // TILE), _cuda.sm_count(dev))
    iargs, _ = kernel_iargs(cfg, ws, n, grid, lay, bf16)
    kernel.launch(iargs, [x, out, pack, *bs], cfg.scale, dev)
    return out


def sdf_forward(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], cfg,
                x: torch.Tensor,
                pack: Optional[Tuple[torch.Tensor, TP.PackLayout]] = None,
                bf16: bool = False) -> torch.Tensor:
    """No-grad SDF forward: K2 (bf16: K2-bf16) on a CUDA tensor, the plain
    twin on a CPU tensor.  The result carries no gradient.  ``pack``:
    pack_weights (bf16: pack_weights_bf16) of ws, or of the same network
    with the full last layer (the step's pack); built here when not
    given."""
    if x.is_cuda:
        with torch.no_grad():
            return _launch(ws, bs, cfg, x, pack, bf16)
    if x.device.type == "cpu":
        with torch.no_grad():
            return sdf_forward_plain(ws, bs, cfg, x, bf16=bf16)
    raise ValueError(f"sdf_forward: unsupported device {x.device}")
