"""The weight packs and the arithmetic of the tensor-core kernels, and who
reads which (every kernel multiplies on Hopper's warpgroup ``wgmma``):

  pack_sweep_bf16      K2-bf16 (csrc/sdf_fwd_bf16.cu) and the forward of
                       every bf16 K1 kernel (csrc/geometry_fwd_bf16_wg.cu,
                       geometry_bwd_bf16_wg.cu,
                       geometry_bwd_chains_bf16_wg.cu); with pack_rev_bf16,
                       their reverse
  pack_rad_sweep_bf16  K3-fwd-bf16 and K3-bwd-bf16
                       (csrc/radiance_fwd_bf16_wg.cu,
                       radiance_bwd_bf16_wg.cu), with pack_rad_rev_bf16
                       (layer 0's feature rows first, its 33 narrow rows in
                       a slab of their own)
  pack_sweep_f32       K2 and every f32 K1 kernel (csrc/sdf_fwd_wg.cu,
                       geometry_fwd_wg.cu, geometry_bwd_wg.cu,
                       geometry_bwd_chains_wg.cu: 3xTF32 on wgmma,
                       csrc/wgf.cuh); with pack_rev_f32, K1's reverse
  pack_rad_sweep_f32   K3-fwd and K3-bwd (csrc/radiance_fwd_wg.cu,
                       radiance_bwd_wg.cu); with pack_rad_rev_f32, K3-bwd's
                       reverse

A bf16 slab pack cuts each layer's bf16 W^T (the reverse packs: W) into
slabs of 64 k, each slab the exact shared-memory image its wgmma B
descriptor reads (csrc/wgmma.cuh).  The f32 slab packs hold each weight
as TF32 big and small halves, k permuted by ``tf32_slot``, in slabs of 32
k.  ``mm_3xtf32`` and ``mm_bf16`` emulate the kernels' product arithmetic in
plain PyTorch for the CPU tests.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

SMEM_MAX = 232448          # shared memory a block may use


TF32_MASK = -8192          # 0xffffe000: sign, exponent, 10 mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10-bit mantissa), to nearest with ties
    away from zero: the kernels' split, (bits + 0x1000) & 0xffffe000."""
    return ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads of a float32 operand: its 13
    low mantissa bits dropped (tools/tf32_mma_probe.py)."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = tf32_round(x), small = x - big, exact in f32."""
    big = tf32_round(x)
    return big, x - big


def _toward_zero(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor core adds to
    its float32 accumulator."""
    r = t.float()
    return torch.where(r.double().abs() > t.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _split(x: torch.Tensor, how: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 x: big rounded to TF32 (``round``, the
    f32 slab packers' split) or its 13 low mantissa bits dropped
    (``trunc``: the tensor core's own reading of an f32 operand in shared
    memory, with small = x - big made beside it); small exact in f32."""
    big = tf32_round(x) if how == "round" else tf32_truncate(x)
    return big, x - big


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor,
              stage: Optional[int] = 16, a_split: str = "round",
              b_split: str = "round") -> torch.Tensor:
    """a [M, K] @ b [K, N] (float32) as the tensor-core kernels compute it: each
    operand split into TF32 big and small, small_a big_b + big_a small_b +
    big_a big_b per 8-k instruction (m16n8k8 mma.sync or m64nNk8 wgmma: the
    products summed exactly, the tensor core reading only the TF32 bits of
    each small), each instruction's sum added to a float32 accumulator
    rounding toward zero; every ``stage`` k (a ring stage of 16 weight rows,
    the 64 rows of a weight-gradient tile, the 32 rows of a wgmma pass
    stage) the accumulator is added to the running float32 sum with a
    rounded add.  ``stage=None``: one accumulator over all k.  ``a_split``,
    ``b_split``: each operand's split (_split), ``round`` or ``trunc``."""
    ab, as_ = _split(a.float().contiguous(), a_split)
    bb, bs = _split(b.float().contiguous(), b_split)
    terms = [(tf32_truncate(as_).double(), bb.double()),
             (ab.double(), tf32_truncate(bs).double()),
             (ab.double(), bb.double())]
    K = a.shape[1]
    stage = stage or K
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                        device=a.device)
    for k0 in range(0, K, stage):
        part = torch.zeros_like(total)
        for k in range(k0, min(k0 + stage, K), 8):
            for x, y in terms:
                part = _toward_zero(part.double() + x[:, k:k + 8] @ y[k:k + 8])
        total = total + part
    return total


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to x's dtype:
    the operand of a bf16 product, as JAX's ``astype(bfloat16)`` and the
    kernels' ``__floats2bfloat162_rn`` round it."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] on bf16 operands with a float32 (or, for float64
    inputs, float64) sum: K1's bf16 mode, and pallas_geometry's
    ``_mm_fns(bf16=True)``.  A product of two bf16 values is exact in
    float32, so only the sum's order and rounding differ from the
    kernels'."""
    return bf16_round(a) @ bf16_round(b)


# -- K2-bf16's pack: slabs for wgmma ----------------------------------------

SLAB_K = 64                # k rows of a slab: one 128-byte row of bf16
SLAB_ROW = 128             # bytes of one column's row in a slab
HIDDEN_COLS = 256          # columns of a hidden layer's product
FULL_LAST_COLS = 264       # 256 + 8: a full last layer (m64n256 + m64n8)
NARROW_LAST_COLS = 8       # a last layer of at most 8 outputs (m64n8)
ENC_COLS = 48              # widest encoding: three k-steps


class SweepLayout(NamedTuple):
    """Layout of pack_sweep_bf16's pack.  Layer l's input, the k rows of
    its W^T: h (the last layer's output, zero-padded to HIDDEN_COLS; none
    for layer 0), then, where ``enc[l]`` (layer 0 and a skip layer), the
    encoding (zero-padded to ENC_COLS): a skip layer's rows are reordered
    to [h | pad | enc | pad].  Its ``nslab[l]`` slabs of SLAB_K rows (four
    of h, one of the encoding) each hold ``cols[l]`` columns (256 for a
    hidden layer, 8 or 264 for the last) and start at byte ``off[l] + s *
    cols[l] * SLAB_ROW``; ``nbytes`` in all.  The fixed depths let the
    kernel issue every layer's products in one straight path."""
    enc: List[int]
    nslab: List[int]
    cols: List[int]
    off: List[int]
    nbytes: int
    operand: str = "wgmma-bf16"


def sweep_layout(ins: Sequence[int], outs: Sequence[int],
                 skip_layers: Sequence[int], d_embed: int) -> SweepLayout:
    """The slab layout of an SDF network of layers ins -> outs whose layer
    0 and ``skip_layers`` read the d_embed-wide encoding after h; raises for
    a network K2-bf16 cannot run (a hidden layer over 256 columns, a last
    layer over 264, an encoding over 48, a skip into the last layer, a
    single layer)."""
    L = len(ins)
    if d_embed > ENC_COLS or any(o > HIDDEN_COLS for o in outs[:-1]) or \
            outs[-1] > FULL_LAST_COLS or L < 2 or L - 1 in skip_layers:
        raise ValueError(f"K2-bf16 takes two layers or more, hidden widths "
                         f"<= {HIDDEN_COLS}, a last layer <= "
                         f"{FULL_LAST_COLS} with no skip into it and an "
                         f"encoding <= {ENC_COLS} wide")
    enc, nslab, cols, off, pos = [], [], [], [], 0
    for l in range(L):
        enc.append(int(l == 0 or l in skip_layers))
        nslab.append((HIDDEN_COLS // SLAB_K if l else 0) + enc[-1])
        cols.append(HIDDEN_COLS if l < L - 1 else
                    NARROW_LAST_COLS if outs[l] <= NARROW_LAST_COLS
                    else FULL_LAST_COLS)
        off.append(pos)
        pos += nslab[-1] * cols[-1] * SLAB_ROW
    return SweepLayout(enc, nslab, cols, off, pos)


def swizzle128(e: np.ndarray) -> np.ndarray:
    """Element index (bf16) within a slab of plain index e = n * 64 + k:
    the 128-byte swizzle, 16-byte chunk (k // 8) ^ (n % 8).  Its own
    inverse."""
    return e ^ (((e >> 6) & 7) << 3)


def sweep_k_rows(lay: SweepLayout, l: int, in_dim: int,
                 d_embed: int) -> np.ndarray:
    """Row k of layer l's slabs for each input column of its W [out, in]:
    h's columns first, the encoding's from row HIDDEN_COLS on (from row 0
    in layer 0)."""
    c = np.arange(in_dim)
    if not lay.enc[l]:
        return c
    h = in_dim - d_embed
    return np.where(c < h, c, (HIDDEN_COLS if l else 0) + c - h)


@functools.lru_cache(maxsize=16)
def _sweep_sources(ins: Tuple[int, ...], outs: Tuple[int, ...],
                   skip_layers: Tuple[int, ...], d_embed: int,
                   device: torch.device) -> Tuple[torch.Tensor, SweepLayout]:
    """For each bf16 element of the pack, the index of its weight in the
    weights flattened one after another (each [out, in] row-major), or
    the index one past them (a zero); on ``device``, built once."""
    lay = sweep_layout(ins, outs, skip_layers, d_embed)
    zero = sum(i * o for i, o in zip(ins, outs))
    src = np.full(lay.nbytes // 2, zero, np.int64)
    base = 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        k = sweep_k_rows(lay, l, i, d_embed)[None, :]       # [1, in]
        n = np.arange(o)[:, None]                            # [out, 1]
        e = (lay.off[l] // 2 + (k // SLAB_K) * lay.cols[l] * SLAB_K
             + swizzle128(n * SLAB_K + k % SLAB_K))
        src[e.ravel()] = base + np.arange(o * i)
        base += i * o
    return torch.from_numpy(src).to(device), lay


def pack_sweep_bf16(ws: Sequence[torch.Tensor], skip_layers: Sequence[int],
                    d_embed: int) -> Tuple[torch.Tensor, SweepLayout]:
    """K2-bf16's weight pack of an SDF network (effective weights ws, layer
    0 and ``skip_layers`` reading the encoding): every layer's W^T rounded
    to bf16 (to nearest even, as JAX's ``astype``) in sweep_layout's slabs,
    each the 128-byte-swizzled image one bulk copy lands in shared memory
    (swizzle128), zero in the padding.  A float32 tensor of the bytes."""
    if any(w.dtype != torch.float32 for w in ws):
        raise ValueError("the tensor-core kernels take float32 weights")
    ins = tuple(int(w.shape[1]) for w in ws)
    outs = tuple(int(w.shape[0]) for w in ws)
    dev = ws[0].device
    idx, lay = _sweep_sources(ins, outs, tuple(sorted(skip_layers)),
                              d_embed, dev)
    src = torch.cat([w.detach().reshape(-1) for w in ws]
                    + [torch.zeros(1, device=dev)])
    return src[idx].to(torch.bfloat16).view(torch.float32), lay


def _read_slabs(pack: torch.Tensor, start: int, nslab: int, cols: int
                ) -> torch.Tensor:
    """``nslab`` slabs of ``cols`` columns from byte ``start`` of a pack
    read back: the [64 nslab, cols] float32 block (k by n)."""
    flat = pack.view(torch.bfloat16)
    sw = torch.from_numpy(swizzle128(np.arange(cols * SLAB_K))).to(
        pack.device)
    first = start // 2
    images = flat[first:first + nslab * cols * SLAB_K].view(nslab, -1)
    return images[:, sw].view(nslab, cols, SLAB_K).transpose(1, 2).reshape(
        nslab * SLAB_K, cols).float()


def sweep_block(pack: torch.Tensor, lay: SweepLayout, l: int
                ) -> torch.Tensor:
    """Layer l's slabs read back: the [64 nslab, cols] float32 block of
    bf16 values that its products multiply, row k of layer l's input
    (sweep_k_rows) by output column n."""
    return _read_slabs(pack, lay.off[l], lay.nslab[l], lay.cols[l])


# -- K1-bwd-bf16's reverse pack: W in slabs, the B of R W -------------------

REV_LAST_EXTRA = 8         # outputs of a last layer beyond 256 (k-step 16)


def rev_layout(ins: Sequence[int], outs: Sequence[int],
               d_embed: int) -> SweepLayout:
    """The slab layout of pack_rev_bf16: layer l's slabs hold W_l with k
    the layer's output (the depth of r W) and n its input: four slabs of
    SLAB_K outputs (a layer's outputs zero-padded to 256), a fifth for a
    last layer of 257-264 outputs (read for its first k-step only), each
    ENC_COLS columns wide for layer 0 (the encoding) and HIDDEN_COLS for
    the others (a skip layer's [h | enc] in W's own column order); no
    encoding slabs (``enc`` all 0).  Raises for a network K1-bwd-bf16
    cannot run."""
    L = len(ins)
    if L < 2 or ins[0] != d_embed or d_embed > ENC_COLS or \
            any(i > HIDDEN_COLS for i in ins[1:]) or \
            any(o > HIDDEN_COLS for o in outs[:-1]) or \
            outs[-1] > HIDDEN_COLS + REV_LAST_EXTRA:
        raise ValueError(f"K1-bwd-bf16 takes two layers or more, an "
                         f"encoding <= {ENC_COLS} wide, hidden widths <= "
                         f"{HIDDEN_COLS} and a last layer <= "
                         f"{HIDDEN_COLS + REV_LAST_EXTRA}")
    nslab, cols, off, pos = [], [], [], 0
    for l in range(L):
        nslab.append(HIDDEN_COLS // SLAB_K + int(outs[l] > HIDDEN_COLS))
        cols.append(ENC_COLS if l == 0 else HIDDEN_COLS)
        off.append(pos)
        pos += nslab[-1] * cols[-1] * SLAB_ROW
    return SweepLayout([0] * L, nslab, cols, off, pos, "wgmma-bf16-rev")


@functools.lru_cache(maxsize=16)
def _rev_sources(ins: Tuple[int, ...], outs: Tuple[int, ...], d_embed: int,
                 device: torch.device) -> Tuple[torch.Tensor, SweepLayout]:
    """As _sweep_sources, for pack_rev_bf16: row k = output o, column n =
    input i of W_l [out, in]."""
    lay = rev_layout(ins, outs, d_embed)
    zero = sum(i * o for i, o in zip(ins, outs))
    src = np.full(lay.nbytes // 2, zero, np.int64)
    base = 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        k = np.arange(o)[:, None]                            # [out, 1]
        n = np.arange(i)[None, :]                            # [1, in]
        e = (lay.off[l] // 2 + (k // SLAB_K) * lay.cols[l] * SLAB_K
             + swizzle128(n * SLAB_K + k % SLAB_K))
        src[e.ravel()] = base + np.arange(o * i)
        base += i * o
    return torch.from_numpy(src).to(device), lay


def pack_rev_bf16(ws: Sequence[torch.Tensor], d_embed: int
                  ) -> Tuple[torch.Tensor, SweepLayout]:
    """K1-bwd-bf16's reverse pack (effective weights ws, layer 0 reading
    the d_embed-wide encoding): every layer's W rounded to bf16 (to nearest
    even) in rev_layout's slabs, the 128-byte-swizzled image one bulk copy
    lands in shared memory, zero in the padding.  The product r W of the
    reverse sweep reads it as wgmma's B: k an output of the layer, n an
    input.  A float32 tensor of the bytes."""
    if any(w.dtype != torch.float32 for w in ws):
        raise ValueError("the tensor-core kernels take float32 weights")
    ins = tuple(int(w.shape[1]) for w in ws)
    outs = tuple(int(w.shape[0]) for w in ws)
    dev = ws[0].device
    idx, lay = _rev_sources(ins, outs, d_embed, dev)
    src = torch.cat([w.detach().reshape(-1) for w in ws]
                    + [torch.zeros(1, device=dev)])
    return src[idx].to(torch.bfloat16).view(torch.float32), lay


# -- K3-bwd-bf16's packs: the radiance MLP in slabs --------------------------

RAD_LAST_COLS = 8          # widest last layer of the radiance MLP (m64n8)
RAD_MAX_HIDDEN = 4         # most hidden layers (their ReLU masks in registers)


def _rad_check(ins: Sequence[int], outs: Sequence[int],
               d_narrow: int) -> None:
    """Raises for a radiance MLP K3-bwd-bf16 cannot run: its first layer's
    input is [narrow (d_narrow) | feature], the narrow columns at most
    ENC_COLS and the feature 2-256 wide (an even count); at most
    RAD_MAX_HIDDEN hidden layers of at most 256 and a last layer of at most
    RAD_LAST_COLS outputs."""
    L = len(ins)
    d_feat = ins[0] - d_narrow
    if L < 2 or L - 1 > RAD_MAX_HIDDEN or d_narrow > ENC_COLS or \
            not 2 <= d_feat <= HIDDEN_COLS or d_feat % 2 or \
            any(o > HIDDEN_COLS for o in outs[:-1]) or \
            outs[-1] > RAD_LAST_COLS or \
            any(ins[l] != outs[l - 1] for l in range(1, L)):
        raise ValueError(f"K3-bwd-bf16 takes 1-{RAD_MAX_HIDDEN} hidden "
                         f"layers <= {HIDDEN_COLS} wide, a last layer <= "
                         f"{RAD_LAST_COLS}, narrow columns <= {ENC_COLS} "
                         f"and an even feature width <= {HIDDEN_COLS}")


def rad_sweep_layout(ins: Sequence[int], outs: Sequence[int],
                     d_narrow: int) -> SweepLayout:
    """The slab layout of pack_rad_sweep_bf16, the forward X W of
    K3-bwd-bf16: layer 0's W^T with the feature's rows first (k 0 ..
    255, four slabs) and the d_narrow narrow rows [pts | PE(dirs) |
    normals] at k = 256 (a fifth slab, ``enc``); a hidden layer four
    slabs; each HIDDEN_COLS wide but the last layer's four, RAD_LAST_COLS
    wide (m64n8).  Raises for a network the kernel cannot run."""
    _rad_check(ins, outs, d_narrow)
    L = len(ins)
    nslab = [HIDDEN_COLS // SLAB_K + int(l == 0) for l in range(L)]
    cols = [HIDDEN_COLS] * (L - 1) + [RAD_LAST_COLS]
    off, pos = [], 0
    for l in range(L):
        off.append(pos)
        pos += nslab[l] * cols[l] * SLAB_ROW
    return SweepLayout([1] + [0] * (L - 1), nslab, cols, off, pos,
                       "wgmma-bf16-rad")


def rad_rev_layout(ins: Sequence[int], outs: Sequence[int],
                   d_narrow: int) -> SweepLayout:
    """The slab layout of pack_rad_rev_bf16, the reverse r W of
    K3-bwd-bf16: layer l's W with k its output and n its input.  A hidden
    layer and layer 0 four slabs of SLAB_K outputs (zero-padded to 256),
    the last layer one (its outputs in k-step 0); layer 0's n is the
    feature's 256 columns, then, in four more slabs ENC_COLS wide, the
    narrow columns (``cols[0]`` = 256 + 48 counts both)."""
    _rad_check(ins, outs, d_narrow)
    L = len(ins)
    nslab = [8] + [HIDDEN_COLS // SLAB_K] * (L - 2) + [1]
    cols = [HIDDEN_COLS + ENC_COLS] + [HIDDEN_COLS] * (L - 1)
    off, pos = [], 0
    for l in range(L):
        off.append(pos)
        pos += (HIDDEN_COLS // SLAB_K * cols[l] if l == 0
                else nslab[l] * cols[l]) * SLAB_ROW
    return SweepLayout([0] * L, nslab, cols, off, pos, "wgmma-bf16-rad-rev")


def _slab_elems(start: int, cols: int, k: np.ndarray,
                n: np.ndarray) -> np.ndarray:
    """bf16 element of (k, n) in slabs of ``cols`` columns from element
    ``start`` on (one slab a SLAB_K rows of k)."""
    return start + (k // SLAB_K) * cols * SLAB_K + swizzle128(
        n * SLAB_K + k % SLAB_K)


def _rad_columns(i: np.ndarray, d_narrow: int) -> np.ndarray:
    """Where K3-bwd-bf16's layer 0 keeps input column i of W_0 ([narrow
    | feature]): the feature's at i - d_narrow, the narrow ones at
    HIDDEN_COLS + i."""
    return np.where(i >= d_narrow, i - d_narrow, HIDDEN_COLS + i)


@functools.lru_cache(maxsize=16)
def _rad_sources(ins: Tuple[int, ...], outs: Tuple[int, ...], d_narrow: int,
                 reverse: bool, device: torch.device
                 ) -> Tuple[torch.Tensor, SweepLayout]:
    """As _sweep_sources, for pack_rad_sweep_bf16 (``reverse`` False: k =
    the row of W^T, layer 0's reordered by _rad_columns) and
    pack_rad_rev_bf16 (k = W's output, n = its input, layer 0's narrow
    columns in their own slabs)."""
    lay = (rad_rev_layout if reverse else rad_sweep_layout)(ins, outs,
                                                           d_narrow)
    zero = sum(i * o for i, o in zip(ins, outs))
    src = np.full(lay.nbytes // 2, zero, np.int64)
    base = 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        o_idx = np.arange(o)[:, None]                        # [out, 1]
        i_idx = np.arange(i)[None, :]                        # [1, in]
        col = _rad_columns(i_idx, d_narrow) if l == 0 else i_idx
        start = lay.off[l] // 2
        if not reverse:
            e = _slab_elems(start, lay.cols[l], col, o_idx)
        elif l == 0:
            feat = col < HIDDEN_COLS
            e = np.where(feat, _slab_elems(start, HIDDEN_COLS, o_idx, col),
                         _slab_elems(start + 4 * HIDDEN_COLS * SLAB_K,
                                     ENC_COLS, o_idx, col - HIDDEN_COLS))
        else:
            e = _slab_elems(start, lay.cols[l], o_idx, i_idx)
        src[np.broadcast_to(e, (o, i)).ravel()] = base + np.arange(o * i)
        base += i * o
    return torch.from_numpy(src).to(device), lay


def _pack_rad(ws: Sequence[torch.Tensor], d_narrow: int, reverse: bool
              ) -> Tuple[torch.Tensor, SweepLayout]:
    if any(w.dtype != torch.float32 for w in ws):
        raise ValueError("the tensor-core kernels take float32 weights")
    ins = tuple(int(w.shape[1]) for w in ws)
    outs = tuple(int(w.shape[0]) for w in ws)
    dev = ws[0].device
    idx, lay = _rad_sources(ins, outs, d_narrow, reverse, dev)
    src = torch.cat([w.detach().reshape(-1) for w in ws]
                    + [torch.zeros(1, device=dev)])
    return src[idx].to(torch.bfloat16).view(torch.float32), lay


def pack_rad_sweep_bf16(ws: Sequence[torch.Tensor], d_narrow: int
                        ) -> Tuple[torch.Tensor, SweepLayout]:
    """K3-bwd-bf16's forward pack of the radiance MLP (effective weights
    ws, layer 0 reading [d_narrow narrow columns | feature]): every
    layer's W^T rounded to bf16 (to nearest even) in rad_sweep_layout's
    slabs, each the 128-byte-swizzled image one bulk copy lands in shared
    memory (swizzle128), zero in the padding.  A float32 tensor of the
    bytes."""
    return _pack_rad(ws, d_narrow, False)


def pack_rad_rev_bf16(ws: Sequence[torch.Tensor], d_narrow: int
                      ) -> Tuple[torch.Tensor, SweepLayout]:
    """K3-bwd-bf16's reverse pack: every layer's W rounded to bf16 in
    rad_rev_layout's slabs (k an output of the layer, n an input), as
    pack_rad_sweep_bf16."""
    return _pack_rad(ws, d_narrow, True)


def rad_block(pack: torch.Tensor, lay: SweepLayout, l: int) -> torch.Tensor:
    """Layer l of a K3-bwd-bf16 pack read back through the swizzle's
    inverse: the float32 [64 nslab, cols] block of bf16 values (k by n)
    that its products multiply; layer 0 of the reverse pack as [256, 304],
    its narrow slabs' columns after the feature's."""
    if lay.operand == "wgmma-bf16-rad-rev" and l == 0:
        narrow = lay.off[0] + 4 * HIDDEN_COLS * SLAB_ROW
        return torch.cat([_read_slabs(pack, lay.off[0], 4, HIDDEN_COLS),
                          _read_slabs(pack, narrow, 4, ENC_COLS)], 1)
    return sweep_block(pack, lay, l)


# -- K1's f32 packs: TF32 big and small slabs for wgmma ---------------------

F32_SLAB_K = 32            # k rows of an f32 slab: one 128-byte row of f32


def tf32_slot(c: np.ndarray) -> np.ndarray:
    """The k slot of column (or row) c in K1-bwd's f32 tiles and slabs:
    within each group of 8, slot t holds 2t and slot t + 4 holds 2t + 1,
    the order in which wgmma's accumulator holds a thread's columns, so a
    layer's result is the next product's A fragment as it stands
    (csrc/wgmma.cuh).  A permutation of each group of 8."""
    c = np.asarray(c)
    return (c & ~7) + ((c & 7) >> 1) + ((c & 1) << 2)


def swizzle32(e: np.ndarray) -> np.ndarray:
    """f32 index within a slab part of plain index e = n * 32 + k: the
    128-byte swizzle, 16-byte chunk (k // 4) ^ (n % 8).  Its own
    inverse."""
    return e ^ (((e >> 5) & 7) << 2)


def sweep_layout_f32(ins: Sequence[int], outs: Sequence[int],
                     skip_layers: Sequence[int], d_embed: int) -> SweepLayout:
    """The slab layout of pack_sweep_f32, the forward X W of K1-bwd and
    K1-fwd: layer l's W^T with k its input in W's own column order (a skip
    layer's [h | enc]) at tf32_slot(k), zero-padded to 64 k (layer 0, the
    encoding) or 256 (the others); ``nslab[l]`` slabs of F32_SLAB_K k,
    each ``cols[l]`` columns, its big half then its small half (2 x 32 KB
    for 256 columns): layer 0 two, a hidden layer eight, each HIDDEN_COLS
    wide; the last layer (K1-fwd's and K2's) eight, FULL_LAST_COLS wide
    for a last layer over 256 (else HIDDEN_COLS), after every byte K1-bwd
    reads.
    ``enc[l]``: layer l reads the encoding (layer 0, a skip layer).
    Raises for a network K1-bwd cannot run."""
    L = len(ins)
    if L < 2 or ins[0] != d_embed or d_embed > ENC_COLS or \
            any(i > HIDDEN_COLS for i in ins[1:]) or \
            any(o > HIDDEN_COLS for o in outs[:-1]) or \
            outs[-1] > HIDDEN_COLS + REV_LAST_EXTRA or L - 1 in skip_layers:
        raise ValueError(f"K1-bwd takes two layers or more, an encoding <= "
                         f"{ENC_COLS} wide, hidden widths <= {HIDDEN_COLS}, "
                         f"a last layer <= {HIDDEN_COLS + REV_LAST_EXTRA} "
                         f"and no skip into it")
    enc, nslab, cols, off, pos = [], [], [], [], 0
    for l in range(L):
        enc.append(int(l == 0 or l in skip_layers))
        nslab.append(2 if l == 0 else HIDDEN_COLS // F32_SLAB_K)
        cols.append(FULL_LAST_COLS if l == L - 1 and outs[l] > HIDDEN_COLS
                    else HIDDEN_COLS)
        off.append(pos)
        pos += nslab[-1] * 2 * cols[-1] * SLAB_ROW
    return SweepLayout(enc, nslab, cols, off, pos, "wgmma-f32")


def rev_layout_f32(ins: Sequence[int], outs: Sequence[int],
                   d_embed: int) -> SweepLayout:
    """The slab layout of pack_rev_f32, the reverse r W of K1-bwd: layer
    l's W with k its output at tf32_slot(k) and n its input: eight slabs
    of F32_SLAB_K outputs (zero-padded to 256) and a ninth for a last
    layer of 257-264 outputs (its first k-step read), each ENC_COLS
    columns wide for layer 0 and HIDDEN_COLS for the others, big half then
    small half.  Raises as sweep_layout_f32."""
    sweep_layout_f32(ins, outs, (), d_embed)
    L = len(ins)
    nslab, cols, off, pos = [], [], [], 0
    for l in range(L):
        nslab.append(HIDDEN_COLS // F32_SLAB_K + int(outs[l] > HIDDEN_COLS))
        cols.append(ENC_COLS if l == 0 else HIDDEN_COLS)
        off.append(pos)
        pos += nslab[-1] * 2 * cols[-1] * SLAB_ROW
    return SweepLayout([0] * L, nslab, cols, off, pos, "wgmma-f32-rev")


def _f32_elems(start: int, cols: int, k: np.ndarray, n: np.ndarray,
               small: bool) -> np.ndarray:
    """f32 element of (k slot k, column n) in f32 slabs of ``cols`` columns
    from element ``start`` on (a slab a F32_SLAB_K slots: big part, then
    small part)."""
    return (start + (k // F32_SLAB_K) * 2 * cols * F32_SLAB_K
            + int(small) * cols * F32_SLAB_K
            + swizzle32(n * F32_SLAB_K + k % F32_SLAB_K))


@functools.lru_cache(maxsize=16)
def _f32_sources(ins: Tuple[int, ...], outs: Tuple[int, ...],
                 skip_layers: Tuple[int, ...], d_embed: int, reverse: bool,
                 device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, SweepLayout]:
    """For each f32 element of pack_sweep_f32's (``reverse`` False) or
    pack_rev_f32's pack, the index of its weight in the weights flattened
    one after another (each [out, in] row-major), or the index one past
    them (a zero), and whether it is the weight's small half; on
    ``device``, built once."""
    lay = (rev_layout_f32(ins, outs, d_embed) if reverse else
           sweep_layout_f32(ins, outs, skip_layers, d_embed))
    zero = sum(i * o for i, o in zip(ins, outs))
    src = np.full(lay.nbytes // 4, zero, np.int64)
    small = np.zeros(lay.nbytes // 4, bool)
    base = 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        if lay.nslab[l]:
            o_idx = np.arange(o)[:, None]                    # [out, 1]
            i_idx = np.arange(i)[None, :]                    # [1, in]
            k, n = ((tf32_slot(o_idx), i_idx) if reverse
                    else (tf32_slot(i_idx), o_idx))
            for half in (False, True):
                e = _f32_elems(lay.off[l] // 4, lay.cols[l], k, n, half)
                e = np.broadcast_to(e, (o, i)).ravel()
                src[e] = base + np.arange(o * i)
                small[e] = half
        base += i * o
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(small).to(device), lay)


def _pack_f32(ws: Sequence[torch.Tensor], skip_layers: Sequence[int],
              d_embed: int, reverse: bool) -> Tuple[torch.Tensor, SweepLayout]:
    if any(w.dtype != torch.float32 for w in ws):
        raise ValueError("the tensor-core kernels take float32 weights")
    ins = tuple(int(w.shape[1]) for w in ws)
    outs = tuple(int(w.shape[0]) for w in ws)
    dev = ws[0].device
    idx, small, lay = _f32_sources(ins, outs, tuple(sorted(skip_layers)),
                                   d_embed, reverse, dev)
    src = torch.cat([w.detach().reshape(-1) for w in ws]
                    + [torch.zeros(1, device=dev)])
    big, sm = tf32_split(src)
    return torch.where(small, sm[idx], big[idx]), lay


def pack_sweep_f32(ws: Sequence[torch.Tensor], skip_layers: Sequence[int],
                   d_embed: int) -> Tuple[torch.Tensor, SweepLayout]:
    """K1-bwd's, K1-fwd's and K2's forward pack of an SDF network
    (effective weights ws, layer 0 and ``skip_layers`` reading the
    encoding): every layer's W^T split into TF32 big (rounded to nearest,
    ties away) and small (W - big, exact), in sweep_layout_f32's slabs,
    each half the 128-byte-swizzled image one bulk copy lands in shared
    memory (swizzle32), zero in the padding.  big + small is W exactly."""
    return _pack_f32(ws, skip_layers, d_embed, False)


def pack_rev_f32(ws: Sequence[torch.Tensor], d_embed: int
                 ) -> Tuple[torch.Tensor, SweepLayout]:
    """K1-bwd's and K1-fwd's reverse pack: every layer's W (k its output, n its input)
    split as pack_sweep_f32's, in rev_layout_f32's slabs."""
    return _pack_f32(ws, (), d_embed, True)


def f32_block(pack: torch.Tensor, lay: SweepLayout, l: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer l of an f32 slab pack read back through the swizzle's
    inverse: (big, small), each the float32 [32 nslab, cols] block (k slot
    by n) that its products multiply."""
    nslab, cols = lay.nslab[l], lay.cols[l]
    sw = torch.from_numpy(swizzle32(np.arange(cols * F32_SLAB_K))).to(
        pack.device)
    first = lay.off[l] // 4
    slabs = pack[first:first + nslab * 2 * cols * F32_SLAB_K].view(
        nslab, 2, cols * F32_SLAB_K)[:, :, sw]
    blk = slabs.view(nslab, 2, cols, F32_SLAB_K).permute(1, 0, 3, 2)
    blk = blk.reshape(2, nslab * F32_SLAB_K, cols)
    return blk[0], blk[1]


# -- K3-bwd's f32 packs: the radiance MLP in TF32 big and small slabs --------

RAD_F32_NARROW = 48        # narrow columns of layer 0's A tile (six k-steps)
RAD_F32_FWD0 = 10          # forward layer-0 slabs: the feature's 8, narrow 2


def _rad_check_f32(ins: Sequence[int], outs: Sequence[int],
                   d_narrow: int) -> None:
    """Raises for a radiance MLP K3-bwd cannot run: _rad_check's limits
    (at most RAD_MAX_HIDDEN hidden layers of at most 256, a last layer of
    at most RAD_LAST_COLS, an even feature 2-256 wide) with at most
    RAD_F32_NARROW narrow columns."""
    try:
        _rad_check(ins, outs, d_narrow)
    except ValueError as e:
        raise ValueError(str(e).replace("K3-bwd-bf16", "K3-bwd")) from None
    if d_narrow > RAD_F32_NARROW:
        raise ValueError(f"K3-bwd takes narrow columns <= {RAD_F32_NARROW}")


def _f32_offsets(nbytes: Sequence[int]) -> Tuple[List[int], int]:
    off, pos = [], 0
    for b in nbytes:
        off.append(pos)
        pos += b
    return off, pos


def rad_sweep_layout_f32(ins: Sequence[int], outs: Sequence[int],
                         d_narrow: int) -> SweepLayout:
    """The slab layout of pack_rad_sweep_f32, the forward X W of K3-bwd:
    layer 0's W^T with the feature's rows at k 0 .. 255 and the d_narrow
    narrow rows [pts | PE(dirs) | normals] from k = 256 on (``enc``), ten
    slabs of F32_SLAB_K k (RAD_F32_FWD0; the last two k-steps deep); a
    hidden layer eight; each k at tf32_slot(k), HIDDEN_COLS columns wide,
    big half then small half (2 x 32 KB), but the last layer's eight,
    RAD_LAST_COLS wide (m64n8).  Raises for a network the kernel cannot
    run."""
    _rad_check_f32(ins, outs, d_narrow)
    L = len(ins)
    nslab = [RAD_F32_FWD0] + [HIDDEN_COLS // F32_SLAB_K] * (L - 1)
    cols = [HIDDEN_COLS] * (L - 1) + [RAD_LAST_COLS]
    off, pos = _f32_offsets([s * 2 * c * SLAB_ROW
                             for s, c in zip(nslab, cols)])
    return SweepLayout([1] + [0] * (L - 1), nslab, cols, off, pos,
                       "wgmma-f32-rad")


def rad_rev_layout_f32(ins: Sequence[int], outs: Sequence[int],
                       d_narrow: int) -> SweepLayout:
    """The slab layout of pack_rad_rev_f32, the reverse r W of K3-bwd:
    layer l's W with k its output at tf32_slot(k) and n its input, big
    half then small half.  A hidden layer and layer 0 eight slabs of
    F32_SLAB_K outputs (zero-padded to 256), the last layer one (its
    outputs in k-step 0); layer 0's n is the feature's 256 columns, then,
    in eight more slabs ENC_COLS wide, the narrow columns (``nslab[0]`` =
    16 and ``cols[0]`` = 256 + 48 count both)."""
    _rad_check_f32(ins, outs, d_narrow)
    L = len(ins)
    nslab = [16] + [HIDDEN_COLS // F32_SLAB_K] * (L - 2) + [1]
    cols = [HIDDEN_COLS + ENC_COLS] + [HIDDEN_COLS] * (L - 1)
    per = 8 * 2 * F32_SLAB_K * 4
    off, pos = _f32_offsets([per * (HIDDEN_COLS + ENC_COLS)]
                            + [s * 2 * c * SLAB_ROW
                               for s, c in zip(nslab[1:], cols[1:])])
    return SweepLayout([0] * L, nslab, cols, off, pos, "wgmma-f32-rad-rev")


@functools.lru_cache(maxsize=16)
def _rad_f32_sources(ins: Tuple[int, ...], outs: Tuple[int, ...],
                     d_narrow: int, reverse: bool, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor, SweepLayout]:
    """As _f32_sources, for pack_rad_sweep_f32 (``reverse`` False: k = the
    row of W^T at its kernel column, _rad_columns, for layer 0) and
    pack_rad_rev_f32 (k = W's output, n its input, layer 0's narrow
    columns in their own slabs)."""
    lay = (rad_rev_layout_f32 if reverse else rad_sweep_layout_f32)(
        ins, outs, d_narrow)
    zero = sum(i * o for i, o in zip(ins, outs))
    src = np.full(lay.nbytes // 4, zero, np.int64)
    small = np.zeros(lay.nbytes // 4, bool)
    base = 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        o_idx = np.arange(o)[:, None]                        # [out, 1]
        i_idx = np.arange(i)[None, :]                        # [1, in]
        col = _rad_columns(i_idx, d_narrow) if l == 0 else i_idx
        start = lay.off[l] // 4
        for half in (False, True):
            if not reverse:
                e = _f32_elems(start, lay.cols[l], tf32_slot(col), o_idx,
                               half)
            elif l == 0:
                k = tf32_slot(o_idx)
                narrow = start + 8 * 2 * HIDDEN_COLS * F32_SLAB_K
                e = np.where(col < HIDDEN_COLS,
                             _f32_elems(start, HIDDEN_COLS, k, col, half),
                             _f32_elems(narrow, ENC_COLS, k,
                                        col - HIDDEN_COLS, half))
            else:
                e = _f32_elems(start, lay.cols[l], tf32_slot(o_idx), i_idx,
                               half)
            e = np.broadcast_to(e, (o, i)).ravel()
            src[e] = base + np.arange(o * i)
            small[e] = half
        base += i * o
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(small).to(device), lay)


def _pack_rad_f32(ws: Sequence[torch.Tensor], d_narrow: int, reverse: bool
                  ) -> Tuple[torch.Tensor, SweepLayout]:
    if any(w.dtype != torch.float32 for w in ws):
        raise ValueError("the tensor-core kernels take float32 weights")
    ins = tuple(int(w.shape[1]) for w in ws)
    outs = tuple(int(w.shape[0]) for w in ws)
    dev = ws[0].device
    idx, small, lay = _rad_f32_sources(ins, outs, d_narrow, reverse, dev)
    src = torch.cat([w.detach().reshape(-1) for w in ws]
                    + [torch.zeros(1, device=dev)])
    big, sm = tf32_split(src)
    return torch.where(small, sm[idx], big[idx]), lay


def pack_rad_sweep_f32(ws: Sequence[torch.Tensor], d_narrow: int
                       ) -> Tuple[torch.Tensor, SweepLayout]:
    """K3-fwd's and K3-bwd's forward pack of the radiance MLP (effective
    weights ws, layer 0 reading [d_narrow narrow columns | feature]):
    every layer's W^T split into TF32 big (rounded to nearest, ties away)
    and small (W - big, exact) in rad_sweep_layout_f32's slabs, each half
    the 128-byte-swizzled image one bulk copy lands in shared memory
    (swizzle32), zero in the padding.  big + small is W exactly."""
    return _pack_rad_f32(ws, d_narrow, False)


def pack_rad_rev_f32(ws: Sequence[torch.Tensor], d_narrow: int
                     ) -> Tuple[torch.Tensor, SweepLayout]:
    """K3-bwd's reverse pack: every layer's W (k its output, n its input)
    split as pack_rad_sweep_f32's, in rad_rev_layout_f32's slabs."""
    return _pack_rad_f32(ws, d_narrow, True)


def _read_f32(pack: torch.Tensor, start: int, nslab: int, cols: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nslab`` f32 slabs of ``cols`` columns from float ``start`` of a
    pack read back: (big, small), each [32 nslab, cols] (k slot by n)."""
    sw = torch.from_numpy(swizzle32(np.arange(cols * F32_SLAB_K))).to(
        pack.device)
    slabs = pack[start:start + nslab * 2 * cols * F32_SLAB_K].view(
        nslab, 2, cols * F32_SLAB_K)[:, :, sw]
    blk = slabs.view(nslab, 2, cols, F32_SLAB_K).permute(1, 0, 3, 2)
    blk = blk.reshape(2, nslab * F32_SLAB_K, cols)
    return blk[0], blk[1]


def rad_f32_block(pack: torch.Tensor, lay: SweepLayout, l: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer l of a K3-bwd f32 pack read back (f32_block); layer 0 of the
    reverse pack as [256, 304], its narrow slabs' columns after the
    feature's."""
    if lay.operand == "wgmma-f32-rad-rev" and l == 0:
        first = lay.off[0] // 4
        fb, fs = _read_f32(pack, first, 8, HIDDEN_COLS)
        nb, ns = _read_f32(pack, first + 8 * 2 * HIDDEN_COLS * F32_SLAB_K, 8,
                           ENC_COLS)
        return torch.cat([fb, nb], 1), torch.cat([fs, ns], 1)
    return _read_f32(pack, lay.off[l] // 4, lay.nslab[l], lay.cols[l])
