"""The arithmetic and weight layout of the K1 tensor-core kernels
(csrc/tc_mma.cuh), on the CPU: the 3xTF32 emulation of
ops/geometry_kernel.py against float64 at K1's shapes and the card's
tolerances, and the packed weight buffer the kernels stage from."""
import math

import numpy as np
import pytest
import torch

from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops.embedder import positional_encoding
from factored_neus_tpu_torch.ops.mlp import softplus_beta


def _bits(x):
    return x.contiguous().view(torch.int32)


NETS = [SDFConfig(),                                        # full width
        SDFConfig(n_layers=4, d_hidden=64, d_out=65, skip_in=(2,),
                  multires=4)]


@pytest.mark.parametrize("cfg", NETS, ids=["full", "small"])
def test_pack_layout_and_split(cfg):
    """big + small == w exactly, big has no bits below TF32's mantissa,
    padding is zero in both halves, and the offsets and strides are the
    ones the kernels are told (16-byte aligned, a staged row 8 mod 32)."""
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, _ = net.effective_weights()
    pack, lay = GK.pack_weights(ws)
    H = lay.half
    assert pack.shape == (2 * H,) and pack.dtype == torch.float32
    big, small = pack[:H], pack[H:]
    assert torch.equal(_bits(big) & 0x1fff, torch.zeros_like(_bits(big)))
    assert (small.abs() <= big.abs() * 2.0 ** -11).all()
    covered = torch.zeros(H, dtype=torch.bool)
    off = 0
    for l, w in enumerate(ws):
        o, i = w.shape
        kp, np_ = -(-i // 8) * 8, -(-o // 8) * 8
        for start, stride, rows, cols, want in (
                (lay.fwd_off[l], lay.fwd_stride[l], kp, np_, w.t()),
                (lay.rev_off[l], lay.rev_stride[l], np_, kp, w)):
            assert start == off and start % 8 == 0
            assert stride % 32 == 8 and cols <= stride < cols + 32
            n = rows * stride
            blk = (big + small)[start:start + n].view(rows, stride)
            assert torch.equal(blk[:want.shape[0], :want.shape[1]], want)
            pad = torch.ones(rows, stride, dtype=torch.bool)
            pad[:want.shape[0], :want.shape[1]] = False
            for half in (big, small):
                assert not half[start:start + n].view(rows, stride)[pad].any()
            covered[start:start + n] = True
            off += n
    assert off == H and covered.all()
    iargs, ld = GK.kernel_iargs(cfg, ws, 1000, 7, lay)
    L = len(ws)
    assert ld % 8 == 4 and ld >= max(-(-w // 8) * 8 for w in
                                     [*(x.shape[0] for x in ws),
                                      *(x.shape[1] for x in ws)])
    assert iargs[7 + 2 * L:] == [*lay.fwd_off, *lay.fwd_stride,
                                 *lay.rev_off, *lay.rev_stride, H]


def test_k1_refuses_layers_wider_than_its_shared_memory():
    """The full-width 257 is the widest layer K1 takes; a wider one is
    refused before any launch."""
    cfg = SDFConfig(n_layers=2, d_hidden=264, d_out=65, skip_in=())
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, _ = net.effective_weights()
    with pytest.raises(ValueError, match="257"):
        GK.kernel_iargs(cfg, ws, 100, 1, GK.pack_weights(ws)[1])


def test_tf32_round_and_truncate():
    """Rounding to nearest with ties away from zero, on the bits."""
    one = 1.0
    u = 2.0 ** -10                                    # TF32 ulp at 1
    x = torch.tensor([one + 0.49 * u, one + 0.5 * u, -(one + 0.5 * u),
                      one + 0.75 * u, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + u, -(one + u), one + u, 3.0])
    assert torch.equal(GK.tf32_round(x), want)
    assert torch.equal(GK.tf32_truncate(x),
                       torch.tensor([one, one, -one, one, 3.0]))
    big, small = GK.tf32_split(x)
    assert torch.equal(big + small, x)


def _k1_forward(ws, bs, cfg, x, mm):
    """K1-fwd's (out, grad) in the kernel's order of operations, every
    product through mm(a [M, K], b [K, N])."""
    L, lL = len(ws), len(ws) - 1
    enc = positional_encoding(x * cfg.scale, cfg.multires)
    h, pre = enc, []
    r2 = 1.0 / math.sqrt(2.0)
    for l in range(L):
        if l in cfg.skip_in:
            h = torch.cat([h, enc], -1) * r2
        a = mm(h, ws[l].t()) + bs[l]
        if l < lL:
            pre.append(a)
            h = softplus_beta(a, 100.0)
    out = torch.cat([a[:, :1] / cfg.scale, a[:, 1:]], -1)
    y = (ws[lL][:1] / cfg.scale).expand(x.shape[0], -1)
    r_enc = torch.zeros_like(enc)
    for l in range(lL, -1, -1):
        if l < lL:
            y = mm(xr, ws[l])
        if l in cfg.skip_in:
            hw = y.shape[1] - enc.shape[1]
            r_enc = r_enc + y[:, hw:] * r2
            y = y[:, :hw] * r2
        if l == 0:
            r_enc = r_enc + y
        else:
            xr = y * torch.sigmoid(100.0 * pre[l - 1])
    u = x * cfg.scale
    zero = torch.zeros_like(u)
    ct = GK._encode_backward(u, zero, r_enc, torch.zeros_like(r_enc),
                             cfg.multires)
    return out, ct * cfg.scale


def test_3xtf32_forward_within_k1_fwd_tolerance():
    """The full-width K1-fwd chain with every product in emulated 3xTF32
    (ring stages of 16 k) against float64: within K1-fwd's card tolerance
    of 1e-5 absolute, as close as the float32 chain.  With one truncating
    accumulator over all k the error would be several times larger."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    x = torch.from_numpy((np.random.RandomState(1).randn(48, 3) * 0.5)
                         .astype(np.float32))
    with torch.no_grad():
        ref = _k1_forward([w.double() for w in ws], [b.double() for b in bs],
                          cfg, x.double(), lambda a, b: a @ b)
        f32 = _k1_forward(ws, bs, cfg, x, lambda a, b: a @ b)
        tc = _k1_forward(ws, bs, cfg, x, GK.mm_3xtf32)
        flat = _k1_forward(ws, bs, cfg, x,
                           lambda a, b: GK.mm_3xtf32(a, b, None))
    err = lambda got: max(float((g.double() - r).abs().max())
                          for g, r in zip(got, ref))
    e_tc, e_f32, e_flat = err(tc), err(f32), err(flat)
    assert e_tc <= 1e-5
    assert e_tc <= 4 * e_f32 + 1e-6
    assert e_flat > e_tc


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("K,N", [(40, 256), (224, 256), (256, 264)])
def test_3xtf32_weight_gradient_within_k1_bwd_tolerance(rows, K, N):
    """Weight-gradient sums at K1's shapes: each tile's X^T R over 32 or 64
    rows in one truncating accumulator, tile sums added in float32, 64
    tiles; against float64 within K1-bwd's per-tensor card tolerance
    1e-4 + 1e-5 max|ref|, at most a few times the float32 sum's error."""
    rng = np.random.RandomState(K + N + rows)
    X = torch.from_numpy(rng.uniform(0, 1, (64, rows, K)).astype(np.float32))
    R = torch.from_numpy(rng.randn(64, rows, N).astype(np.float32))
    ref = torch.einsum("trk,trn->kn", X.double(), R.double())
    tc = torch.zeros(K, N)
    f32 = torch.zeros(K, N)
    for t in range(X.shape[0]):
        tc = tc + GK.mm_3xtf32(X[t].t(), R[t], stage=rows)
        f32 = f32 + X[t].t() @ R[t]
    tol = 1e-4 + 1e-5 * float(ref.abs().max())
    e_tc = float((tc.double() - ref).abs().max())
    e_f32 = float((f32.double() - ref).abs().max())
    assert e_tc <= tol
    assert e_tc <= 4 * e_f32 + 1e-6


@pytest.mark.parametrize("K,N", [(40, 256), (256, 264), (264, 256)])
def test_3xtf32_product_matches_float64(K, N):
    """One 64-row product at K1's depths, stages of 16 k: as close to
    float64 as a float32 product, and exact where the operands are
    already TF32 values whose products add up exactly."""
    rng = np.random.RandomState(K * N)
    a = torch.from_numpy(rng.randn(64, K).astype(np.float32))
    b = torch.from_numpy(rng.randn(K, N).astype(np.float32))
    ref = a.double() @ b.double()
    e_tc = float((GK.mm_3xtf32(a, b).double() - ref).abs().max())
    e_f32 = float(((a @ b).double() - ref).abs().max())
    assert e_tc <= 4 * e_f32
    ai = torch.from_numpy(rng.randint(-8, 8, (64, K)).astype(np.float32))
    bi = torch.from_numpy(rng.randint(-8, 8, (K, N)).astype(np.float32))
    assert torch.equal(GK.mm_3xtf32(ai, bi), ai @ bi)
