"""The arithmetic and weight layout of the tensor-core kernels (K1, K2,
K3; 3xTF32 on wgmma), on the CPU: the 3xTF32 emulation of
ops/tc_pack.py against float64 at the kernels' shapes and the card's
tolerances, the slab packs the kernels stream, and their shared-memory
counts."""
import math

import numpy as np
import pytest
import torch

from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                   RenderingNetwork,
                                                   SDFConfig, SDFNetwork)
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP
from factored_neus_tpu_torch.ops.embedder import positional_encoding
from factored_neus_tpu_torch.ops.mlp import softplus_beta


def test_k1_refuses_layers_wider_than_its_shared_memory():
    """The full-width 257 is the widest last layer K1 takes and 256 the
    widest hidden layer (a 64 KB A tile of f32, 256 columns of a
    product); a wider one is refused before any launch: the slab packs
    that every K1 kernel's plan reads cannot be built for it, in either
    mode."""
    cfg = SDFConfig(n_layers=2, d_hidden=264, d_out=65, skip_in=())
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, _ = net.effective_weights()
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="hidden widths <= 256"):
            GK.make_bwd_slabs(cfg, ws, bf16=bf16)


def test_tf32_round_and_truncate():
    """Rounding to nearest with ties away from zero, on the bits."""
    one = 1.0
    u = 2.0 ** -10                                    # TF32 ulp at 1
    x = torch.tensor([one + 0.49 * u, one + 0.5 * u, -(one + 0.5 * u),
                      one + 0.75 * u, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + u, -(one + u), one + u, 3.0])
    assert torch.equal(TP.tf32_round(x), want)
    assert torch.equal(TP.tf32_truncate(x),
                       torch.tensor([one, one, -one, one, 3.0]))
    big, small = TP.tf32_split(x)
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
        tc = _k1_forward(ws, bs, cfg, x, TP.mm_3xtf32)
        flat = _k1_forward(ws, bs, cfg, x,
                           lambda a, b: TP.mm_3xtf32(a, b, None))
    err = lambda got: max(float((g.double() - r).abs().max())
                          for g, r in zip(got, ref))
    e_tc, e_f32, e_flat = err(tc), err(f32), err(flat)
    assert e_tc <= 1e-5
    assert e_tc <= 4 * e_f32 + 1e-6
    assert e_flat > e_tc


# the (224, 256) cases are in test_torch_tf32_wgrad.py: each of the two
# files then holds about half of this test's time, and the runner, which
# keeps a file on one worker, can spread them
@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("K,N", [(40, 256), (256, 264)])
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
        tc = tc + TP.mm_3xtf32(X[t].t(), R[t], stage=rows)
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
    e_tc = float((TP.mm_3xtf32(a, b).double() - ref).abs().max())
    e_f32 = float(((a @ b).double() - ref).abs().max())
    assert e_tc <= 4 * e_f32
    ai = torch.from_numpy(rng.randint(-8, 8, (64, K)).astype(np.float32))
    bi = torch.from_numpy(rng.randint(-8, 8, (K, N)).astype(np.float32))
    assert torch.equal(TP.mm_3xtf32(ai, bi), ai @ bi)


def _radiance(cfg, n, seed=0):
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    rng = np.random.RandomState(seed + 1)
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [rng.randn(n, 3) * 0.4, rng.randn(n, 3), dirs,
              rng.randn(n, cfg.d_feature) * 0.5]
    inputs = [torch.from_numpy(a.astype(np.float32)) for a in inputs]
    ct = torch.from_numpy(rng.randn(n, cfg.d_out).astype(np.float32))
    return list(ws), list(bs), inputs, ct


def _k3_backward(ws, bs, cfg, inputs, ct, mm, atb, masks=None):
    """K3-bwd's (ct_pts, ct_normals, ct_dirs, ct_feat, dW..., db...) in the
    kernel's order of operations: the forward x W^T through mm(a, b), the
    ReLU masks from its own pre-activations unless ``masks`` are given,
    the seed ct y (1 - y), the weight gradients through atb(x, r) (64-row
    tiles), the input cotangents r W through mm."""
    pts, normals, dirs, feat = inputs
    x0 = torch.cat([pts, positional_encoding(dirs, cfg.multires_view),
                    normals, feat], -1)
    L = len(ws)
    xs, own = [x0], []
    for l in range(L):
        a = mm(xs[-1], ws[l].t()) + bs[l]
        if l < L - 1:
            own.append(a > 0)
            xs.append(torch.relu(a))
    masks = own if masks is None else masks
    y = torch.sigmoid(a)
    r = ct * y * (1 - y)
    dws, dbs = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        dws[l] = atb(xs[l], r).t()
        dbs[l] = r.sum(0)
        r = mm(r, ws[l])
        if l > 0:
            r = r * masks[l - 1].to(r.dtype)
    d_view = cfg.d_view
    u = dirs
    zero = torch.zeros_like(u)
    r_enc = r[:, 3:3 + d_view]
    ct_dirs = GK._encode_backward(u, zero, r_enc, torch.zeros_like(r_enc),
                                  cfg.multires_view)
    return ([r[:, :3], r[:, 3 + d_view:6 + d_view], ct_dirs,
             r[:, 6 + d_view:]] + dws + dbs), own


def _k3_forward(ws, bs, cfg, inputs, mm):
    """K3-fwd's rgb in the kernel's order of operations: x0, then per layer
    mm(h, W^T) + b, ReLU on the hidden layers, the sigmoid last."""
    pts, normals, dirs, feat = inputs
    h = torch.cat([pts, positional_encoding(dirs, cfg.multires_view),
                   normals, feat], -1)
    for l, (w, b) in enumerate(zip(ws, bs)):
        h = mm(h, w.t()) + b
        if l < len(ws) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


RAD_CASES = [(RenderingConfig(), 256),                  # 289 -> 4 x 256 -> 3
             (RenderingConfig(d_feature=64, d_hidden=64, n_layers=3), 200)]


@pytest.mark.parametrize("case", RAD_CASES, ids=["full", "small"])
def test_3xtf32_radiance_forward_within_k3_fwd_tolerance(case):
    """K3-fwd's products at K3's widths in emulated 3xTF32 (ring stages of
    16 k) against float64: rgb within K3-fwd's card tolerance of 1e-5 abs,
    and at most a few times the float32 chain's own error."""
    cfg, n = case
    ws, bs, inputs, _ = _radiance(cfg, n)
    with torch.no_grad():
        ref = _k3_forward([w.double() for w in ws], [b.double() for b in bs],
                          cfg, [v.double() for v in inputs],
                          lambda a, b: a @ b)
        f32 = _k3_forward(ws, bs, cfg, inputs, lambda a, b: a @ b)
        tc = _k3_forward(ws, bs, cfg, inputs, TP.mm_3xtf32)
    assert tc.shape == ref.shape == (n, cfg.d_out)
    e_tc = float((tc.double() - ref).abs().max())
    e_f32 = float((f32.double() - ref).abs().max())
    assert e_tc <= 1e-5
    assert e_tc <= 4 * e_f32 + 1e-6


def _atb_tiles(mm):
    """X^T R summed over 64-row tiles, each tile's sum added in float32."""
    def atb(x, r):
        total = torch.zeros(x.shape[1], r.shape[1], dtype=x.dtype)
        for t0 in range(0, x.shape[0], 64):
            total = total + mm(x[t0:t0 + 64].t(), r[t0:t0 + 64])
        return total
    return atb


@pytest.mark.parametrize("case", RAD_CASES, ids=["full", "small"])
def test_3xtf32_radiance_backward_within_k3_bwd_tolerance(case):
    """K3-bwd's three products at K3's widths in emulated 3xTF32 (forward
    and input cotangents in ring stages of 16 k, weight gradients in 64-row
    tiles) against float64 with the float32 forward's ReLU masks: every
    tensor within K3-bwd's card criterion |err| <= 1e-4 + 1e-5 max|ref|,
    and at most a few times the float32 chain's own error."""
    cfg, n = case
    ws, bs, inputs, ct = _radiance(cfg, n)
    with torch.no_grad():
        f32, masks = _k3_backward(ws, bs, cfg, inputs, ct,
                                  lambda a, b: a @ b, lambda x, r: x.t() @ r)
        ref, _ = _k3_backward([w.double() for w in ws],
                              [b.double() for b in bs],
                              cfg, [v.double() for v in inputs], ct.double(),
                              lambda a, b: a @ b, lambda x, r: x.t() @ r,
                              masks)
        tc, tc_masks = _k3_backward(
            ws, bs, cfg, inputs, ct, TP.mm_3xtf32,
            _atb_tiles(lambda a, b: TP.mm_3xtf32(a, b, stage=64)))
    # no pre-activation lies within the 3xTF32 sums' error of the kink here
    assert all(torch.equal(a, b) for a, b in zip(tc_masks, masks))
    for i, (a, b, c) in enumerate(zip(tc, f32, ref)):
        assert a.shape == c.shape
        tol = 1e-4 + 1e-5 * float(c.abs().max())
        e_tc = float((a.double() - c).abs().max())
        e_f32 = float((b.double() - c).abs().max())
        assert e_tc <= tol, i
        assert e_tc <= 4 * e_f32 + 1e-6, i


def test_k3_pack_layout():
    """K3-fwd's pack is the forward slab pack K3-bwd reads, bit for bit
    (make_fwd_pack, the first of make_bwd_slabs(bf16=False)): the
    289-wide first layer in ten 32-k slabs (the feature's 256 rows, then
    the narrow ones from k = 256), each hidden layer eight, the 3-wide last
    layer eight 8 columns wide; its layer offsets end K3-fwd's arguments,
    and a pack of another network's widths is refused."""
    cfg = RenderingConfig()
    ws, _, _, _ = _radiance(cfg, 1)
    pack, lay = RK.make_fwd_pack(cfg, ws)
    (bpack, blay), _ = RK.make_bwd_slabs(cfg, ws, bf16=False)
    assert lay == blay and torch.equal(pack, bpack)
    assert lay.nslab == [10, 8, 8, 8, 8] and lay.cols == [256] * 4 + [8]
    assert all(o % 1024 == 0 for o in lay.off)
    assert lay.nbytes == 4 * pack.numel() == lay.off[-1] + 8 * 2 * 8 * 128
    iargs = RK.fwd_wg_plan(cfg, ws, 1000, lay, 7)["iargs"]
    assert iargs[:7] == [5, 4, 27, 1000, 7, 16, 1]
    assert iargs[7:17] == [289, 256, 256, 256, 256, 256, 256, 256, 256, 3]
    assert iargs[17:] == lay.off
    other = RenderingConfig(n_layers=3)
    ows, _, _, _ = _radiance(other, 1)
    with pytest.raises(ValueError, match="layout"):
        RK.fwd_wg_plan(cfg, ws, 1000, RK.make_fwd_pack(other, ows)[1], 7)


def test_k2_reads_k1_pack_narrowed():
    """The narrowed sweep's weights in K1's f32 slab pack of the same step
    (sweep32): every layer before the last is K2's own narrowed pack's
    bytes, and in each slab of the last layer the first column of both
    halves (the first 32 f32 of each: K2 copies the first 8 columns, a
    1 KB prefix) is the narrowed row, whose other 7 columns the own pack
    holds as zero; the layouts are accepted as the narrowed network's and
    a pack of other widths is refused."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, _ = net.effective_weights()
    narrowed = ws[:-1] + [ws[-1][:1]]
    k1, lay = SK.make_sweep_pack(cfg, ws, bf16=False)
    own, lay_n = SK.make_sweep_pack(cfg, narrowed, bf16=False)
    L = len(ws)
    assert lay.off == lay_n.off and lay.cols[-1] == 264
    assert lay_n.cols[-1] == 256
    first = lay.off[-1] // 4
    assert torch.equal(k1[:first], own[:first])
    for s_ in range(8):
        for h in (0, 1):
            a = k1[first + (2 * s_ + h) * 264 * 32:][:8 * 32]
            b = own[first + (2 * s_ + h) * 256 * 32:][:8 * 32]
            assert torch.equal(a[:32], b[:32])
            assert not b[32:].any()
    big, small = TP.f32_block(own, lay_n, L - 1)
    want = torch.zeros_like(big[:, 0])
    want[TP.tf32_slot(np.arange(256))] = narrowed[-1][0]
    assert torch.equal(big[:, 0] + small[:, 0], want)
    for ly in (lay, lay_n):
        SK.sweep_wg_plan(cfg, narrowed, 100, ly, 1)
    with pytest.raises(ValueError, match="layout"):
        SK.sweep_wg_plan(cfg, narrowed, 100, lay._replace(off=[0] * L), 1)


def test_shared_memory_counts_fit_a_block():
    """The byte counts the kernels' headers state, at full width, all
    within the 232,448 bytes a block may use: K1-fwd and K1-fwd-stash on
    wgmma 226,336 (two 66 KB slab stages, the 64 KB A tile, the encoding
    tile and its cotangents); K2 on wgmma 214,048 (two 66 KB slab stages,
    the 64 KB A tile, the encoding tile), narrowed or not;
    K3-fwd on wgmma 226,336 (two 64 KB stages, the 80 KB A tile);
    K3-fwd-bf16 on wgmma 229,632 (two consumers' narrow tiles, six 32 KB
    bf16 slab stages).  A radiance MLP with 288-wide hidden layers is
    refused before any launch."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, _ = net.effective_weights()
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    k1 = [GK.fwd_wg_plan(cfg, ws, 100, slabs, 1, stash)["sweep_smem"]
          for stash in (False, True)]
    narrowed = ws[:-1] + [ws[-1][:1]]
    flay = SK.make_sweep_pack(cfg, ws, bf16=False)[1]
    k2 = [SK.sweep_wg_plan(cfg, w, 100, flay, 1)["sweep_smem"]
          for w in (ws, narrowed)]
    rcfg = RenderingConfig()
    rws, _, _, _ = _radiance(rcfg, 1)
    k3 = RK.fwd_wg_plan(rcfg, rws, 100, RK.make_fwd_pack(rcfg, rws)[1],
                        1)["sweep_smem"]
    k3_16 = RK.fwd_wg16_plan(rcfg, rws, 100, RK.make_fwd_pack(
        rcfg, rws, bf16=True)[1], 1)["sweep_smem"]
    assert (k1, k2, k3, k3_16) == ([226336] * 2, [214048] * 2, 226336,
                                   229632)
    assert max(*k1, *k2, k3, k3_16) <= TP.SMEM_MAX == 232448
    wide = RenderingConfig(d_hidden=288)
    wws, _, _, _ = _radiance(wide, 1)
    with pytest.raises(ValueError):
        RK.make_fwd_pack(wide, wws, bf16=True)
    with pytest.raises(ValueError):
        RK.make_fwd_pack(wide, wws)
