"""K3-bwd-bf16 on wgmma (csrc/radiance_bwd_bf16_wg.cu), on the CPU: its
two slab packs (tc_pack.pack_rad_sweep_bf16, pack_rad_rev_bf16) and the
layouts' refusals, its launch plan (radiance_kernel.bwd_wg_plan), the
decoding of its ReLU mask bits (radiance_kernel.decode_mask_bits), and its
weight-gradient pass in plain PyTorch (radiance_kernel.
weight_grad_pass_plain: split-K chunks of bf16 X_l^T R_l summed in the
kernel's order) against the twin radiance_bwd_plain(bf16=True) and against
the JAX package's bf16 body (pallas_radiance._make_radiance, interpret
mode).  The kernel itself is held against the twin on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_radiance import SIZES
from util_packs import ROW_MAJOR

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_radiance as PR
from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                   RenderingNetwork)
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP

# the twins' bf16 tolerance (tests/test_torch_bf16.py TWIN_RTOL): both
# round the same operands and sum them in f32 in other orders; relative to
# the largest entry of each tensor
TWIN_RTOL = 1e-3

NETS = {  # (d_feature, d_hidden, n_layers, multires_view)
    "full width": (256, 256, 4, 4),
    "2 x 96, no encoding": (32, 96, 2, 0),
    "1 x 64": (64, 64, 1, 4),
}


@functools.lru_cache(maxsize=None)
def _net(key):
    """(cfg, ws [out, in]) of NETS[key], the weights drawn from a seed."""
    d_feature, d_hidden, n_layers, multires = NETS[key]
    cfg = RenderingConfig(d_feature=d_feature, d_hidden=d_hidden,
                          n_layers=n_layers, multires_view=multires)
    rng = np.random.RandomState(0)
    ws = [torch.from_numpy((rng.randn(o, i) / np.sqrt(i)).astype(np.float32))
          for i, o in zip(cfg.dims[:-1], cfg.dims[1:])]
    return cfg, ws


@pytest.mark.parametrize("key", list(NETS))
def test_rad_packs_read_back_rounded_w(key):
    """Read back through the swizzle's inverse (tc_pack.rad_block), the
    forward pack holds bf16(W^T) and the reverse pack bf16(W) of every
    layer, zero elsewhere, each weight once: layer 0's feature rows first
    and its narrow rows [pts | PE(dirs) | normals] at k = 256 (forward),
    its feature columns in 256-wide slabs and the narrow ones in 48-wide
    slabs after them (reverse); hidden layers at four slabs; the 3-wide
    last layer 8 columns wide (forward) and one slab deep (reverse)."""
    cfg, ws = _net(key)
    nar = 6 + cfg.d_view
    (fp, fl), (rp, rl) = RK.make_bwd_slabs(cfg, ws)
    L = len(ws)
    assert (fl.operand, rl.operand) == ("wgmma-bf16-rad",
                                        "wgmma-bf16-rad-rev")
    assert fl.nslab == [5] + [4] * (L - 1)
    assert fl.cols == [256] * (L - 1) + [8]
    assert rl.nslab == [8] + [4] * (L - 2) + [1]
    assert all(o % 1024 == 0 for o in fl.off + rl.off)
    total = 0.0
    for l, w in enumerate(ws):
        o, i = w.shape
        w16 = TP.bf16_round(w)
        fwd, rev = TP.rad_block(fp, fl, l), TP.rad_block(rp, rl, l)
        want_f, want_r = torch.zeros_like(fwd), torch.zeros_like(rev)
        if l == 0:
            assert fwd.shape == (320, 256) and rev.shape == (256, 304)
            want_f[:i - nar, :o] = w16[:, nar:].t()
            want_f[256:256 + nar, :o] = w16[:, :nar].t()
            want_r[:o, :i - nar] = w16[:, nar:]
            want_r[:o, 256:256 + nar] = w16[:, :nar]
        else:
            want_f[:i, :o] = w16.t()
            want_r[:o, :i] = w16
        assert torch.equal(fwd, want_f), l
        assert torch.equal(rev, want_r), l
        total += float(w16.double().pow(2).sum())
    for p, lay in ((fp, fl), (rp, rl)):
        assert 4 * p.numel() == lay.nbytes
        flat = p.view(torch.bfloat16).double()
        assert float(flat.pow(2).sum()) == pytest.approx(total, rel=1e-12)


def test_rad_layouts_refuse_what_the_kernel_cannot_run():
    """Five hidden layers (the masks of four fit in registers), a hidden
    layer over 256, a last layer over 8, narrow columns over 48, an odd
    or too wide feature: refused before any launch, by both layouts."""
    cases = (([289] + [256] * 5, [256] * 5 + [3], 33),
             ([289, 288], [288, 3], 33),
             ([289, 256], [256, 9], 33),
             ([51 + 256, 256], [256, 3], 51),
             ([33 + 63, 64], [64, 3], 33),
             ([33 + 258, 256], [256, 3], 33))
    for ins, outs, nar in cases:
        for layout in (TP.rad_sweep_layout, TP.rad_rev_layout):
            with pytest.raises(ValueError, match="K3-bwd-bf16"):
                layout(ins, outs, nar)


@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_rad_bwd_wg_plan_covers_every_tile(n):
    """The launch plan at the step's 65,536 rows and smaller: two consumer
    warpgroups a block only when the tiles outnumber the SMs, one block a
    pass up to one a SM, the weight-gradient pass over units x chunks <=
    SMs blocks whose chunks hold every tile once and none empty, the
    images of every consumer tile, shared memory within a block's 227 KB;
    packs of another kind, or of another network, are refused."""
    cfg, ws = _net("full width")
    ins, outs = [int(w.shape[1]) for w in ws], [int(w.shape[0]) for w in ws]
    slabs = ((None, TP.rad_sweep_layout(ins, outs, 33)),
             (None, TP.rad_rev_layout(ins, outs, 33)))
    sms = 132
    p = RK.bwd_wg_plan(cfg, ws, n, slabs, sms)
    tiles = -(-n // RK.WG_TILE)
    assert p["tiles"] == tiles
    assert p["nc"] == (2 if tiles > sms else 1)
    assert p["n_pass"] * p["nc"] >= tiles > (p["n_pass"] - 1) * p["nc"]
    assert p["grid"] == min(p["n_pass"], sms)
    assert p["units"] == 3 + 3 * 2 + 2
    assert p["units"] * p["chunks"] <= sms or p["chunks"] == 1
    assert p["chunks"] * p["per"] >= tiles > (p["chunks"] - 1) * p["per"]
    per_tile = RK.WG_BLOCK * (5 + 4 * 4 + 4 * 4 + 1)
    assert p["image_bytes"] == p["n_pass"] * p["nc"] * per_tile
    assert max(p["sweep_smem"], p["wgrad_smem"]) <= TP.SMEM_MAX
    assert len(p["iargs"]) == 11 + 4 * len(ws) and p["mask_words"] == 0
    assert RK.bwd_wg_plan(cfg, ws, n, slabs, sms, masks=True)[
        "mask_words"] == p["n_pass"] * p["nc"] * 128 * 4 * 4
    with pytest.raises(ValueError, match="wgmma"):
        RK.bwd_wg_plan(cfg, ws, n, (ROW_MAJOR,) * 2, sms)
    other = [int(w.shape[1]) for w in _net("1 x 64")[1]], [
        int(w.shape[0]) for w in _net("1 x 64")[1]], 33
    with pytest.raises(ValueError, match="layouts"):
        RK.bwd_wg_plan(cfg, ws, n, ((None, TP.rad_sweep_layout(*other)),
                                    (None, TP.rad_rev_layout(*other))), sms)


def test_mask_bits_decode_to_the_tile_layout():
    """decode_mask_bits inverts the kernel's mask words: bit i % 32 of
    word i / 32 of thread tid (warp w, lane group g, t) is row 16 w + g
    (+ 8 for i % 4 >= 2) and column 8 (i / 4) + 2 t + i % 2 of the tile,
    rows past n dropped, columns past the layer's width dropped."""
    rng = np.random.RandomState(3)
    tiles, H, n, outs = 3, 2, 150, [256, 96]
    want = rng.rand(H, tiles * 64, 256) > 0.5
    tid, i = np.arange(128)[:, None], np.arange(128)[None, :]
    lane = tid % 32
    row = 16 * (tid // 32) + lane // 4 + 8 * (i % 4 >= 2)       # [128, 128]
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    tile_rows = want.reshape(H, tiles, 64, 256)[:, :, row, col]
    words = (tile_rows.reshape(H, tiles, 128, 4, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    bits = np.ascontiguousarray(words.astype(np.uint32).transpose(1, 2, 0, 3))
    got = RK.decode_mask_bits(torch.from_numpy(bits.view(np.int32)), n,
                              outs)
    for l in range(H):
        assert torch.equal(got[l], torch.from_numpy(
            want[l, :n, :outs[l]])), l


@functools.lru_cache(maxsize=None)
def _jax_bwd():
    """JAX's bf16 radiance backward body (run_bwd through _make_radiance's
    VJP, jitted, interpret mode) on the smallest net of the K3 tests
    (test_torch_radiance.SIZES, 150 rows; effective weights and inputs
    drawn from a seed): (cfg, ws [out, in], bs, inputs, ct, dW [in, out]
    per layer, db per layer)."""
    cfg = RenderingConfig(**SIZES)
    rng = np.random.RandomState(5)
    ws = [(rng.randn(o, i) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(cfg.dims[:-1], cfg.dims[1:])]
    bs = [(rng.randn(o) * 0.1).astype(np.float32) for o in cfg.dims[1:]]
    n = 150
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [a.astype(np.float32) for a in (
        rng.randn(n, 3) * 0.4, rng.randn(n, 3), dirs,
        rng.randn(n, cfg.d_feature) * 0.5)]
    ct = rng.randn(n, cfg.d_out).astype(np.float32)
    ws_j = tuple(jnp.asarray(w.T) for w in ws)
    bs_j = tuple(jnp.asarray(b) for b in bs)
    fn = PR._make_radiance(JF.RenderingConfig(**SIZES), True, 64)

    @jax.jit     # one compiled body, not op-by-op interpretation
    def bwd(ws, bs, pts, normals, dirs, feat, ct):
        return jax.vjp(fn, ws, bs, pts, normals, dirs, feat)[1](ct)
    dws, dbs = bwd(ws_j, bs_j, *map(jnp.asarray, inputs),
                   jnp.asarray(ct))[:2]
    t = torch.from_numpy
    return (cfg, [t(w) for w in ws], [t(b) for b in bs],
            [t(a) for a in inputs], t(ct), [np.asarray(w) for w in dws],
            [np.asarray(b) for b in dbs])


@pytest.mark.parametrize("tiles_per_chunk", [1, 2])
def test_rad_weight_grad_pass_matches_twin_and_jax_bf16(tiles_per_chunk):
    """The weight-gradient pass in plain PyTorch (bf16 X_l and R_l of the
    twin's sweep in, split-K chunks of tiles_per_chunk tiles summed in
    order; db the f32 sum of R_l) against the twin
    radiance_bwd_plain(bf16=True) within TWIN_RTOL of each tensor's
    largest entry, and against JAX's bf16 run_bwd (pallas_radiance,
    interpret mode): within TWIN_RTOL and closer to it than the f32
    function is, wherever the two differ.  The f32 function is the port's
    f32 twin, which test_torch_radiance holds to JAX's f32 body within
    1e-5 (one JAX body compiled here, not two)."""
    cfg, ws, bs, inputs, ct, j16w, j16b = _jax_bwd()
    ops = {}
    *_, tw_w, tw_b = RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct,
                                           bf16=True, operands=ops)
    *_, f32w, f32b = RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct)
    j32w = [w.t().numpy() for w in f32w]
    j32b = [b.numpy() for b in f32b]
    dws, dbs = RK.weight_grad_pass_plain(ops, tiles_per_chunk)
    ratios = []
    for l in range(len(ws)):
        for got, twin, a, b, name in (
                (dws[l], tw_w[l], j16w[l].T, j32w[l].T, f"dW{l}"),
                (dbs[l], tw_b[l], j16b[l], j32b[l], f"db{l}")):
            tol = TWIN_RTOL * float(twin.abs().max())
            assert float((got - twin).abs().max()) <= tol, name
            d_port = float(np.abs(got.numpy() - a).max())
            d_f32 = float(np.abs(b - a).max())
            assert d_port <= TWIN_RTOL * float(np.abs(a).max()), name
            if d_f32 > 0:   # the last layer's db is the seed's sum in both
                assert d_port < d_f32, (name, d_port, d_f32)
                ratios.append(d_port / d_f32)
    print(f"K3 weight-gradient pass, {tiles_per_chunk} tiles a chunk: port "
          f"to JAX-bf16 / f32 to JAX-bf16, worst {max(ratios):.3e} over "
          f"{len(ratios)} tensors")


def test_kernel_weights_build_no_slabs_on_the_cpu():
    """On the CPU the radiance MLP's kernel weights carry no pack, and the
    bf16 mode differentiates through the explicit twins."""
    cfg, _ = _net("1 x 64")
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0))
    weights = net.kernel_weights(bf16=True, f32=False)
    assert weights[2:] == (None,) * (len(weights) - 2)
    rng = np.random.RandomState(0)
    inputs = [torch.from_numpy(rng.randn(70, d).astype(np.float32))
              for d in (3, 3, 3, cfg.d_feature)]
    net(*inputs, weights=weights, bf16=True).sum().backward()
    assert all(l.weight_v.grad is not None for l in net.layers())
