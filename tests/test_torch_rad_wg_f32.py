"""K3-bwd on wgmma in 3xTF32 (csrc/radiance_bwd_wg.cu), on the CPU: its two
f32 slab packs (tc_pack.pack_rad_sweep_f32, pack_rad_rev_f32) read back
and the layouts' refusals, its launch plan (radiance_kernel.bwd_wg_plan),
the decoding of its ReLU mask bits (two consumers' 256 threads, 2 words a
layer), its weight-gradient pass in plain PyTorch
(radiance_kernel.weight_grad_pass_plain(f32=True): split-K chunks of
X_l^T R_l in 3xTF32, a rounded add every 32-row stage) against the f32
twin and the JAX package's f32 body (pallas_radiance._make_radiance,
interpret mode, jitted), and the design's accumulation
(radiance_kernel.sweep_mm_f32 through the twin's sweep, then the pass) at
full width against the float64 twin at chip_smoke.check_vjp's bound.  The
kernel itself is held against the twin on a card by
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
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_radiance as PR
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                   RenderingNetwork)
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (d_feature, d_hidden, n_layers, multires_view)
    "full width": (256, 256, 4, 4),
    "2 x 96, no encoding": (32, 96, 2, 0),
    "1 x 64": (64, 64, 1, 4),
}
# chip_smoke.check_vjp: per tensor, |kernel - f64 twin| <= 1e-4 + 1e-5
# max|f64 twin|
VJP_ATOL, VJP_RTOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _net(key):
    """(cfg, ws [out, in], bs) of NETS[key], drawn from a seed."""
    d_feature, d_hidden, n_layers, multires = NETS[key]
    cfg = RenderingConfig(d_feature=d_feature, d_hidden=d_hidden,
                          n_layers=n_layers, multires_view=multires)
    rng = np.random.RandomState(0)
    ws = [torch.from_numpy((rng.randn(o, i) / np.sqrt(i)).astype(np.float32))
          for i, o in zip(cfg.dims[:-1], cfg.dims[1:])]
    bs = [torch.from_numpy((rng.randn(o) * 0.1).astype(np.float32))
          for o in cfg.dims[1:]]
    return cfg, ws, bs


def _inputs(cfg, n, seed=5):
    rng = np.random.RandomState(seed)
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(n, 3) * 0.4, rng.randn(n, 3), dirs,
        rng.randn(n, cfg.d_feature) * 0.5)]
    ct = torch.from_numpy(rng.randn(n, cfg.d_out).astype(np.float32))
    return inputs, ct


@pytest.mark.parametrize("key", list(NETS))
def test_rad_f32_packs_read_back_split_w(key):
    """Read back through the swizzle's inverse (tc_pack.rad_f32_block), the
    forward pack holds W^T and the reverse pack W of every layer, each k
    at tf32_slot(k), split into big = tf32_round(W) and small = W - big,
    big + small == W exactly, zero elsewhere, each weight once in each
    half: layer 0's feature rows first and its narrow rows [pts |
    PE(dirs) | normals] from k = 256 on, ten slabs (forward), its feature
    columns in 256-wide slabs and the narrow ones in 48-wide slabs after
    them (reverse); hidden layers eight slabs; the 3-wide last layer 8
    columns wide (forward) and one slab deep (reverse)."""
    cfg, ws, _ = _net(key)
    nar = 6 + cfg.d_view
    (fp, fl), (rp, rl) = RK.make_bwd_slabs(cfg, ws, bf16=False)
    L = len(ws)
    assert (fl.operand, rl.operand) == ("wgmma-f32-rad",
                                        "wgmma-f32-rad-rev")
    assert fl.nslab == [10] + [8] * (L - 1)
    assert fl.cols == [256] * (L - 1) + [8]
    assert rl.nslab == [16] + [8] * (L - 2) + [1]
    assert all(o % 1024 == 0 for o in fl.off + rl.off)
    total = 0.0
    for l, w in enumerate(ws):
        o, i = w.shape
        fwd, rev = TP.rad_f32_block(fp, fl, l), TP.rad_f32_block(rp, rl, l)
        want_f = torch.zeros_like(fwd[0])
        want_r = torch.zeros_like(rev[0])
        if l == 0:
            assert want_f.shape == (320, 256) and want_r.shape == (256, 304)
            kf = TP.tf32_slot(np.arange(i - nar))
            kn = TP.tf32_slot(256 + np.arange(nar))
            want_f[kf, :o] = w[:, nar:].t()
            want_f[kn, :o] = w[:, :nar].t()
            ko = TP.tf32_slot(np.arange(o))
            want_r[ko, :i - nar] = w[:, nar:]
            want_r[ko, 256:256 + nar] = w[:, :nar]
        else:
            want_f[TP.tf32_slot(np.arange(i)), :o] = w.t()
            want_r[TP.tf32_slot(np.arange(o)), :i] = w
        for (big, small), want in ((fwd, want_f), (rev, want_r)):
            assert torch.equal(big + small, want), l
            assert torch.equal(big, TP.tf32_round(want)), l
        total += float(w.double().pow(2).sum())
    for p, lay in ((fp, fl), (rp, rl)):
        assert 4 * p.numel() == lay.nbytes
        blocks = [TP.rad_f32_block(p, lay, l) for l in range(L)]
        sq = sum(float(((b.double() + s.double()) ** 2).sum())
                 for b, s in blocks)
        assert sq == pytest.approx(total, rel=1e-12)
        assert float(p.double().abs().sum()) == pytest.approx(sum(
            float(b.double().abs().sum() + s.double().abs().sum())
            for b, s in blocks), rel=1e-12)


def test_rad_f32_layouts_refuse_what_the_kernel_cannot_run():
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
        for layout in (TP.rad_sweep_layout_f32, TP.rad_rev_layout_f32):
            with pytest.raises(ValueError, match="K3-bwd takes"):
                layout(ins, outs, nar)


@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_rad_f32_plan_covers_every_tile(n):
    """K3-bwd's launch plan at the step's 65,536 rows and smaller: one
    block a tile up to one a SM, the weight-gradient pass over units x
    chunks <= SMs blocks (units: layer 0's three X pairs and every hidden
    layer's two, each with R's two halves; the last layer's two X pairs
    with its one 8-column R), whose chunks hold every tile once and none
    empty, the images of every tile, shared memory within a block's 227
    KB; the other mode's packs are refused by the f32 launch."""
    cfg, ws, _ = _net("full width")
    ins, outs = [int(w.shape[1]) for w in ws], [int(w.shape[0]) for w in ws]
    slabs = ((None, TP.rad_sweep_layout_f32(ins, outs, 33)),
             (None, TP.rad_rev_layout_f32(ins, outs, 33)))
    sms = 132
    p = RK.bwd_wg_plan(cfg, ws, n, slabs, sms)
    tiles = -(-n // RK.WG_TILE)
    assert p["tiles"] == p["n_pass"] == tiles
    assert p["grid"] == min(tiles, sms)
    assert p["units"] == 3 * 2 + 3 * 2 * 2 + 2
    assert p["units"] * p["chunks"] <= sms or p["chunks"] == 1
    assert p["chunks"] * p["per"] >= tiles > (p["chunks"] - 1) * p["per"]
    per_tile = 4 * 64 * (320 + 4 * 256 + 4 * 256 + 8)
    assert p["image_bytes"] == tiles * per_tile
    assert p["sweep_smem"] <= TP.SMEM_MAX and p["wgrad_smem"] <= TP.SMEM_MAX
    assert p["wgrad_smem"] == 1024 + 4 * (49152 + 24)
    L = len(ws)
    assert len(p["iargs"]) == 10 + 4 * L and p["mask_words"] == 0
    assert p["iargs"][10 + 2 * L:] == [*slabs[0][1].off, *slabs[1][1].off]
    assert p["slot_floats"] == p["units"] * p["chunks"] * 2 * 64 * 136
    assert RK.bwd_wg_plan(cfg, ws, n, slabs, sms, masks=True)[
        "mask_words"] == tiles * 256 * 4 * 2
    with pytest.raises(ValueError, match="wgmma"):
        RK.bwd_wg_plan(cfg, ws, n, (ROW_MAJOR,) * 2, sms)
    with pytest.raises(ValueError, match="wgmma-f32-rad"):
        RK._launch_backward_wg(cfg, ws, [], *([torch.zeros(n, 3)] * 4), None,
                               RK.make_bwd_slabs(cfg, ws), bf16=False)
    with pytest.raises(ValueError, match="make_bwd_slabs"):
        RK.launch_backward(cfg, ws, [], *([torch.zeros(n, 3)] * 4), None)


def test_rad_f32_mask_bits_decode_to_the_tile_layout():
    """decode_mask_bits inverts K3-bwd's mask words: bit i % 32 of word i /
    32 of thread tid (consumer c = tid / 128, warp w, lane group g, t) is
    row 16 w + g (+ 8 for i % 4 >= 2) and column 128 c + 8 (i / 4) + 2 t
    + i % 2 of the tile, rows past n dropped, columns past the layer's
    width dropped."""
    rng = np.random.RandomState(4)
    tiles, H, n, outs = 3, 2, 150, [256, 96]
    want = rng.rand(H, tiles * 64, 256) > 0.5
    tid, i = np.arange(256)[:, None], np.arange(64)[None, :]
    lane = tid % 32
    row = 16 * ((tid % 128) // 32) + lane // 4 + 8 * (i % 4 >= 2)
    col = 128 * (tid // 128) + 8 * (i // 4) + 2 * (lane % 4) + i % 2
    tile_rows = want.reshape(H, tiles, 64, 256)[:, :, row, col]
    words = (tile_rows.reshape(H, tiles, 256, 2, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    bits = np.ascontiguousarray(words.astype(np.uint32).transpose(1, 2, 0, 3))
    got = RK.decode_mask_bits(torch.from_numpy(bits.view(np.int32)), n,
                              outs)
    for l in range(H):
        assert torch.equal(got[l], torch.from_numpy(
            want[l, :n, :outs[l]])), l


@functools.lru_cache(maxsize=None)
def _jax_f32_bwd():
    """JAX's f32 radiance backward body (run_bwd through _make_radiance's
    VJP, interpret mode, jitted) on the K3 tests' small net
    (test_torch_radiance.SIZES, 150 rows), weights and inputs drawn from a
    seed: (cfg, ws, bs, inputs, ct, dW [in, out] per layer, db)."""
    cfg = RenderingConfig(**SIZES)
    rng = np.random.RandomState(5)
    ws = [(rng.randn(o, i) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(cfg.dims[:-1], cfg.dims[1:])]
    bs = [(rng.randn(o) * 0.1).astype(np.float32) for o in cfg.dims[1:]]
    inputs, ct = _inputs(cfg, 150, seed=6)
    fn = PR._make_radiance(JF.RenderingConfig(**SIZES), False, 64)

    @jax.jit     # one compiled body, not op-by-op interpretation
    def bwd(ws, bs, pts, normals, dirs, feat, ct):
        return jax.vjp(fn, ws, bs, pts, normals, dirs, feat)[1](ct)
    dws, dbs = bwd(tuple(jnp.asarray(w.T) for w in ws),
                   tuple(jnp.asarray(b) for b in bs),
                   *(jnp.asarray(a.numpy()) for a in inputs),
                   jnp.asarray(ct.numpy()))[:2]
    t = torch.from_numpy
    return (cfg, [t(w) for w in ws], [t(b) for b in bs], inputs, ct,
            [np.asarray(w) for w in dws], [np.asarray(b) for b in dbs])


@pytest.mark.parametrize("tiles_per_chunk", [1, 2])
def test_rad_f32_weight_grad_pass_matches_twin_and_jax(tiles_per_chunk):
    """The f32 weight-gradient pass in plain PyTorch (the twin's X_l and
    R_l in, 3xTF32 on both operands as the tensor core reads the images, a
    rounded add every 32-row stage, split-K chunks of tiles_per_chunk tiles
    summed in order; db the f32 sum of R_l) against the f32 twin and
    JAX's f32 run_bwd (pallas_radiance, interpret mode), per tensor within
    check_vjp's bound of each (1e-4 + 1e-5 max|ref|): what K3-bwd must
    meet against the f64 twin on the card."""
    cfg, ws, bs, inputs, ct, jw, jb = _jax_f32_bwd()
    ops = {}
    *_, tw_w, tw_b = RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct,
                                           operands=ops)
    dws, dbs = RK.weight_grad_pass_plain(ops, tiles_per_chunk, f32=True)
    worst = 0.0
    for l in range(len(ws)):
        for got, twin, jax_ref, name in ((dws[l], tw_w[l], jw[l].T, f"dW{l}"),
                                         (dbs[l], tw_b[l], jb[l], f"db{l}")):
            for ref in (twin.numpy(), jax_ref):
                tol = VJP_ATOL + VJP_RTOL * float(np.abs(ref).max())
                err = float(np.abs(got.numpy() - ref).max())
                worst = max(worst, err / tol)
                assert err <= tol, (name, err, tol)
    print(f"K3 f32 weight-gradient pass, {tiles_per_chunk} tiles a chunk: "
          f"worst ratio to check_vjp's bound {worst:.3f}")


def _design_ratios(mm_of, n=128):
    """Per-tensor ratios to check_vjp's bound of K3-bwd's arithmetic at full
    width against the float64 twin on the masks of the emulated forward
    (as chip_smoke's check takes the kernel's own): the sweep's products
    by ``mm_of(narrow)`` (layer 0's forward in the kernel's k order), then
    the f32 pass (weight_grad_pass_plain(f32=True))."""
    cfg, ws, bs = _net("full width")
    inputs, ct = _inputs(cfg, n, seed=1)
    nar, ins0 = 6 + cfg.d_view, int(ws[0].shape[1])
    ops = {}
    mm = lambda a, b: mm_of(nar if a.shape[1] == ins0 else 0)(a, b)
    *cts, _, dbs = RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct,
                                         operands=ops, mm=mm)
    dws, _ = RK.weight_grad_pass_plain(ops, 1, f32=True)
    masks = [ops[l][0] > 0 for l in range(1, len(ws))]
    *rc, rw, rb = RK.radiance_bwd_plain(
        [w.double() for w in ws], [b.double() for b in bs], cfg,
        *(v.double() for v in inputs), ct.double(), masks=masks)
    got, ref = [*cts, *dws, *dbs], [*rc, *rw, *rb]
    return [float((g.double() - r).abs().max())
            / (VJP_ATOL + VJP_RTOL * float(r.abs().max()))
            for g, r in zip(got, ref)]


def test_rad_design_accumulation_within_check_vjp_bound():
    """K3-bwd's arithmetic emulated at full width on 128 rows (two tiles),
    against the float64 twin on the same ReLU masks: with a rounded add
    every slab of 32 k (K1's engine, GK.WGF_SWEEP_STAGE, through
    sweep_mm_f32) and every 32-row stage of the pass, every tensor lies
    within 0.5 of check_vjp's bound."""
    assert GK.WGF_SWEEP_STAGE == RK.WGF_PASS_STAGE == 32
    ratios = _design_ratios(
        lambda nar: functools.partial(RK.sweep_mm_f32, narrow=nar))
    print(f"K3-bwd design: worst ratio to check_vjp's bound "
          f"{max(ratios):.3f}")
    assert max(ratios) <= 0.5


def test_rad_kernel_weights_build_no_f32_slabs_on_the_cpu():
    """On the CPU the radiance MLP's f32 kernel weights carry no pack, and
    the f32 mode differentiates through the plain twin; bwd_slabs names
    the f32 pair sweep32, rev32."""
    cfg, _, _ = _net("1 x 64")
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0))
    weights = net.kernel_weights()
    assert weights[2:] == (None,) * (len(weights) - 2)
    fake = weights._replace(sweep32=("f",), rev32=("r",))
    assert TF.bwd_slabs(fake, False) == (("f",), ("r",))
    inputs, _ = _inputs(cfg, 70)
    net(*inputs, weights=weights).sum().backward()
    assert all(l.weight_v.grad is not None for l in net.layers())
