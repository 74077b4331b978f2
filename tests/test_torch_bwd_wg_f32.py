"""K1-bwd on wgmma in 3xTF32 (csrc/geometry_bwd_wg.cu), on the CPU: its
two f32 slab packs (tc_pack.pack_sweep_f32, pack_rev_f32) read back, its
launch plan (geometry_kernel.bwd_wg_plan), its weight-gradient pass in
plain PyTorch (geometry_kernel.weight_grad_pass_plain(f32=True): split-K
chunks of X_l^T R_l in 3xTF32, the rows in the tiles' order, a rounded add
every 32-row stage) against the f32 twin and the JAX package's f32 stacked
body (pallas_geometry._make_geom, jitted), and the design's accumulation
(geometry_kernel.sweep_mm_f32 through the twin's sweep, then the pass) at
full width against the float64 twin at chip_smoke.check_vjp's bound: the
test that fixes how many k-steps a wgmma accumulator may sum before a
rounded add.  The kernel itself is held against the twin on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_packs import ROW_MAJOR
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "2 x 64, no skip": (2, 64, 65, (), 4, 1.0),
}
# chip_smoke.check_vjp: per tensor, |kernel - f64 twin| <= 1e-4 + 1e-5
# max|f64 twin|
VJP_ATOL, VJP_RTOL = 1e-4, 1e-5


def _net(key):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, [w.detach() for w in ws], [b.detach() for b in bs]


def _inputs(cfg, ws, n, seed=7):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3) * 0.4).astype(np.float32)
    ct_out = rng.randn(n, int(ws[-1].shape[0])).astype(np.float32)
    ct_g = rng.randn(n, 3).astype(np.float32)
    return x, ct_out, ct_g


def test_tf32_slot_is_the_accumulator_order():
    """Within each group of 8, k slot t holds column 2t and slot t + 4
    column 2t + 1 (wgmma's accumulator order of a thread's columns), a
    permutation of the group."""
    c = np.arange(264)
    s = TP.tf32_slot(c)
    assert sorted(s) == list(c)
    assert np.array_equal(s // 8, c // 8)
    for t in range(4):
        assert s[2 * t] == t and s[2 * t + 1] == t + 4
        assert s[256 + 2 * t] == 256 + t


@pytest.mark.parametrize("key", list(NETS))
def test_f32_packs_read_back_split_w(key):
    """Read back through the swizzle's inverse (tc_pack.f32_block), each
    layer's slabs hold W (forward: W^T, k its input; reverse: W, k its
    output), each k at tf32_slot(k), split into big = tf32_round(W) and
    small = W - big, big + small == W exactly; fixed depths (forward 2
    slabs for layer 0, 8 for the others and for the last, K1-fwd's;
    reverse 8, 9 for the 257-wide last layer); columns 256 (reverse layer
    0: 48; the forward 257-wide last layer: 264); zero elsewhere; every
    weight lands once in each half."""
    cfg, ws, _ = _net(key)
    skip = sorted(GK.skip_layers(cfg, len(ws)))
    fwd, flay = TP.pack_sweep_f32(ws, skip, cfg.d_embed)
    rev, rlay = TP.pack_rev_f32(ws, cfg.d_embed)
    assert (flay.operand, rlay.operand) == ("wgmma-f32", "wgmma-f32-rev")
    L = len(ws)
    assert flay.nslab == [2] + [8] * (L - 1)
    assert flay.cols == [256] * (L - 1) + [264 if ws[-1].shape[0] > 256
                                           else 256]
    assert rlay.nslab == [8] * (L - 1) + [9 if ws[-1].shape[0] > 256 else 8]
    assert rlay.cols == [48] + [256] * (L - 1)
    for pack, lay, reverse in ((fwd, flay, False), (rev, rlay, True)):
        assert 4 * pack.numel() == lay.nbytes
        total = 0.0
        for l, w in enumerate(ws):
            if not lay.nslab[l]:
                continue
            big, small = TP.f32_block(pack, lay, l)
            assert big.shape == (32 * lay.nslab[l], lay.cols[l])
            m = w if reverse else w.t()
            want = torch.zeros_like(big)
            want[TP.tf32_slot(np.arange(m.shape[0])), :m.shape[1]] = m
            assert torch.equal(big + small, want), (l, reverse)
            assert torch.equal(big, TP.tf32_round(want)), (l, reverse)
            assert torch.equal(small, want - TP.tf32_round(want))
            total += float(want.double().pow(2).sum())
        # each weight once: nothing but the blocks read above is nonzero,
        # and they hold each weight once
        blocks = [TP.f32_block(pack, lay, l) for l in range(L)
                  if lay.nslab[l]]
        sq = sum(float(((b.double() + s.double()) ** 2).sum())
                 for b, s in blocks)
        assert sq == pytest.approx(total, rel=1e-12)
        assert float(pack.double().abs().sum()) == pytest.approx(sum(
            float(b.double().abs().sum() + s.double().abs().sum())
            for b, s in blocks), rel=1e-12)


def test_f32_layouts_refuse_what_the_kernel_cannot_run():
    """Hidden layers over 256 wide, a last layer over 264, an encoding
    over 48, a single layer, a skip into the last layer: refused before
    any launch."""
    for ins, outs, d, skip in (([39, 288], [288, 1], 39, ()),
                               ([39, 256], [256, 265], 39, ()),
                               ([51, 256], [256, 1], 51, ()),
                               ([39], [257], 39, ()),
                               ([39, 295], [256, 1], 39, (1,))):
        with pytest.raises(ValueError, match="K1-bwd"):
            TP.sweep_layout_f32(ins, outs, skip, d)
        if not skip:
            with pytest.raises(ValueError, match="K1-bwd"):
                TP.rev_layout_f32(ins, outs, d)


@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_f32_plan_covers_every_tile(n):
    """K1-bwd's launch plan at the step's 65,536 points and smaller: one
    block a tile up to one a SM, the weight-gradient pass over units x
    chunks <= SMs blocks (units: layer 0's one X pair and every other
    layer's two, each with R's two halves) whose chunks hold every tile
    once and none empty, the images of every tile, shared memory within a
    block's 227 KB; the other mode's packs are refused by the f32 launch."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    sms = 132
    p = GK.bwd_wg_plan(cfg, ws, n, slabs, sms)
    tiles = -(-n // GK.WG_POINTS)
    assert p["tiles"] == p["n_pass"] == tiles
    assert p["grid"] == min(tiles, sms)
    assert p["units"] == 2 + 8 * 4
    assert p["units"] * p["chunks"] <= sms or p["chunks"] == 1
    assert p["chunks"] * p["per"] >= tiles > (p["chunks"] - 1) * p["per"]
    per_tile = 4 * (2 * 64 * 32 + 8 * 2 * 256 * 32 + 8 * 2 * 256 * 32
                    + 2 * 264 * 32)
    assert p["image_bytes"] == tiles * per_tile
    assert p["sweep_smem"] <= TP.SMEM_MAX and p["wgrad_smem"] <= TP.SMEM_MAX
    assert p["wgrad_smem"] == 1024 + 4 * (51200 + 24)
    L = len(ws)
    assert len(p["iargs"]) == 8 + 6 * L
    assert p["iargs"][8 + 2 * L:8 + 3 * L] == [1, 0, 0, 0, 1, 0, 0, 0, 0]
    assert p["iargs"][8 + 5 * L:] == [48] + [256] * (L - 1)
    assert p["slot_floats"] == p["units"] * p["chunks"] * 2 * 64 * 136
    with pytest.raises(ValueError, match="wgmma"):
        GK.bwd_wg_plan(cfg, ws, n, (ROW_MAJOR,) * 2, sms)
    with pytest.raises(ValueError, match="wgmma-f32"):
        GK._launch_backward_wg(cfg, torch.zeros(n, 3), ws, [], None, None,
                               GK.make_bwd_slabs(cfg, ws), bf16=False)


@functools.lru_cache(maxsize=None)
def _jax_f32_bwd(key, n):
    """JAX's f32 stacked backward body, jitted, on the effective weights of
    _net(key): (dW [in, out], db) per layer."""
    cfg, ws, bs = _net(key)
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    x, ct_out, ct_g = _inputs(cfg, ws, n)
    geom = PG._make_geom(jcfg, False, 64)

    @jax.jit     # one compiled body, not op-by-op interpretation
    def bwd(ws, bs, x, ct_out, ct_g):
        return jax.vjp(geom, ws, bs, x)[1]((ct_out, ct_g))
    dws, dbs, _ = bwd(tuple(jnp.asarray(w.t().numpy()) for w in ws),
                      tuple(jnp.asarray(b.numpy()) for b in bs),
                      jnp.asarray(x), jnp.asarray(ct_out), jnp.asarray(ct_g))
    return [np.asarray(w) for w in dws], [np.asarray(b) for b in dbs]


@pytest.mark.parametrize("tiles_per_chunk", [1, 2])
def test_weight_grad_pass_f32_matches_twin_and_jax(tiles_per_chunk):
    """The f32 weight-gradient pass in plain PyTorch (the twin's X_l and
    R_l in, the rows in the tiles' order, 3xTF32 on both operands as the
    tensor core reads the images, a rounded add every 32-row stage, split-K
    chunks of tiles_per_chunk tiles summed in order) against the f32 twin
    and against JAX's f32 stacked body (pallas_geometry, jitted), per
    tensor within check_vjp's bound of each (1e-4 + 1e-5 max|ref|): what
    K1-bwd must meet against the f64 twin on the card."""
    key, n = "3 x 64, skip", 100      # 4 tiles, the last ragged
    cfg, ws, bs = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, n)
    ops = {}
    _, tw_w, tw_b = GK.geometry_bwd_plain(
        ws, bs, torch.from_numpy(x), torch.from_numpy(ct_out),
        torch.from_numpy(ct_g), cfg, operands=ops)
    dws, dbs = GK.weight_grad_pass_plain(ops, tiles_per_chunk, f32=True)
    jw, jb = _jax_f32_bwd(key, n)
    worst = 0.0
    for l in range(len(ws)):
        for got, twin, jax_ref, name in ((dws[l], tw_w[l], jw[l].T, f"dW{l}"),
                                         (dbs[l], tw_b[l], jb[l], f"db{l}")):
            for ref in (twin.numpy(), jax_ref):
                tol = VJP_ATOL + VJP_RTOL * float(np.abs(ref).max())
                err = float(np.abs(got.numpy() - ref).max())
                worst = max(worst, err / tol)
                assert err <= tol, (name, err, tol)
    print(f"f32 weight-gradient pass, {tiles_per_chunk} tiles a chunk: "
          f"worst ratio to check_vjp's bound {worst:.3f}")


def _design_ratios(mm, n=64):
    """Per-tensor ratios to check_vjp's bound of the design's arithmetic
    at full width against the float64 twin: the sweep's products by
    ``mm``, then the f32 pass (weight_grad_pass_plain(f32=True))."""
    cfg, ws, bs = _net("full width")
    x, ct_out, ct_g = (torch.from_numpy(v) for v in _inputs(cfg, ws, n, 1))
    ref = GK.geometry_bwd_plain([w.double() for w in ws],
                                [b.double() for b in bs], x.double(),
                                ct_out.double(), ct_g.double(), cfg)
    ref = [ref[0], *ref[1], *ref[2]]
    ops = {}
    ct_x, _, dbs = GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                         operands=ops, mm=mm)
    dws, _ = GK.weight_grad_pass_plain(ops, 2, f32=True)
    got = [ct_x, *dws, *dbs]
    return [float((g.double() - r).abs().max())
            / (VJP_ATOL + VJP_RTOL * float(r.abs().max()))
            for g, r in zip(got, ref)]


def test_design_accumulation_within_check_vjp_bound():
    """K1-bwd's arithmetic emulated at full width on 64 points (two
    tiles), against the float64 twin: with a rounded add every slab of 32
    k (GK.WGF_SWEEP_STAGE, sweep_mm_f32) every tensor lies within 0.5 of
    check_vjp's bound; one accumulator over each 256-deep product (96
    truncating adds toward zero) exceeds it.  This fixes the sweep's stage
    length; the pass's (32 rows, GK.WGF_PASS_STAGE) is the one emulated."""
    assert GK.WGF_SWEEP_STAGE == GK.WGF_PASS_STAGE == 32
    chosen = _design_ratios(GK.sweep_mm_f32)
    one_acc = _design_ratios(
        lambda a, b: TP.mm_3xtf32(a, b, None, "trunc", "round"))
    print(f"worst ratio to check_vjp's bound: a rounded add every 32 k "
          f"{max(chosen):.3f}; one accumulator a layer {max(one_acc):.3f}")
    assert max(chosen) <= 0.5
    assert max(one_acc) > 1.0


def test_kernel_weights_name_their_packs():
    """fields.KernelWeights is a NamedTuple whose fields name the packs
    (read by sweep_pack, bwd_slabs), every one a slab pack (it carries no
    mma.sync pack); on the CPU no pack is built, and the f32 mode's
    backward differentiates through the twin."""
    cfg, _, _ = _net("2 x 64, no skip")
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    w = net.kernel_weights()
    assert isinstance(w, TF.KernelWeights)
    assert w._fields == ("ws", "bs", "sweep16", "rev16", "sweep32", "rev32")
    assert w[2:] == (None,) * 4
    ws, bs, *_ = w
    assert ws is w.ws and bs is w.bs
    assert TF.bwd_slabs(w, False) is None and TF.bwd_slabs(w, True) is None
    fake = w._replace(sweep32=("f",), rev32=("r",), sweep16=("s",))
    assert TF.bwd_slabs(fake, False) == (("f",), ("r",))
    assert TF.sweep_pack(fake, True) == ("s",)
    x = torch.from_numpy(_inputs(cfg, [torch.zeros(65, 1)], 40)[0])
    s, f, g = net.value_grad_feat(x, w)
    (s.sum() + f.pow(2).sum() + g.pow(2).sum()).backward()
    assert all(l.weight_v.grad is not None for l in net.layers())
