"""K1-bwd-bf16 on wgmma (csrc/geometry_bwd_bf16_wg.cu), on the CPU: its
reverse slab pack (tc_pack.pack_rev_bf16), its launch plan
(geometry_kernel.bwd_wg_plan), and its weight-gradient pass in plain
PyTorch (geometry_kernel.weight_grad_pass_plain: split-K chunks of bf16
X_l^T R_l summed in the kernel's order) against the twin
geometry_bwd_plain(bf16=True) and against the JAX package's bf16 body
(pallas_geometry._make_geom, interpret mode).  The kernel itself is held
against the twin on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_packs import ROW_MAJOR

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import tc_pack as TP

# the twins' bf16 tolerance (tests/test_torch_bf16.py TWIN_RTOL): both
# round the same operands and sum them in f32 in other orders; relative to
# the largest entry of each tensor
TWIN_RTOL = 1e-3

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "2 x 64, no skip": (2, 64, 65, (), 4, 1.0),
}


def _net(key):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, list(ws), list(bs)


@pytest.mark.parametrize("key", list(NETS))
def test_rev_pack_reads_back_rounded_w(key):
    """Read back through the swizzle's inverse (tc_pack.sweep_block), each
    layer's reverse slabs hold bf16(W) with k its output and n its input
    (a skip layer's [h | enc] in W's own order), at the fixed depth of
    four slabs (five for the 257-wide last layer), 48 columns for layer 0
    and 256 for the others, zero elsewhere; every weight lands once."""
    cfg, ws, _ = _net(key)
    pack, lay = TP.pack_rev_bf16(ws, cfg.d_embed)
    assert pack.dtype == torch.float32 and 4 * pack.numel() == lay.nbytes
    assert lay.operand == "wgmma-bf16-rev" and not any(lay.enc)
    total = 0.0
    for l, w in enumerate(ws):
        blk = TP.sweep_block(pack, lay, l)
        assert lay.nslab[l] == (5 if w.shape[0] > 256 else 4)
        assert blk.shape == (64 * lay.nslab[l], 48 if l == 0 else 256)
        want = torch.zeros_like(blk)
        want[:w.shape[0], :w.shape[1]] = TP.bf16_round(w)
        assert torch.equal(blk, want), l
        total += float(want.double().pow(2).sum())
    flat = pack.view(torch.bfloat16).double()
    assert float(flat.pow(2).sum()) == pytest.approx(total, rel=1e-12)


def test_rev_layout_refuses_what_the_kernel_cannot_run():
    """Hidden layers over 256 wide, a last layer over 264, an encoding
    over 48, a single layer: refused before any launch."""
    for ins, outs, d in (([39, 288], [288, 1], 39), ([39, 256], [256, 265],
                                                      39),
                         ([51, 256], [256, 1], 51), ([39], [257], 39)):
        with pytest.raises(ValueError, match="K1-bwd-bf16"):
            TP.rev_layout(ins, outs, d)


@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_bwd_wg_plan_covers_every_tile(n):
    """The launch plan at the step's 65,536 points and smaller: two
    consumer warpgroups a block only when the tiles outnumber the SMs, one
    block a pass up to one a SM, the weight-gradient pass over units x
    chunks <= SMs blocks whose chunks hold every tile once and none
    empty, the images of every consumer tile, shared memory within a
    block's 227 KB; a pack of another kind is refused."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws)
    sms = 132
    p = GK.bwd_wg_plan(cfg, ws, n, slabs, sms)
    tiles = -(-n // GK.WG_POINTS)
    assert p["tiles"] == tiles
    assert p["nc"] == (2 if tiles > sms else 1)
    assert p["n_pass"] * p["nc"] >= tiles > (p["n_pass"] - 1) * p["nc"]
    assert p["grid"] == min(p["n_pass"], sms)
    assert p["units"] == 1 + 8 * 2
    assert p["units"] * p["chunks"] <= sms or p["chunks"] == 1
    assert p["chunks"] * p["per"] >= tiles > (p["chunks"] - 1) * p["per"]
    per_tile = GK.WG_BLOCK * (1 + 8 * 4 + 8 * 4 + 5)
    assert p["image_bytes"] == p["n_pass"] * p["nc"] * per_tile
    assert max(p["sweep_smem"], p["wgrad_smem"]) <= TP.SMEM_MAX
    assert len(p["iargs"]) == 9 + 8 * len(ws)
    with pytest.raises(ValueError, match="wgmma"):
        GK.bwd_wg_plan(cfg, ws, n, (ROW_MAJOR,) * 2, sms)


@functools.lru_cache(maxsize=None)
def _jax_bwd(key, n):
    """JAX's stacked backward body (bf16 and f32), jitted, on the
    effective weights of _net(key): (cfg, ws [out, in], bs, x, ct_out,
    ct_grad, {bf16: (dW [in, out], db)})."""
    cfg, ws, bs = _net(key)
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    rng = np.random.RandomState(7)
    x = (rng.randn(n, 3) * 0.4).astype(np.float32)
    ct_out = rng.randn(n, int(ws[-1].shape[0])).astype(np.float32)
    ct_g = rng.randn(n, 3).astype(np.float32)
    ws_j = tuple(jnp.asarray(w.t().numpy()) for w in ws)
    bs_j = tuple(jnp.asarray(b.numpy()) for b in bs)
    res = {}
    for bf16 in (True, False):
        geom = PG._make_geom(jcfg, bf16, 64)

        @jax.jit     # one compiled body, not op-by-op interpretation
        def bwd(ws, bs, x, ct_out, ct_g):
            return jax.vjp(geom, ws, bs, x)[1]((ct_out, ct_g))
        dws, dbs, _ = bwd(ws_j, bs_j, jnp.asarray(x), jnp.asarray(ct_out),
                          jnp.asarray(ct_g))
        res[bf16] = ([np.asarray(w) for w in dws],
                     [np.asarray(b) for b in dbs])
    return cfg, ws, bs, x, ct_out, ct_g, res


@pytest.mark.parametrize("tiles_per_chunk", [1, 2])
def test_weight_grad_pass_matches_twin_and_jax_bf16(tiles_per_chunk):
    """The weight-gradient pass in plain PyTorch (bf16 X_l and R_l of the
    twin's sweep in, split-K chunks of tiles_per_chunk tiles summed in
    order; db the f32 sum of the primal R_l) against the twin
    geometry_bwd_plain(bf16=True) within TWIN_RTOL of each tensor's
    largest entry, and against JAX's bf16 stacked dot_at
    (pallas_geometry, interpret mode): within TWIN_RTOL and closer to it
    than JAX's f32 body is, wherever the two JAX bodies differ."""
    cfg, ws, bs, x, ct_out, ct_g, res = _jax_bwd("3 x 64, skip", 64)
    ops = {}
    _, tw_w, tw_b = GK.geometry_bwd_plain(
        ws, bs, torch.from_numpy(x), torch.from_numpy(ct_out),
        torch.from_numpy(ct_g), cfg, bf16=True, operands=ops)
    dws, dbs = GK.weight_grad_pass_plain(ops, tiles_per_chunk)
    (j16w, j16b), (j32w, j32b) = res[True], res[False]
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
            if d_f32 > 0:   # the last layer's db is ct_out's sum in both
                assert d_port < d_f32, (name, d_port, d_f32)
                ratios.append(d_port / d_f32)
    print(f"weight-gradient pass, {tiles_per_chunk} tiles a chunk: port to "
          f"JAX-bf16 / JAX-f32 to JAX-bf16, worst {max(ratios):.3e} over {len(ratios)} tensors")
