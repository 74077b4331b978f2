"""K1-bwd-split and K1-bwd-stash on wgmma in 3xTF32
(csrc/geometry_bwd_chains_wg.cu), on the CPU: their launch plans
(geometry_kernel.chains_wg_plan) over every tile, the launches refusing to
run without K1-bwd's f32 slab packs, which packs
fields.SDFNetwork.kernel_weights builds under each switch, and the
designs' arithmetic emulated in plain PyTorch (geometry_kernel.sweep_mm_f32
through the twin's sweep, each chain's rows one product, then K1-bwd's f32
pass, weight_grad_pass_plain(f32=True)): within chip_smoke.check_vjp's
bound of the float64 twins, each product of the split's sweep K1-bwd's
stacked product bit for bit, and the stash's result against the JAX package's
stash backward (pallas_geometry._make_geom(stash=True), interpret mode,
jitted) at tests/test_torch_stash.py's tolerance.  The kernels themselves
are held against the twins on a card by tests/test_torch_cuda.py and
chip_smoke.py.
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
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "4 x 96, skip": (4, 96, 97, (2,), 4, 1.0),
}
# chip_smoke.check_vjp: per tensor, |kernel - f64 twin| <= 1e-4 + 1e-5
# max|f64 twin|
VJP_ATOL, VJP_RTOL = 1e-4, 1e-5
# tests/test_torch_stash.py: the stash pair against JAX's, per tensor
STASH_ATOL, STASH_RTOL = 2e-5, 1e-4
SMS = 132


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
    return [torch.from_numpy(v) for v in (x, ct_out, ct_g)]


@pytest.mark.parametrize("stash", [False, True], ids=["split", "stash"])
@pytest.mark.parametrize("n", [1, 64, 9001, 65536])
def test_chains_plan_covers_every_tile(n, stash):
    """The sweep: tiles of 64 points, one persistent block a tile up to
    one a SM, every tile taken once (block b takes b, b + grid, ...), two
    of K1-bwd's 32-point image tiles each; the weight-gradient pass and
    the reduce K1-bwd's own (the same units, chunks and slots over the
    image tiles that hold a point, so its dW sums run in K1-bwd's order);
    the stash's columns in the integer arguments; shared memory within a
    block's 227 KB."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    p = GK.chains_wg_plan(cfg, ws, n, slabs, SMS, stash)
    k1 = GK.bwd_wg_plan(cfg, ws, n, slabs, SMS)
    tiles = -(-n // 64)
    assert p["tiles"] == tiles and p["grid"] == min(tiles, SMS)
    taken = sorted(t for b in range(p["grid"])
                   for t in range(b, tiles, p["grid"]))
    assert taken == list(range(tiles))
    assert p["image_tiles"] == 2 * tiles >= k1["tiles"] == -(-n // 32)
    assert p["image_bytes"] == 2 * tiles * k1["image_bytes"] // k1["tiles"]
    for key in ("units", "chunks", "per", "slot_floats", "wgrad_smem"):
        assert p[key] == k1[key], key
    L = len(ws)
    assert p["db_floats"] == p["grid"] * 4 * L * GK.WG_DB_ROW
    assert p["scratch_floats"] == p["grid"] * ((L - 1) * 32 + 16) * 256 * 4
    ia = p["iargs"]
    assert len(ia) == 9 + 6 * L
    assert ia[:8] == [L, cfg.multires, cfg.d_embed, n, p["grid"], tiles,
                      k1["chunks"], k1["per"]]
    assert ia[8] == (GK.stash_columns(ws) if stash else 0)
    assert ia[9:] == k1["iargs"][8:]
    assert p["sweep_smem"] == 222240 <= TP.SMEM_MAX
    assert p["wgrad_smem"] <= TP.SMEM_MAX


@pytest.mark.parametrize("variant", ["split", "stash"])
def test_launches_raise_without_slabs(variant):
    """K1-bwd-split and K1-bwd-stash read make_bwd_slabs(bf16=False)'s two
    packs and build none: without them, or on the bf16 slab packs or a
    row-major 3xTF32 layout, the launch raises before any CUDA call, and
    so does the plan; the kernel weights carry no mma.sync pack."""
    cfg, ws, bs = _net("3 x 64, skip")
    x, ct_out, ct_g = _inputs(cfg, ws, 10)
    stash = torch.zeros(10, GK.stash_columns(ws), dtype=torch.bfloat16)

    def launch(pack):
        if variant == "split":
            return GK.launch_backward_split(cfg, x, ws, bs, ct_out, ct_g,
                                            slabs=pack)
        return GK.launch_backward_stash(cfg, x, ws, stash, ct_out, ct_g,
                                        slabs=pack)
    others = (GK.make_bwd_slabs(cfg, ws), (ROW_MAJOR,) * 2)
    for pack, match in zip((None, *others),
                           ("make_bwd_slabs", "wgmma-f32", "wgmma-f32")):
        with pytest.raises(ValueError, match=match):
            launch(pack)
    for pack in others:
        with pytest.raises(ValueError, match="wgmma"):
            GK.chains_wg_plan(cfg, ws, 10, pack, SMS, variant == "stash")
    assert "pack" not in TF.KernelWeights._fields


def _design(key, n, stash=None, per=2, seed=1):
    """The design's arithmetic: (ct_x, dW per layer from the f32 pass, db,
    the pass's operands), the sweep's products by sweep_mm_f32, each
    chain's rows one product."""
    cfg, ws, bs = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, n, seed)
    ops = {}
    ct_x, _, dbs = GK.geometry_bwd_plain(
        ws, None if stash is not None else bs, x, ct_out, ct_g, cfg,
        stash=stash, operands=ops, mm=GK.sweep_mm_f32)
    dws, _ = GK.weight_grad_pass_plain(ops, per, f32=True)
    return ct_x, dws, dbs, ops


def _ratios(got, ref):
    return [float((g.double() - r).abs().max())
            / (VJP_ATOL + VJP_RTOL * float(r.abs().max()))
            for g, r in zip(got, ref)]


@pytest.mark.parametrize("key", ["3 x 64, skip", "4 x 96, skip"])
@pytest.mark.parametrize("variant", ["split", "stash"])
def test_design_within_check_vjp_bound(key, variant):
    """Each design's arithmetic at narrow width on 100 points (two tiles
    of 64, the second ragged), against its float64 twin (K1-bwd-split:
    K1-bwd's; K1-bwd-stash: the stash twin on the same bf16 stash): every
    tensor within check_vjp's bound, what the kernels must meet on the
    card."""
    cfg, ws, bs = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, 100, 1)
    stash = None
    if variant == "stash":
        stash = GK.geometry_fwd_stash_plain(ws, bs, x, cfg)[2]
        ref = GK.geometry_bwd_stash_plain([w.double() for w in ws],
                                          x.double(), stash, ct_out.double(),
                                          ct_g.double(), cfg)
    else:
        ref = GK.geometry_bwd_plain([w.double() for w in ws],
                                    [b.double() for b in bs], x.double(),
                                    ct_out.double(), ct_g.double(), cfg)
    ct_x, dws, dbs, _ = _design(key, 100, stash)
    r = _ratios([ct_x, *dws, *dbs], [ref[0], *ref[1], *ref[2]])
    print(f"{variant} design, {key}: worst ratio to check_vjp's bound "
          f"{max(r):.3f}")
    assert max(r) <= 0.5


def _stacked(a, b, w):
    """a @ w and b @ w by sweep_mm_f32 as K1-bwd runs them: both chains'
    rows one product, in its tiles' order (geometry_kernel._tile_rows)."""
    n, T = a.shape[0], -(-a.shape[0] // GK.WG_POINTS)
    y = GK.sweep_mm_f32(GK._tile_rows(a, b), w).view(T, 4, 2, 8, -1)
    return (y[:, :, 0].reshape(T * GK.WG_POINTS, -1)[:n],
            y[:, :, 1].reshape(T * GK.WG_POINTS, -1)[:n])


@pytest.mark.parametrize("key", ["3 x 64, skip", "full width"])
def test_split_design_is_k1_bwd_bit_for_bit(key):
    """Each row's chain of slab products and rounded adds does not depend
    on which rows share its product: on the split design's own operands
    (each layer's inputs of both chains, their reverse sums r and rd),
    every product of the sweep, each chain's rows one product, equals
    K1-bwd's stacked product row for row, bit for bit; the rest of the
    sweep is row-wise, so the split's ct_x and images are K1-bwd's and
    its pass gives K1-bwd's dW (chip_smoke.py prints the kernels' bits)."""
    cfg, ws, _ = _net(key)
    n = 100 if key != "full width" else 40
    ops = _design(key, n)[3]
    for l, (xl, xdl, r, rd) in ops.items():
        w = ws[l]
        for (a, b), m in (((xl, xdl), w.t()), ((r, rd), w)):
            got = (GK.sweep_mm_f32(a, m), GK.sweep_mm_f32(b, m))
            for u, v in zip(got, _stacked(a, b, m)):
                assert torch.equal(u, v), l


@functools.lru_cache(maxsize=None)
def _jax_stash_bwd(key, n):
    """JAX's f32 stash backward (pallas_geometry._make_geom(stash=True):
    run_fwd_stash's bf16 stash, then run_bwd_stash, interpret mode),
    jitted, on the effective weights of _net(key): (dx, dW [in, out] and db
    per layer, and its stash in the port's layout, [n, stash_columns]
    bf16: the residual of its VJP, [rows, L x MAXW], layer l's
    pre-activations in columns l MAXW on)."""
    cfg, ws, bs = _net(key)
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    x, ct_out, ct_g = _inputs(cfg, ws, n, 1)
    geom = PG._make_geom(jcfg, False, 64, stash=True)

    @jax.jit     # one compiled body, not op-by-op interpretation
    def bwd(ws, bs, x, ct_out, ct_g):
        _, vjp = jax.vjp(geom, ws, bs, x)
        st = [r for r in jax.tree_util.tree_leaves(vjp)
              if r.dtype == jnp.bfloat16]
        return vjp((ct_out, ct_g)), st
    (dws, dbs, dx), (st,) = bwd(
        tuple(jnp.asarray(w.t().numpy()) for w in ws),
        tuple(jnp.asarray(b.numpy()) for b in bs), jnp.asarray(x.numpy()),
        jnp.asarray(ct_out.numpy()), jnp.asarray(ct_g.numpy()))
    maxw = PG._specialize(jcfg, False)["MAXW"]
    st = torch.from_numpy(np.array(st.astype(jnp.float32)))
    stash = torch.cat([st[:n, l * maxw:l * maxw + int(w.shape[0])]
                       for l, w in enumerate(ws[:-1])], 1).to(torch.bfloat16)
    return (np.asarray(dx), [np.asarray(w) for w in dws],
            [np.asarray(b) for b in dbs], stash)


def test_stash_design_matches_jax():
    """K1-bwd-stash's arithmetic (the tangent forward alone, the primal's
    softplus and sigma(100 a) from the bf16 stash, 3xTF32 products, K1-bwd's
    f32 pass) on JAX's own stash against JAX's stash backward in interpret
    mode, per tensor within tests/test_torch_stash.py's 2e-5 + 1e-4
    max|ref|; the port's stash differs from JAX's only by rare one-ulp bf16
    flips where the two packages' f32 pre-activations round apart."""
    key, n = "3 x 64, skip", 100
    cfg, ws, bs = _net(key)
    x, _, _ = _inputs(cfg, ws, n, 1)
    jx, jw, jb, stash = _jax_stash_bwd(key, n)
    ours = GK.geometry_fwd_stash_plain(ws, bs, x, cfg)[2]
    assert ours.shape == stash.shape
    assert (ours != stash).float().mean() < 1e-3
    ct_x, dws, dbs, _ = _design(key, n, stash)
    worst = 0.0
    for got, ref, name in ([(ct_x, jx, "ct_x")]
                           + [(dws[l], jw[l].T, f"dW{l}")
                              for l in range(len(ws))]
                           + [(dbs[l], jb[l], f"db{l}")
                              for l in range(len(ws))]):
        err = float(np.abs(got.numpy() - ref).max())
        tol = STASH_ATOL + STASH_RTOL * float(np.abs(ref).max())
        worst = max(worst, err / tol)
        assert err <= tol, (name, err, tol)
    print(f"stash design against JAX: worst ratio {worst:.3f}")


@pytest.fixture
def card(monkeypatch):
    """kernel_weights as on a card, every pack replaced by a marker of its
    kind."""
    monkeypatch.setattr(TF, "_on_card", lambda t: True)
    monkeypatch.setattr(GK, "make_bwd_slabs", lambda cfg, ws, bf16=True: (
        ("sweep32",), ("rev32",)))
    monkeypatch.setattr(SK, "make_sweep_pack",
                        lambda cfg, ws, bf16=True: ("sweep32",))


def _built(kw):
    return {f for f in kw._fields[2:] if getattr(kw, f) is not None}


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("switch", ["split", "stash"])
def test_kernel_weights_build_the_chains_packs(card, monkeypatch, switch,
                                               grad):
    """The f32 mode's SDF kernel weights under each switch, with grad or
    without: K1-fwd's two slab packs, which K1-bwd-split reads too (the
    split switch) and K1-fwd-stash and K1-bwd-stash read (the stash
    switch), and no other pack (KernelWeights has no field for an
    mma.sync pack)."""
    monkeypatch.setattr(GK, "STASH_BWD" if switch == "stash"
                        else "STACKED_BWD", switch == "stash")
    net = SDFNetwork(SDFConfig(n_layers=2, d_hidden=64, d_out=65,
                               skip_in=(), multires=4))
    with torch.set_grad_enabled(grad):
        kw = net.kernel_weights()
    assert _built(kw) == {"sweep32", "rev32"}
    assert "pack" not in kw._fields
    assert TF.bwd_slabs(kw, False) == (("sweep32",), ("rev32",))


SASS = """
	Function : _Z28geometry_bwd_split_wgf_sweep6FcDims
        /*0000*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24 ;
        /*0010*/                   MOV R1, c[0x0][0x28] ;
	Function : _Z29geometry_bwd_chains_wgf_wgrad7FwgDims
        /*0000*/                   HGMMA.64x8x8.F32.TF32 R4, gdesc[UR8], R4 ;
	Function : _Z28geometry_bwd_stash_wgf_sweep6FcDims
        /*0000*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24 ;
        /*0010*/              @P0  %(stash)s R8, R12, R16, R8 ;
	Function : _Z30geometry_bwd_chains_wgf_reducePKfPfiii
        /*0000*/                   %(reduce)s R2, R2, R3, R2 ;
"""
MMA = "HMMA.1688.F32.TF32"
CHAINS = ("geometry_bwd_split", "geometry_bwd_stash",
          "geometry_bwd_chains_wgf_wgrad")


@pytest.mark.parametrize("mma_in", [None, "stash", "reduce"])
def test_build_report_counts_each_kernel(monkeypatch, mma_in):
    """chip_smoke.wgmma_build_report(kernels=...): each kernel's SASS
    functions (cuobjdump's "Function :" sections whose names hold it)
    counted apart, each held to HGMMA; an HMMA fails the source, in a
    counted kernel (the stash's sweep) even where the others run on
    wgmma, or in a function no kernel names (the reduce).  Without
    ``kernels`` the source's functions are counted under its label."""
    import chip_smoke
    from factored_neus_tpu_torch.ops import _cuda

    class Done:
        stdout = SASS % {"stash": MMA if mma_in == "stash" else "FADD",
                         "reduce": MMA if mma_in == "reduce" else "FFMA"}
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setitem(_cuda.BUILD_LOG, "geometry_bwd_chains_wg.cu",
                        "ptxas info    : Used 168 registers\n")
    label = "K1-bwd-split and K1-bwd-stash"
    if mma_in is None:
        rep = chip_smoke.wgmma_build_report(label,
                                            "geometry_bwd_chains_wg.cu",
                                            CHAINS)
        assert rep["sass"] == {k: {"HGMMA": 1, "HMMA": 0} for k in CHAINS}
        assert rep["ptxas"] == ["ptxas info    : Used 168 registers"]
        rep = chip_smoke.wgmma_build_report(label,
                                            "geometry_bwd_chains_wg.cu")
        assert rep["sass"] == {label: {"HGMMA": 3, "HMMA": 0}}
    else:
        with pytest.raises(AssertionError, match=f"geometry_bwd_.*{mma_in}"):
            chip_smoke.wgmma_build_report(label, "geometry_bwd_chains_wg.cu",
                                          CHAINS)
