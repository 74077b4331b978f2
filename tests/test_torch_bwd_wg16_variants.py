"""K1-bwd-split-bf16 and K1-bwd-stash-bf16 on bf16 wgmma
(csrc/geometry_bwd_chains_bf16_wg.cu), on the CPU: their launch plan
(geometry_kernel.chains_wg16_plan) over every tile, the launches refusing
to run without K1-bwd-bf16's slab packs, which packs
fields.SDFNetwork.kernel_weights builds under each switch in the bf16
mode, and the designs' arithmetic in plain PyTorch (the twin's sweep on
bf16 operands, each chain's rows one product, then K1-bwd-bf16's pass over
the images, weight_grad_pass_plain): within chip_smoke.check_flips' gate
of the float64 twins, each product of the split's forward K1-bwd-bf16's
stacked product bit for bit (a k16-step emulation of the bf16 wgmma's
f32 sum), and the stash design against the JAX package's bf16 stash
backward (pallas_geometry._make_geom(bf16=True, stash=True), interpret
mode, jitted) by tests/test_torch_bf16.py's rule.  The kernels themselves
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

import chip_smoke
from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "4 x 96, skip": (4, 96, 97, (2,), 4, 1.0),
}
# tests/test_torch_bf16.py: the port's bf16 results within TWIN_RTOL of
# the largest JAX-bf16 entry, and closer to it than JAX-f32 is
TWIN_RTOL = 1e-3
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
def test_chains16_plan_covers_every_tile(n, stash):
    """The sweep: tiles of 64 points (a consumer warpgroup a chain), one
    persistent block a tile up to one a SM, every tile taken once (block b
    takes b, b + grid, ...), two of K1-bwd-bf16's 32-point image tiles
    each; the weight-gradient pass and the reduce K1-bwd-bf16's own (the
    same units, chunks and slots over the image tiles that hold a point,
    so its dW sums run in K1-bwd-bf16's order); the layers' arguments
    K1-bwd-bf16's, the stash's columns beside them; a ring of six 32 KB
    stages (more than a 257-wide layer's five slabs) beside the encoding
    tile within a block's 227 KB."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws)
    p = GK.chains_wg16_plan(cfg, ws, n, slabs, SMS, stash)
    k1 = GK.bwd_wg_plan(cfg, ws, n, slabs, SMS)
    tiles = -(-n // 64)
    assert p["tiles"] == tiles and p["grid"] == min(tiles, SMS)
    taken = sorted(t for b in range(p["grid"])
                   for t in range(b, tiles, p["grid"]))
    assert taken == list(range(tiles))
    assert p["image_tiles"] == 2 * tiles >= k1["tiles"] == -(-n // 32)
    per_tile = GK.WG_BLOCK * (1 + 8 * 4 + 8 * 4 + 5)
    assert p["image_bytes"] == 2 * tiles * per_tile
    for key in ("units", "chunks", "per", "slot_floats", "wgrad_smem"):
        assert p[key] == k1[key], key
    L = len(ws)
    assert p["db_floats"] == p["grid"] * 2 * 4 * L * GK.WG_DB_ROW
    assert p["scratch_floats"] == p["grid"] * 2 * (L - 1) * 32 * 128 * 4
    ia = p["iargs"]
    assert len(ia) == 9 + 8 * L
    assert ia[:9] == [L, cfg.multires, cfg.d_embed, n, p["grid"], tiles,
                      k1["chunks"], k1["per"],
                      GK.stash_columns(ws) if stash else 0]
    assert ia[9:] == k1["iargs"][9:]
    fixed = 1024 + 64 * 2 * 48 * 4 + L * GK.WG_DB_ROW * 4
    assert p["sweep_smem"] == fixed + 6 * (32768 + 16) <= TP.SMEM_MAX
    assert p["sweep_smem"] + 32768 + 16 > TP.SMEM_MAX


@pytest.mark.parametrize("variant", ["split", "stash"])
def test_launches_raise_without_bf16_slabs(variant):
    """K1-bwd-split-bf16 and K1-bwd-stash-bf16 read make_bwd_slabs(bf16=
    True)'s two packs and build none: without them, or on the f32 slab
    packs or a row-major bf16 layout, the launch raises before any CUDA
    call, and so does the plan; the kernel weights carry no mma.sync
    pack."""
    cfg, ws, bs = _net("3 x 64, skip")
    x, ct_out, ct_g = _inputs(cfg, ws, 10)
    stash = torch.zeros(10, GK.stash_columns(ws), dtype=torch.bfloat16)

    def launch(pack):
        if variant == "split":
            return GK.launch_backward_split(cfg, x, ws, bs, ct_out, ct_g,
                                            pack, bf16=True)
        return GK.launch_backward_stash(cfg, x, ws, stash, ct_out, ct_g,
                                        pack, bf16=True)
    others = (GK.make_bwd_slabs(cfg, ws, bf16=False), (ROW_MAJOR,) * 2)
    for pack, match in zip((None, *others),
                           ("make_bwd_slabs", "wgmma-bf16", "wgmma-bf16")):
        with pytest.raises(ValueError, match=match):
            launch(pack)
    for pack in others:
        with pytest.raises(ValueError, match="wgmma"):
            GK.chains_wg16_plan(cfg, ws, 10, pack, SMS, variant == "stash")
    assert "pack16" not in TF.KernelWeights._fields


@pytest.fixture
def card(monkeypatch):
    """kernel_weights as on a card (the packs built on the CPU)."""
    monkeypatch.setattr(TF, "_on_card", lambda t: True)


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("switch", ["split", "stash"])
def test_kernel_weights_build_what_the_chains16_read(card, monkeypatch,
                                                     switch, grad):
    """The bf16 mode's SDF kernel weights under each switch, with grad or
    without: K1-fwd-bf16's two slab packs, which K1-bwd-split-bf16's plan
    takes as they are (the split switch), and K1-fwd-stash-bf16's and
    K1-bwd-stash-bf16's plans take (the stash switch); no other pack
    (KernelWeights has no field for a bf16 mma.sync pack)."""
    monkeypatch.setattr(GK, "STASH_BWD" if switch == "stash"
                        else "STACKED_BWD", switch == "stash")
    cfg = SDFConfig(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,),
                    multires=4)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.set_grad_enabled(grad):
        kw = net.kernel_weights(bf16=True, f32=False)
    built = {f for f in kw._fields[2:] if getattr(kw, f) is not None}
    stash = switch == "stash"
    assert built == {"sweep16", "rev16"}
    assert "pack16" not in kw._fields
    ws = [w.detach() for w in kw.ws]
    p = GK.chains_wg16_plan(cfg, ws, 100, TF.bwd_slabs(kw, True), SMS,
                            stash)
    assert p["tiles"] == 2
    if stash:
        assert GK.fwd_wg16_plan(cfg, ws, 100, TF.bwd_slabs(kw, True), SMS,
                                stash)["stash_columns"] == \
            GK.stash_columns(ws)


def _design(key, n, stash=None, per=2, seed=1):
    """The design's arithmetic: (ct_x, dW per layer from K1-bwd-bf16's
    pass over the images, db, the pass's operands), the sweep's products
    on bf16 operands, each chain's rows one product."""
    cfg, ws, bs = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, n, seed)
    ops = {}
    ct_x, _, dbs = GK.geometry_bwd_plain(
        ws, None if stash is not None else bs, x, ct_out, ct_g, cfg,
        bf16=True, stash=stash, operands=ops)
    dws, _ = GK.weight_grad_pass_plain(ops, per)
    return ct_x, dws, dbs, ops


@pytest.mark.parametrize("key", ["3 x 64, skip", "4 x 96, skip"])
@pytest.mark.parametrize("variant", ["split", "stash"])
def test_design_within_check_flips_gate(key, variant):
    """Each design's arithmetic at narrow width on 100 points (two tiles
    of 64, the second ragged) against its bf16 twin (K1-bwd-split-bf16:
    K1-bwd-bf16's; K1-bwd-stash-bf16: the stash twin on the same bf16
    stash) and the float64 unrounded function: within chip_smoke.py's
    check_flips gate, what the kernels must meet on the card."""
    cfg, ws, bs = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, 100, 1)
    flat = lambda r: [r[0], *r[1], *r[2]]
    w64 = [w.double() for w in ws]
    if variant == "stash":
        stash = GK.geometry_fwd_stash_plain(ws, bs, x, cfg, bf16=True)[2]
        twin = flat(GK.geometry_bwd_stash_plain(ws, x, stash, ct_out, ct_g,
                                                cfg, bf16=True))
        ref = flat(GK.geometry_bwd_stash_plain(w64, x.double(), stash,
                                               ct_out.double(),
                                               ct_g.double(), cfg))
    else:
        stash = None
        twin = flat(GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                          bf16=True))
        ref = flat(GK.geometry_bwd_plain(w64, [b.double() for b in bs],
                                         x.double(), ct_out.double(),
                                         ct_g.double(), cfg))
    ct_x, dws, dbs, _ = _design(key, 100, stash)
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    chip_smoke.check_flips(f"{variant} design, {key}", [ct_x, *dws, *dbs],
                           twin, [t.float() for t in ref], names)


def _wg16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16 operands as a row of an m64 bf16 wgmma sums it: k-step
    after k-step of 16, each k-step's 16 exact products summed (float64
    holds them) and added to the f32 accumulator; every row on its own."""
    a, b = TP.bf16_round(a).double(), TP.bf16_round(b).double()
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        acc = acc + (a[:, k:k + 16] @ b[k:k + 16]).float()
    return acc


def _stacked(a, b, w):
    """a @ w and b @ w by _wg16_mm as K1-bwd-bf16 runs them: both chains'
    rows one product, in its tiles' order (geometry_kernel._tile_rows)."""
    n, T = a.shape[0], -(-a.shape[0] // GK.WG_POINTS)
    y = _wg16_mm(GK._tile_rows(a, b), w).view(T, 4, 2, 8, -1)
    return (y[:, :, 0].reshape(T * GK.WG_POINTS, -1)[:n],
            y[:, :, 1].reshape(T * GK.WG_POINTS, -1)[:n])


@pytest.mark.parametrize("key", ["3 x 64, skip", "full width"])
def test_split_design_is_k1_bwd_bf16_bit_for_bit(key):
    """A row of a bf16 wgmma product depends on that row's operands and
    the k order alone: on the split design's own operands (each layer's
    input of both chains), every product of the split's forward, each
    chain's rows one product, equals K1-bwd-bf16's stacked product row for
    row, bit for bit; the forward's epilogues are K1-bwd-bf16's
    expressions row by row and its reverse is K1-bwd-bf16's own code, so
    the split's ct_x, images and dW are K1-bwd-bf16's (chip_smoke.py
    prints the kernels' bits)."""
    cfg, ws, _ = _net(key)
    n = 100 if key != "full width" else 40
    ops = _design(key, n)[3]
    for l, (xl, xdl, _, _) in ops.items():
        m = ws[l].t()
        got = (_wg16_mm(xl, m), _wg16_mm(xdl, m))
        for u, v in zip(got, _stacked(xl, xdl, m)):
            assert torch.equal(u, v), l


@functools.lru_cache(maxsize=None)
def _jax_stash_bwd(key, n):
    """JAX's stash backward (pallas_geometry._make_geom(stash=True):
    run_fwd_stash's bf16 stash, then run_bwd_stash, interpret mode),
    jitted, on the effective weights of _net(key), in the bf16 operand
    mode and in f32: {bf16: (dx, dW [in, out] and db per layer)} and the
    bf16 mode's stash in the port's layout, [n, stash_columns] bf16 (the
    residual of its VJP, [rows, L x MAXW], layer l's pre-activations in
    columns l MAXW on)."""
    cfg, ws, bs = _net(key)
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    x, ct_out, ct_g = _inputs(cfg, ws, n, 1)
    res, stash = {}, None
    for bf16 in (True, False):
        geom = PG._make_geom(jcfg, bf16, 64, stash=True)

        @jax.jit     # one compiled body, not op-by-op interpretation
        def bwd(ws, bs, x, ct_out, ct_g):
            _, vjp = jax.vjp(geom, ws, bs, x)
            st = [r for r in jax.tree_util.tree_leaves(vjp)
                  if r.dtype == jnp.bfloat16]
            return vjp((ct_out, ct_g)), st
        (dws, dbs, dx), (st,) = bwd(
            tuple(jnp.asarray(w.t().numpy()) for w in ws),
            tuple(jnp.asarray(b.numpy()) for b in bs),
            jnp.asarray(x.numpy()), jnp.asarray(ct_out.numpy()),
            jnp.asarray(ct_g.numpy()))
        res[bf16] = (np.asarray(dx), [np.asarray(w) for w in dws],
                     [np.asarray(b) for b in dbs])
        if bf16:
            maxw = PG._specialize(jcfg, True)["MAXW"]
            st = torch.from_numpy(np.array(st.astype(jnp.float32)))
            stash = torch.cat([st[:n, l * maxw:l * maxw + int(w.shape[0])]
                               for l, w in enumerate(ws[:-1])],
                              1).to(torch.bfloat16)
    return res, stash


def test_stash_design_matches_jax_bf16():
    """K1-bwd-stash-bf16's arithmetic (the tangent forward alone, the
    primal's softplus and sigma(100 a) from the bf16 stash, bf16 products
    with f32 sums, K1-bwd-bf16's pass) on JAX's own bf16 stash against
    JAX's bf16 stash backward in interpret mode: per tensor within
    TWIN_RTOL of its largest JAX-bf16 entry, and closer to it than JAX's
    f32 stash backward is wherever the two JAX modes differ; the port's
    bf16 stash is JAX's but for rare one-ulp flips."""
    key, n = "3 x 64, skip", 100
    cfg, ws, bs = _net(key)
    x, _, _ = _inputs(cfg, ws, n, 1)
    res, stash = _jax_stash_bwd(key, n)
    ours = GK.geometry_fwd_stash_plain(ws, bs, x, cfg, bf16=True)[2]
    assert ours.shape == stash.shape
    assert (ours != stash).float().mean() < 1e-2
    ct_x, dws, dbs, _ = _design(key, n, stash)
    (jx, jw, jb), (fx, fw, fb) = res[True], res[False]
    L = len(ws)
    ratios = []
    for got, a, b, name in ([(ct_x, jx, fx, "ct_x")]
                            + [(dws[l], jw[l].T, fw[l].T, f"dW{l}")
                               for l in range(L)]
                            + [(dbs[l], jb[l], fb[l], f"db{l}")
                               for l in range(L)]):
        d_port = float(np.abs(got.numpy() - a).max())
        d_f32 = float(np.abs(b - a).max())
        assert d_port <= TWIN_RTOL * float(np.abs(a).max()), name
        if d_f32 > 0:   # the last layer's db is ct_out's sum in both
            assert d_port < d_f32, (name, d_port, d_f32)
            ratios.append(d_port / d_f32)
    print(f"stash design against JAX-bf16: port / JAX-f32 distance, worst "
          f"{max(ratios):.3e} over {len(ratios)} tensors")
