"""K1-fwd on wgmma in 3xTF32 (csrc/geometry_fwd_wg.cu), on the CPU: the
last layer's forward slabs it appends to the f32 sweep pack
(tc_pack.pack_sweep_f32) read back, K1-bwd's part of that pack unchanged,
its launch plan (geometry_kernel.fwd_wg_plan) and its refusals, its twin
(geometry_plain, geometry_explicit) against the JAX package's f32 forward
body (pallas_geometry._make_geom(..., bf16=False), jitted), the design's
accumulation (geometry_explicit(mm=sweep_mm_f32)) at full width against
the float64 twin at chip_smoke's 1e-5 abs, and that the callers that run
K1-fwd without grad (validation, stages 2 and 3) build its slabs.  The
kernel itself is held against the twin on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import port_config, tiny_config
from util_packs import ROW_MAJOR
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch.meshing import extract as MEXT
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "2 x 64, no skip": (2, 64, 65, (), 4, 1.0),
}
FWD_ATOL = 1e-5      # chip_smoke.py: out and grad against the f32 twin


@functools.lru_cache(maxsize=None)
def _net(key):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, [w.detach() for w in ws], [b.detach() for b in bs]


def _points(n, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * 0.4).astype(np.float32)


@pytest.mark.parametrize("key", list(NETS))
def test_f32_sweep_pack_last_layer_and_k1_bwd_part(key):
    """The f32 sweep pack ends with K1-fwd's eight slabs of the last layer
    (264 columns for a last layer over 256, else 256), which read back as
    W_last^T at tf32_slot(k), big = tf32_round, big + small == W exactly;
    every byte before them (K1-bwd's layers, at the offsets of a pack
    without them) does not depend on the last layer's weights."""
    cfg, ws, _ = _net(key)
    skip = sorted(GK.skip_layers(cfg, len(ws)))
    pack, lay = TP.pack_sweep_f32(ws, skip, cfg.d_embed)
    L = len(ws)
    wide = ws[-1].shape[0] > 256
    assert lay.nslab[-1] == 8 and lay.cols[-1] == (264 if wide else 256)
    # K1-bwd's layers: layer 0 two 64 KB slabs, every other eight
    assert lay.off[:L] == [0] + [65536 * (2 + 8 * (l - 1))
                                 for l in range(1, L)]
    assert lay.nbytes == lay.off[-1] + 8 * 2 * lay.cols[-1] * 128
    big, small = TP.f32_block(pack, lay, L - 1)
    want = torch.zeros_like(big)
    m = ws[-1].t()
    want[TP.tf32_slot(np.arange(m.shape[0])), :m.shape[1]] = m
    assert torch.equal(big + small, want)
    assert torch.equal(big, TP.tf32_round(want))
    zeroed, _ = TP.pack_sweep_f32(ws[:-1] + [torch.zeros_like(ws[-1])], skip,
                                  cfg.d_embed)
    k1_bwd = lay.off[-1] // 4
    assert torch.equal(pack[:k1_bwd], zeroed[:k1_bwd])
    assert not zeroed[k1_bwd:].any()


@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_fwd_wg_plan_covers_every_tile(n):
    """K1-fwd's launch plan at the step's 65,536 points and smaller: tiles
    of 64 points, one block a tile up to one a SM, a scratch of sigma(100
    a) for each block's eight hidden layers, shared memory within a
    block's 227 KB; its integer arguments name both packs' layouts and the
    last layer's slab width; the bf16 mode's packs and a row-major 3xTF32
    layout are refused."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    (_, flay), (_, rlay) = slabs
    sms = 132
    p = GK.fwd_wg_plan(cfg, ws, n, slabs, sms)
    tiles = -(-n // 64)
    assert p["tiles"] == tiles and p["grid"] == min(tiles, sms)
    assert p["scratch_floats"] == p["grid"] * 8 * 16 * 256 * 4
    assert p["sweep_smem"] <= TP.SMEM_MAX
    L = len(ws)
    assert len(p["iargs"]) == 6 + 6 * L + 1
    assert p["iargs"][6 + 2 * L:6 + 3 * L] == flay.enc
    assert p["iargs"][6 + 3 * L:6 + 5 * L] == [*flay.off, *rlay.off]
    assert p["iargs"][-L - 1:] == [48] + [256] * (L - 1) + [264]
    for bad in (GK.make_bwd_slabs(cfg, ws), (ROW_MAJOR,) * 2):
        with pytest.raises(ValueError, match="wgmma"):
            GK.fwd_wg_plan(cfg, ws, n, bad, sms)
        with pytest.raises(ValueError, match="wgmma-f32"):
            GK.launch_forward(cfg, torch.zeros(n, 3), ws, [], bad)
    with pytest.raises(ValueError, match="make_bwd_slabs"):
        GK.launch_forward(cfg, torch.zeros(n, 3), ws, [])
    other = _net("3 x 64, skip")
    with pytest.raises(ValueError, match="layouts"):
        GK.fwd_wg_plan(cfg, ws, n, GK.make_bwd_slabs(other[0], other[1],
                                                     bf16=False), sms)


@functools.lru_cache(maxsize=None)
def _jax_f32_fwd(key, n):
    """JAX's f32 forward body (run_fwd through _make_geom, jitted) on the
    effective weights of _net(key): (out, grad)."""
    cfg, ws, bs = _net(key)
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    geom = PG._make_geom(jcfg, False, 64)
    out, grad = jax.jit(geom)(tuple(jnp.asarray(w.t().numpy()) for w in ws),
                              tuple(jnp.asarray(b.numpy()) for b in bs),
                              jnp.asarray(_points(n)))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("key", ["3 x 64, skip", "2 x 64, no skip"])
def test_k1_fwd_twins_match_jax_f32(key):
    """The f32 twins (geometry_plain, autograd; geometry_explicit with f32
    products, the kernel's reverse sweep written out) against JAX's f32
    forward body (pallas_geometry, jitted) within 1e-5 abs on 100 points:
    (out, grad)."""
    cfg, ws, bs = _net(key)
    x = torch.from_numpy(_points(100))
    jout, jgrad = _jax_f32_fwd(key, 100)
    with torch.no_grad():
        plain = GK.geometry_plain(ws, bs, x, cfg)
    explicit = GK.geometry_explicit(ws, bs, x, cfg, mm=torch.matmul)
    for out, grad in (plain, explicit):
        assert np.abs(out.numpy() - jout).max() <= FWD_ATOL
        assert np.abs(grad.numpy() - jgrad).max() <= FWD_ATOL


def test_k1_fwd_design_accumulation_within_tolerance():
    """K1-fwd's arithmetic emulated at full width on 128 points (two
    tiles): every product in 3xTF32 with a rounded add every 32-k slab
    (GK.sweep_mm_f32), the first reverse step W_last's row 0 / scale read
    exactly; (out, grad) within 0.5 of chip_smoke's 1e-5 abs of the
    float64 twin."""
    cfg, ws, bs = _net("full width")
    x = torch.from_numpy(_points(128, seed=1))
    got = GK.geometry_explicit(ws, bs, x, cfg, mm=GK.sweep_mm_f32)
    with torch.no_grad():
        ref = GK.geometry_plain([w.double() for w in ws],
                                [b.double() for b in bs], x.double(), cfg)
    errs = [float((g.double() - r).abs().max()) for g, r in zip(got, ref)]
    print(f"K1-fwd design: max|err| out {errs[0]:.3e}, grad {errs[1]:.3e} "
          f"against the f64 twin (0.5 x {FWD_ATOL:g} allowed)")
    assert max(errs) <= 0.5 * FWD_ATOL


@pytest.fixture
def on_card(monkeypatch):
    """kernel_weights as on a card, the packs replaced by markers; returns
    the list of networks whose f32 slabs were built."""
    built = []
    monkeypatch.setattr(TF, "_on_card", lambda t: True)
    monkeypatch.setattr(TP, "pack_rev_bf16", lambda ws, d: ("rev16",))
    monkeypatch.setattr(SK, "make_sweep_pack", lambda cfg, ws, bf16=True: (
        "sweep16",) if bf16 else ("sweep32",))

    def slabs(name):
        def make(cfg, ws, bf16=True):
            built.append((name, bf16))
            return ("sweep",), ("rev",)
        return make
    monkeypatch.setattr(GK, "make_bwd_slabs", slabs("sdf"))
    monkeypatch.setattr(RK, "make_bwd_slabs", slabs("color"))
    return built


def test_no_grad_kernel_weights_ask_for_f32_slabs(on_card, monkeypatch):
    """Where K1-fwd runs without grad, the f32 mode's kernel weights carry
    its two slab packs: a validation image's (Stage1Model.kernel_weights
    under no_grad) and a stage-2 or stage-3 run's (Stage2Model's, built
    once); the radiance MLP's K3-bwd slabs only where a backward can
    follow.  The sweeps alone (value_sweep, the grid fill) build none of
    them, only K2's forward slab pack (sweep32); the stash switch builds
    both with grad or without, which K1-fwd-stash reads (and K1-bwd-stash
    after it); the bf16 mode builds none."""
    cfg = port_config(tiny_config())
    stage1 = TR.Stage1Model(cfg)
    with torch.no_grad():
        sdf_w, color_w = stage1.kernel_weights()
    assert TF.bwd_slabs(sdf_w, False) == (("sweep",), ("rev",))
    assert TF.bwd_slabs(color_w, False) is None
    assert on_card == [("sdf", False)]
    sdf_w, color_w = stage1.kernel_weights()
    assert TF.bwd_slabs(color_w, False) == (("sweep",), ("rev",))
    assert on_card[1:] == [("sdf", False), ("color", False)]
    del on_card[:]
    sdf_w, _ = TR.Stage2Model(cfg).kernel_weights()
    assert TF.bwd_slabs(sdf_w, False) == (("sweep",), ("rev",))
    assert on_card == [("sdf", False)]
    del on_card[:]
    net = stage1.sdf
    kw = net.kernel_weights(k1=False)
    assert (kw.sweep32, kw.rev32) == (("sweep32",), None)
    MEXT.sdf_grid_query(net)
    with torch.no_grad():
        assert net.kernel_weights(bf16=True, f32=False).sweep32 is None
    monkeypatch.setattr(GK, "STASH_BWD", True)
    with torch.no_grad():
        kw = net.kernel_weights()
    assert (kw.sweep32, kw.rev32) == (("sweep",), ("rev",))
    assert on_card == [("sdf", False)]
    kw = net.kernel_weights()
    assert (kw.sweep32, kw.rev32) == (("sweep",), ("rev",))
    assert on_card == [("sdf", False)] * 2
    assert "pack" not in kw._fields
