"""K1-fwd-stash and K1-fwd-stash-bf16 on wgmma (csrc/geometry_fwd_wg.cu,
csrc/geometry_fwd_bf16_wg.cu: K1-fwd's and K1-fwd-bf16's sweeps, which
also store each hidden layer's pre-activation rounded to bf16), on the CPU:
their launch plans (geometry_kernel.fwd_wg_plan and fwd_wg16_plan with
``stash``) over every tile and their refusals; the design's stash (the
pre-activations of K1-fwd's 3xTF32 arithmetic, geometry_explicit(mm=
sweep_mm_f32), or of the bf16 mode's, rounded to bf16) against the stash
array of the JAX package's run_fwd_stash (pallas_geometry._make_geom(
stash=True), interpret mode, jitted) at chip_smoke.py's rule, and fed to
the stash backward's twin against the JAX stash backward at
tests/test_torch_stash.py's tolerance; which packs
fields.SDFNetwork.kernel_weights builds under the stash switch; and that
no kernel source is left on ``mma.sync``.  The kernels are held against
their twins and K1-fwd's bits on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fwd_wg_bf16 import _tiles_covered
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import _cuda
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import tc_pack as TP

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "2 x 64, no skip": (2, 64, 65, (), 4, 1.0),
}
# chip_smoke.py's rule for a stash entry: equal to the twin's, one bf16
# ulp apart, or within 1e-5 abs
STASH_ULPS, STASH_ATOL = 1, 1e-5
# tests/test_torch_stash.py: the stash pair against JAX's, per tensor
BWD_ATOL, BWD_RTOL = 2e-5, 1e-4
N_POINTS = 100
SMS = 132


@functools.lru_cache(maxsize=None)
def _net(key):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, [w.detach() for w in ws], [b.detach() for b in bs]


def _inputs(cfg, ws, n, seed=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3) * 0.4).astype(np.float32)
    ct_out = rng.randn(n, int(ws[-1].shape[0])).astype(np.float32)
    ct_g = rng.randn(n, 3).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, ct_out, ct_g)]


def _bf16_ulps(a, b):
    """|a - b| of two bf16 tensors in units of the larger one's last place
    (chip_smoke.bf16_ulps)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


# -- the plans ----------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [65536, 9001, 300, 1])
def test_stash_plans_cover_every_tile(n, bf16):
    """K1-fwd-stash's plan is K1-fwd's (K1-fwd-stash-bf16's K1-fwd-bf16's)
    with the stash's columns appended to the integer arguments, 2,009 at
    full width: every tile of 64 points that holds a point taken once."""
    cfg, ws, _ = _net("full width")
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=bf16)
    plan_fn = GK.fwd_wg16_plan if bf16 else GK.fwd_wg_plan
    p = plan_fn(cfg, ws, n, slabs, SMS, stash=True)
    base = plan_fn(cfg, ws, n, slabs, SMS)
    assert GK.stash_columns(ws) == p["stash_columns"] == 2009
    assert p["iargs"] == base["iargs"] + [2009]
    assert base["stash_columns"] == 0
    for key in ("grid", "tiles", "sweep_smem", "scratch_floats"):
        assert p[key] == base[key], key
    tiles = -(-n // 64)
    assert p["tiles"] == tiles
    if bf16:
        assert set(range(tiles)) <= _tiles_covered(p)
    else:
        walked = sorted(t for b in range(p["grid"])
                        for t in range(b, tiles, p["grid"]))
        assert walked == list(range(tiles))
    assert p["sweep_smem"] <= TP.SMEM_MAX


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stash_launches_refuse_before_any_cuda_call(bf16):
    """K1-fwd-stash (bf16: K1-fwd-stash-bf16) reads make_bwd_slabs' two
    packs of its mode and builds none: without them or on the other
    mode's packs the launch raises before any CUDA call (here on CPU
    tensors), and the plan refuses the other mode's packs."""
    cfg, ws, bs = _net("3 x 64, skip")
    x = torch.zeros(10, 3)
    mine = GK.make_bwd_slabs(cfg, ws, bf16=bf16)
    other = GK.make_bwd_slabs(cfg, ws, bf16=not bf16)
    with pytest.raises(ValueError, match="make_bwd_slabs"):
        GK.launch_forward_stash(cfg, x, ws, bs, None, bf16)
    with pytest.raises(ValueError, match="slabs: it takes no other"):
        GK.launch_forward_stash(cfg, x, ws, bs, other, bf16)
    with pytest.raises(ValueError, match="wgmma"):
        (GK.fwd_wg16_plan if bf16 else GK.fwd_wg_plan)(
            cfg, ws, 10, other, SMS, stash=True)
    with pytest.raises(ValueError, match="expects CUDA tensors"):
        GK.launch_forward_stash(cfg, x, ws, bs, mine, bf16)
    assert GK.KERNELS["fwd_stash", bf16].launches == 0


# -- the design's stash against JAX ------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_stash(key, bf16):
    """JAX's stash pair (pallas_geometry._make_geom(stash=True):
    run_fwd_stash, then run_bwd_stash, interpret mode), jitted, on the
    effective weights of _net(key) at _inputs' points and cotangents: (its
    stash in the port's layout, [n, stash_columns] bf16: the residual of
    its VJP, [rows, L x MAXW], layer l's pre-activations in columns l MAXW
    on; dx, dW [in, out] and db per layer)."""
    cfg, ws, bs = _net(key)
    jcfg = JF.SDFConfig(**{f: getattr(cfg, f) for f in (
        "d_out", "d_hidden", "n_layers", "skip_in", "multires", "scale")})
    x, ct_out, ct_g = _inputs(cfg, ws, N_POINTS)
    geom = PG._make_geom(jcfg, bf16, 64, stash=True)

    @jax.jit     # one compiled body, not op-by-op interpretation
    def run(ws, bs, x, ct_out, ct_g):
        _, vjp = jax.vjp(geom, ws, bs, x)
        st = [r for r in jax.tree_util.tree_leaves(vjp)
              if r.dtype == jnp.bfloat16]
        return vjp((ct_out, ct_g)), st
    (dws, dbs, dx), (st,) = run(
        tuple(jnp.asarray(w.t().numpy()) for w in ws),
        tuple(jnp.asarray(b.numpy()) for b in bs), jnp.asarray(x.numpy()),
        jnp.asarray(ct_out.numpy()), jnp.asarray(ct_g.numpy()))
    maxw = PG._specialize(jcfg, bf16)["MAXW"]
    st = torch.from_numpy(np.array(st.astype(jnp.float32)))
    stash = torch.cat([st[:N_POINTS, l * maxw:l * maxw + int(w.shape[0])]
                       for l, w in enumerate(ws[:-1])], 1).to(torch.bfloat16)
    return (stash, np.asarray(dx), [np.asarray(w) for w in dws],
            [np.asarray(b) for b in dbs])


def _design_stash(key, bf16):
    """The kernel's stash, emulated: each hidden pre-activation of the
    kernel's arithmetic (K1-fwd's 3xTF32 products, sweep_mm_f32; the bf16
    mode's bf16 products with an f32 sum) plus its bias, rounded once to
    bf16, in the stash layout."""
    cfg, ws, bs = _net(key)
    x, _, _ = _inputs(cfg, ws, N_POINTS)
    pre = []
    GK.geometry_explicit(ws, bs, x, cfg, mm=None if bf16 else GK.sweep_mm_f32,
                         preacts=pre)
    return torch.cat(pre, 1).to(torch.bfloat16)


@pytest.mark.parametrize("key", ["3 x 64, skip", "2 x 64, no skip"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_design_stash_matches_jax(key, bf16):
    """The design's stash against JAX's run_fwd_stash array, entry by
    entry: equal, one bf16 ulp apart (the two f32 sums of a
    pre-activation round to neighbours), or within 1e-5 abs, in each
    mode, with and without a skip."""
    cfg, ws, _ = _net(key)
    ours = _design_stash(key, bf16)
    theirs = _jax_stash(key, bf16)[0]
    assert ours.shape == theirs.shape == (N_POINTS, GK.stash_columns(ws))
    ulps = _bf16_ulps(ours, theirs)
    far = (ulps > STASH_ULPS) & ((ours.float() - theirs.float()).abs()
                                 > STASH_ATOL)
    print(f"{key}, bf16 {bf16}: {int((ulps == 0).sum())} stash entries "
          f"equal, {int((ulps == 1).sum())} one ulp apart, "
          f"{int((ulps > 1).sum())} further, {int(far.sum())} outside the "
          f"rule")
    assert not far.any()
    assert (ulps == 0).float().mean() > 0.99


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_design_stash_feeds_the_stash_backward(bf16):
    """The design's stash fed to the stash backward's twin
    (geometry_bwd_stash_plain, in the mode) against JAX's stash backward on
    its own stash: ct_x, every dW and db within tests/test_torch_stash.py's
    2e-5 + 1e-4 max|ref| per tensor."""
    key = "3 x 64, skip"
    cfg, ws, _ = _net(key)
    x, ct_out, ct_g = _inputs(cfg, ws, N_POINTS)
    _, jx, jw, jb = _jax_stash(key, bf16)
    ct_x, dws, dbs = GK.geometry_bwd_stash_plain(
        ws, x, _design_stash(key, bf16), ct_out, ct_g, cfg, bf16)
    worst = 0.0
    for got, ref, name in ([(ct_x, jx, "ct_x")]
                           + [(dws[l], jw[l].T, f"dW{l}")
                              for l in range(len(ws))]
                           + [(dbs[l], jb[l], f"db{l}")
                              for l in range(len(ws))]):
        err = float(np.abs(got.numpy() - ref).max())
        tol = BWD_ATOL + BWD_RTOL * float(np.abs(ref).max())
        worst = max(worst, err / tol)
        assert err <= tol, (name, err, tol)
    print(f"stash backward on the design's stash, bf16 {bf16}: worst ratio "
          f"{worst:.3f}")


# -- the packs and the sources ------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """kernel_weights as on a card (the packs built on the CPU)."""
    monkeypatch.setattr(TF, "_on_card", lambda t: True)


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_weights_under_the_stash_switch(card, monkeypatch, bf16,
                                               grad):
    """Under the stash switch, with grad (a step) or without (a validation
    image), the SDF network's kernel weights carry make_bwd_slabs' two
    packs of the mode, which K1-fwd-stash and K1-bwd-stash (or their bf16
    variants) read, and no other pack: KernelWeights has no field for an
    mma.sync pack."""
    monkeypatch.setattr(GK, "STASH_BWD", True)
    cfg, _, _ = _net("3 x 64, skip")
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.set_grad_enabled(grad):
        kw = net.kernel_weights(bf16=bf16, f32=not bf16)
    built = {f for f in kw._fields[2:] if getattr(kw, f) is not None}
    assert built == ({"sweep16", "rev16"} if bf16 else {"sweep32", "rev32"})
    assert "pack" not in kw._fields and "pack16" not in kw._fields
    ws = [w.detach() for w in kw.ws]
    slabs = TF.bwd_slabs(kw, bf16)
    want = GK.make_bwd_slabs(cfg, ws, bf16=bf16)
    assert all(torch.equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(slabs, want))
    p = (GK.fwd_wg16_plan if bf16 else GK.fwd_wg_plan)(
        cfg, ws, 100, slabs, SMS, stash=True)
    assert p["stash_columns"] == GK.stash_columns(ws)


def test_no_mma_sync_pack_builder_is_left():
    """The row-major mma.sync packs and their readers are gone: tc_pack
    builds only slab packs, and fields has no pick of such a pack."""
    for name in ("pack_weights", "pack_weights_bf16", "make_pack",
                 "pack_for", "smem_bytes", "check_layout", "layout_iargs",
                 "bf16_pair_rows"):
        assert not hasattr(TP, name), name
    assert not hasattr(GK, "kernel_iargs") and not hasattr(TF, "mode_pack")
    assert GK.KERNELS["fwd_stash", False].source == "geometry_fwd_wg.cu"
    assert GK.KERNELS["fwd_stash", True].source == "geometry_fwd_bf16_wg.cu"


def test_sources_are_all_on_wgmma():
    """_cuda.SOURCES names only files of csrc/, every kernel's source among
    them; no file in csrc/ holds an mma.sync instruction."""
    files = set(os.listdir(_cuda.CSRC))
    assert set(_cuda.SOURCES) <= files
    assert {f for f in files if f.endswith(".cu")} == set(_cuda.SOURCES)
    assert {k.source for k in GK.KERNELS.values()} <= set(_cuda.SOURCES)
    for f in sorted(files):
        with open(os.path.join(_cuda.CSRC, f)) as fh:
            assert "mma.sync.aligned" not in fh.read(), f
    assert "tc_mma.cuh" not in files and "geometry_fwd.cu" not in files


def test_smoke_counts_slab_builds_and_finds_no_mma_sync_pack(monkeypatch):
    """chip_smoke.count_pack_calls: it raises where an mma.sync pack
    builder or field is left, and otherwise counts K1's reverse slab packs
    (tc_pack.pack_rev_f32, pack_rev_bf16) once however often it runs."""
    import chip_smoke
    monkeypatch.setattr(TP, "pack_rev_f32", TP.pack_rev_f32)
    monkeypatch.setattr(TP, "pack_rev_bf16", TP.pack_rev_bf16)
    monkeypatch.setattr(chip_smoke, "PACK_CALLS", [0])
    monkeypatch.setattr(chip_smoke, "PACK16_CALLS", [0])
    assert chip_smoke.mma_sync_packs_left() == []
    chip_smoke.count_pack_calls()
    chip_smoke.count_pack_calls()
    cfg, ws, _ = _net("3 x 64, skip")
    GK.make_bwd_slabs(cfg, ws, bf16=False)
    GK.make_bwd_slabs(cfg, ws, bf16=True)
    assert (chip_smoke.PACK_CALLS, chip_smoke.PACK16_CALLS) == ([1], [1])
    monkeypatch.setattr(TP, "pack_weights", lambda ws: None, raising=False)
    with pytest.raises(AssertionError, match="mma.sync pack is left"):
        chip_smoke.count_pack_calls()


def test_smoke_refuses_an_hmma_in_any_library(monkeypatch):
    """chip_smoke.no_hmma_anywhere reads every library of _cuda.SOURCES
    (here a stand-in for cuobjdump's SASS counts) and raises on one HMMA
    in any function."""
    import chip_smoke
    counts = {src: {"_Z6kernelv": {"HMMA": 0}} for src in _cuda.SOURCES}
    monkeypatch.setattr(chip_smoke, "sass_by_function",
                        lambda lib, ops: counts[next(
                            s for s in counts if s[:-3] in lib)])
    assert set(chip_smoke.no_hmma_anywhere()) == set(_cuda.SOURCES)
    counts["geometry_fwd_wg.cu"]["_Z4stubv"] = {"HMMA": 1}
    with pytest.raises(AssertionError, match="geometry_fwd_wg.cu"):
        chip_smoke.no_hmma_anywhere()
