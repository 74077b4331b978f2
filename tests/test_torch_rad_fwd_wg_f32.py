"""K3-fwd on wgmma in 3xTF32 (csrc/radiance_fwd_wg.cu), on the CPU: its
pack (radiance_kernel.make_fwd_pack) is K3-bwd's forward slab pack bit for
bit, its launch plan (radiance_kernel.fwd_wg_plan) at every path's shapes
and its refusals, the design's accumulation (radiance_plain(mm=
radiance_kernel.sweep_mm_f32), layer 0 in the kernel's k order) at full
width against the float64 twin at chip_smoke's 1e-5 abs, and the same
arithmetic and the twin at a small width against the JAX package's
rendering_apply_pallas(bf16=False) in interpret mode.  The kernel itself
is held against the twin on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_radiance import _setup
from test_torch_rad_wg_f32 import _inputs, _net
from util_packs import ROW_MAJOR
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.ops import pallas_radiance as PR
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP

RGB_ATOL = 1e-5       # chip_smoke.py: K3-fwd against its f32 and f64 twins
# a stage-1 step, a ragged count, a validation chunk, stage 2's first-hit
# colour
PATH_ROWS = (65536, 9001, 262144, 2048, 1)


def _design_mm(cfg, ws):
    """The products of K3-fwd's sweep: layer 0's in the kernel's k order
    (the feature's columns from k = 0, the narrow ones from k = 256)."""
    nar, ins0 = 6 + cfg.d_view, int(ws[0].shape[1])
    return lambda a, b: RK.sweep_mm_f32(a, b, nar if a.shape[1] == ins0
                                        else 0)


@pytest.mark.parametrize("key", ["full width", "2 x 96, no encoding"])
def test_k3_fwd_pack_is_k3_bwd_forward_pack(key):
    """K3-fwd reads the radiance MLP's forward f32 slab pack (sweep32),
    the first of K3-bwd's two, bit for bit and in the same layout: the
    forward of a step and the one K3-bwd recomputes sum the same slabs in
    the same order."""
    cfg, ws, _ = _net(key)
    pack, lay = RK.make_fwd_pack(cfg, ws)
    (bpack, blay), _ = RK.make_bwd_slabs(cfg, ws, bf16=False)
    assert lay == blay and torch.equal(pack, bpack)
    assert lay.operand == "wgmma-f32-rad"


@pytest.mark.parametrize("n", PATH_ROWS)
def test_k3_fwd_plan_covers_every_tile(n):
    """K3-fwd's launch plan at each path's rows: tiles of 64 rows, one
    persistent block a tile up to one a SM, whose strided walk covers every
    tile once and every row; its arguments end with the pack's layer
    offsets; shared memory within a block's 227 KB."""
    cfg, ws, _ = _net("full width")
    lay = RK.make_fwd_pack(cfg, ws)[1]
    p = RK.fwd_wg_plan(cfg, ws, n, lay, 132)
    tiles = -(-n // 64)
    assert p["tiles"] == tiles and p["grid"] == min(tiles, 132)
    walked = sorted(t for b in range(p["grid"])
                    for t in range(b, tiles, p["grid"]))
    assert walked == list(range(tiles)) and 64 * tiles >= n
    assert p["iargs"][3:7] == [n, p["grid"], tiles, 1]
    assert p["iargs"][-len(ws):] == lay.off
    assert p["sweep_smem"] == RK.WGF_FWD_SMEM <= TP.SMEM_MAX


def test_k3_fwd_refuses_other_packs_and_none():
    """K3-fwd takes its f32 slab pack only: K3-bwd-bf16's slab pack, the
    reverse f32 pack, a row-major layout and the pack of another network
    are refused; a launch, and K3-fwd-bf16's, given no pack raises before
    it reads the tensors (on a CUDA tensor it never builds one)."""
    cfg, ws, bs = _net("full width")
    bad = [RK.make_bwd_slabs(cfg, ws)[0][1],
           RK.make_bwd_slabs(cfg, ws, bf16=False)[1][1],
           ROW_MAJOR[1]]
    for lay in bad:
        with pytest.raises(ValueError, match="wgmma"):
            RK.fwd_wg_plan(cfg, ws, 64, lay, 132)
    ocfg, ows, _ = _net("2 x 96, no encoding")
    with pytest.raises(ValueError):
        RK.fwd_wg_plan(cfg, ws, 64, RK.make_fwd_pack(ocfg, ows)[1], 132)
    inputs, _ = _inputs(cfg, 4)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="pack"):
            RK.launch_forward(cfg, ws, bs, *inputs, pack=None, bf16=bf16)


def test_k3_fwd_design_accumulation_within_tolerance():
    """K3-fwd's arithmetic emulated at full width on 128 rows (two tiles):
    every product in 3xTF32 with a rounded add every 32-k slab, layer 0 in
    the kernel's k order; rgb within chip_smoke's 1e-5 abs of the float64
    twin."""
    cfg, ws, bs = _net("full width")
    inputs, _ = _inputs(cfg, 128, seed=1)
    got = RK.radiance_plain(ws, bs, cfg, *inputs, mm=_design_mm(cfg, ws))
    with torch.no_grad():
        ref = RK.radiance_plain([w.double() for w in ws],
                                [b.double() for b in bs], cfg,
                                *(v.double() for v in inputs))
    err = float((got.double() - ref).abs().max())
    print(f"K3-fwd design: max|err| {err:.3e} against the f64 twin "
          f"({RGB_ATOL:g} allowed)")
    assert err <= RGB_ATOL


@functools.lru_cache(maxsize=None)
def _jax_rgb(n):
    jcfg, params, _, inputs = _setup(n)
    return np.asarray(PR.rendering_apply_pallas(
        params, jcfg, *map(jnp.asarray, inputs), bf16=False, block_rows=64))


def test_k3_fwd_twin_and_design_match_jax_pallas():
    """At a small width (3 x 64, d_feature 64), the plain twin and K3-fwd's
    design arithmetic against the JAX package's rendering_apply_pallas
    (bf16=False, interpret mode) within 1e-5 abs, the tolerance of
    tests/test_torch_radiance.py."""
    _, _, net, inputs = _setup(150)
    ws, bs = net.effective_weights()
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    x = list(map(torch.from_numpy, inputs))
    want = _jax_rgb(150)
    with torch.no_grad():
        twin = RK.radiance_plain(ws, bs, net.cfg, *x)
    design = RK.radiance_plain(ws, bs, net.cfg, *x,
                               mm=_design_mm(net.cfg, ws))
    for got in (twin, design):
        np.testing.assert_allclose(got.numpy(), want, atol=RGB_ATOL)
