"""K2 on wgmma in 3xTF32 (csrc/sdf_fwd_wg.cu), on the CPU: its narrowed
read of the f32 sweep pack that K1-fwd and K1-bwd share (sweep32,
tc_pack.pack_sweep_f32), its launch plan (sdf_kernel.sweep_wg_plan) at
every path's shapes and its refusals, the design's accumulation
(sdf_forward_plain(mm=geometry_kernel.sweep_mm_f32)) at full width against
the float64 twin at chip_smoke's 1e-5 abs, the same arithmetic and the
twin at a small width against the JAX package's sdf_forward_pallas
(interpret mode, narrowed and full), and which packs kernel_weights builds
on each path: slab packs only, under either switch too.  The kernel
itself is held against the twin
on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import _setup
from test_torch_render import port_config, tiny_config
from util_packs import ROW_MAJOR
from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu.ops.pallas_sdf import sdf_forward_pallas
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
}
SWEEP_ATOL = 1e-5     # chip_smoke.py: K2 against its f32 and f64 twins
# the rows of each path's call: the ladder's first sweep and its three
# later ones, a ragged count, a validation chunk's first sweep, stages 2-3's
# localisation sweep, stage 2's coarse sweep with sweep_act_bf16 off, one
# 32-plane slab of the 512^3 grid fill
PATH_ROWS = (32768, 8192, 9001, 131072, 65536, 1048576, 512 * 512 * 32, 1)


@functools.lru_cache(maxsize=None)
def _net(key):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, [w.detach() for w in ws], [b.detach() for b in bs]


def _narrow(ws, bs):
    return list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]


def _points(n, seed=7):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(n, 3) * 0.4).astype(np.float32))


@pytest.mark.parametrize("key", list(NETS))
def test_k2_reads_the_sdf_row_from_sweep32(key):
    """K2's pack is K1's forward pack itself (make_sweep_pack(bf16=False)
    is make_bwd_slabs(bf16=False)'s first, bit for bit: no new bytes); for
    a narrowed last layer the kernel copies the first 1,024 bytes of each
    half of each of its eight slabs, which read back through the swizzle
    as that slab's first 8 columns of tc_pack.f32_block: column 0 the sdf
    row's big half (tf32_round) and small half (W - big) at tf32_slot(k),
    exactly, columns 1-7 the next rows of W_last."""
    cfg, ws, _ = _net(key)
    pack, lay = SK.make_sweep_pack(cfg, ws, bf16=False)
    (k1, k1_lay), _ = GK.make_bwd_slabs(cfg, ws, bf16=False)
    assert lay == k1_lay and torch.equal(pack, k1)
    L, cols = len(ws), lay.cols[-1]
    big, small = TP.f32_block(pack, lay, L - 1)
    sw = torch.from_numpy(TP.swizzle32(np.arange(8 * 32)))
    first = lay.off[-1] // 4
    for s in range(lay.nslab[-1]):
        for h, want in ((0, big), (1, small)):
            start = first + (2 * s + h) * cols * 32
            got = pack[start:start + 8 * 32][sw].view(8, 32).t()
            assert torch.equal(got, want[32 * s:32 * s + 32, :8])
    row = ws[-1][0]
    k = TP.tf32_slot(np.arange(row.shape[0]))
    assert torch.equal(big[k, 0], TP.tf32_round(row))
    assert torch.equal(small[k, 0], row - TP.tf32_round(row))
    assert not (big[:, 0].abs().sum() - big[k, 0].abs().sum())


@pytest.mark.parametrize("n", PATH_ROWS)
def test_k2_plan_covers_every_tile(n):
    """K2's launch plan at each path's rows: tiles of 64 rows, one
    persistent block a tile up to one a SM, the blocks' strided walk
    covering every tile once and every row; the last layer read from K1's
    264-wide slabs (narrowed) or the narrowed network's own 256-wide ones;
    shared memory within a block's 227 KB."""
    cfg, ws, _ = _net("full width")
    wn, _ = _narrow(ws, ws)
    sms = 132
    for w, lay in ((wn, SK.make_sweep_pack(cfg, ws, bf16=False)[1]),
                   (wn, SK.make_sweep_pack(cfg, wn, bf16=False)[1]),
                   (ws, SK.make_sweep_pack(cfg, ws, bf16=False)[1])):
        p = SK.sweep_wg_plan(cfg, w, n, lay, sms)
        tiles = -(-n // 64)
        assert p["tiles"] == tiles and p["grid"] == min(tiles, sms)
        walked = sorted(t for b in range(p["grid"])
                        for t in range(b, tiles, p["grid"]))
        assert walked == list(range(tiles)) and 64 * tiles >= n
        assert p["iargs"][3:7] == [n, p["grid"], tiles, lay.cols[-1]]
        assert p["sweep_smem"] <= TP.SMEM_MAX


def test_k2_refuses_other_packs_and_none():
    """K2 takes the f32 slab pack only: the bf16 slab pack, K1's f32
    reverse pack, a row-major layout and a pack of other widths are
    refused, and a launch given no pack raises before it reads the tensor
    (on a CUDA tensor it never builds one); so does K2-bf16's."""
    cfg, ws, bs = _net("full width")
    wn, bn = _narrow(ws, bs)
    ins, outs = [w.shape[1] for w in ws], [w.shape[0] for w in ws]
    for bad in (SK.make_sweep_pack(cfg, ws)[1],
                TP.rev_layout_f32(ins, outs, cfg.d_embed), ROW_MAJOR[1]):
        with pytest.raises(ValueError, match="wgmma"):
            SK.sweep_wg_plan(cfg, wn, 64, bad, 132)
    other = _net("3 x 64, skip")
    with pytest.raises(ValueError, match="layout"):
        SK.sweep_wg_plan(cfg, wn, 64, SK.make_sweep_pack(
            other[0], other[1], bf16=False)[1], 132)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="make_sweep_pack"):
            SK._launch(wn, bn, cfg, torch.zeros(64, 3), None, bf16)


@pytest.mark.parametrize("narrow", [True, False], ids=["narrowed", "full"])
def test_k2_design_accumulation_within_tolerance(narrow):
    """K2's arithmetic emulated at full width on 128 rows (two tiles):
    every product in 3xTF32 with a rounded add every 32-k slab
    (GK.sweep_mm_f32); [sdf / scale | feature] within chip_smoke's 1e-5
    abs of the float64 twin, narrowed (the ladder's and the grid fill's
    sdf) and with the full 257-wide output."""
    cfg, ws, bs = _net("full width")
    if narrow:
        ws, bs = _narrow(ws, bs)
    x = _points(128, seed=1)
    got = SK.sdf_forward_plain(ws, bs, cfg, x, mm=GK.sweep_mm_f32)
    with torch.no_grad():
        ref = SK.sdf_forward_plain([w.double() for w in ws],
                                   [b.double() for b in bs], cfg, x.double())
    err = float((got.double() - ref).abs().max())
    print(f"K2 design ({'narrowed' if narrow else 'full'}): max|err| "
          f"{err:.3e} against the f64 twin ({SWEEP_ATOL:g} allowed)")
    assert got.shape == ref.shape and err <= SWEEP_ATOL


@pytest.mark.parametrize("full", [False, True], ids=["narrowed", "full"])
def test_k2_twin_and_design_match_jax_pallas(full):
    """At a small width (3 x 64, skip at 2, scale 1.5), the plain twin and
    K2's design arithmetic against the JAX package's sdf_forward_pallas
    (interpret mode, f32; full_out False: the sdf column, True: [sdf /
    scale | feature]) within 1e-5 abs, the tolerance of
    tests/test_torch_kernels.py."""
    jcfg, params, net, x = _setup(1.5, (2,))
    ws, bs = net.effective_weights()
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    if not full:
        ws, bs = _narrow(ws, bs)
    xt = torch.from_numpy(x)
    want = np.asarray(sdf_forward_pallas(params, jcfg, jnp.asarray(x),
                                         full_out=full, block_rows=64))
    want = want.reshape(len(x), -1)
    with torch.no_grad():
        twin = SK.sdf_forward_plain(ws, bs, net.cfg, xt)
    design = SK.sdf_forward_plain(ws, bs, net.cfg, xt, mm=GK.sweep_mm_f32)
    for got in (twin, design):
        np.testing.assert_allclose(got.numpy(), want, atol=SWEEP_ATOL)


@pytest.fixture
def packs(monkeypatch):
    """kernel_weights as on a card, every pack replaced by a marker of its
    kind."""
    monkeypatch.setattr(TF, "_on_card", lambda t: True)
    monkeypatch.setattr(TP, "pack_rev_bf16", lambda ws, d: ("rev16",))
    monkeypatch.setattr(SK, "make_sweep_pack", lambda cfg, ws, bf16=True: (
        "sweep16",) if bf16 else ("sweep32",))
    monkeypatch.setattr(GK, "make_bwd_slabs", lambda cfg, ws, bf16=True: (
        ("sweep32",), ("rev32",)))
    monkeypatch.setattr(RK, "make_bwd_slabs", lambda cfg, ws, bf16=True: (
        ("rsweep",), ("rrev",)))
    monkeypatch.setattr(RK, "make_fwd_pack", lambda cfg, ws: ("rsweep",))


def _built(kw):
    return {f for f in kw._fields[2:] if getattr(kw, f) is not None}


@pytest.mark.parametrize("path", ["step", "validation", "stage 2-3",
                                  "grid fill", "value_sweep"])
def test_kernel_weights_build_no_3xtf32_pack_on_the_default_path(
        packs, path):
    """The f32 path's kernel weights, built as each caller builds them,
    carry no 3xTF32 mma.sync pack (KernelWeights has no field for one):
    K2 reads sweep32,
    which the SDF network's weights carry wherever K2 or K1-fwd runs, and
    K3-fwd the radiance MLP's sweep32, with or without grad."""
    model = TR.Stage1Model(port_config(tiny_config()))
    if path == "step":
        sdf, color = model.kernel_weights()
        assert _built(sdf) == {"sweep32", "rev32"}
        assert _built(color) == {"sweep32", "rev32"}
    elif path == "validation":
        with torch.no_grad():
            sdf, color = model.kernel_weights()
        assert _built(sdf) == {"sweep32", "rev32"}
        assert _built(color) == {"sweep32"} and color.sweep32 == ("rsweep",)
    elif path == "stage 2-3":
        sdf, color = TR.Stage2Model(port_config(tiny_config())
                                    ).kernel_weights()
        assert _built(sdf) == {"sweep32", "rev32"}
        assert _built(color) == {"sweep32"}
    else:
        with torch.no_grad():
            sdf = model.sdf.kernel_weights(k1=False)
        if path == "grid fill":
            MEXT.sdf_grid_query(model.sdf)
        assert _built(sdf) == {"sweep32"}
    assert TF.sweep_pack(sdf, False) == ("sweep32",)
    assert "pack" not in sdf._fields


@pytest.mark.parametrize("switch", ["stash", "split"])
def test_kernel_weights_build_the_3xtf32_pack_under_the_switches(
        packs, monkeypatch, switch):
    """Under either switch the SDF network's step weights carry the two
    f32 slab packs and no 3xTF32 pack (KernelWeights has no field for
    one): K1-fwd-stash and K1-bwd-stash read them under the stash switch,
    K1-fwd and K1-bwd-split under the split switch, and K2 the first; the
    sweeps alone build none; the bf16 mode builds its bf16 slab packs
    instead, under either switch."""
    monkeypatch.setattr(GK, "STASH_BWD" if switch == "stash"
                        else "STACKED_BWD", switch == "stash")
    net = TR.Stage1Model(port_config(tiny_config())).sdf
    kw = net.kernel_weights()
    assert _built(kw) == {"sweep32", "rev32"}
    assert "pack" not in kw._fields
    assert _built(net.kernel_weights(k1=False)) == {"sweep32"}
    kw = net.kernel_weights(bf16=True, f32=False)
    assert _built(kw) == {"sweep16", "rev16"}
