"""K1-fwd-bf16 and K3-fwd-bf16 on wgmma (csrc/geometry_fwd_bf16_wg.cu,
csrc/radiance_fwd_bf16_wg.cu), on the CPU: their launch plans cover every
tile, their launches refuse to run without their slab packs (before any
CUDA call), the reverse sweep's first step reads W_last's row 0 where the
kernel reads it in the reverse slab pack, and which packs kernel_weights
builds for the bf16 mode: the slab packs wherever the kernels run, with
grad or without, under either switch, and no other pack.  The kernels
are held against
their twins on a card by chip_smoke.py and tests/test_torch_cuda.py; the
bf16 stage-1 step against the JAX package's by
tests/test_torch_bf16_sweep.py.
"""
import numpy as np
import pytest
import torch

from util_packs import ROW_MAJOR

from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                   RenderingNetwork,
                                                   SDFConfig, SDFNetwork)
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP

SDF_CFG = SDFConfig(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,),
                    multires=4, scale=1.5)
RAD_CFG = RenderingConfig(d_feature=64, d_hidden=64, n_layers=2)
# the rows of the plans' checks: one point, a ragged first tile, one tile,
# a tile and a point, and chip_smoke.py's ragged count
ROWS = (1, 63, 64, 65, 9001)


def _sdf(cfg=SDF_CFG):
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return net, [w.detach() for w in ws], [b.detach() for b in bs]


def _rad():
    net = RenderingNetwork(RAD_CFG, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return net, [w.detach() for w in ws], [b.detach() for b in bs]


def _tiles_covered(plan):
    """The tiles the persistent blocks of a plan run, each once: block b
    takes passes b, b + grid, ..., consumer w of pass p tile nc p + w."""
    seen = [p * plan["nc"] + w for b in range(plan["grid"])
            for p in range(b, plan["n_pass"], plan["grid"])
            for w in range(plan["nc"])]
    assert len(seen) == len(set(seen))
    return set(seen)


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n", ROWS)
def test_fwd_bf16_plans_cover_every_tile(n, sms):
    """Each launch plan's blocks, passes and consumers run every 64-row
    tile that holds a row, and no pass is empty; K1-fwd-bf16's scratch
    holds a consumer's hidden layers (32 float4s a thread a layer) for
    each of its consumers, and its integer arguments end with the reverse
    pack's layer offsets and slab widths."""
    _, ws, _ = _sdf()
    slabs = GK.make_bwd_slabs(SDF_CFG, ws)
    plan = GK.fwd_wg16_plan(SDF_CFG, ws, n, slabs, sms)
    tiles = -(-n // 64)
    assert plan["tiles"] == tiles and plan["grid"] <= sms
    assert set(range(tiles)) <= _tiles_covered(plan)
    assert (plan["n_pass"] - 1) * plan["nc"] < tiles
    assert plan["nc"] == (2 if tiles > sms else 1)
    L = len(ws)
    assert plan["scratch_floats"] == \
        plan["grid"] * plan["nc"] * (L - 1) * 32 * 128 * 4
    rlay = slabs[1][1]
    assert plan["iargs"][-2 * L:] == [*rlay.off, *rlay.cols]
    assert plan["iargs"][3:7] == [n, plan["nc"], plan["grid"],
                                  plan["n_pass"]]
    assert plan["sweep_smem"] <= TP.SMEM_MAX

    _, rws, _ = _rad()
    lay = RK.make_fwd_pack(RAD_CFG, rws, bf16=True)[1]
    rplan = RK.fwd_wg16_plan(RAD_CFG, rws, n, lay, sms)
    assert rplan["tiles"] == tiles and rplan["grid"] <= sms
    assert set(range(tiles)) <= _tiles_covered(rplan)
    assert (rplan["n_pass"] - 1) * rplan["nc"] < tiles
    assert rplan["iargs"][3:8] == [n, rplan["nc"], rplan["grid"],
                                   rplan["n_pass"], 1]
    assert rplan["sweep_smem"] <= TP.SMEM_MAX


def test_fwd_bf16_launches_raise_without_their_slab_packs():
    """K1-fwd-bf16 and K3-fwd-bf16 raise without their slab packs, or on
    another mode's, before any CUDA call (here on CPU tensors); neither
    builds a pack."""
    _, ws, bs = _sdf()
    x = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="make_bwd_slabs"):
        GK.launch_forward(SDF_CFG, x, ws, bs, None, bf16=True)
    with pytest.raises(ValueError, match="wgmma-bf16 slabs"):
        GK.launch_forward(SDF_CFG, x, ws, bs,
                          GK.make_bwd_slabs(SDF_CFG, ws, bf16=False),
                          bf16=True)
    with pytest.raises(ValueError, match="wgmma-bf16 slabs"):
        GK.launch_forward(SDF_CFG, x, ws, bs, (ROW_MAJOR, None), bf16=True)
    with pytest.raises(ValueError, match="takes make_bwd_slabs"):
        GK.fwd_wg16_plan(SDF_CFG, ws, 5,
                         GK.make_bwd_slabs(SDF_CFG, ws, bf16=False), 132)
    # the forward pack with the last layer narrowed to the sdf column
    wn = list(ws[:-1]) + [ws[-1][:1]]
    narrowed = (GK.make_sweep_pack(SDF_CFG, wn),
                GK.make_bwd_slabs(SDF_CFG, ws)[1])
    with pytest.raises(ValueError, match="do not match"):
        GK.fwd_wg16_plan(SDF_CFG, ws, 5, narrowed, 132)

    _, rws, rbs = _rad()
    rin = [torch.zeros(5, 3)] * 3 + [torch.zeros(5, RAD_CFG.d_feature)]
    with pytest.raises(ValueError, match="make_fwd_pack"):
        RK.launch_forward(RAD_CFG, rws, rbs, *rin, pack=None, bf16=True)
    for other in (RK.make_fwd_pack(RAD_CFG, rws), ROW_MAJOR):
        with pytest.raises(ValueError, match="wgmma-bf16-rad slabs"):
            RK.launch_forward(RAD_CFG, rws, rbs, *rin, pack=other,
                              bf16=True)


def test_reverse_seed_reads_w_last_row_0_from_the_reverse_pack():
    """The reverse sweep's first step: JAX's dot rounds e0 / scale and
    W_last's column 0 to bf16, and their one product is exact in f32; the
    kernel reads bf16 element (64 c) ^ ((c % 8) << 3) of the reverse
    pack's first last-layer slab for input column c (k 0 of its swizzled
    row), which is bf16(W_last[0, c]), zero past the layer's inputs; the
    product with bf16(1 / scale) is the twin's r W of that step."""
    _, ws, _ = _sdf()
    rp, rlay = TP.pack_rev_bf16(ws, SDF_CFG.d_embed)
    L = len(ws)
    flat = rp.view(torch.bfloat16)[rlay.off[L - 1] // 2:].float()
    c = np.arange(256)
    seed_row = flat[torch.from_numpy((64 * c) ^ ((c & 7) << 3))]
    n_in = ws[-1].shape[1]
    assert torch.equal(seed_row[:n_in], TP.bf16_round(ws[-1][0]))
    assert not seed_row[n_in:].any()
    s = TP.bf16_round(torch.tensor(1.0 / SDF_CFG.scale))
    r = torch.zeros(3, ws[-1].shape[0])
    r[:, 0] = 1.0 / SDF_CFG.scale
    want = TP.mm_bf16(r, ws[-1])
    assert torch.equal(want, (s * seed_row[:n_in]).expand(3, -1))


@pytest.fixture
def card(monkeypatch):
    """kernel_weights as on a card (the packs built on the CPU)."""
    monkeypatch.setattr(TF, "_on_card", lambda t: True)


def _built(kw):
    return {f for f in kw._fields[2:] if getattr(kw, f) is not None}


@pytest.mark.parametrize("switch", [None, "stash", "split"])
@pytest.mark.parametrize("grad", [True, False])
def test_bf16_kernel_weights_build_the_slab_packs(card, monkeypatch, switch,
                                                  grad):
    """The bf16 mode's kernel weights, with grad (a step) or without (a
    validation image): the SDF network's carry sweep16 and rev16 wherever
    K1 runs in the mode (K1-fwd-bf16, which K1-bwd-bf16 and
    K1-bwd-split-bf16 follow, or under the stash switch K1-fwd-stash-bf16
    and K1-bwd-stash-bf16), and no other pack (KernelWeights has no field
    for a bf16 mma.sync pack); the radiance MLP's carry K3-fwd-bf16's
    sweep16 (and, with grad, K3-bwd-bf16's rev16)."""
    if switch:
        monkeypatch.setattr(GK, "STASH_BWD" if switch == "stash"
                            else "STACKED_BWD", switch == "stash")
    net, ws, _ = _sdf()
    rnet, rws, _ = _rad()
    with torch.set_grad_enabled(grad):
        kw = net.kernel_weights(bf16=True, f32=False)
        rkw = rnet.kernel_weights(bf16=True, f32=False)
    assert _built(kw) == {"sweep16", "rev16"}
    assert "pack16" not in kw._fields
    slabs = TF.bwd_slabs(kw, True)
    assert GK.fwd_wg16_plan(SDF_CFG, ws, 100, slabs, 132,
                            switch == "stash")["tiles"] == 2
    assert torch.equal(slabs[0][0], GK.make_sweep_pack(SDF_CFG, ws)[0])
    assert _built(rkw) == ({"sweep16", "rev16"} if grad else {"sweep16"})
    assert torch.equal(TF.sweep_pack(rkw, True)[0],
                       RK.make_fwd_pack(RAD_CFG, rws, bf16=True)[0])
