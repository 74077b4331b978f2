"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA device and nvcc; every test carries the ``gpu`` marker and
skips elsewhere.  The file imports neither JAX nor the JAX package, so on
a machine without them it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from util_packs import ROW_MAJOR

from factored_neus_tpu_torch.data import rays as RAYS
from factored_neus_tpu_torch.meshing import extract as MEXT
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.models.fields import (RefColorConfig,
                                                   RenderingConfig,
                                                   RenderingNetwork,
                                                   SDFConfig, SDFNetwork)
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops.embedder import positional_encoding


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = [  # (n_layers, d_hidden, d_out, skip_in, multires, scale, n)
    (4, 64, 65, (2,), 4, 1.0, 300),
    (4, 64, 65, (2,), 4, 1.5, 150),
    (2, 64, 65, (), 4, 1.0, 77),
    (8, 256, 257, (4,), 6, 1.0, 1000),
]


def _row_major(ws):
    """A stand-in for a row-major weight buffer on ws' device, which no
    kernel reads: each refuses it (tests/util_packs.py)."""
    return (torch.zeros(1, device=ws[0].device), ROW_MAJOR[1])


def _net(case, device):
    L, h, d_out, skip, multires, scale, n = case
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    x = torch.from_numpy((np.random.RandomState(1).randn(n, 3) * 0.4)
                         .astype(np.float32)).to(device)
    return cfg, list(ws), list(bs), x


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_geometry_kernels_match_twin(cuda_device, case):
    cfg, ws, bs, x = _net(case, cuda_device)
    out_k, grad_k = GK.launch_forward(cfg, x, ws, bs,
                                      GK.make_bwd_slabs(cfg, ws, bf16=False))
    with torch.no_grad():
        out_p, grad_p = GK.geometry_plain(ws, bs, x, cfg)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(grad_k, grad_p, atol=1e-5, rtol=0)

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct_out = torch.randn(out_p.shape, device=cuda_device, generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    ct_x, dws, dbs = GK.launch_backward(
        cfg, x, ws, bs, ct_out, ct_g, GK.make_bwd_slabs(cfg, ws, bf16=False))
    leaves = [t.clone().requires_grad_(True) for t in [x, *ws, *bs]]
    L = len(ws)
    o, g = GK.geometry_plain(leaves[1:1 + L], leaves[1 + L:], leaves[0], cfg)
    ref = torch.autograd.grad((o, g), leaves, (ct_out, ct_g))
    for a, b in zip([ct_x, *dws, *dbs], ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_sdf_sweep_kernel_matches_twin(cuda_device, case):
    """K2 (wgmma, 3xTF32) with the full and the narrowed last layer, on the
    full network's f32 slab pack, within 1e-5 abs of its twin; without a
    pack it raises."""
    cfg, ws, bs, x = _net(case, cuda_device)
    pack = SK.make_sweep_pack(cfg, ws, bf16=False)
    for wn, bn in ((ws, bs), (ws[:-1] + [ws[-1][:1]], bs[:-1] + [bs[-1][:1]])):
        with torch.no_grad():
            want = SK.sdf_forward_plain(wn, bn, cfg, x)
        torch.testing.assert_close(SK.sdf_forward(wn, bn, cfg, x, pack),
                                   want, atol=1e-5, rtol=0)
        with pytest.raises(ValueError, match="make_sweep_pack"):
            SK.sdf_forward(wn, bn, cfg, x)


@pytest.mark.gpu
def test_autograd_function_and_launch_counts(cuda_device):
    """GeometryFn through autograd: one K1-fwd and one K1-bwd launch, and
    the eikonal-style loss's gradients equal the plain twin's."""
    cfg, _, _, x = _net(CASES[0], cuda_device)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    ref = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)

    def loss(s, f, g):
        return ((g.norm(dim=-1) - 1) ** 2).mean() + (f ** 2).mean() + \
            s.abs().mean()

    f0, b0 = GK.K1_FWD.launches, GK.K1_BWD.launches
    loss(*net.value_grad_feat(x)).backward()
    assert (GK.K1_FWD.launches - f0, GK.K1_BWD.launches - b0) == (1, 1)
    ws_r, bs_r = ref.effective_weights()
    o, g = GK.geometry_plain(ws_r, bs_r, x, cfg)
    loss(o[:, 0], o[:, 1:], g).backward()
    for (name, a), b in zip(net.named_parameters(), ref.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4,
                                   msg=name)


def worst_scaled_ratio(a, b, atol=1e-4, rtol=1e-5):
    """max |a - b| / (atol + rtol max|b|) over one tensor: a weight
    gradient sums every row, so its error scales with the tensor."""
    return float((a - b).abs().max()) / (atol + rtol * float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_split_backward_matches_f64_twin(cuda_device, case):
    """K1-bwd-split (on wgmma, from K1-bwd's f32 slab packs) against the
    float64 twin per tensor at |err| <= 1e-4 + 1e-5 max|ref|, as K1-bwd is
    held in chip_smoke.py."""
    cfg, ws, bs, x = _net(case, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n_out = ws[-1].shape[0]
    ct_out = torch.randn(x.shape[0], n_out, device=cuda_device, generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    ct_x, dws, dbs = GK.launch_backward_split(
        cfg, x, ws, bs, ct_out, ct_g,
        slabs=GK.make_bwd_slabs(cfg, ws, bf16=False))
    leaves = [t.double().requires_grad_(True) for t in [x, *ws, *bs]]
    L = len(ws)
    o, g = GK.geometry_plain(leaves[1:1 + L], leaves[1 + L:], leaves[0], cfg)
    ref = torch.autograd.grad((o, g), leaves, (ct_out.double(),
                                               ct_g.double()))
    for i, (a, b) in enumerate(zip([ct_x, *dws, *dbs], ref)):
        assert a.shape == b.shape
        assert worst_scaled_ratio(a.double(), b) <= 1.0, i


def f64_vjp(cfg, x, ws, bs, ct_out, ct_g):
    """(ct_x, dW..., db...) of the plain twin in float64."""
    leaves = [t.double().requires_grad_(True) for t in [x, *ws, *bs]]
    L = len(ws)
    o, g = GK.geometry_plain(leaves[1:1 + L], leaves[1 + L:], leaves[0], cfg)
    return torch.autograd.grad((o, g), leaves, (ct_out.double(),
                                                ct_g.double()))


RAGGED = (8, 256, 257, (4,), 6, 1.0, 9001)   # full width, 2-3 tiles a block


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["stacked", "split", "stash"])
def test_k1_ragged_tiles_over_several_rounds(cuda_device, variant):
    """9,001 rows at full width: the last tile of K1-fwd (64 rows) and of
    K1-bwd (32 + 32) is ragged, and the persistent blocks take several
    tiles each, so the partial slices accumulate.  K1-fwd against its f32
    twin at 1e-5; the backward against the f64 twin per tensor at
    |err| <= 1e-4 + 1e-5 max|ref| (the stash variant against its own f64
    twin, fed the kernel's stash)."""
    cfg, ws, bs, x = _net(RAGGED, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct_out = torch.randn(x.shape[0], ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    with torch.no_grad():
        out_p, grad_p = GK.geometry_plain(ws, bs, x, cfg)
    if variant == "stash":
        out_k, grad_k, st = GK.launch_forward_stash(cfg, x, ws, bs, slabs)
        got = GK.launch_backward_stash(cfg, x, ws, st, ct_out, ct_g,
                                       slabs=slabs)
        want = GK.geometry_bwd_stash_plain([w.double() for w in ws],
                                           x.double(), st, ct_out.double(),
                                           ct_g.double(), cfg)
        want = [want[0], *want[1], *want[2]]
    else:
        out_k, grad_k = GK.launch_forward(cfg, x, ws, bs, slabs)
        got = (GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs)
               if variant == "stacked" else
               GK.launch_backward_split(cfg, x, ws, bs, ct_out, ct_g,
                                        slabs=slabs))
        want = f64_vjp(cfg, x, ws, bs, ct_out, ct_g)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(grad_k, grad_p, atol=1e-5, rtol=0)
    for i, (a, b) in enumerate(zip([got[0], *got[1], *got[2]], want)):
        assert a.shape == b.shape
        assert worst_scaled_ratio(a.double(), b) <= 1.0, i


@pytest.mark.gpu
@pytest.mark.parametrize("launch", ["launch_backward",
                                    "launch_backward_split"])
def test_k1_backward_is_deterministic(cuda_device, launch):
    """Two launches on the same inputs give bitwise-equal ct_x, dW and db:
    the weight-gradient sums run in a fixed order (per-block partial
    slices, then a fixed-order reduce), with no atomics."""
    cfg, ws, bs, x = _net(RAGGED, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ct_out = torch.randn(x.shape[0], ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    fn = getattr(GK, launch)
    arg = {"launch_backward": "pack", "launch_backward_split": "slabs"}
    slabs = {arg[launch]: GK.make_bwd_slabs(cfg, ws, bf16=False)}
    a = fn(cfg, x, ws, bs, ct_out, ct_g, **slabs)
    b = fn(cfg, x, ws, bs, ct_out, ct_g, **slabs)
    for u, v in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001, 2048, 512])
def test_k1_fwd_wgmma_f32_matches_twin(cuda_device, n):
    """K1-fwd (csrc/geometry_fwd_wg.cu, 3xTF32 on wgmma) at full width
    within 1e-5 abs of its f32 twin, out and grad, at the stage-1 and
    stage-2 step's 65,536 points, a ragged 9,001 and stages 2-3's 2,048 and
    512; two launches bitwise equal; on the slabs SDFNetwork.kernel_weights
    builds without grad, bitwise as on its own; it raises without its
    slabs and on the bf16 mode's or the 3xTF32 pack, and geometry raises
    without them on a CUDA tensor."""
    cfg, ws, bs, x = _net((8, 256, 257, (4,), 6, 1.0, n), cuda_device)
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    got = GK.launch_forward(cfg, x, ws, bs, slabs)
    with torch.no_grad():
        want = GK.geometry_plain(ws, bs, x, cfg)
        kw = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(
            cuda_device).kernel_weights()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    again = GK.launch_forward(cfg, x, ws, bs, TF.bwd_slabs(kw, False))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for pack in (None, GK.make_bwd_slabs(cfg, ws), (_row_major(ws),) * 2):
        with pytest.raises(ValueError):
            GK.launch_forward(cfg, x, ws, bs, pack)
    with pytest.raises(ValueError, match="slabs"):
        GK.geometry(ws, bs, x, cfg, stash=False)


@pytest.mark.gpu
def test_split_switch_launches_k1_bwd_split(cuda_device, monkeypatch):
    """With FNEUS_PG_STACKED off, value_grad_feat runs K1-fwd and
    K1-bwd-split once each and not K1-bwd; the stash switch still wins."""
    monkeypatch.setattr(GK, "STACKED_BWD", False)
    cfg, _, _, x = _net(CASES[0], cuda_device)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    kernels = (GK.K1_FWD, GK.K1_BWD, GK.K1_BWD_SPLIT, GK.K1_FWD_STASH,
               GK.K1_BWD_STASH)

    def launches():
        before = [k.launches for k in kernels]
        s, f, g = net.value_grad_feat(x)
        (((g.norm(dim=-1) - 1) ** 2).mean() + (f ** 2).mean()
         + s.abs().mean()).backward()
        return [k.launches - b for k, b in zip(kernels, before)]

    assert launches() == [1, 0, 1, 0, 0]
    monkeypatch.setattr(GK, "STASH_BWD", True)
    assert launches() == [0, 0, 0, 1, 1]


def bf16_ulps(a, b):
    """|a - b| of two bf16 tensors in units of the larger one's last
    place (8 significant bits)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def stash_agrees(a, b):
    """Each bf16 stash entry within one ulp of the other's or, near zero
    where one ulp is finer than the f32 sums' own error, within K1-fwd's
    f32 tolerance of 1e-5."""
    return bool(((bf16_ulps(a, b) <= 1.0) |
                 ((a.float() - b.float()).abs() <= 1e-5)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_stash_kernels_match_twins(cuda_device, case):
    """K1-fwd-stash: exact (out, grad) and every stash entry within one
    bf16 ulp of the twin's; K1-bwd-stash and its twin fed the kernel's own
    stash."""
    cfg, ws, bs, x = _net(case, cuda_device)
    out_k, grad_k, st_k = GK.launch_forward_stash(
        cfg, x, ws, bs, GK.make_bwd_slabs(cfg, ws, bf16=False))
    out_p, grad_p, st_p = GK.geometry_fwd_stash_plain(ws, bs, x, cfg)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(grad_k, grad_p, atol=1e-5, rtol=0)
    assert st_k.dtype == torch.bfloat16 and st_k.shape == st_p.shape
    assert stash_agrees(st_k, st_p)

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct_out = torch.randn(out_p.shape, device=cuda_device, generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    got = GK.launch_backward_stash(cfg, x, ws, st_k, ct_out, ct_g,
                                   slabs=GK.make_bwd_slabs(cfg, ws,
                                                           bf16=False))
    want = GK.geometry_bwd_stash_plain(ws, x, st_k, ct_out, ct_g, cfg)
    for a, b in zip([got[0], *got[1], *got[2]],
                    [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [65536, 9001, 100])
def test_k1_fwd_stash_wgmma_is_k1_fwd_with_a_stash(cuda_device, n, bf16):
    """K1-fwd-stash (bf16: K1-fwd-stash-bf16), K1-fwd's (K1-fwd-bf16's)
    wgmma sweep with the stash stored from its epilogues, at full width:
    out and grad K1-fwd's (K1-fwd-bf16's) bit for bit, two launches
    bitwise equal; the stash
    against its twin's (f32: each entry within one bf16 ulp or 1e-5;
    bf16: chip_smoke.check_flips beside the f64 pre-activations); the
    launch raises without the mode's slab packs or on another pack."""
    cfg, ws, bs, x = _net((8, 256, 257, (4,), 6, 1.0, n), cuda_device)
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=bf16)
    out, grad, st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)
    again = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)
    k1 = GK.launch_forward(cfg, x, ws, bs, slabs, bf16)
    assert torch.equal(out, k1[0]) and torch.equal(grad, k1[1])
    assert all(torch.equal(a, b) for a, b in zip((out, grad, st), again))
    st_p = GK.geometry_fwd_stash_plain(ws, bs, x, cfg, bf16)[2]
    assert st.shape == st_p.shape == (n, GK.stash_columns(ws))
    if bf16:
        pre = []
        with torch.no_grad():
            GK.geometry_plain([w.double() for w in ws],
                              [b.double() for b in bs], x.double(), cfg, pre)
        chip_smoke.check_flips(f"K1-fwd-stash-bf16 stash N={n}",
                               [st.float()], [st_p.float()],
                               [torch.cat(pre, -1).float()], ["stash"])
    else:
        assert stash_agrees(st, st_p)
    for pack in (None, GK.make_bwd_slabs(cfg, ws, bf16=not bf16),
                 (_row_major(ws),) * 2):
        with pytest.raises(ValueError):
            GK.launch_forward_stash(cfg, x, ws, bs, pack, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001, 100])
def test_k1_bwd_chains_wgmma_f32(cuda_device, n):
    """K1-bwd-split and K1-bwd-stash (csrc/geometry_bwd_chains_wg.cu,
    3xTF32 on wgmma) at full width against their f64 twins per tensor at
    |err| <= 1e-4 + 1e-5 max|ref| (the stash's fed K1-fwd-stash's stash),
    two launches bitwise equal; on the slab packs kernel_weights builds,
    bitwise as on their own; each raises without K1-bwd's f32 slab packs
    or on another pack.  Printed: whether the split's ct_x and dW are
    K1-bwd's bit for bit."""
    cfg, ws, bs, x = _net((8, 256, 257, (4,), 6, 1.0, n), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    ct_out = torch.randn(n, ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(n, 3, device=cuda_device, generator=gen)
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    flat = lambda r: [r[0], *r[1], *r[2]]
    st = GK.launch_forward_stash(cfg, x, ws, bs, slabs)[2]
    runs = {"split": lambda p: flat(GK.launch_backward_split(
                cfg, x, ws, bs, ct_out, ct_g, slabs=p)),
            "stash": lambda p: flat(GK.launch_backward_stash(
                cfg, x, ws, st, ct_out, ct_g, slabs=p))}
    w64 = [w.double() for w in ws]
    refs = {"split": f64_vjp(cfg, x, ws, bs, ct_out, ct_g),
            "stash": flat(GK.geometry_bwd_stash_plain(
                w64, x.double(), st, ct_out.double(), ct_g.double(), cfg))}
    with torch.no_grad():
        kw = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(
            cuda_device).kernel_weights()
    for name, run in runs.items():
        got, again = run(slabs), run(TF.bwd_slabs(kw, False))
        for i, (a, b) in enumerate(zip(got, refs[name])):
            assert a.shape == b.shape
            assert worst_scaled_ratio(a.double(), b) <= 1.0, (name, i)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        for pack in (None, GK.make_bwd_slabs(cfg, ws),
                     (_row_major(ws),) * 2):
            with pytest.raises(ValueError):
                run(pack)
    k1 = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs))
    split = runs["split"](slabs)
    L = len(ws)
    print(f"K1-bwd-split N={n}: ct_x bitwise K1-bwd's: "
          f"{torch.equal(split[0], k1[0])}; dW: "
          f"{all(torch.equal(a, b) for a, b in zip(split[1:1 + L], k1[1:1 + L]))}"
          f"; db: {all(torch.equal(a, b) for a, b in zip(split[1 + L:], k1[1 + L:]))}")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001, 100])
def test_k1_bwd_chains_wgmma_bf16(cuda_device, n):
    """K1-bwd-split-bf16 and K1-bwd-stash-bf16
    (csrc/geometry_bwd_chains_bf16_wg.cu, bf16 wgmma) at full width
    against their twins and the f64 unrounded function
    (chip_smoke.check_flips; the stash's fed K1-fwd-stash-bf16's stash),
    two launches bitwise equal; on the slab packs kernel_weights builds,
    bitwise as on their own; each raises without K1-bwd-bf16's slab packs
    or on another pack.  Printed: whether the split's ct_x and dW are
    K1-bwd-bf16's bit for bit."""
    cfg, ws, bs, x = _net((8, 256, 257, (4,), 6, 1.0, n), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    ct_out = torch.randn(n, ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(n, 3, device=cuda_device, generator=gen)
    slabs = GK.make_bwd_slabs(cfg, ws)
    flat = lambda r: [r[0], *r[1], *r[2]]
    st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16=True)[2]
    runs = {"split": lambda p: flat(GK.launch_backward_split(
                cfg, x, ws, bs, ct_out, ct_g, p, bf16=True)),
            "stash": lambda p: flat(GK.launch_backward_stash(
                cfg, x, ws, st, ct_out, ct_g, p, bf16=True))}
    w64 = [w.double() for w in ws]
    twins = {"split": (flat(GK.geometry_bwd_plain(
                 ws, bs, x, ct_out, ct_g, cfg, bf16=True)),
                 flat(GK.geometry_bwd_plain(
                     w64, [b.double() for b in bs], x.double(),
                     ct_out.double(), ct_g.double(), cfg))),
             "stash": (flat(GK.geometry_bwd_stash_plain(
                 ws, x, st, ct_out, ct_g, cfg, bf16=True)),
                 flat(GK.geometry_bwd_stash_plain(
                     w64, x.double(), st, ct_out.double(), ct_g.double(),
                     cfg)))}
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    with torch.no_grad():
        kw = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(
            cuda_device).kernel_weights(bf16=True)
    for name, run in runs.items():
        got, again = run(slabs), run(TF.bwd_slabs(kw, True))
        twin, ref = twins[name]
        chip_smoke.check_flips(f"K1-bwd-{name}-bf16 N={n}", got, twin,
                               [t.float() for t in ref], names)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        for pack in (None, GK.make_bwd_slabs(cfg, ws, bf16=False),
                     (_row_major(ws),) * 2):
            with pytest.raises(ValueError):
                run(pack)
    k1 = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                 bf16=True))
    split = runs["split"](slabs)
    print(f"K1-bwd-split-bf16 N={n}: ct_x bitwise K1-bwd-bf16's: "
          f"{torch.equal(split[0], k1[0])}; dW: "
          f"{all(torch.equal(a, b) for a, b in zip(split[1:1 + L], k1[1:1 + L]))}"
          f"; db: {all(torch.equal(a, b) for a, b in zip(split[1 + L:], k1[1 + L:]))}")


RAD_CASES = [  # (d_feature, d_hidden, n_layers, multires_view, n)
    (64, 64, 3, 4, 300),
    (64, 64, 1, 4, 150),
    (32, 96, 2, 0, 77),
    (256, 256, 4, 4, 1000),     # the wmask widths: 289 in, 256 hidden, 3 out
]


def _rad(case, device):
    d_feature, d_hidden, n_layers, multires, n = case
    cfg = RenderingConfig(d_feature=d_feature, d_hidden=d_hidden,
                          n_layers=n_layers, multires_view=multires)
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    rng = np.random.RandomState(1)
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [rng.randn(n, 3) * 0.4, rng.randn(n, 3), dirs,
              rng.randn(n, d_feature) * 0.5]
    return cfg, net, [torch.from_numpy(a.astype(np.float32)).to(device)
                      for a in inputs]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RAD_CASES)
def test_radiance_kernels_match_twin(cuda_device, case):
    cfg, net, inputs = _rad(case, cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
        want = RK.radiance_plain(ws, bs, cfg, *inputs)
    torch.testing.assert_close(RK.launch_forward(
        cfg, ws, bs, *inputs, pack=RK.make_fwd_pack(cfg, ws)), want,
        atol=1e-5, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct = torch.randn(want.shape, device=cuda_device, generator=gen)
    *cts, dws, dbs = RK.launch_backward(
        cfg, ws, bs, *inputs, ct, pack=RK.make_bwd_slabs(cfg, ws, False))
    # the f32 twin differentiates the function the kernel computes: on the
    # ReLU masks of the kernel's own forward (chip_smoke.k3_bwd_masks holds
    # them to the f32 forward's within rounding of 0), as rad_f64_vjp
    masks, _ = chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs)
    *rc, rw, rb = RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct,
                                        masks=masks)
    for a, b in zip([*cts, *dws, *dbs], [*rc, *rw, *rb]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_radiance_function_and_launch_counts(cuda_device):
    """RenderingNetwork on CUDA tensors: one K3-fwd and one K3-bwd launch,
    and every parameter and input gradient equal to the plain twin's."""
    cfg, net, inputs = _rad(RAD_CASES[0], cuda_device)
    ref = RenderingNetwork(cfg, torch.Generator().manual_seed(0)).to(
        cuda_device)

    def run(model, fn):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        rgb = fn(model, leaves)
        (torch.mean(rgb ** 2) + rgb[:, 0].sum() * 1e-3).backward()
        return [t.grad for t in leaves]

    f0, b0 = RK.K3_FWD.launches, RK.K3_BWD.launches
    got = run(net, lambda m, a: m(*a))
    assert (RK.K3_FWD.launches - f0, RK.K3_BWD.launches - b0) == (1, 1)
    want = run(ref, lambda m, a: RK.radiance_plain(
        *m.effective_weights(), cfg, *a))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    for (name, a), b in zip(net.named_parameters(), ref.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4,
                                   msg=name)

    other = RenderingNetwork(RenderingConfig(
        d_feature=64, d_hidden=64, n_layers=3, mode="no_view_dir", d_in=6,
        multires_view=0)).to(cuda_device)
    with pytest.raises(NotImplementedError, match="no_view_dir"):
        other(inputs[0], inputs[1], inputs[2], inputs[3])


@pytest.mark.gpu
def test_stash_switch_launches_the_stash_pair(cuda_device, monkeypatch):
    """With the switch on, value_grad_feat runs K1-fwd-stash and
    K1-bwd-stash once each and neither K1-fwd nor K1-bwd."""
    monkeypatch.setattr(GK, "STASH_BWD", True)
    cfg, _, _, x = _net(CASES[0], cuda_device)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    kernels = (GK.K1_FWD, GK.K1_BWD, GK.K1_FWD_STASH, GK.K1_BWD_STASH)
    before = [k.launches for k in kernels]
    s, f, g = net.value_grad_feat(x)
    (((g.norm(dim=-1) - 1) ** 2).mean() + (f ** 2).mean()
     + s.abs().mean()).backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 1, 1]


@pytest.mark.gpu
def test_grid_fill_matches_cpu_twin(cuda_device):
    """A 64^3 grid of the full-width SDF filled on the card (K2, slabs of
    32 planes kept in flight) against the CPU twin's at 1e-5."""
    net = SDFNetwork(SDFConfig(), torch.Generator().manual_seed(0))
    box = ([-1.01] * 3, [1.01] * 3)
    before = SK.SDF_FWD.launches
    card = MEXT.extract_fields(*box, 64, MEXT.sdf_grid_query(
        net.to(cuda_device)), cuda_device)
    assert SK.SDF_FWD.launches - before == 2
    cpu = MEXT.extract_fields(*box, 64, MEXT.sdf_grid_query(net.cpu()),
                              "cpu")
    assert np.abs(card - cpu).max() <= 1e-5
    assert np.isfinite(card).all() and (card > 0).any() and (card < 0).any()


def rad_f64_vjp(cfg, ws, bs, inputs, ct):
    """(ct_pts, ct_normals, ct_dirs, ct_feat, dW..., db...) of the plain
    twin in float64 with the ReLU masks of K3-bwd's own forward
    (chip_smoke.k3_bwd_masks, which raises where they differ from the f32
    forward's beyond rounding of 0): where a pre-activation lies within f32
    rounding of 0, a forward summed in another order (cuBLAS's f32, f64, or
    the 3xTF32 emulation) takes the other side of the kink and
    differentiates another function, one whole cotangent element apart."""
    L = len(ws)

    def x0(pts, normals, dirs, feat):
        return torch.cat([pts, positional_encoding(dirs, cfg.multires_view),
                          normals, feat], -1)

    masks, _ = chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs)
    leaves = [t.double().requires_grad_(True) for t in [*inputs, *ws, *bs]]
    h = x0(*leaves[:4])
    for l in range(L):
        h = torch.nn.functional.linear(h, leaves[4 + l], leaves[4 + L + l])
        if l < L - 1:
            h = h * masks[l].to(h.dtype)
    rgb = torch.sigmoid(h) if cfg.squeeze_out else h
    return torch.autograd.grad(rgb, leaves, ct.double())


RAD_RAGGED = (256, 256, 4, 4, 9001)   # full width, 1-2 tiles a block


@pytest.mark.gpu
@pytest.mark.parametrize("case", RAD_CASES + [RAD_RAGGED])
def test_k3_bwd_matches_f64_twin(cuda_device, case):
    """K3-bwd (3xTF32 on wgmma) against the float64 twin per tensor at
    |err| <= 1e-4 + 1e-5 max|ref|, the twin on the kernel's ReLU masks
    once they are held against the f32 forward's (rad_f64_vjp); 9,001 rows
    take the persistent blocks over several tiles, the last one ragged."""
    cfg, net, inputs = _rad(case, cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct = torch.randn(inputs[0].shape[0], cfg.d_out, device=cuda_device,
                     generator=gen)
    *cts, dws, dbs = RK.launch_backward(
        cfg, ws, bs, *inputs, ct, pack=RK.make_bwd_slabs(cfg, ws, False))
    want = rad_f64_vjp(cfg, ws, bs, inputs, ct)
    for i, (a, b) in enumerate(zip([*cts, *dws, *dbs], want)):
        assert a.shape == b.shape
        assert worst_scaled_ratio(a.double(), b) <= 1.0, i


@pytest.mark.gpu
def test_k3_bwd_is_deterministic(cuda_device):
    """Two K3-bwd launches on the same inputs give bitwise-equal
    cotangents, dW and db (per-warp db slots and per-chunk dW slots, a
    fixed-order reduce)."""
    cfg, net, inputs = _rad(RAD_RAGGED, cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ct = torch.randn(inputs[0].shape[0], cfg.d_out, device=cuda_device,
                     generator=gen)
    slabs = RK.make_bwd_slabs(cfg, ws, False)
    a = RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=slabs)
    b = RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=slabs)
    for u, v in zip([*a[:4], *a[4], *a[5]], [*b[:4], *b[4], *b[5]]):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k3_fwd_full_width_matches_twin(cuda_device, n):
    """K3-fwd (tensor cores, 3xTF32) at full width within 1e-5 abs of its
    f32 twin: the step's 65,536 rows, and 9,001 that take the persistent
    blocks over several tiles, the last one ragged."""
    cfg, net, inputs = _rad((256, 256, 4, 4, n), cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
        want = RK.radiance_plain(ws, bs, cfg, *inputs)
    got = RK.launch_forward(cfg, ws, bs, *inputs,
                            pack=RK.make_fwd_pack(cfg, ws))
    assert got.shape == (n, 3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_k3_fwd_is_deterministic(cuda_device):
    """Two K3-fwd launches, one on its own pack and one on the forward slab
    pack that kernel_weights builds for K3-bwd, give the same bits; it
    raises without a pack, on the reverse pack and on the 3xTF32 pack."""
    cfg, net, inputs = _rad(RAD_RAGGED, cuda_device)
    kw = net.kernel_weights()
    with torch.no_grad():
        ws, bs = net.effective_weights()
    a = RK.launch_forward(cfg, ws, bs, *inputs,
                          pack=RK.make_fwd_pack(cfg, ws))
    b = RK.launch_forward(cfg, ws, bs, *inputs, pack=kw.sweep32)
    assert torch.equal(a, b)
    for pack in (None, kw.rev32, _row_major(ws)):
        with pytest.raises(ValueError):
            RK.launch_forward(cfg, ws, bs, *inputs, pack=pack)


@pytest.mark.gpu
def test_k3_bwd_reads_only_its_f32_slabs(cuda_device):
    """K3-bwd on the slabs RenderingNetwork.kernel_weights builds (grad on,
    sweep32 and rev32) gives the bits of its slabs built here, writes its
    ReLU masks on request without changing a bit, and raises without its
    slabs, on the bf16 mode's or on the 3xTF32 pack."""
    cfg, net, inputs = _rad(RAD_RAGGED, cuda_device)
    kw = net.kernel_weights()
    ws, bs = [w.detach() for w in kw.ws], [b.detach() for b in kw.bs]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ct = torch.randn(inputs[0].shape[0], cfg.d_out, device=cuda_device,
                     generator=gen)
    flat = lambda r: [*r[:4], *r[4], *r[5]]
    masks = []
    a = flat(RK.launch_backward(cfg, ws, bs, *inputs, ct,
                                pack=TF.bwd_slabs(kw, False)))
    b = flat(RK.launch_backward(cfg, ws, bs, *inputs, ct,
                                pack=RK.make_bwd_slabs(cfg, ws, False),
                                masks=masks))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [tuple(m.shape) for m in masks] == [
        (inputs[0].shape[0], 256)] * 4
    for pack in (None, RK.make_bwd_slabs(cfg, ws),
                 (_row_major(ws),) * 2):
        with pytest.raises(ValueError):
            RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=pack)
    with pytest.raises(ValueError, match="slabs"):
        RK.radiance(list(kw.ws), list(kw.bs), cfg, *inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 32768, 9001])
def test_k2_sweep_shapes_match_twin(cuda_device, n):
    """K2 at the ladder's two sweep shapes (512 rays x 16 and x 64
    samples) and a ragged count, full width, last layer narrowed: fed K1's
    f32 slab pack of the same weights (the step's route, sweep32) within
    1e-5 abs of its twin, and bitwise equal to K2 fed its own narrowed
    pack."""
    case = (8, 256, 257, (4,), 6, 1.0, n)
    cfg, ws, bs, x = _net(case, cuda_device)
    wn, bn = ws[:-1] + [ws[-1][:1]], bs[:-1] + [bs[-1][:1]]
    k1_pack = GK.make_bwd_slabs(cfg, ws, bf16=False)[0]
    got = SK.sdf_forward(wn, bn, cfg, x, k1_pack)
    own = SK.sdf_forward(wn, bn, cfg, x,
                         SK.make_sweep_pack(cfg, wn, bf16=False))
    with torch.no_grad():
        want = SK.sdf_forward_plain(wn, bn, cfg, x)
    assert got.shape == (n, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, own)


@pytest.mark.gpu
def test_step_launches_each_kernel_once_and_k2_four_times(cuda_device):
    """One stage-1 render + backward on the card (narrow widths, 4-round
    ladder): K2 four times (the first sweep and three of the four rounds'
    new samples), K1-fwd, K1-bwd, K3-fwd and K3-bwd once each."""
    cfg = TR.RendererConfig(
        n_samples=16, n_importance=16, up_sample_steps=4,
        sdf=SDFConfig(n_layers=4, d_hidden=64, d_out=65, skip_in=(2,),
                      multires=4),
        rendering=RenderingConfig(d_feature=64, d_hidden=64, n_layers=3),
        refcolor=RefColorConfig(d_feature=64))
    model = TR.Stage1Model(cfg, seed=0).to(cuda_device)
    rng = np.random.RandomState(0)
    o = rng.randn(32, 3) * 0.1 + np.array([0.0, 0.0, -3.0])
    d = np.array([0.0, 0.0, 1.0]) + rng.randn(32, 3) * 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
            for a in (o, d))
    near, far = RAYS.near_far_from_sphere(o, d)
    kernels = (SK.SDF_FWD, GK.K1_FWD, GK.K1_BWD, RK.K3_FWD, RK.K3_BWD)
    before = [k.launches for k in kernels]
    out = TR.render(model, cfg, o, d, near, far)
    (out["color_fine"].sum() + out["gradient_error"].sum()).backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 1, 1,
                                                                 1, 1]


def _bf16_runs(cfg, ws, bs, x, ct_out, ct_g, slabs):
    """Each bf16 K1 kernel and its plain twin: {name: (launch, twin)}, the
    kernels' outputs as lists of tensors; ``slabs``: the bf16 slab packs
    of ws."""
    flat = lambda r: [r[0], *r[1], *r[2]]
    st_k = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16=True)[2]
    tw_f = list(GK.geometry_plain(ws, bs, x, cfg, bf16=True))
    tw_b = flat(GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                      bf16=True))
    return {
        "fwd": (lambda: list(GK.launch_forward(
            cfg, x, ws, bs, GK.make_bwd_slabs(cfg, ws), bf16=True)), tw_f),
        "fwd_stash": (lambda: list(GK.launch_forward_stash(
            cfg, x, ws, bs, slabs, bf16=True)[:2]), tw_f),
        "bwd": (lambda: flat(GK.launch_backward(
            cfg, x, ws, bs, ct_out, ct_g, GK.make_bwd_slabs(cfg, ws),
            bf16=True)), tw_b),
        "bwd_split": (lambda: flat(GK.launch_backward_split(
            cfg, x, ws, bs, ct_out, ct_g, GK.make_bwd_slabs(cfg, ws),
            bf16=True)), tw_b),
        "bwd_stash": (lambda: flat(GK.launch_backward_stash(
            cfg, x, ws, st_k, ct_out, ct_g, GK.make_bwd_slabs(cfg, ws),
            bf16=True)),
            flat(GK.geometry_bwd_stash_plain(ws, x, st_k, ct_out, ct_g, cfg,
                                             bf16=True)))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_bf16_kernels_match_twins(cuda_device, case):
    """K1's bf16 kernels against their twins and the f64 unrounded
    function (chip_smoke.check_flips), two launches of each bitwise
    equal."""
    cfg, ws, bs, x = _net(case, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    ct_out = torch.randn(x.shape[0], ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(x.shape[0], 3, device=cuda_device, generator=gen)
    w64, b64 = [w.double() for w in ws], [b.double() for b in bs]
    ref_f = [t.float() for t in GK.geometry_plain(w64, b64, x.double(), cfg)]
    r = GK.geometry_bwd_plain(w64, b64, x.double(), ct_out.double(),
                              ct_g.double(), cfg)
    ref_b = [t.float() for t in [r[0], *r[1], *r[2]]]
    L = len(ws)
    names_b = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    pack = GK.make_bwd_slabs(cfg, ws)
    for name, (run, twin) in _bf16_runs(cfg, ws, bs, x, ct_out, ct_g,
                                         pack).items():
        got, again = run(), run()
        fwd = name.startswith("fwd")
        chip_smoke.check_flips(f"{name} {case}", got, twin,
                               ref_f if fwd else ref_b,
                               ["out", "grad"] if fwd else names_b)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k1_bwd_bf16_wgmma_matches_twin(cuda_device, n):
    """K1-bwd-bf16 (csrc/geometry_bwd_bf16_wg.cu, on wgmma) at full width,
    the step's 65,536 points and a ragged 9,001, against its twin and the
    f64 unrounded function (chip_smoke.check_flips), two launches bitwise
    equal; an mma.sync pack is refused, and so is a launch without the
    slab packs."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(n, 3, device=cuda_device, generator=gen) * 0.5
    ct_out = torch.randn(n, ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(n, 3, device=cuda_device, generator=gen)
    flat = lambda r: [r[0], *r[1], *r[2]]
    slabs = GK.make_bwd_slabs(cfg, ws)
    got = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                  bf16=True))
    again = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                    bf16=True))
    twin = flat(GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                      bf16=True))
    ref = [t.float() for t in flat(GK.geometry_bwd_plain(
        [w.double() for w in ws], [b.double() for b in bs], x.double(),
        ct_out.double(), ct_g.double(), cfg))]
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    chip_smoke.check_flips(f"K1-bwd-bf16 N={n}", got, twin, ref, names)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="wgmma"):
        GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g,
                           (_row_major(ws),) * 2, bf16=True)
    with pytest.raises(ValueError, match="none was given"):
        GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, None, bf16=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k1_fwd_bf16_wgmma_matches_twin(cuda_device, n):
    """K1-fwd-bf16 (csrc/geometry_fwd_bf16_wg.cu, on wgmma) at full width,
    the step's 65,536 points and a ragged 9,001, against its twin and the
    f64 unrounded function (chip_smoke.check_flips), two launches bitwise
    equal, its out K2-bf16's full output on the same slab pack bit for
    bit; another mode's packs are refused, and so is a launch without the
    slab packs."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(n, 3, device=cuda_device, generator=gen) * 0.5
    slabs = GK.make_bwd_slabs(cfg, ws)
    got = list(GK.launch_forward(cfg, x, ws, bs, slabs, bf16=True))
    again = list(GK.launch_forward(cfg, x, ws, bs, slabs, bf16=True))
    twin = list(GK.geometry_plain(ws, bs, x, cfg, bf16=True))
    ref = [t.float() for t in GK.geometry_plain(
        [w.double() for w in ws], [b.double() for b in bs], x.double(),
        cfg)]
    chip_smoke.check_flips(f"K1-fwd-bf16 N={n}", got, twin, ref,
                           ["out", "grad"])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], SK.sdf_forward(ws, bs, cfg, x, slabs[0],
                                              bf16=True))
    with pytest.raises(ValueError, match="wgmma-bf16 slabs"):
        GK.launch_forward(cfg, x, ws, bs, GK.make_bwd_slabs(cfg, ws, False),
                          bf16=True)
    with pytest.raises(ValueError, match="none was given"):
        GK.launch_forward(cfg, x, ws, bs, None, bf16=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k3_fwd_bf16_wgmma_matches_twin(cuda_device, n):
    """K3-fwd-bf16 (csrc/radiance_fwd_bf16_wg.cu, on wgmma) at full width
    against its twin and the f64 unrounded function
    (chip_smoke.check_flips), two launches bitwise equal, on K3-bwd-bf16's
    forward pack; K3-fwd's f32 pack is refused."""
    rcfg = RenderingConfig()
    net = RenderingNetwork(rcfg, torch.Generator().manual_seed(0)).to(
        cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rin = [torch.randn(n, 3, device=cuda_device, generator=gen) * 0.5,
           torch.randn(n, 3, device=cuda_device, generator=gen),
           torch.nn.functional.normalize(torch.randn(
               n, 3, device=cuda_device, generator=gen), dim=-1),
           torch.randn(n, rcfg.d_feature, device=cuda_device,
                       generator=gen) * 0.5]
    pack = RK.make_bwd_slabs(rcfg, ws)[0]
    got = [RK.launch_forward(rcfg, ws, bs, *rin, pack=pack, bf16=True)]
    again = [RK.launch_forward(rcfg, ws, bs, *rin, pack=pack, bf16=True)]
    twin = [RK.radiance_plain(ws, bs, rcfg, *rin, bf16=True)]
    ref = [RK.radiance_plain([w.double() for w in ws],
                             [b.double() for b in bs], rcfg,
                             *(t.double() for t in rin)).float()]
    chip_smoke.check_flips(f"K3-fwd-bf16 N={n}", got, twin, ref, ["rgb"])
    assert torch.equal(got[0], again[0])
    with pytest.raises(ValueError, match="wgmma-bf16-rad slabs"):
        RK.launch_forward(rcfg, ws, bs, *rin, pack=RK.make_fwd_pack(rcfg, ws),
                          bf16=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k1_bwd_wgmma_f32_matches_f64_twin(cuda_device, n):
    """K1-bwd (csrc/geometry_bwd_wg.cu, 3xTF32 on wgmma) at full width,
    the step's 65,536 points and a ragged 9,001, against the f64 twin at
    chip_smoke.check_vjp's bound, two launches (the second on slab packs
    built anew) bitwise equal; a bf16 slab pack is refused, and so is a
    launch without slab packs."""
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(n, 3, device=cuda_device, generator=gen) * 0.5
    ct_out = torch.randn(n, ws[-1].shape[0], device=cuda_device,
                         generator=gen)
    ct_g = torch.randn(n, 3, device=cuda_device, generator=gen)
    flat = lambda r: [r[0], *r[1], *r[2]]
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    got = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs))
    again = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g,
                                    GK.make_bwd_slabs(cfg, ws, bf16=False)))
    ref = [t.float() for t in flat(GK.geometry_bwd_plain(
        [w.double() for w in ws], [b.double() for b in bs], x.double(),
        ct_out.double(), ct_g.double(), cfg))]
    twin = flat(GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg))
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    chip_smoke.check_vjp(f"K1-bwd N={n}", got, ref, twin, names)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="wgmma-f32"):
        GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g,
                           GK.make_bwd_slabs(cfg, ws))
    with pytest.raises(ValueError, match="make_bwd_slabs"):
        GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g)


@pytest.mark.gpu
def test_f32_mode_builds_the_f32_slabs(cuda_device):
    """kernel_weights() carries K1-fwd's and K1-bwd's two f32 slab packs
    (sweep32, rev32), which value_grad_feat hands to both: one K1-fwd and
    one K1-bwd launch; K1-fwd reads them without grad too, or with every
    parameter frozen, so they are built there as well, but not for the
    sweeps alone (k1=False); geometry() without them raises."""
    cfg, _, _, x = _net(CASES[0], cuda_device)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    weights = net.kernel_weights()
    assert weights.sweep32[1].operand == "wgmma-f32"
    assert weights.rev32[1].operand == "wgmma-f32-rev"
    assert weights.rev16 is None and "pack" not in weights._fields
    with torch.no_grad():
        assert net.kernel_weights().rev32 is not None
        assert net.kernel_weights(k1=False).rev32 is None
    kernels = (GK.K1_FWD, GK.K1_BWD, GK.K1_BWD_BF16)
    before = [k.launches for k in kernels]
    s, f, g = net.value_grad_feat(x, weights)
    (((g.norm(dim=-1) - 1) ** 2).mean() + (f ** 2).mean()
     + s.abs().mean()).backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0]
    with pytest.raises(ValueError, match="slabs"):
        GK.geometry(weights.ws, weights.bs, x, cfg)
    net.requires_grad_(False)
    assert net.kernel_weights().rev32 is not None


@pytest.mark.gpu
def test_bf16_mode_launches_the_bf16_kernels(cuda_device):
    """value_grad_feat(bf16=True) through autograd: one K1-fwd-bf16 launch
    and one K1-bwd-bf16, both on the two slab packs of
    kernel_weights(bf16=True), no f32 K1 launch; the f32 slab pack stays
    the K2 sweep's, and no mma.sync pack (3xTF32 or bf16) is built.
    Without grad the same slab packs are built: K1-fwd-bf16 reads both."""
    cfg, _, _, x = _net(CASES[0], cuda_device)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    weights = net.kernel_weights(bf16=True)
    assert not {"pack", "pack16"} & set(weights._fields)
    assert weights.rev32 is None
    assert weights.sweep32[1].operand == "wgmma-f32"
    assert weights.sweep16[1].operand == "wgmma-bf16"
    assert weights.rev16[1].operand == "wgmma-bf16-rev"
    with torch.no_grad():
        assert net.kernel_weights(bf16=True).rev16[1].operand == \
            "wgmma-bf16-rev"
    kernels = (GK.K1_FWD, GK.K1_BWD, GK.K1_FWD_BF16, GK.K1_BWD_BF16)
    before = [k.launches for k in kernels]
    s, f, g = net.value_grad_feat(x, weights, bf16=True)
    (((g.norm(dim=-1) - 1) ** 2).mean() + (f ** 2).mean()
     + s.abs().mean()).backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 1, 1]
    net.value_sweep(x, weights)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + [(8, 256, 257, (4,), 6, 1.0, n)
                                          for n in (32768, 9001)])
def test_k2_bf16_matches_twin(cuda_device, case):
    """K2-bf16 (the last layer narrowed) on the full network's slab pack
    against its twin and the f64 unrounded sweep (chip_smoke.check_flips),
    two launches bitwise equal, and bitwise equal to K2-bf16 on its own
    narrowed pack; the ladder's 32,768 rows and a ragged 9,001 at full
    width."""
    cfg, ws, bs, x = _net(case, cuda_device)
    wn, bn = ws[:-1] + [ws[-1][:1]], bs[:-1] + [bs[-1][:1]]
    pack = SK.make_sweep_pack(cfg, ws)
    got = SK.sdf_forward(wn, bn, cfg, x, pack, bf16=True)
    with torch.no_grad():
        twin = SK.sdf_forward_plain(wn, bn, cfg, x, bf16=True)
        ref = SK.sdf_forward_plain([w.double() for w in wn],
                                   [b.double() for b in bn], cfg, x.double())
    chip_smoke.check_flips(f"K2-bf16 {case}", [got], [twin], [ref.float()],
                           ["sdf"])
    assert torch.equal(got, SK.sdf_forward(wn, bn, cfg, x, pack, bf16=True))
    assert torch.equal(got, SK.sdf_forward(
        wn, bn, cfg, x, SK.make_sweep_pack(cfg, wn), bf16=True))


@pytest.mark.gpu
@pytest.mark.parametrize("case", RAD_CASES + [RAD_RAGGED])
def test_k3_bf16_kernels_match_twins(cuda_device, case):
    """K3-fwd-bf16 and K3-bwd-bf16 against their twins and the f64
    unrounded function (chip_smoke.check_flips; the backward's twin on the
    kernel's own ReLU masks, chip_smoke.k3_bwd_masks with bf16: in bf16
    the two forwards round pre-activations near 0 to opposite sides more
    often than in 3xTF32, so the masks are held to a margin of each
    element's bf16 rounding, in any number of places), two launches of
    each bitwise equal, both on wgmma from K3-bwd-bf16's two slab packs
    (K3-fwd-bf16 the first), K3-bwd-bf16 bitwise equal with and without
    its mask output."""
    cfg, net, inputs = _rad(case, cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct = torch.randn(inputs[0].shape[0], cfg.d_out, device=cuda_device,
                     generator=gen)
    flat = lambda r: [*r[:4], *r[4], *r[5]]
    w64, b64 = [w.double() for w in ws], [b.double() for b in bs]
    in64 = [t.double() for t in inputs]
    slabs = RK.make_bwd_slabs(cfg, ws)
    fwd = lambda: RK.launch_forward(cfg, ws, bs, *inputs, pack=slabs[0],
                                    bf16=True)
    bwd = lambda: flat(RK.launch_backward(cfg, ws, bs, *inputs, ct,
                                          pack=slabs, bf16=True))
    with torch.no_grad():
        tw_f = RK.radiance_plain(ws, bs, cfg, *inputs, bf16=True)
        ref_f = RK.radiance_plain(w64, b64, cfg, *in64).float()
    masks, _ = chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs, bf16=True)
    tw_b = flat(RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct, bf16=True,
                                      masks=masks))
    ref_b = [t.float() for t in flat(RK.radiance_bwd_plain(
        w64, b64, cfg, *in64, ct.double()))]
    names = ["ct_pts", "ct_normals", "ct_dirs", "ct_feat"] + [
        f"{k}{l}" for k in ("dW", "db") for l in range(len(ws))]
    got = fwd()
    chip_smoke.check_flips(f"K3-fwd-bf16 {case}", [got], [tw_f], [ref_f],
                           ["rgb"])
    assert torch.equal(got, fwd())
    got = bwd()
    chip_smoke.check_flips(f"K3-bwd-bf16 {case}", got, tw_b, ref_b, names)
    assert all(torch.equal(a, b) for a, b in zip(got, bwd()))
    own = []
    with_masks = flat(RK.launch_backward(cfg, ws, bs, *inputs, ct,
                                         pack=slabs, bf16=True, masks=own))
    assert all(torch.equal(a, b) for a, b in zip(got, with_masks))
    assert all(torch.equal(a, b) for a, b in zip(own, masks))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 9001])
def test_k3_bwd_bf16_wgmma_matches_twin(cuda_device, n):
    """K3-bwd-bf16 (csrc/radiance_bwd_bf16_wg.cu, on wgmma) at full width,
    the step's 65,536 rows and a ragged 9,001, against its twin on the
    kernel's own ReLU masks and the f64 unrounded function
    (chip_smoke.check_flips), two launches bitwise equal; an mma.sync pack
    is refused, and so is a launch without the slab packs."""
    cfg, net, inputs = _rad((256, 256, 4, 4, n), cuda_device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct = torch.randn(n, cfg.d_out, device=cuda_device, generator=gen)
    flat = lambda r: [*r[:4], *r[4], *r[5]]
    slabs = RK.make_bwd_slabs(cfg, ws)
    masks = []
    got = flat(RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=slabs,
                                  bf16=True, masks=masks))
    again = flat(RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=slabs,
                                    bf16=True))
    twin = flat(RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct, bf16=True,
                                      masks=masks))
    ref = [t.float() for t in flat(RK.radiance_bwd_plain(
        [w.double() for w in ws], [b.double() for b in bs], cfg,
        *[t.double() for t in inputs], ct.double()))]
    L = len(ws)
    names = ["ct_pts", "ct_normals", "ct_dirs", "ct_feat"] + [
        f"{k}{l}" for k in ("dW", "db") for l in range(L)]
    chip_smoke.check_flips(f"K3-bwd-bf16 N={n}", got, twin, ref, names)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="wgmma"):
        RK.launch_backward(cfg, ws, bs, *inputs, ct,
                           pack=(_row_major(ws),) * 2, bf16=True)
    with pytest.raises(ValueError, match="none was given"):
        RK.launch_backward(cfg, ws, bs, *inputs, ct, bf16=True)


@pytest.mark.gpu
def test_bf16_switches_launch_the_bf16_kernels(cuda_device):
    """A stage-1 render + backward with core_act_bf16 and
    use_pallas_sampling (narrow widths): K2-bf16 four times and no K2,
    K1-fwd-bf16, K1-bwd-bf16, K3-fwd-bf16 and K3-bwd-bf16 once and no f32
    K1 or K3, every slab pack built once and no mma.sync pack; then stage
    2's lvis_render at the defaults: the coarse sweep on K2-bf16, once,
    and K2 five times."""
    cfg = TR.RendererConfig(
        n_samples=16, n_importance=16, up_sample_steps=4,
        sdf=SDFConfig(n_layers=4, d_hidden=64, d_out=65, skip_in=(2,),
                      multires=4),
        rendering=RenderingConfig(d_feature=64, d_hidden=64, n_layers=3),
        refcolor=RefColorConfig(d_feature=64), core_act_bf16=True,
        use_pallas_sampling=True)
    model = TR.Stage2Model(cfg, seed=0).to(cuda_device)
    rng = np.random.RandomState(0)
    o = rng.randn(32, 3) * 0.1 + np.array([0.0, 0.0, -3.0])
    d = np.array([0.0, 0.0, 1.0]) + rng.randn(32, 3) * 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
            for a in (o, d))
    near, far = RAYS.near_far_from_sphere(o, d)
    kernels = (SK.SDF_FWD, SK.SDF_FWD_BF16, GK.K1_FWD, GK.K1_BWD,
               GK.K1_FWD_BF16, GK.K1_BWD_BF16, RK.K3_FWD, RK.K3_BWD,
               RK.K3_FWD_BF16, RK.K3_BWD_BF16)
    geo = TR.Stage1Model(cfg, seed=0).to(cuda_device)
    weights = geo.kernel_weights(True, True)
    assert not any({"pack", "pack16"} & set(w._fields) for w in weights)
    assert [w[1].operand for w in (weights[1].sweep16, weights[1].rev16)] \
        == ["wgmma-bf16-rad", "wgmma-bf16-rad-rev"]
    assert (weights[1].sweep32, weights[1].rev32) == (None, None)
    with torch.no_grad():
        no_grad = geo.kernel_weights(True, True)[1]
        assert no_grad.sweep16[1].operand == "wgmma-bf16-rad"
        assert (no_grad.rev16, no_grad.sweep32, no_grad.rev32) == \
            (None,) * 3
    before = [k.launches for k in kernels]
    out = TR.render(geo, cfg, o, d, near, far, weights=weights)
    (out["color_fine"].sum() + out["gradient_error"].sum()).backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        0, 4, 0, 0, 1, 1, 0, 0, 1, 1]
    cfg2 = dataclasses.replace(cfg, core_act_bf16=False,
                               use_pallas_sampling=False)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        TR.lvis_render(model, cfg2, o, d, near, far,
                       generator=torch.Generator(device=cuda_device))
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        5, 1, 3, 0, 0, 0, 1, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", chip_smoke.BLOCK_VARIANTS,
                         ids=[v[0] for v in chip_smoke.BLOCK_VARIANTS])
def test_block_graph_follows_the_eager_steps(cuda_device, tmp_path,
                                             variant):
    """train.block_steps = 8 on the card (a captured step, replayed)
    against eager steps at full width: bit for bit, or within the
    stage-1 step's tolerance (chip_smoke.block_graph_variant)."""
    out = chip_smoke.block_graph_variant(str(tmp_path), "", *variant)
    assert out["bitwise"] or out["worst_ratio"] <= 1.0


@pytest.mark.gpu
def test_block_graph_debug_nans_stops_at_the_replay(cuda_device, tmp_path):
    """Under debug_nans a NaN that reaches the graph's loss stops the run
    at that step (checked after each replay); the count and moments of a
    capturable Adam live on the card, and load back there."""
    from factored_neus_tpu_torch.data.datasets import make_dataset
    from factored_neus_tpu_torch.train import common as TC
    from factored_neus_tpu_torch.train.stage1 import Stage1Trainer
    from factored_neus_tpu_torch.utils import config as CFG
    from factored_neus_tpu_torch.utils import logging as LOG

    conf = CFG.load(chip_smoke.write_conf(str(tmp_path), 16), "sphere")
    ds = make_dataset("dtu", conf["dataset"], cuda_device)
    cfg = CFG.renderer_config(conf)
    tcfg = TC.TrainConfig.from_conf(conf)
    model = TR.Stage1Model(cfg, seed=0, device=cuda_device)
    trainer = Stage1Trainer(model, cfg, tcfg, ds.train_data(), seed=1)
    idxs = [i % ds.n_images for i in range(8)]
    with LOG.debug_nans(True):
        trainer.run_block(0, idxs, graph=True)
        assert trainer.replays == 8 - TC.WARMUP_STEPS
        with torch.no_grad():
            model.sdf.lin0.bias.fill_(float("nan"))
        with pytest.raises(FloatingPointError, match="loss at step 8$"):
            trainer.run_block(8, idxs, graph=True)
    leaves = TC.optimizer_leaves(model, trainer.opt)
    fresh = TC.make_optimizer(model, tcfg)
    TC.load_optimizer_leaves(model, fresh, leaves)
    assert all(st["step"].device == p.device and st["step"].is_cuda
               for p, st in fresh.state.items())
    assert fresh.defaults["capturable"]
