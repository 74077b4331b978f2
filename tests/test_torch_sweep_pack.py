"""K2-bf16's slab pack (tc_pack.pack_sweep_bf16) and the kernel's slab
arithmetic in plain PyTorch (sdf_kernel.sdf_forward_slabs), on the CPU;
and, on a card, the kernel against its twin.

The file imports neither JAX nor the JAX package: its twin,
sdf_forward_plain(bf16=True), is held against the JAX package's bf16
Pallas body by tests/test_torch_bf16_sweep.py.
"""
import numpy as np
import pytest
import torch

from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP

# the twins' bf16 tolerance (tests/test_torch_bf16.py TWIN_RTOL): the slab
# sums and the twin's products round the same operands, so they part only
# where a pre-activation within f32 rounding of a bf16 boundary rounds to
# its two neighbours; relative to 1 + the largest entry
TWIN_RTOL = 1e-3

NETS = {  # (n_layers, d_hidden, d_out, skip_in, multires, scale)
    "full width": (8, 256, 257, (4,), 6, 1.0),
    "3 x 64, skip": (3, 64, 65, (2,), 4, 1.5),
    "2 x 64, no skip": (2, 64, 65, (), 4, 1.0),
}


def _net(key, device="cpu"):
    L, h, d_out, skip, multires, scale = NETS[key]
    cfg = SDFConfig(n_layers=L, d_hidden=h, d_out=d_out, skip_in=skip,
                    multires=multires, scale=scale)
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    return cfg, list(ws), list(bs)


def _narrow(ws, bs):
    return ws[:-1] + [ws[-1][:1]], bs[:-1] + [bs[-1][:1]]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("key", list(NETS))
def test_sweep_pack_reads_back_rounded_wt(key, narrow):
    """Read back through the swizzle's inverse (tc_pack.sweep_block),
    every layer's slabs hold bf16(W^T) exactly at sweep_k_rows' rows (a
    skip layer's reordered [h | pad | enc | pad]) and zero elsewhere: the
    hidden layers 256 columns wide, the last layer 264 (full) or 8
    (narrowed); every weight lands once, and nothing else is nonzero."""
    cfg, ws, bs = _net(key)
    if narrow:
        ws, bs = _narrow(ws, bs)
    pack, lay = SK.make_sweep_pack(cfg, ws)
    assert pack.dtype == torch.float32 and 4 * pack.numel() == lay.nbytes
    assert lay.cols[-1] == (8 if narrow else 264)
    total = 0.0
    for l, w in enumerate(ws):
        blk = TP.sweep_block(pack, lay, l)
        assert blk.shape == (64 * lay.nslab[l], lay.cols[l])
        rows = torch.from_numpy(TP.sweep_k_rows(lay, l, w.shape[1],
                                                cfg.d_embed))
        want = torch.zeros_like(blk)
        want[rows, :w.shape[0]] = TP.bf16_round(w.t())
        assert torch.equal(blk, want), l
        total += float(want.double().pow(2).sum())
    flat = pack.view(torch.bfloat16).double()
    assert float(flat.pow(2).sum()) == pytest.approx(total, rel=1e-12)


def test_swizzle_is_the_128_byte_pattern():
    """swizzle128 moves 16-byte chunk c of a slab's column n to chunk
    c ^ (n % 8), within its own 128-byte row, and is its own inverse."""
    e = np.arange(264 * TP.SLAB_K)
    sw = TP.swizzle128(e)
    assert np.array_equal(TP.swizzle128(sw), e)
    n, k = e // 64, e % 64
    assert np.array_equal(sw // 64, n)
    assert np.array_equal((sw % 64) // 8, (k // 8) ^ (n % 8))
    assert np.array_equal(sw % 8, k % 8)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("key", ["3 x 64, skip", "2 x 64, no skip"])
def test_slab_sums_match_twin(key, narrow):
    """sdf_forward_slabs (the kernel's arithmetic over its pack: padded
    widths, a float32 sum of the slabs' products in order) against the
    twin sdf_forward_plain(bf16=True) on 300 rows, within TWIN_RTOL; the
    narrowed last layer read from the full network's pack."""
    cfg, ws, bs = _net(key)
    pack = SK.make_sweep_pack(cfg, ws)
    if narrow:
        ws, bs = _narrow(ws, bs)
    x = torch.from_numpy((np.random.RandomState(1).randn(300, 3) * 0.4)
                         .astype(np.float32))
    with torch.no_grad():
        got = SK.sdf_forward_slabs(pack, bs, cfg, x, ws[-1].shape[0])
        twin = SK.sdf_forward_plain(ws, bs, cfg, x, bf16=True)
    assert got.shape == twin.shape
    tol = TWIN_RTOL * (1 + float(twin.abs().max()))
    assert float((got - twin).abs().max()) <= tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [300, 8192, 9001])
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("key", list(NETS))
def test_k2_bf16_kernel_matches_twin(cuda_device, key, narrow, rows):
    """The kernel on the full network's slab pack, narrowed or full,
    against its twin and the f64 unrounded function
    (chip_smoke.check_flips), and two launches bitwise equal: one consumer
    warpgroup a block at 300 and 8,192 rows, two at 9,001."""
    import chip_smoke
    cfg, ws, bs = _net(key, cuda_device)
    pack = SK.make_sweep_pack(cfg, ws)
    if narrow:
        ws, bs = _narrow(ws, bs)
    x = torch.from_numpy((np.random.RandomState(2).randn(rows, 3) * 0.4)
                         .astype(np.float32)).to(cuda_device)
    got = SK.sdf_forward(ws, bs, cfg, x, pack, bf16=True)
    with torch.no_grad():
        twin = SK.sdf_forward_plain(ws, bs, cfg, x, bf16=True)
        ref = SK.sdf_forward_plain([w.double() for w in ws],
                                   [b.double() for b in bs], cfg,
                                   x.double()).float()
    split = lambda t: [t[:, :1], t[:, 1:]] if t.shape[1] > 1 else [t]
    chip_smoke.check_flips(f"K2-bf16 {key} narrow={narrow} N={rows}",
                           split(got), split(twin), split(ref),
                           ["sdf", "feature"])
    assert torch.equal(got, SK.sdf_forward(ws, bs, cfg, x, pack, bf16=True))
