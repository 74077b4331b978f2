"""chip_smoke.py's guard on K3-bwd's ReLU masks, on the CPU: the f64 twin
takes the masks of the kernel's own forward only where they differ from
the f32 forward's within rounding of 0.  A stand-in for K3-bwd fills its
mask output from the plain f32 forward (for K3-bwd-bf16: from the plain
bf16 forward), with or without an injected fault; the guard passes a flip
at a pre-activation within its margin and fails a row of zeroed
activations and a flip far from 0."""
import numpy as np
import pytest
import torch

import chip_smoke
from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                   RenderingNetwork)
from factored_neus_tpu_torch.ops import _cuda
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP
from factored_neus_tpu_torch.ops.embedder import positional_encoding

N = 500                     # 3 chunks of 3 blocks x 64 rows, the last ragged


def _x0(cfg, pts, normals, dirs, feat):
    return torch.cat([pts, positional_encoding(dirs, cfg.multires_view),
                      normals, feat], -1)


def _stand_in(fault):
    """K3-bwd's mask output (launch_backward's ``masks``) as the plain f32
    forward gives it, with ``fault(l, a, h)`` applied."""
    def launch(cfg, ws, bs, pts, normals, dirs, feat, ct, pack=None,
               bf16=False, masks=None):
        assert not bf16 and pack[0][1].operand == "wgmma-f32-rad"
        h = _x0(cfg, pts, normals, dirs, feat)
        for l in range(len(ws) - 1):
            a = torch.nn.functional.linear(h, ws[l], bs[l])
            h = torch.relu(a)
            masks.append(fault(l, a, h.clone()) > 0)
    return launch


def _flip_near_zero(l, a, h):
    """Every layer-0 pre-activation within 2e-7 of 0 to the other side."""
    if l == 0:
        near = a.abs() < 2e-7
        h[near] = torch.where(a[near] > 0, 0.0, 1e-9)
    return h


def _flip_row(l, a, h):
    """Row 5's first layer-0 unit to the other side, wherever it lies."""
    if l == 0:
        h[5, 0] = 0.0 if a[5, 0] > 0 else 1.0
    return h


def _zero_row(l, a, h):
    if l == 1:
        h[5] = 0.0
    return h


@pytest.mark.parametrize("fault,near_zero,passes", [
    (lambda l, a, h: h, False, True),
    (_flip_near_zero, True, True),
    (_flip_row, False, False),
    (_zero_row, False, False),
])
def test_k3_bwd_mask_guard(monkeypatch, fault, near_zero, passes):
    cfg = RenderingConfig(d_feature=32, d_hidden=64, n_layers=3,
                          multires_view=4)
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = [list(t) for t in net.effective_weights()]
    rng = np.random.RandomState(1)
    dirs = rng.randn(N, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.randn(N, 3) * 0.4, rng.randn(N, 3), dirs,
        rng.randn(N, 32) * 0.5)]
    if near_zero:
        # row 0's first layer-0 pre-activation to within f32 rounding of 0,
        # by the bias of its unit
        with torch.no_grad():
            a = torch.nn.functional.linear(_x0(cfg, *inputs), ws[0], bs[0])
            bs[0] = bs[0].clone()
            bs[0][0] -= a[0, 0] - 1e-9
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: 3)
    monkeypatch.setattr(RK, "launch_backward", _stand_in(fault))
    if passes:
        masks, text = chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs)
        assert [tuple(m.shape) for m in masks] == [(N, 64)] * 3
        assert f", {int(near_zero)} on the other side" in text
    else:
        with pytest.raises(AssertionError, match="beyond rounding"):
            chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs)


def _stand_in_bf16(fault):
    """K3-bwd-bf16's mask output (launch_backward's ``masks``) as its
    twin's bf16 forward gives it, with ``fault(l, a, h)`` applied."""
    def launch(cfg, ws, bs, pts, normals, dirs, feat, ct, pack=None,
               bf16=False, masks=None):
        assert bf16 and pack is not None
        h = _x0(cfg, pts, normals, dirs, feat)
        for l in range(len(ws) - 1):
            a = TP.mm_bf16(h, ws[l].t()) + bs[l]
            h = torch.relu(a)
            masks.append(fault(l, a, h.clone()) > 0)
    return launch


def _flip_within_bf16_rounding(l, a, h):
    """Every layer-1 pre-activation within 1e-4 of 0 to the other side:
    well inside one bf16 ulp of its inputs' terms."""
    if l == 1:
        near = a.abs() < 1e-4
        h[near] = torch.where(a[near] > 0, 0.0, 1e-9)
    return h


@pytest.mark.parametrize("fault,flipped,passes", [
    (lambda l, a, h: h, False, True),
    (_flip_within_bf16_rounding, True, True),
    (_flip_row, False, False),
    (_zero_row, False, False),
])
def test_k3_bwd_bf16_mask_guard(monkeypatch, fault, flipped, passes):
    """The bf16 guard (k3_bwd_masks with bf16): the masks of K3-bwd-bf16's
    forward against its twin's bf16 forward may differ wherever a
    pre-activation lies within BF16_MASK_ULP x sum|x w| of 0, in any
    number of places, and nowhere else: a flip far from 0 and a row of
    zeroed activations fail."""
    cfg = RenderingConfig(d_feature=32, d_hidden=64, n_layers=3,
                          multires_view=4)
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ws, bs = [list(t) for t in net.effective_weights()]
    rng = np.random.RandomState(1)
    dirs = rng.randn(N, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.randn(N, 3) * 0.4, rng.randn(N, 3), dirs,
        rng.randn(N, 32) * 0.5)]
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: 3)
    monkeypatch.setattr(RK, "launch_backward", _stand_in_bf16(fault))
    if passes:
        masks, text = chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs,
                                              bf16=True)
        assert [tuple(m.shape) for m in masks] == [(N, 64)] * 3
        n = int(text.split(", ")[1].split(" on the other side")[0])
        assert (n > 0) == flipped, text
    else:
        with pytest.raises(AssertionError, match="beyond rounding"):
            chip_smoke.k3_bwd_masks(cfg, ws, bs, inputs, bf16=True)
