"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA device and nvcc; every test carries the ``gpu`` marker and
skips elsewhere.  The file imports neither JAX nor the JAX package, so on
a machine without them it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import sdf_kernel as SK


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
    out_k, grad_k = GK.launch_forward(cfg, x, ws, bs)
    with torch.no_grad():
        out_p, grad_p = GK.geometry_plain(ws, bs, x, cfg)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(grad_k, grad_p, atol=1e-5, rtol=0)

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ct_out = torch.randn(out_p.shape, device=cuda_device, generator=gen)
    ct_g = torch.randn(x.shape, device=cuda_device, generator=gen)
    ct_x, dws, dbs = GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g)
    leaves = [t.clone().requires_grad_(True) for t in [x, *ws, *bs]]
    L = len(ws)
    o, g = GK.geometry_plain(leaves[1:1 + L], leaves[1 + L:], leaves[0], cfg)
    ref = torch.autograd.grad((o, g), leaves, (ct_out, ct_g))
    for a, b in zip([ct_x, *dws, *dbs], ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_sdf_sweep_kernel_matches_twin(cuda_device, case):
    cfg, ws, bs, x = _net(case, cuda_device)
    for wn, bn in ((ws, bs), (ws[:-1] + [ws[-1][:1]], bs[:-1] + [bs[-1][:1]])):
        with torch.no_grad():
            want = SK.sdf_forward_plain(wn, bn, cfg, x)
        torch.testing.assert_close(SK.sdf_forward(wn, bn, cfg, x), want,
                                   atol=1e-5, rtol=0)


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
