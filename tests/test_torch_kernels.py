"""K1 (geometry forward + backward) and K2 (SDF sweep) of the PyTorch port
against the JAX package: the plain twins the port runs on the CPU are held
against the XLA path and against the Pallas kernels in interpret mode, at
the sizes and tolerances of tests/test_pallas_geometry.py.  The CUDA
kernels themselves are held against the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factored_neus_tpu.models import fields as F
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu.ops.pallas_sdf import sdf_forward_pallas
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import sdf_kernel as SK

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _setup(scale=1.0, skip=(2,), n=150, seed=0):
    kw = dict(d_out=65, d_hidden=64, n_layers=4, skip_in=skip, multires=4,
              scale=scale)
    jcfg = F.SDFConfig(**kw)
    params = F.sdf_init(jax.random.PRNGKey(seed), jcfg)
    net = TF.SDFNetwork(TF.SDFConfig(**kw))
    bridge.load_layers(net, jax.tree_util.tree_map(np.asarray, params))
    x = (np.random.RandomState(seed + 1).randn(n, 3) * 0.4).astype(np.float32)
    return jcfg, params, net, x


def _loss_terms_jax(s, f, g, x):
    eik = jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)
    return (eik + jnp.mean(jnp.sum(g * x, -1) * s) + jnp.mean(f ** 2)
            + jnp.mean(jnp.abs(s)))


def _loss_terms_torch(s, f, g, x):
    eik = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    return (eik + torch.mean(torch.sum(g * x, -1) * s) + torch.mean(f ** 2)
            + torch.mean(torch.abs(s)))


CASES = [(1.0, (2,)), (1.5, (2,)), (1.0, ())]


@pytest.mark.parametrize("scale,skip", CASES)
def test_k1_twin_forward_matches_jax(scale, skip):
    jcfg, params, net, x = _setup(scale, skip)
    s, f, g = net.value_grad_feat(torch.from_numpy(x))
    for ref in (F.sdf_value_and_grad_feat(params, jcfg, jnp.asarray(x)),
                PG.sdf_value_grad_feat_pallas(params, jcfg, jnp.asarray(x),
                                              bf16=False, block_rows=64)):
        for a, b in zip((s, f, g), ref):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-5)


@pytest.mark.parametrize("scale,skip", CASES)
def test_k1_twin_backward_matches_jax(scale, skip):
    """Loss, d/dx and every g/v/b gradient through the port's twin against
    jax.grad through the XLA path and through the Pallas custom VJP."""
    jcfg, params, net, x = _setup(scale, skip)
    xt = torch.from_numpy(x).requires_grad_(True)
    s, f, g = net.value_grad_feat(xt)
    lt = _loss_terms_torch(s, f, g, xt)
    lt.backward()
    tgrads = bridge.jax_tree_layers(net, grads=True)

    def loss_xla(p, x):
        return _loss_terms_jax(*F.sdf_value_and_grad_feat(p, jcfg, x), x)

    def loss_pallas(p, x):
        return _loss_terms_jax(*PG.sdf_value_grad_feat_pallas(
            p, jcfg, x, bf16=False, block_rows=64), x)

    for fn in (loss_xla, loss_pallas):
        lj = float(fn(params, jnp.asarray(x)))
        np.testing.assert_allclose(float(lt), lj, rtol=1e-5)
        gp, gx = jax.grad(fn, argnums=(0, 1))(params, jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=2e-5, rtol=1e-4, err_msg="d/dx")
        for a, b in zip(jax.tree_util.tree_leaves(tgrads),
                        jax.tree_util.tree_leaves(gp)):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-5,
                                       rtol=1e-4)


@pytest.mark.parametrize("scale,skip", [(1.0, (2,)), (1.5, ())])
def test_k2_twin_matches_jax(scale, skip):
    jcfg, params, net, x = _setup(scale, skip)
    xt = torch.from_numpy(x)
    sweep = net.value_sweep(xt).numpy()
    np.testing.assert_allclose(sweep, np.asarray(
        F.sdf_value_sweep(params, jcfg, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(sweep, np.asarray(sdf_forward_pallas(
        params, jcfg, jnp.asarray(x), block_rows=64)), atol=1e-5)
    ws, bs = net.effective_weights()
    full = SK.sdf_forward(ws, bs, net.cfg, xt)
    assert not full.requires_grad
    np.testing.assert_allclose(full.numpy(), np.asarray(sdf_forward_pallas(
        params, jcfg, jnp.asarray(x), full_out=True, block_rows=64)),
        atol=1e-5)


def test_cpu_path_launches_no_kernel():
    _, _, net, x = _setup()
    before = (GK.K1_FWD.launches, GK.K1_BWD.launches, SK.SDF_FWD.launches)
    xt = torch.from_numpy(x).requires_grad_(True)
    s, f, g = net.value_grad_feat(xt)
    (s.sum() + g.sum()).backward()
    net.value_sweep(xt)
    assert (GK.K1_FWD.launches, GK.K1_BWD.launches,
            SK.SDF_FWD.launches) == before


def test_kernel_arguments_describe_the_network():
    """The integer arguments handed to the kernels, at full width."""
    net = TF.SDFNetwork(TF.SDFConfig())
    ws, _ = net.effective_weights()
    iargs, ld = SK.kernel_iargs(net.cfg, ws, n=1000, grid=7)
    L = 9
    assert iargs[:7] == [L, 6, 39, 260, 1 << 4, 1000, 7]
    assert iargs[7:7 + L] == [39, 256, 256, 256, 256, 256, 256, 256, 256]
    assert iargs[7 + L:] == [256, 256, 256, 217, 256, 256, 256, 256, 257]
    assert ld == 260
    with pytest.raises(ValueError):
        SK.kernel_iargs(TF.SDFConfig(d_hidden=512), [
            torch.zeros(512, 39)] + [torch.zeros(512, 512)] * 2, 10, 1)
