"""K1 (geometry forward + backward) and K2 (SDF sweep) of the PyTorch port
against the JAX package: the plain twins the port runs on the CPU are held
against the XLA path and against the Pallas kernels in interpret mode, at
the sizes and tolerances of tests/test_pallas_geometry.py.  The CUDA
kernels themselves are held against the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import os
import subprocess
import sys

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
from factored_neus_tpu_torch.ops import tc_pack as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    kernels = (GK.K1_FWD, GK.K1_BWD, GK.K1_BWD_SPLIT, SK.SDF_FWD)
    before = [k.launches for k in kernels]
    xt = torch.from_numpy(x).requires_grad_(True)
    for stacked in (True, False):
        out, g = GK.geometry(*net.effective_weights(), xt, net.cfg,
                             stacked=stacked)
        (out[:, 0].sum() + g.sum()).backward()
    net.value_sweep(xt)
    assert [k.launches for k in kernels] == before


def test_kernel_arguments_describe_the_network():
    """The integer arguments handed to K2, at full width: the layers, the
    last layer's slab width, then the f32 slab pack's layer offsets; the
    narrowed sweep reads the full network's pack (264-wide last slabs) or
    its own (256); a network wider than the slabs is refused."""
    net = TF.SDFNetwork(TF.SDFConfig())
    ws, _ = net.effective_weights()
    _, lay = SK.make_sweep_pack(net.cfg, ws, bf16=False)
    p = SK.sweep_wg_plan(net.cfg, ws, n=1000, lay=lay, sms=7)
    iargs = p["iargs"]
    L = 9
    assert iargs[:7] == [L, 6, 39, 1000, 7, 16, 264]
    assert (p["grid"], p["tiles"]) == (7, 16)
    assert iargs[7:7 + L] == [39, 256, 256, 256, 256, 256, 256, 256, 256]
    assert iargs[7 + L:7 + 2 * L] == [256, 256, 256, 217, 256, 256, 256, 256,
                                      257]
    assert iargs[7 + 2 * L:] == [*lay.enc, *lay.off]
    assert lay.enc == [1, 0, 0, 0, 1, 0, 0, 0, 0]
    narrowed = ws[:-1] + [ws[-1][:1]]
    for ly, cols in ((lay, 264), (SK.make_sweep_pack(
            net.cfg, narrowed, bf16=False)[1], 256)):
        iargs = SK.sweep_wg_plan(net.cfg, narrowed, 1000, ly, 7)["iargs"]
        assert iargs[6] == cols and iargs[7 + 2 * L - 1] == 1
    with pytest.raises(ValueError):
        SK.sweep_wg_plan(TF.SDFConfig(d_hidden=512), [
            torch.zeros(512, 39)] + [torch.zeros(512, 512)] * 2, 10, lay, 1)


@pytest.mark.parametrize("skip", [(2,), ()])
def test_k1_split_twin_backward_matches_jax(skip):
    """K1-bwd-split's function: the port's geometry with stacked=False
    (on the CPU, K1-bwd's twin) against jax.grad through the Pallas
    split-chain backward (stacked=False, interpret mode): the loss, d/dx
    and every g/v/b gradient at the JAX test's tolerance."""
    jcfg, params, net, x = _setup(1.0, skip)
    xt = torch.from_numpy(x).requires_grad_(True)
    ws, bs = net.effective_weights()
    out, g = GK.geometry(ws, bs, xt, net.cfg, stacked=False)
    lt = _loss_terms_torch(out[:, 0], out[:, 1:], g, xt)
    lt.backward()
    tgrads = bridge.jax_tree_layers(net, grads=True)

    def loss_split(p, x):
        return _loss_terms_jax(*PG.sdf_value_grad_feat_pallas(
            p, jcfg, x, bf16=False, block_rows=64, stacked=False), x)

    np.testing.assert_allclose(float(lt), float(loss_split(
        params, jnp.asarray(x))), rtol=1e-5)
    gp, gx = jax.grad(loss_split, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-5,
                               rtol=1e-4, err_msg="d/dx")
    for a, b in zip(jax.tree_util.tree_leaves(tgrads),
                    jax.tree_util.tree_leaves(gp), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)


def test_stacked_switch_is_read_at_import():
    """FNEUS_PG_STACKED=0 turns STACKED_BWD off in a fresh process, as
    the JAX package's switch of the same name does; unset, it is on."""
    code = ("from factored_neus_tpu_torch.ops import geometry_kernel as GK; "
            "print(GK.STACKED_BWD, GK.STASH_BWD)")
    for env, want in (({"FNEUS_PG_STACKED": "0"}, "False False"),
                      ({}, "True False")):
        base = {k: v for k, v in os.environ.items()
                if k not in ("FNEUS_PG_STACKED", "FNEUS_PG_HBM_STASH")}
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env={**base, **env}, capture_output=True,
                             text=True, timeout=120, check=True).stdout
        assert out.split() == want.split(), (env, out)


def test_stash_switch_takes_precedence_over_split(monkeypatch):
    """With both switches set, geometry() runs the stash pair (whose
    gradients differ from the exact ones), as _make_geom does."""
    _, _, net, x = _setup()
    ws, bs = net.effective_weights()

    def grad_x(**kw):
        xt = torch.from_numpy(x).requires_grad_(True)
        out, g = GK.geometry(ws, bs, xt, net.cfg, **kw)
        (xg,) = torch.autograd.grad(
            _loss_terms_torch(out[:, 0], out[:, 1:], g, xt), xt)
        return xg

    stash, exact = grad_x(stash=True), grad_x(stash=False, stacked=False)
    monkeypatch.setattr(GK, "STACKED_BWD", False)
    monkeypatch.setattr(GK, "STASH_BWD", True)
    assert torch.equal(grad_x(), stash)
    assert not torch.equal(stash, exact)
