"""The HBM-stash geometry pair (K1-fwd-stash, K1-bwd-stash) of the PyTorch
port against the JAX package's stash variant
(sdf_value_grad_feat_pallas(stash=True), interpret mode) and its XLA path,
and one stage-1 step with the stash switched on in both packages.  The
CUDA kernels themselves are held against the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import CASES, _loss_terms_jax, _loss_terms_torch, \
    _setup
from test_torch_stage1 import GROUPS, _batch, _jax_loss_and_grads
from test_torch_render import build_pair

from factored_neus_tpu.models import fields as F
from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _stash_pallas(params, jcfg, x):
    return PG.sdf_value_grad_feat_pallas(params, jcfg, x, bf16=False,
                                         block_rows=64, stash=True)


def worst_ratio(a, b, atol, rtol):
    """max |a - b| / (atol + rtol max|b|) over one tensor: a weight
    gradient sums many rows, so its error scales with the tensor."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (atol + rtol * np.abs(b).max()))


def close_in_direction(a, b, name):
    """The JAX test's criterion for the stash class against the f32 XLA
    path (test_pallas_geometry.test_hbm_stash_backward_close)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    denom = np.linalg.norm(b)
    assert denom > 0.0, name
    rel = np.linalg.norm(a - b) / denom
    assert rel < 0.05, f"{name}: relative grad error {rel:.4f}"
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * denom + 1e-12))
    assert cos > 0.999, f"{name}: cosine {cos:.5f}"


@pytest.mark.parametrize("scale,skip", CASES)
def test_stash_forward_twin_matches_jax(scale, skip):
    """(out, grad) are exact f32 (the stash never feeds them); the stash
    is the hidden pre-activations rounded to bf16."""
    jcfg, params, net, x = _setup(scale, skip)
    ws, bs = net.effective_weights()
    out, grad, stash = GK.geometry_fwd_stash_plain(ws, bs,
                                                   torch.from_numpy(x), net.cfg)
    s, f, g = _stash_pallas(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(s), atol=1e-5)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(f), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g), atol=1e-5)
    assert stash.dtype == torch.bfloat16
    assert tuple(stash.shape) == (x.shape[0], GK.stash_columns(ws))
    pre = []
    with torch.no_grad():
        GK.sdf_forward_plain(ws, bs, net.cfg, torch.from_numpy(x), pre)
    assert torch.equal(stash, torch.cat(pre, -1).to(torch.bfloat16))


@pytest.mark.parametrize("scale,skip", CASES)
def test_stash_backward_twin_matches_jax(scale, skip):
    """Loss, d/dx and every g/v/b gradient through the port's stash pair
    against jax.grad through the JAX stash variant (per tensor: a rare
    one-ulp bf16 flip where the two packages' f32 pre-activations round
    differently), and against the f32 XLA path at the JAX test's
    direction-and-magnitude criterion."""
    jcfg, params, net, x = _setup(scale, skip)
    xt = torch.from_numpy(x).requires_grad_(True)
    ws, bs = net.effective_weights()
    out, g = GK.geometry(ws, bs, xt, net.cfg, stash=True)
    lt = _loss_terms_torch(out[:, 0], out[:, 1:], g, xt)
    lt.backward()
    tgrads = jax.tree_util.tree_leaves(bridge.jax_tree_layers(net,
                                                              grads=True))

    def loss(fn):
        return lambda p, x: _loss_terms_jax(*fn(p, jcfg, x), x)

    xj = jnp.asarray(x)
    stash_loss = loss(_stash_pallas)
    np.testing.assert_allclose(float(lt.detach()),
                               float(stash_loss(params, xj)), rtol=1e-5)
    gp, gx = jax.grad(stash_loss, argnums=(0, 1))(params, xj)
    ratios = [worst_ratio(xt.grad.numpy(), gx, 2e-5, 1e-4)]
    ratios += [worst_ratio(a, b, 2e-5, 1e-4)
               for a, b in zip(tgrads, jax.tree_util.tree_leaves(gp))]
    print(f"stash backward, scale {scale} skip {skip}: worst ratio to "
          f"(2e-5 + 1e-4 max|ref|) against JAX {max(ratios):.3f}")
    assert max(ratios) <= 1.0, ratios

    rp, rx = jax.grad(loss(F.sdf_value_and_grad_feat), argnums=(0, 1))(
        params, xj)
    close_in_direction(xt.grad.numpy(), rx, "d/dx")
    for i, (a, b) in enumerate(zip(tgrads, jax.tree_util.tree_leaves(rp))):
        close_in_direction(a, b, f"param[{i}]")


def test_stash_switch_selects_the_pair(monkeypatch):
    """geometry() takes its default from STASH_BWD: with it on, the step's
    gradients are the stash pair's, which differ from the exact ones."""
    _, _, net, x = _setup()
    ws, bs = net.effective_weights()

    def grads():
        xt = torch.from_numpy(x).requires_grad_(True)
        out, g = GK.geometry(ws, bs, xt, net.cfg)
        (xg,) = torch.autograd.grad(
            _loss_terms_torch(out[:, 0], out[:, 1:], g, xt), xt)
        return xg

    exact = grads()
    monkeypatch.setattr(GK, "STASH_BWD", True)
    stashed = grads()
    assert not torch.equal(exact, stashed)
    torch.testing.assert_close(stashed, exact, atol=1e-2, rtol=0.05)


def test_stage1_step_with_the_stash_matches_jax(monkeypatch):
    """One stage-1 step on the same weights, batch and jitter with the
    HBM-stash pair on in both packages (the JAX side through its Pallas
    geometry core in interpret mode): the loss at rtol 1e-5 and every
    parameter gradient per tensor at the stash pair's tolerance."""
    monkeypatch.setattr(PG, "STASH_BWD", True)
    monkeypatch.setattr(GK, "STASH_BWD", True)
    jcfg, jparams, cfg, model = build_pair()
    jcfg = dataclasses.replace(jcfg, use_pallas_geometry=True)
    o, d, rgb, mask = _batch()
    step = 20
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)
    key = jax.random.PRNGKey(11)
    k1, _ = jax.random.split(key)
    t_rand = torch.from_numpy(np.asarray(
        jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))
    (jl, jg), _ = _jax_loss_and_grads(jcfg, jparams, tcfg, o, d, rgb, mask,
                                      key, step)
    t = torch.from_numpy
    before = GK.K1_FWD_STASH.launches, GK.K1_BWD_STASH.launches
    tl, _ = TS1.loss_on_batch(model, cfg, tcfg, t(o), t(d), t(rgb), t(mask),
                              step, t_rand=t_rand)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tl.backward()
    assert (GK.K1_FWD_STASH.launches, GK.K1_BWD_STASH.launches) == before
    tg = bridge.jax_tree(model, grads=True)
    ratios = []
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree_util.tree_leaves(
                                {k: jg[k] for k in GROUPS})):
        ratios.append(worst_ratio(a, b, 2e-5, 1e-4))
        assert ratios[-1] <= 1.0, (jax.tree_util.keystr(path), ratios[-1])
    print(f"stage-1 step with the stash: worst gradient ratio to "
          f"(2e-5 + 1e-4 max|ref|) against JAX {max(ratios):.3f}")
