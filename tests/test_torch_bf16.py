"""K1's bf16 operand mode in the PyTorch port (FNEUS_CORE_ACT_BF16, the
JAX step's default): the packs' refusals, and the plain twins of the bf16
kernels against the JAX package's bf16 Pallas bodies
(sdf_value_grad_feat_pallas(bf16=True), interpret mode) and a stage-1 step
with the mode on in both packages.  Each comparison also asks that the port
be closer to JAX's bf16 result than JAX's own f32 result is, which an f32
port would not be.  The CUDA kernels are held against these twins on the
card by tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import (CASES, _loss_terms_jax, _loss_terms_torch,
                                _setup)
from test_torch_render import build_pair
from test_torch_stage1 import GROUPS, _batch, _jax_loss_and_grads

from factored_neus_tpu.ops import pallas_geometry as PG
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX package's own tolerances for its bf16 bodies against f32
# (tests/test_pallas_geometry.py::test_bf16_variant_close)
SDF_ATOL, GRAD_ATOL = 3e-2, 5e-2
# the port's bf16 twins against JAX's bf16 bodies: both round the same
# operands, so they part only where a pre-activation within f32 rounding
# of a bf16 boundary rounds to its two neighbours (one bf16 ulp down the
# chain); per tensor, relative to its largest entry
TWIN_RTOL = 1e-3


def test_bf16_pack_shared_memory_and_refusals():
    """K2 refuses a bf16 layout (it reads the f32 slab pack), and K1-fwd
    refuses the slab packs of the other operand mode: no mode runs on
    another's pack."""
    cfg = TR.F.SDFConfig()
    ws = [torch.zeros(o, i) for i, o in zip(cfg.dims[:-1], (
        256, 256, 256, 217, 256, 256, 256, 256, 257))]
    ins = [int(w.shape[1]) for w in ws]
    outs = [int(w.shape[0]) for w in ws]
    with pytest.raises(ValueError, match="f32 slab pack"):
        SK.sweep_wg_plan(cfg, [ws[0], *ws[1:-1], ws[-1][:1]], 64,
                         TP.sweep_layout(ins, outs[:-1] + [1], (4,),
                                         cfg.d_embed), 132)
    x = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="wgmma-bf16 slabs"):
        GK.launch_forward(cfg, x, ws, [], GK.make_bwd_slabs(cfg, ws, False),
                          bf16=True)
    with pytest.raises(ValueError, match="wgmma-f32 slabs"):
        GK.launch_forward(cfg, x, ws, [], GK.make_bwd_slabs(cfg, ws, True),
                          bf16=False)


def test_mm_bf16_is_the_rounded_product():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(40, 70).astype(np.float32))
    b = torch.from_numpy(rng.randn(70, 9).astype(np.float32))
    want = (TP.bf16_round(a).double() @ TP.bf16_round(b).double()).float()
    torch.testing.assert_close(TP.mm_bf16(a, b), want, atol=1e-5, rtol=0)
    assert not torch.allclose(TP.mm_bf16(a, b), a @ b, atol=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_results(scale, skip, stash=False):
    """JAX's bf16 and f32 Pallas bodies on _setup's case: (out triples,
    loss, d/dx, parameter gradients) for each."""
    jcfg, params, _, x = _setup(scale, skip)
    xj = jnp.asarray(x)
    res = {}
    for bf16 in (True, False):
        def fn(p, xx):
            return PG.sdf_value_grad_feat_pallas(p, jcfg, xx, bf16=bf16,
                                                 block_rows=64, stash=stash)

        def loss(p, xx):
            return _loss_terms_jax(*fn(p, xx), xx)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, xj)
        res[bf16] = ([np.asarray(t) for t in fn(params, xj)],
                     float(loss(params, xj)), np.asarray(gx),
                     [np.asarray(t) for t in jax.tree_util.tree_leaves(gp)])
    return res


def _closer(port, j16, j32, atol, name):
    """Within atol of JAX-bf16, and closer to it than JAX-f32 is (per
    tensor, in max abs)."""
    d_port = float(np.abs(np.asarray(port) - j16).max())
    d_f32 = float(np.abs(j32 - j16).max())
    assert d_port <= atol, (name, d_port, atol)
    assert d_port < d_f32, (name, d_port, d_f32)
    return d_port / d_f32


@pytest.mark.parametrize("scale,skip", CASES)
def test_bf16_twin_forward_matches_jax_bf16(scale, skip):
    """(sdf, feature, grad) of geometry(bf16=True) on the CPU against
    sdf_value_grad_feat_pallas(bf16=True): within the JAX package's bf16
    tolerances, and closer than its f32 bodies."""
    _, _, net, x = _setup(scale, skip)
    ws, bs = net.effective_weights()
    with torch.no_grad():
        out, grad = GK.geometry(ws, bs, torch.from_numpy(x), net.cfg,
                                bf16=True)
    res = _jax_results(scale, skip)
    (s16, f16, g16), (s32, f32, g32) = res[True][0], res[False][0]
    for port, a, b, atol, name in (
            (out[:, 0], s16, s32, SDF_ATOL, "sdf"),
            (out[:, 1:], f16, f32, SDF_ATOL, "feature"),
            (grad, g16, g32, GRAD_ATOL, "grad")):
        _closer(port.numpy(), a, b, min(atol, TWIN_RTOL * (
            1.0 + np.abs(a).max())), name)


@pytest.mark.parametrize("scale,skip,stash", [(*c, False) for c in CASES]
                         + [(1.0, (2,), True)])
def test_bf16_twin_backward_matches_jax_bf16(scale, skip, stash):
    """The loss, d/dx and every g/v/b gradient through the port's bf16
    twins (the explicit backward; with ``stash`` the stash pair's) against
    jax.grad through the JAX bf16 bodies: within TWIN_RTOL of the largest
    entry (well inside the JAX package's bf16 tolerances), and closer
    than the JAX f32 bodies are."""
    _, _, net, x = _setup(scale, skip)
    xt = torch.from_numpy(x).requires_grad_(True)
    ws, bs = net.effective_weights()
    out, g = GK.geometry(ws, bs, xt, net.cfg, stash=stash, bf16=True)
    lt = _loss_terms_torch(out[:, 0], out[:, 1:], g, xt)
    lt.backward()
    tgrads = jax.tree_util.tree_leaves(bridge.jax_tree_layers(net,
                                                              grads=True))
    res = _jax_results(scale, skip, stash)
    (_, l16, gx16, gp16), (_, l32, gx32, gp32) = res[True], res[False]
    lt = float(lt.detach())
    assert abs(lt - l16) < abs(l32 - l16), (lt, l16, l32)
    ratios = [_closer(xt.grad.numpy(), gx16, gx32,
                      TWIN_RTOL * np.abs(gx16).max(), "d/dx")]
    for i, (a, b, c) in enumerate(zip(tgrads, gp16, gp32)):
        ratios.append(_closer(a, b, c, TWIN_RTOL * np.abs(b).max() + 1e-7,
                              f"param[{i}]"))
    print(f"bf16 backward, scale {scale} skip {skip} stash {stash}: port "
          f"to JAX-bf16 / JAX-f32 to JAX-bf16, worst {max(ratios):.3f}")


def test_bf16_mode_off_leaves_the_f32_path_unchanged():
    """geometry(bf16=False) on the CPU is the f32 twin bit for bit, value
    and gradient, and the renderer's mode defaults off under the tests'
    pin (tests/conftest.py)."""
    _, _, net, x = _setup()
    ws, bs = net.effective_weights()

    def run(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        out, g = fn(xt)
        (gx,) = torch.autograd.grad(
            _loss_terms_torch(out[:, 0], out[:, 1:], g, xt), xt)
        return out, g, gx

    a = run(lambda xt: GK.geometry(ws, bs, xt, net.cfg, bf16=False))
    b = run(lambda xt: GK.geometry_plain(ws, bs, xt, net.cfg))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert TR.RendererConfig().core_act_bf16 is False
    s16 = net.value_grad_feat(torch.from_numpy(x), bf16=True)[0]
    s32 = net.value_grad_feat(torch.from_numpy(x))[0]
    assert torch.equal(s32, b[0][:, 0].detach())
    assert not torch.equal(s16, s32)


def test_stage1_step_with_bf16_k1_matches_jax():
    """One stage-1 step on the same weights, batch and jitter with the
    mode on in both packages (JAX: core_act_bf16 through its Pallas
    geometry core in interpret mode).  The SDF network's gradients are
    within TWIN_RTOL of JAX-bf16's and closer to them than JAX-f32's are;
    the loss and the other gradients within JAX's own bf16-to-f32
    distance (JAX rounds the radiance MLP's activations on its XLA path,
    the port at K3-bf16's products) plus the stage-1 f32 tolerance."""
    jcfg, jparams, cfg, model = build_pair()
    jcfg = dataclasses.replace(jcfg, use_pallas_geometry=True)
    o, d, rgb, mask = _batch()
    step = 20
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)
    key = jax.random.PRNGKey(11)
    k1, _ = jax.random.split(key)
    t_rand = torch.from_numpy(np.array(
        jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))
    jax_runs = {}
    for bf16 in (True, False):
        (jl, jg), _ = _jax_loss_and_grads(
            dataclasses.replace(jcfg, core_act_bf16=bf16), jparams, tcfg, o,
            d, rgb, mask, key, step)
        jax_runs[bf16] = (float(jl), [np.asarray(b) for b in
                                      jax.tree_util.tree_leaves(
                                          {k: jg[k] for k in GROUPS})])
    t = torch.from_numpy
    cfg16 = dataclasses.replace(cfg, core_act_bf16=True)
    tl, _ = TS1.loss_on_batch(model, cfg16, tcfg, t(o), t(d), t(rgb),
                              t(mask), step, t_rand=t_rand)
    tl.backward()
    (l16, g16), (l32, g32) = jax_runs[True], jax_runs[False]
    assert abs(float(tl) - l16) <= abs(l32 - l16) + 1e-5 * abs(l16), (
        float(tl), l16, l32)
    tg = bridge.jax_tree(model, grads=True)
    n_sdf = 0
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(tg),
                               g16, g32):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if name.startswith("['sdf']"):
            n_sdf += 1
            _closer(a, b, c, TWIN_RTOL * np.abs(b).max() + 1e-7, name)
        else:
            tol = (np.abs(c - b).max() + 3e-4 + 2e-3 * np.abs(b).max())
            assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(),
                                                tol)
    assert n_sdf == 3 * len(cfg.sdf.dims[:-1])
