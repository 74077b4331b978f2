"""The womask stage-1 path of the PyTorch port (background NeRF,
n_outside > 0) against the JAX package on bridged weights: the NeRF, the
background core, the whole render, one train step's loss and every
parameter gradient, and the port's CLI on confs/womask.conf's schema."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_render import OUT_KEYS, make_rays, port_config
from test_torch_stage1 import GROUPS, no_mesh
from util_scene import tiny_config, tiny_params

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu.utils import schedule as JSCH
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch import exp_runner
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1
from factored_neus_tpu_torch.train.runner1 import CKPT_KEYS
from factored_neus_tpu_torch.utils import checkpoints as CK
from factored_neus_tpu_torch.utils import config as CFG

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_OUTSIDE = 8
# D 4, W 64 with a skip after layer 1, so the [pts_e, h] concat is covered
NERF = dict(D=4, W=64, multires=4, multires_view=2, skips=(1,))


def build_womask_pair(seed=0):
    jcfg = dataclasses.replace(tiny_config(n_outside=N_OUTSIDE),
                               nerf=JF.NeRFConfig(**NERF))
    jparams = tiny_params(jcfg, seed)
    jparams["nerf"] = JF.nerf_init(jax.random.PRNGKey(seed + 100), jcfg.nerf)
    cfg = port_config(jcfg)
    model = TR.Stage1Model(cfg)
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, cfg, model


def jitters(key, B):
    """The two draws JAX's render makes from ``key``: the inside jitter
    [B, 1] in [-0.5, 0.5) and the outside one [B, n_outside] in [0, 1)."""
    k1, k2 = jax.random.split(key)
    t = lambda a: torch.from_numpy(np.asarray(a))
    return (t(jax.random.uniform(k1, (B, 1)) - 0.5),
            t(jax.random.uniform(k2, (B, N_OUTSIDE))))


@pytest.mark.parametrize("multires", [4, 0])
def test_nerf_matches_jax(multires):
    """NeRF against nerf_apply at 1e-5, with the encoded and the identity
    (multires 0, d_in channels) input."""
    kw = {**NERF, "multires": multires}
    cfg = JF.NeRFConfig(**kw)
    params = JF.nerf_init(jax.random.PRNGKey(3), cfg)
    net = TF.NeRF(TF.NeRFConfig(**kw))
    bridge.load_nerf(net, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(2)
    pts = rng.randn(50, 4).astype(np.float32)
    dirs = rng.randn(50, 3).astype(np.float32)
    with torch.no_grad():
        alpha, rgb = net(torch.from_numpy(pts), torch.from_numpy(dirs))
    ja, jrgb = JF.nerf_apply(params, cfg, pts, dirs)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)


def test_render_core_outside_matches_jax():
    jcfg, jparams, cfg, model = build_womask_pair()
    o, d, near, far = make_rays(B=12)
    rng = np.random.RandomState(4)
    z = np.sort(near + rng.rand(12, 20).astype(np.float32) * (far + 4.0
                                                             - near), -1)
    jout = JR.render_core_outside(jparams, jcfg, o, d, z, 2.0 / 16,
                                  background_rgb=jnp.ones((1, 3)))
    t = torch.from_numpy
    with torch.no_grad():
        tout = TR.render_core_outside(model, cfg, t(o), t(d), t(z), 2.0 / 16,
                                      background_rgb=torch.ones(1, 3))
    for k in ("color", "sampled_color", "alpha", "weights"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("jitter", [False, True])
def test_womask_render_matches_jax(jitter):
    """The whole render with the background model: both jitters given
    (JAX draws them from its key), or none; weights cover the 16 + 16
    inside and the 8 outside samples of a ray."""
    jcfg, jparams, cfg, model = build_womask_pair()
    o, d, near, far = make_rays()
    kw = dict(cos_anneal_ratio=0.37)
    t = torch.from_numpy
    if jitter:
        key = jax.random.PRNGKey(5)
        t_rand, t_rand_out = jitters(key, o.shape[0])
        jout = jax.jit(lambda p: JR.render(p, jcfg, o, d, near, far, key=key,
                                           **kw))(jparams)
        tkw = dict(t_rand=t_rand, t_rand_out=t_rand_out)
    else:
        jout = jax.jit(lambda p: JR.render(p, jcfg, o, d, near, far,
                                           key=None, perturb_overwrite=0.0,
                                           **kw))(jparams)
        tkw = {}
    with torch.no_grad():
        tout = TR.render(model, cfg, t(o), t(d), t(near), t(far), **tkw, **kw)
    assert tout["weights"].shape == (o.shape[0], 32 + N_OUTSIDE)
    for k in OUT_KEYS:
        np.testing.assert_allclose(tout[k].detach().numpy().astype(np.float32),
                                   np.asarray(jout[k]).astype(np.float32),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def test_womask_step_loss_and_grads_match_jax():
    """One womask stage-1 step (mask_weight 0: a mask of ones, as the JAX
    step feeds) on the same weights, rays and both jitters: the loss and
    every parameter gradient, the background NeRF's included, at
    3e-4 + 2e-3 max|g| (test_torch_stage1's tolerance)."""
    jcfg, jparams, cfg, model = build_womask_pair()
    o, d, _, _ = make_rays(B=24, seed=7)
    rgb = np.random.RandomState(7).rand(o.shape[0], 3).astype(np.float32)
    ones = np.ones((o.shape[0], 1), np.float32)
    step = 20
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.0,
                          surface_weight=0.1, anneal_end=50.0)
    key = jax.random.PRNGKey(11)
    t_rand, t_rand_out = jitters(key, o.shape[0])

    def loss(p):
        near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
        out = JR.render({**jparams, **p}, jcfg, o, d, near, far, key=key,
                        cos_anneal_ratio=JSCH.cos_anneal_ratio(
                            step, tcfg.anneal_end))
        return JL.stage1_losses(out, rgb, ones, tcfg, reduce=lambda x: x)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: jparams[k]
                                                for k in GROUPS})
    t = torch.from_numpy
    # the port replaces the mask by ones itself when mask_weight is 0
    tl, _ = TS1.loss_on_batch(model, cfg, tcfg, t(o), t(d), t(rgb),
                              t(np.zeros_like(ones)), step, t_rand=t_rand,
                              t_rand_out=t_rand_out)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tl.backward()
    assert all(p.grad is not None for p in model.nerf.parameters())
    tg = bridge.jax_tree(model, grads=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree_util.tree_leaves(jg), strict=True):
        b = np.asarray(b)
        tol = 3e-4 + 2e-3 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (jax.tree_util.keystr(path),
                                            np.abs(a - b).max(), tol)
    assert np.abs(np.asarray(jg["nerf"]["alpha_linear"]["w"])).max() > 0


def test_womask_conf_schema():
    """confs/womask.conf: the background NeRF's config and 32 outside
    samples reach the renderer config."""
    c = CFG.load(os.path.join(os.path.dirname(__file__), os.pardir, "confs",
                              "womask.conf"), "scan")
    cfg = CFG.renderer_config(c)
    assert cfg.n_outside == 32
    assert cfg.nerf == TF.NeRFConfig(D=8, W=256, d_in=4, d_in_view=3,
                                     multires=10, multires_view=4,
                                     skips=(4,))
    assert cfg.nerf.input_ch == 84 and cfg.nerf.input_ch_view == 27
    assert TC.TrainConfig.from_conf(c).mask_weight == 0.0


def test_cli_trains_womask_and_checkpoints_the_nerf(tmp_path):
    """The port's CLI trains a tiny womask conf (n_outside 8) on a fake
    DTU scene; the checkpoint carries the nerf group, which training
    moved."""
    make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"))
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    no_mesh(conf)
    with open(conf) as f:
        text = f.read().replace("n_outside = 0,", f"n_outside = {N_OUTSIDE},",
                                1).replace("mask_weight = 0.1",
                                           "mask_weight = 0.0")
    with open(conf, "w") as f:
        f.write(text)
    runner = exp_runner.main(["--mode", "train", "--conf", conf, "--case",
                              "fake_scan", "--type", "dtu", "--device",
                              "cpu"])
    assert runner.cfg.n_outside == N_OUTSIDE
    assert runner.iter_step == 4 and np.isfinite(runner.history[0]["loss"])
    ck = CK.load_checkpoint(runner.last_checkpoint)
    assert set(CKPT_KEYS.values()) <= set(ck)
    # the checkpoint keeps the JAX package's layout (bridge.jax_tree)
    init = bridge.jax_tree(TR.Stage1Model(runner.cfg, seed=0))["nerf"]
    saved, start = (jax.tree_util.tree_flatten_with_path(t)[0]
                    for t in (ck["nerf"], init))
    assert [p for p, _ in saved] == [p for p, _ in start]
    moved = [p for (p, v), (_, v0) in zip(saved, start)
             if not np.array_equal(v, v0)]
    assert moved
