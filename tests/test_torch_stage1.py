"""The PyTorch port's stage-1 train step against the JAX package: the loss
and every parameter gradient on the same weights, batch and z jitter, one
Adam step, checkpoints, and the port's CLI on a fabricated DTU scene."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_render import build_pair, make_rays

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.train import common as JC
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu.utils import schedule as JSCH
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch import exp_runner
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1
from factored_neus_tpu_torch.train.runner1 import Runner
from factored_neus_tpu_torch.utils import checkpoints as CK

GROUPS = ("nerf", "sdf", "variance", "color", "ref_color")


def _batch(seed=7):
    o, d, _, _ = make_rays(B=24, seed=seed)
    rng = np.random.RandomState(seed)
    rgb = rng.rand(o.shape[0], 3).astype(np.float32)
    mask = (rng.rand(o.shape[0], 1) > 0.3).astype(np.float32)
    return o, d, rgb, mask


def _jax_loss_and_grads(jcfg, jparams, tcfg, o, d, rgb, mask, key, step):
    sub = {k: jparams[k] for k in GROUPS}

    def loss(p):
        near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
        out = JR.render({**jparams, **p}, jcfg, o, d, near, far, key=key,
                        cos_anneal_ratio=JSCH.cos_anneal_ratio(
                            step, tcfg.anneal_end))
        return JL.stage1_losses(out, rgb, mask, tcfg, reduce=lambda x: x)[0]

    return jax.jit(jax.value_and_grad(loss))(sub), sub


def test_stage1_loss_grads_and_adam_step_match_jax():
    jcfg, jparams, cfg, model = build_pair()
    o, d, rgb, mask = _batch()
    step = 20
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)
    key = jax.random.PRNGKey(11)
    k1, _ = jax.random.split(key)
    t_rand = torch.from_numpy(np.asarray(
        jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))

    (jl, jg), jsub = _jax_loss_and_grads(jcfg, jparams, tcfg, o, d, rgb,
                                         mask, key, step)
    t = torch.from_numpy
    tl, _ = TS1.loss_on_batch(model, cfg, tcfg, t(o), t(d), t(rgb), t(mask),
                              step, t_rand=t_rand)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    opt = TC.make_optimizer(model, tcfg)
    opt.zero_grad()
    tl.backward()
    tg = bridge.jax_tree(model, grads=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        tol = 3e-4 + 2e-3 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (jax.tree_util.keystr(path),
                                            np.abs(a - b).max(), tol)

    # one Adam step each (update count 0); the first Adam update is
    # +-lr wherever |g| >> eps, so elements whose tiny gradients differ in
    # sign may differ by 2 lr: require that for under 1% of them
    lr_fn = lambda c: JSCH.learning_rate(c, tcfg.learning_rate,
                                         tcfg.warm_up_end, tcfg.end_iter,
                                         tcfg.learning_rate_alpha)
    tx = optax.adam(learning_rate=lr_fn)
    upd, _ = tx.update(jg, tx.init(jsub), jsub)
    jnew = optax.apply_updates(jsub, upd)
    TC.set_lr(opt, tcfg, 0)
    opt.step()
    lr = tcfg.learning_rate
    new = np.concatenate([a.ravel() for a in
                          jax.tree_util.tree_leaves(bridge.jax_tree(model))])
    want = np.concatenate([np.asarray(b).ravel() for b in
                           jax.tree_util.tree_leaves(jnew)])
    diff = np.abs(new - want)
    assert diff.max() <= 2 * lr + 1e-6
    assert np.mean(diff > 1e-6) < 0.01


def test_adam_and_schedule_match_optax_on_the_same_gradients():
    """Two steps with warmup: torch.optim.Adam + set_lr == optax.adam with
    the JAX schedule, fed identical gradients."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 4).astype(np.float32)
    gs = [rng.randn(5, 4).astype(np.float32) for _ in range(3)]
    tcfg = TC.TrainConfig(learning_rate=1e-2, warm_up_end=2.0, end_iter=10)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([w], lr=tcfg.learning_rate)
    tx = JC.adam_with_schedule(tcfg)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for i, g in enumerate(gs):
        w.grad = torch.from_numpy(g)
        TC.set_lr(opt, tcfg, i)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                                   atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    groups = {"sdf_network_fine": {"lin0.weight_v": np.ones((2, 3))},
              "iter_step": np.asarray(7)}
    path = CK.save_checkpoint(str(tmp_path), 7, groups)
    assert path.endswith("ckpt_000007.npz")
    back = CK.load_checkpoint(path)
    np.testing.assert_array_equal(back["sdf_network_fine"]["lin0.weight_v"],
                                  np.ones((2, 3)))
    assert int(back["iter_step"]) == 7
    assert CK.latest_checkpoint(str(tmp_path)) == path
    assert CK.latest_checkpoint(str(tmp_path), end_iter=6) is None


def no_mesh(conf: str) -> None:
    """Turn the 512^3 mesh at val_mesh_freq off in a tiny conf (too slow
    for the CPU twin)."""
    with open(conf) as f:
        text = f.read()
    with open(conf, "w") as f:
        f.write(re.sub(r"val_mesh_freq = \d+", "val_mesh_freq = 1000000",
                       text))


def test_cli_trains_fake_dtu_and_resumes(tmp_path):
    data = make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"))
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    no_mesh(conf)
    argv = ["--mode", "train", "--conf", conf, "--case", "fake_scan",
            "--type", "dtu", "--device", "cpu"]
    runner = exp_runner.main(argv)
    assert os.path.isdir(data)
    assert runner.iter_step == 4 and len(runner.history) == 1
    assert np.isfinite(runner.history[0]["loss"])
    assert os.path.exists(runner.last_checkpoint)
    resumed = Runner(conf, case="fake_scan", is_continue=True, device="cpu")
    assert resumed.iter_step == 4
    for a, b in zip(runner.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert resumed.trainer.opt.state_dict()["state"].keys() == \
        runner.trainer.opt.state_dict()["state"].keys()
