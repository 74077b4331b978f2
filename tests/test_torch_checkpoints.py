"""Checkpoints that cross between the packages: a stage-1 checkpoint the
JAX runner wrote resumes in the port, and one the port wrote resumes in
the JAX runner, with the same parameters, Adam moments and update count;
the next step then matches at test_torch_stage1's tolerance (CPU, f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_stage1 import _batch, _jax_loss_and_grads

from factored_neus_tpu.train import common as JC
from factored_neus_tpu.train.runner1 import Runner as JRunner
from factored_neus_tpu.utils import checkpoints as JCK
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import runner1 as TR1
from factored_neus_tpu_torch.train import stage1 as TS1
from factored_neus_tpu_torch.utils import checkpoints as CK

STAGE1 = ("nerf", "sdf", "variance", "color", "ref_color")
LATER = {"lvis": "lvis_network", "indirect": "indiLgt_network",
         "material": "mateIllu_network"}


def _conf(tmp_path, name):
    data = tmp_path / "data" / "fake_scan"
    if not data.exists():
        make_fake_dtu_scene(str(data), n_views=3, H=32, W=40)
    return write_tiny_conf(str(tmp_path / f"{name}.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / name / "CASE_NAME"), iters=8)


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _assert_same_state(jr, tr):
    """The JAX runner's params and optax state equal the port's model and
    Adam state, leaf for leaf."""
    tree = bridge.jax_tree(tr.model)
    for g in STAGE1:
        for a, b in zip(_leaves(tree[g]), _leaves(jr.params[g]),
                        strict=True):
            np.testing.assert_array_equal(a, b, err_msg=g)
    got = TR1.optimizer_leaves(tr.model, tr.trainer.opt)
    for a, b in zip(got, _leaves(jr.opt_state), strict=True):
        np.testing.assert_array_equal(a, b)


def _next_steps_match(jr, tr, step):
    """One step on the same batch and jitter in both: the loss, every
    gradient, and the parameters after Adam (the update is +-lr-sized
    where |g| >> eps, so elements whose tiny gradients differ in sign may
    differ by 2 lr: under 1% of them)."""
    o, d, rgb, mask = _batch()
    key = jax.random.PRNGKey(3)
    k1, _ = jax.random.split(key)
    t_rand = torch.from_numpy(np.array(
        jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))
    (jl, jg), _ = _jax_loss_and_grads(jr.cfg, jr.params, jr.tcfg, o, d, rgb,
                                      mask, key, step)
    t = torch.from_numpy
    tl, _ = TS1.loss_on_batch(tr.model, tr.cfg, tr.tcfg, t(o), t(d), t(rgb),
                              t(mask), step, t_rand=t_rand)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    opt = tr.trainer.opt
    opt.zero_grad(set_to_none=True)
    tl.backward()
    tg = bridge.jax_tree(tr.model, grads=True)
    for g in STAGE1:
        for a, b in zip(_leaves(tg[g]), _leaves(jg[g]), strict=True):
            assert np.abs(a - b).max() <= 3e-4 + 2e-3 * np.abs(b).max(), g

    full = {k: jg[k] if k in jg else jax.tree_util.tree_map(jnp.zeros_like, v)
            for k, v in jr.params.items()}
    tx = JC.make_optimizer(jr.tcfg, stage=1)
    upd, _ = tx.update(full, jr.opt_state, jr.params)
    jnew = optax.apply_updates(jr.params, upd)
    TC.set_lr(opt, tr.tcfg, step)
    opt.step()
    tnew = bridge.jax_tree(tr.model)
    new = np.concatenate([a.ravel() for g in STAGE1 for a in _leaves(tnew[g])])
    want = np.concatenate([a.ravel() for g in STAGE1
                           for a in _leaves(jnew[g])])
    diff = np.abs(new - want)
    assert diff.max() <= 2 * tr.tcfg.learning_rate + 1e-6
    assert np.mean(diff > 1e-6) < 0.01


def test_port_resumes_a_jax_checkpoint(tmp_path):
    conf = _conf(tmp_path, "jax_written")
    jr = JRunner(conf, mode="train", case="fake_scan")
    # two Adam updates on random gradients for every group (the frozen
    # ones stay put): moments and counts that are not the init's
    tx = JC.make_optimizer(jr.tcfg, stage=1)
    rng = np.random.RandomState(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*np.shape(p)), p.dtype),
            jr.params)
        upd, jr.opt_state = tx.update(grads, jr.opt_state, jr.params)
        jr.params = optax.apply_updates(jr.params, upd)
    jr.iter_step = 2
    jr.save_checkpoint()
    JCK.wait_for_async_saves()

    tr = TR1.Runner(conf, case="fake_scan", is_continue=True, device="cpu")
    assert tr.iter_step == 2
    _assert_same_state(jr, tr)
    assert set(tr.passed_through) == set(LATER.values())

    # the later stages' groups pass through the port's next save untouched
    back = CK.load_checkpoint(tr.save_checkpoint())
    for pk, ck in LATER.items():
        for a, b in zip(_leaves(back[ck]), _leaves(jr.params[pk]),
                        strict=True):
            np.testing.assert_array_equal(a, b, err_msg=ck)
    _next_steps_match(jr, tr, 2)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    conf = _conf(tmp_path, "port_written")
    tr = TR1.Runner(conf, case="fake_scan", device="cpu")
    for i in range(3):
        tr.trainer.step(i % 3, i)
    tr.iter_step = 3
    path = tr.save_checkpoint()
    # the JAX package's own reader sees its groups and layout
    raw = JCK.load_checkpoint(path)
    assert set(raw) == set(TR1.CKPT_KEYS.values()) | {"optimizer",
                                                      "iter_step"}

    jr = JRunner(conf, mode="validate_image", case="fake_scan",
                 is_continue=True)
    assert jr.iter_step == 3
    _assert_same_state(jr, tr)
    _next_steps_match(jr, tr, 3)


def test_checkpoint_format_matches_the_jax_writer(tmp_path):
    """Trees (dicts, lists, tuples), Leaves and bare values: the port's
    writer and the JAX package's reader agree, and the other way round."""
    rng = np.random.RandomState(0)
    tree = {"b": [{"v": rng.rand(2, 3), "g": rng.rand(3)}, {"w": rng.rand(1)}],
            "a": (rng.rand(2), {"x": rng.rand(4)})}
    leaves = [np.asarray(3, np.int32), rng.rand(5), np.asarray(3, np.int32)]
    port = CK.save_checkpoint(str(tmp_path / "p"), 5, {
        "net": tree, "optimizer": CK.Leaves(leaves),
        "iter_step": np.asarray(5)})
    jax_path = JCK.save_checkpoint(str(tmp_path / "j"), 5, {
        "net": tree, "optimizer": optax.ScaleByAdamState(
            leaves[0], leaves[1], leaves[2]), "iter_step": 5})
    for read in (JCK.load_checkpoint, CK.load_checkpoint):
        for path in (port, jax_path):
            got = read(path)
            assert int(got["iter_step"]) == 5
            for a, b in zip(_leaves(got["net"]), _leaves(tree), strict=True):
                np.testing.assert_array_equal(a, b)
            assert isinstance(got["net"]["a"], tuple)
            for a, b in zip(got["optimizer"], leaves, strict=True):
                np.testing.assert_array_equal(a, b)
    assert isinstance(CK.load_checkpoint(jax_path)["optimizer"], CK.Leaves)


def test_optimizer_leaves_refuse_another_model(tmp_path):
    tr = TR1.Runner(_conf(tmp_path, "refuse"), case="fake_scan",
                    device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        TR1.load_optimizer_leaves(tr.model, tr.trainer.opt,
                                  [np.asarray(0)] * 5)
