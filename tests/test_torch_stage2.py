"""The PyTorch port's stage-2 train step against the JAX package (CPU,
f32, JAX's sweeps f32): the loss, the lvis and indirect gradients and one
Adam step on the same weights, rays and hemisphere draws, with the frozen
stage-1 groups untouched; the stage-2 train config; checkpoints that cross
between the packages both ways; and the port's stage-1 CLI followed by its
stage-2 CLI on a fabricated DTU scene."""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_render import make_rays
from test_torch_secondary import jax_draws, pair2
from test_torch_stage1 import no_mesh

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.train import common as JC
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu.train.runner1 import Runner as JRunner1
from factored_neus_tpu.train.runner2 import Runner as JRunner2
from factored_neus_tpu.utils import checkpoints as JCK
from factored_neus_tpu.utils import config as JCFG
from factored_neus_tpu_torch import bridge, exp_runner, lvis
from factored_neus_tpu_torch.tools import quality as Q
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import runner1 as TR1
from factored_neus_tpu_torch.train import runner2 as TR2
from factored_neus_tpu_torch.train import stage2 as TS2
from factored_neus_tpu_torch.utils import checkpoints as CK
from factored_neus_tpu_torch.utils import config as TCFG

torch.backends.cuda.matmul.allow_tf32 = False
TRAINED = ("lvis", "indirect")
FROZEN = ("nerf", "sdf", "variance", "color", "ref_color")
t = torch.from_numpy


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _flat(tree, groups):
    return np.concatenate([a.ravel() for g in groups
                           for a in _leaves(tree[g])])


def check_next_step(jparams, jcfg, jtx, jopt_state, model, cfg, tcfg, opt,
                    step: int, seed: int = 3):
    """One stage-2 step in each package on the same rays and hemisphere
    draws: the loss within 1e-5 relative, every lvis and indirect gradient
    within the JAX package's stage-2 tolerance 1.2e-3 + 3e-3 max|g|, the
    parameters after Adam (the first update is +-lr-sized where |g| >> eps,
    so elements whose tiny gradients differ in sign may differ by 2 lr:
    under 1% of them), and every frozen group bit-identical to before."""
    o, d, _, _ = make_rays(B=16, seed=seed)
    key = jax.random.PRNGKey(seed)
    u_theta, u_z = jax_draws(16, seed)
    sub = {k: jparams[k] for k in TRAINED}

    def loss(p):
        near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
        out = JR.lvis_render({**jparams, **p}, jcfg, o, d, near, far, key)
        return JL.stage2_losses(out, lambda x: x)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(sub)
    before = bridge.jax_tree(model)
    tl, metrics = TS2.loss_on_batch(model, cfg, t(o), t(d), t(u_theta),
                                    t(u_z))
    assert metrics["n_hit"] >= 8
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    opt.zero_grad(set_to_none=True)
    tl.backward()
    tg = bridge.jax_tree(model, grads=True, groups=TRAINED)
    for g in TRAINED:
        for a, b in zip(_leaves(tg[g]), _leaves(jg[g]), strict=True):
            tol = 1.2e-3 + 3e-3 * np.abs(b).max()
            assert np.abs(a - b).max() <= tol, (g, np.abs(a - b).max(), tol)
    assert all(p.grad is None for p in model.stage1.parameters())

    full = {k: jg[k] if k in jg else jax.tree_util.tree_map(jnp.zeros_like, v)
            for k, v in jparams.items()}
    upd, jopt_state = jtx.update(full, jopt_state, jparams)
    jnew = optax.apply_updates(jparams, upd)
    TC.set_lr(opt, tcfg, step)
    opt.step()
    after = bridge.jax_tree(model)
    diff = np.abs(_flat(after, TRAINED) - _flat(jnew, TRAINED))
    assert diff.max() <= 2 * tcfg.learning_rate + 1e-6
    assert np.mean(diff > 1e-6) < 0.01
    for g in FROZEN:
        for a, b, c in zip(_leaves(after[g]), _leaves(before[g]),
                           _leaves(jnew[g]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=g)
            np.testing.assert_array_equal(a, c, err_msg=g)


@pytest.mark.parametrize("fused", [True, False])
def test_stage2_step_matches_jax(fused):
    jcfg, jparams, cfg, model = pair2(fused)
    tcfg = TC.TrainConfig(warm_up_end=0.0, end_iter=100)
    jtx = JC.make_optimizer(JC.TrainConfig(warm_up_end=0.0, end_iter=100),
                            stage=2)
    opt = TC.make_optimizer(model, tcfg, stage=2)
    assert {id(p) for g in opt.param_groups for p in g["params"]} == \
        {id(p) for g in TRAINED for p in getattr(model, g).parameters()}
    check_next_step(jparams, jcfg, jtx, jtx.init(jparams), model, cfg, tcfg,
                    opt, 0)


@pytest.mark.parametrize("conf", ["wmask.conf", "womask.conf"])
def test_stage2_configs_match_jax(conf):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "confs",
                        conf)
    tc, jc = TCFG.load(path, "scan"), JCFG.load(path, "scan")
    got = TC.TrainConfig.from_conf(tc, stage=2)
    want = JC.TrainConfig.from_conf(jc, stage=2)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.end_iter, got.batch_size, got.warm_up_end) == \
        (10000, 512, 1000.0)
    rc = TCFG.renderer_config(tc, "model.lvis_renderer")
    jrc = JCFG.renderer_config(jc, "model.lvis_renderer")
    for name in ("n_samples", "n_importance", "n_outside", "up_sample_steps",
                 "secondary_chunk", "fused_fine_sweep"):
        assert getattr(rc, name) == getattr(jrc, name), name
    for name in ("lvis", "indirect"):
        assert dataclasses.asdict(getattr(rc, name)) == \
            dataclasses.asdict(getattr(jrc, name))


def _conf(tmp_path, name, val_chunk=False):
    data = tmp_path / "data" / "fake_scan"
    if not data.exists():
        make_fake_dtu_scene(str(data), n_views=3, H=32, W=40)
    conf = write_tiny_conf(str(tmp_path / f"{name}.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / name / "CASE_NAME"), iters=4,
                           iters2=4)
    no_mesh(conf)
    if val_chunk:
        with open(conf) as f:
            text = f.read().replace("report_freq = 4",
                                    "report_freq = 4\n    val_chunk = 256")
        with open(conf, "w") as f:
            f.write(text)
    return conf


def _assert_same_state(jr, tr):
    """The JAX stage-2 runner's params and optax state equal the port's
    model and Adam state, leaf for leaf."""
    tree = bridge.jax_tree(tr.model)
    for g in TRAINED + FROZEN:
        for a, b in zip(_leaves(tree[g]), _leaves(jr.params[g]),
                        strict=True):
            np.testing.assert_array_equal(a, b, err_msg=g)
    got = TC.optimizer_leaves(tr.model, tr.trainer.opt, stage=2)
    want = _leaves(jr.opt_state)
    assert len(got) == len(want) == 2 + 2 * 20
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def _next_step(jr, tr, step):
    check_next_step(jr.params, dataclasses.replace(jr.cfg,
                                                   sweep_act_bf16=False),
                    JC.make_optimizer(jr.tcfg, stage=2), jr.opt_state,
                    tr.model, dataclasses.replace(tr.cfg,
                                                  sweep_act_bf16=False),
                    tr.tcfg, tr.trainer.opt, step)


def test_port_resumes_a_jax_stage2_checkpoint(tmp_path):
    conf = _conf(tmp_path, "jax_written")
    JRunner1(conf, mode="train", case="fake_scan").save_checkpoint()
    JCK.wait_for_async_saves()
    jr = JRunner2(conf, mode="train", case="fake_scan")
    # two Adam updates on random gradients (the frozen groups stay put):
    # moments and counts that are not the init's
    tx = JC.make_optimizer(jr.tcfg, stage=2)
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

    tr = TR2.Runner(conf, case="fake_scan", is_continue=True, device="cpu")
    assert tr.iter_step == 2
    _assert_same_state(jr, tr)
    assert set(tr.passed_through) == {"mateIllu_network"}
    back = CK.load_checkpoint(tr.save_checkpoint())
    for a, b in zip(_leaves(back["mateIllu_network"]),
                    _leaves(jr.params["material"]), strict=True):
        np.testing.assert_array_equal(a, b)
    _next_step(jr, tr, 2)


def test_jax_resumes_a_port_stage2_checkpoint(tmp_path):
    conf = _conf(tmp_path, "port_written")
    TR1.Runner(conf, case="fake_scan", device="cpu").save_checkpoint()
    tr = TR2.Runner(conf, case="fake_scan", device="cpu")
    for i in range(3):
        tr.trainer.step(i % 3, i)
    tr.iter_step = 3
    raw = JCK.load_checkpoint(tr.save_checkpoint())
    assert set(raw) == set(TR2.STAGE2_KEYS.values()) | {"optimizer",
                                                        "iter_step"}
    jr = JRunner2(conf, mode="validate_image", case="fake_scan",
                  is_continue=True)
    assert jr.iter_step == 3
    _assert_same_state(jr, tr)
    _next_step(jr, tr, 3)


def test_cli_stage1_then_stage2_on_fake_dtu(tmp_path):
    conf = _conf(tmp_path, "cli", val_chunk=True)
    base = ["--conf", conf, "--case", "fake_scan", "--type", "dtu",
            "--device", "cpu"]
    geo = exp_runner.main(["--mode", "train", *base])
    r = lvis.main(["--mode", "train", *base])
    assert r.iter_step == 4 and len(r.history) == 1
    m = r.history[0]
    assert np.isfinite(m["loss"]) and m["n_hit"] > 0
    out = r.base_exp_dir
    assert glob.glob(os.path.join(out, "lvis", "lvis_4_*.png"))
    assert glob.glob(os.path.join(out, "trace_radiance",
                                  "trace_radiance4_*.png"))
    assert os.listdir(os.path.join(out, "logs"))
    # the frozen groups leave stage 2 as they came from stage 1
    ck1 = CK.load_checkpoint(geo.last_checkpoint)
    ck2 = CK.load_checkpoint(r.last_checkpoint)
    for ck in TR1.CKPT_KEYS.values():
        for a, b in zip(_leaves(ck2[ck]), _leaves(ck1[ck]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=ck)
    v = lvis.main(["--mode", "validate_image", "--is_continue", *base])
    assert v.iter_step == 4
    for a, b in zip(v.model.state_dict().values(),
                    r.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(glob.glob(os.path.join(out, "lvis", "lvis_4_*.png"))) >= 1


def test_stage2_runner_needs_a_stage1_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="stage-1 checkpoint"):
        TR2.Runner(_conf(tmp_path, "none"), case="fake_scan", device="cpu")


def test_quality_stage2_leg_scores_a_run(tmp_path):
    """The quality tool's stage-2 leg: the run conf's stage-2 directory,
    and the tail losses and rays/s of a stage-2 log."""
    repo = os.path.dirname(os.path.dirname(__file__))
    path = Q.write_run_conf(os.path.join(repo, "confs", "wmask.conf"),
                            str(tmp_path / "wmask.conf"),
                            str(tmp_path / "data"), str(tmp_path / "e"),
                            20000)
    c = TCFG.load(path, "fake_scan")
    assert c["general.base_exp_dir_lvis"] == str(
        tmp_path / "e" / "fake_scan" / "wmask" / "lvis")
    assert TC.TrainConfig.from_conf(c, stage=2).end_iter == 10000
    log = tmp_path / "lvis.log"
    log.write_text("\n".join(
        f"x INFO iter {i} lvis={v:.5f} trace={v / 10:.5f} rays/s={r}"
        for i, (v, r) in enumerate(zip([0.5, 0.1, 0.2, 0.3, 0.4, 0.5],
                                       [10, 20, 30, 40, 50, 60]))))
    row = Q.score_stage2(str(tmp_path / "exp"), str(log))
    assert row["lvis_loss_tail"] == pytest.approx(0.3)
    assert row["trace_radiance_loss_tail"] == pytest.approx(0.03)
    assert row["stage2_rays_per_sec_median"] == pytest.approx(35.0)
    assert row["stage2_panels"] == str(tmp_path / "exp" / "lvis")
