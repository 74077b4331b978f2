"""The PyTorch port's stage 3 against the JAX package (CPU, f32): the
material render on a batch with hit and missed rays, the stage-3 loss,
every material gradient and one Adam step on the same weights, rays and
visibility draws, with the frozen groups untouched; the stage-3 train
config; and checkpoints that cross between the packages both ways.  The
CLI chain, the Pipeline and the quality tool's stage-3 leg are in
tests/test_torch_stage3_cli.py."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_materials import jax_vis_draws, material_config
from test_torch_render import make_rays, port_config
from test_torch_stage1 import no_mesh
from util_scene import tiny_config, tiny_params

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.train import common as JC
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu.train.runner1 import Runner as JRunner1
from factored_neus_tpu.train.runner2 import Runner as JRunner2
from factored_neus_tpu.train.runner3 import Runner as JRunner3
from factored_neus_tpu.utils import checkpoints as JCK
from factored_neus_tpu.utils import config as JCFG
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import losses as TL
from factored_neus_tpu_torch.train import runner1 as TR1
from factored_neus_tpu_torch.train import runner2 as TR2
from factored_neus_tpu_torch.train import runner3 as TR3
from factored_neus_tpu_torch.train import stage3 as TS3
from factored_neus_tpu_torch.utils import config as TCFG

torch.backends.cuda.matmul.allow_tf32 = False
RENDER_ATOL = 3e-4   # mate_illu_render's maps and losses (the JAX package's)
TRAINED = ("material",)
FROZEN = ("nerf", "sdf", "variance", "color", "ref_color", "lvis",
          "indirect")
MAPS = ("rgb", "env_rgb", "indir_rgb", "diffuse_albedo", "specular_albedo",
        "diffuse_rgb", "specular_rgb", "roughness", "lvis_mean",
        "gt_specular_linear", "gt_diffuse_srgb", "n_out")
SCALARS = ("encoder_loss", "diffuse_loss", "specular_loss", "smooth_loss")
t = torch.from_numpy


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _flat(tree, groups):
    return np.concatenate([a.ravel() for g in groups
                           for a in _leaves(tree[g])])


@functools.lru_cache(maxsize=None)
def _jax_side():
    jcfg = dataclasses.replace(tiny_config(), sweep_act_bf16=False)
    return jcfg, jax.tree_util.tree_map(np.asarray, tiny_params(jcfg))


def pair3():
    """(jcfg, jparams, cfg, model): the tiny JAX config at f32 sweeps and
    a Stage3Model holding the same weights in every group."""
    jcfg, jparams = _jax_side()
    cfg = dataclasses.replace(port_config(jcfg),
                              material=material_config(jcfg.material),
                              sweep_act_bf16=False)
    model = TR.Stage3Model(cfg)
    bridge.load_jax_params(model, jparams)
    return jcfg, jparams, cfg, model


def batch(B=24, seed=3):
    """Rays through the unit sphere (some hit the init's surface, some
    miss it), colours, a mask with zeros and the JAX key and its
    visibility draws."""
    o, d, near, far = (np.array(a) for a in make_rays(B=B, seed=seed))
    rng = np.random.RandomState(seed)
    color = rng.uniform(0.0, 1.0, (B, 3)).astype(np.float32)
    mask = (rng.rand(B, 1) < 0.8).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    return o, d, near, far, color, mask, key


def test_mate_illu_render_matches_jax():
    jcfg, jp, cfg, model = pair3()
    o, d, near, far, _, _, key = batch()
    u = jax_vis_draws(key, 16, 4)
    want = jax.jit(lambda p: JR.mate_illu_render(p, jcfg, o, d, near, far,
                                                 key))(jp)
    with torch.no_grad():
        got = TR.mate_illu_render(model, cfg, t(o), t(d), t(near), t(far),
                                  u_theta=t(u[0]), u_phi=t(u[1]))
    mask = np.asarray(want["sdf_mask"])
    np.testing.assert_array_equal(got["sdf_mask"].numpy(), mask)
    assert 6 <= mask.sum() <= len(mask) - 3, "hit and missed rays"
    for k in MAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=RENDER_ATOL, rtol=0, err_msg=k)
    for k in SCALARS:
        assert abs(float(got[k]) - float(want[k])) <= RENDER_ATOL, k
    assert (got["rgb"][~got["sdf_mask"]] == 1.0).all()
    assert float(got["lvis_mean"][got["sdf_mask"]].max()) > 0.05


def check_next_step(jparams, jcfg, jtx, jopt_state, model, cfg, tcfg, opt,
                    step: int, seed: int = 3):
    """One stage-3 step in each package on the same rays, colours, mask
    and visibility draws: the loss and its metrics within 1e-5 relative,
    every material gradient within 6e-4 + 3e-3 max|g| (the JAX package's
    stage-3 gradient tolerance), the parameters after one Adam step on
    JAX's gradients against optax's (Adam divides by sqrt(v), so a
    gradient within tolerance can still move a parameter whose moments
    are tiny by up to lr), and every frozen group bit-identical to
    before."""
    o, d, _, _, color, mask, key = batch(seed=seed)
    u = jax_vis_draws(key, cfg.material.num_lgt_sgs, cfg.material.vis_nsamp)
    sub = {k: jparams[k] for k in TRAINED}

    def loss(p):
        near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
        out = JR.mate_illu_render({**jparams, **p}, jcfg, o, d, near, far,
                                  key)
        return JL.stage3_losses(out, color, mask, lambda x: x)

    (jl, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(sub)
    before = bridge.jax_tree(model)
    tcfg_mask = dataclasses.replace(tcfg, mask_weight=0.1)
    tl, metrics = TS3.loss_on_batch(model, cfg, tcfg_mask, t(o), t(d),
                                    t(color), t(mask), t(u[0]), t(u[1]))
    assert 6 <= float(metrics["n_hit"]) < len(o), "hit and missed rays"
    for k in ("loss", "rgb_loss", "encoder_loss", "psnr"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    opt.zero_grad(set_to_none=True)
    tl.backward()
    tg = bridge.jax_tree(model, grads=True, groups=TRAINED)
    for a, b in zip(_leaves(tg["material"]), _leaves(jg["material"]),
                    strict=True):
        tol = 6e-4 + 3e-3 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)
    assert all(p.grad is None for g in FROZEN
               for p in bridge._module(model, g).parameters())

    full = {k: jg[k] if k in jg else jax.tree_util.tree_map(jnp.zeros_like, v)
            for k, v in jparams.items()}
    upd, jopt_state = jtx.update(full, jopt_state, jparams)
    jnew = optax.apply_updates(jparams, upd)
    # Adam itself on the same gradients: JAX's, handed to the port

    def set_grad(p, g):
        p.grad = g.clone()
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray, jg),
                           set_grad, TRAINED)
    TC.set_lr(opt, tcfg, step)
    opt.step()
    after = bridge.jax_tree(model)
    np.testing.assert_allclose(_flat(after, TRAINED), _flat(jnew, TRAINED),
                               rtol=1e-6, atol=1e-7)
    for g in FROZEN:
        for a, b, c in zip(_leaves(after[g]), _leaves(before[g]),
                           _leaves(jnew[g]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=g)
            np.testing.assert_array_equal(a, c, err_msg=g)


def test_stage3_step_matches_jax():
    jcfg, jparams, cfg, model = pair3()
    tcfg = TC.TrainConfig(warm_up_end=0.0, end_iter=100)
    jtx = JC.make_optimizer(JC.TrainConfig(warm_up_end=0.0, end_iter=100),
                            stage=3)
    opt = TC.make_optimizer(model, tcfg, stage=3)
    assert {id(p) for g in opt.param_groups for p in g["params"]} == \
        {id(p) for p in model.material.parameters()}
    check_next_step(jparams, jcfg, jtx, jtx.init(jparams), model, cfg, tcfg,
                    opt, 0)


def test_stage3_losses_match_jax():
    rng = np.random.RandomState(0)
    B = 32
    out = {"rgb": rng.rand(B, 3).astype(np.float32),
           "sdf_mask": rng.rand(B) < 0.6,
           "encoder_loss": np.float32(0.0123)}
    color = rng.rand(B, 3).astype(np.float32)
    mask = (rng.rand(B, 1) < 0.8).astype(np.float32)
    _, want = JL.stage3_losses(out, color, mask, lambda x: x)
    _, got = TL.stage3_losses({k: t(np.asarray(v)) for k, v in out.items()},
                              t(color), t(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("conf", ["wmask.conf", "womask.conf"])
def test_stage3_configs_match_jax(conf):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "confs",
                        conf)
    tc, jc = TCFG.load(path, "scan"), JCFG.load(path, "scan")
    got = TC.TrainConfig.from_conf(tc, stage=3)
    want = JC.TrainConfig.from_conf(jc, stage=3)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.end_iter, got.batch_size) == (40000, 512)
    assert got.warm_up_end == float(jc["train.warm_up_end"])
    rc = TCFG.renderer_config(tc, "model.lvis_renderer", tonemap="srgb")
    jrc = JCFG.renderer_config(jc, "model.lvis_renderer", tonemap="srgb")
    want_m = {k: v for k, v in dataclasses.asdict(jrc.material).items()
              if k != "vis_act_bf16"}
    assert dataclasses.asdict(rc.material) == want_m
    assert TCFG.renderer_config(tc, tonemap="none").material.tonemap == "none"


# -- checkpoints and the CLI ---------------------------------------------------

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
    """The JAX stage-3 runner's params and optax state equal the port's
    model and Adam state, leaf for leaf."""
    tree = bridge.jax_tree(tr.model)
    for g in TRAINED + FROZEN:
        for a, b in zip(_leaves(tree[g]), _leaves(jr.params[g]),
                        strict=True):
            np.testing.assert_array_equal(a, b, err_msg=g)
    got = TC.optimizer_leaves(tr.model, tr.trainer.opt, stage=3)
    want = _leaves(jr.opt_state)
    assert len(got) == len(want) == 2 + 2 * 27
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def _next_step(jr, tr, step):
    jcfg = dataclasses.replace(jr.cfg, sweep_act_bf16=False)
    check_next_step(jr.params, jcfg, JC.make_optimizer(jr.tcfg, stage=3),
                    jr.opt_state, tr.model,
                    dataclasses.replace(tr.cfg, sweep_act_bf16=False),
                    tr.tcfg, tr.trainer.opt, step)


def test_port_resumes_a_jax_stage3_checkpoint(tmp_path):
    conf = _conf(tmp_path, "jax_written")
    JRunner1(conf, mode="train", case="fake_scan").save_checkpoint()
    JCK.wait_for_async_saves()
    JRunner2(conf, mode="train", case="fake_scan").save_checkpoint()
    JCK.wait_for_async_saves()
    jr = JRunner3(conf, mode="train", case="fake_scan")
    # two Adam updates on random gradients (the frozen groups stay put):
    # moments and counts that are not the init's
    tx = JC.make_optimizer(jr.tcfg, stage=3)
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

    tr = TR3.Runner(conf, case="fake_scan", is_continue=True, device="cpu")
    assert tr.iter_step == 2
    _assert_same_state(jr, tr)
    _next_step(jr, tr, 2)


def test_jax_resumes_a_port_stage3_checkpoint(tmp_path):
    conf = _conf(tmp_path, "port_written")
    TR1.Runner(conf, case="fake_scan", device="cpu").save_checkpoint()
    TR2.Runner(conf, case="fake_scan", device="cpu").save_checkpoint()
    tr = TR3.Runner(conf, case="fake_scan", device="cpu")
    for i in range(3):
        tr.trainer.step(i % 3, i)
    tr.iter_step = 3
    raw = JCK.load_checkpoint(tr.save_checkpoint())
    assert set(raw) == set(TR3.STAGE3_KEYS.values()) | {"optimizer",
                                                        "iter_step"}
    jr = JRunner3(conf, mode="validate_image", case="fake_scan",
                  is_continue=True)
    assert jr.iter_step == 3
    _assert_same_state(jr, tr)
    _next_step(jr, tr, 3)


def test_stage3_runner_needs_a_stage2_checkpoint(tmp_path):
    conf = _conf(tmp_path, "none")
    with pytest.raises(FileNotFoundError, match="stage-2 checkpoint"):
        TR3.Runner(conf, case="fake_scan", device="cpu")
    # a mode the JAX runner does not have is refused before anything loads;
    # the synthetic modes are ported and need the stage-2 checkpoint too
    with pytest.raises(NotImplementedError, match="relgt_synthetic_img"):
        TR3.Runner(conf, mode="relgt_envmap", case="fake_scan",
                   device="cpu")
    with pytest.raises(FileNotFoundError, match="stage-2 checkpoint"):
        TR3.Runner(conf, mode="relgt_synthetic_img", case="fake_scan",
                   device="cpu")
