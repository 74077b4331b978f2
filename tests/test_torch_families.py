"""The port's modes of the synthetic, Shiny and NeRO families against the
JAX package at tiny width (CPU): a stage-3 step in linear space (tonemap
'none') and a stage-1 step on w2c rays; on one JAX-written checkpoint of
each stage, read by both packages on a fabricated Blender-layout scene:
stage 1's synthetic panels, validate_mesh_shiny's 64^3 mesh and its Shiny
evaluation, stage 3's synthetic PSNRs and relighting, and the stage-3
Pipeline of a Shiny type; and every new CLI mode of the three stages
dispatching on the port alone."""
import dataclasses
import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch

from make_fake_dtu import write_tiny_conf
from test_torch_materials import jax_vis_draws
from test_torch_render import build_pair
from test_torch_stage1 import GROUPS, _jax_loss_and_grads
from test_torch_stage3 import check_next_step, pair3

from factored_neus_tpu.evaltools.shiny import (
    evaluation_shinyblender as jevaluation_shinyblender)
from factored_neus_tpu.meshing.ply import read_ply_mesh as jread_ply_mesh
from factored_neus_tpu.pipeline import Pipeline as JPipeline
from factored_neus_tpu.train import common as JC
from factored_neus_tpu.train import stage1 as JS1
from factored_neus_tpu.train import stage3 as JS3
from factored_neus_tpu.train.runner1 import Runner as JRunner1
from factored_neus_tpu.train.runner2 import Runner as JRunner2
from factored_neus_tpu.train.runner3 import Runner as JRunner3
from factored_neus_tpu.utils import checkpoints as JCK
from factored_neus_tpu_torch import bridge, exp_runner, lvis, mateIllu
from factored_neus_tpu_torch.data import datasets as TD
from factored_neus_tpu_torch.data import rays as TRAYS
from factored_neus_tpu_torch.data.fake_scene import (
    write_blender_scene, write_glossy_synthetic_scene)
from factored_neus_tpu_torch.meshing import extract as MEXT
from factored_neus_tpu_torch.meshing.ply import read_ply_mesh
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.pipeline import Pipeline
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import runner1 as TR1
from factored_neus_tpu_torch.train import runner3 as TR3
from factored_neus_tpu_torch.train import stage1 as TS1

t = torch.from_numpy
CPU = torch.device("cpu")
CASE = "syn"
PSNR_TOL = 0.05       # dB, the synthetic PSNRs of the two packages
LEVEL_SHARE = 0.99    # of an image's values within one 8-bit level


def _tiny_conf(tmp, name, val_freq=None):
    """The tiny conf on <tmp>/data/CASE_NAME, experiments under
    <tmp>/<name>: no 512^3 mesh at val_mesh_freq, 256-ray chunks."""
    conf = write_tiny_conf(str(tmp / f"{name}.conf"),
                           str(tmp / "data" / "CASE_NAME"),
                           str(tmp / name / "CASE_NAME"), iters=4, iters2=4)
    with open(conf) as f:
        text = f.read()
    text = re.sub(r"val_mesh_freq = \d+", "val_mesh_freq = 1000000", text)
    if val_freq is not None:
        text = re.sub(r"val_freq = \d+", f"val_freq = {val_freq}", text)
    text = text.replace("report_freq = 4", "report_freq = 4\n val_chunk = 256")
    with open(conf, "w") as f:
        f.write(text)
    return conf


def _f32_sweeps(jr, tr, stage):
    """The JAX runner's render at f32 sweeps, and the port runner's."""
    jr.cfg = dataclasses.replace(jr.cfg, sweep_act_bf16=False)
    jr._render_fn = (JS1.make_render_fn(jr.cfg, jr.tcfg) if stage == 1
                     else JS3.make_render_fn(jr.cfg))
    tr.cfg = dataclasses.replace(tr.cfg, sweep_act_bf16=False)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A 16 x 20 Blender-layout scene; the JAX runners' checkpoints of
    stages 1, 2 and 3 (the tiny init, iteration 0); the JAX and port
    stage-1 runners (type indisg_synthetic) and stage-3 runners (type
    synthetic) on them."""
    tmp = tmp_path_factory.mktemp("families")
    write_blender_scene(str(tmp / "data" / CASE), n_train=3, n_test=2,
                        H=16, W=20)
    conf = _tiny_conf(tmp, "exp")
    j1 = JRunner1(conf, mode="train", case=CASE, type="indisg_synthetic")
    j1.save_checkpoint()
    JCK.wait_for_async_saves()
    JRunner2(conf, mode="train", case=CASE, type="synthetic"
             ).save_checkpoint()
    JCK.wait_for_async_saves()
    j3 = JRunner3(conf, mode="train", case=CASE, type="synthetic")
    j3.save_checkpoint()
    JCK.wait_for_async_saves()
    t1 = TR1.Runner(conf, mode="validate_synthetic_img", case=CASE,
                    is_continue=True, type="indisg_synthetic", device="cpu")
    t3 = TR3.Runner(conf, mode="cal_synthetic_psnr", case=CASE,
                    is_continue=True, type="synthetic", device="cpu")
    _f32_sweeps(j1, t1, 1)
    _f32_sweeps(j3, t3, 3)
    return tmp, conf, j1, t1, j3, t3


def _inject_jax_draws(monkeypatch, key, module=TR3):
    """The port's stage-3 renders in ``module`` take JAX's visibility
    draws: chunk i of each chunked render those of fold_in(key, i), as
    the JAX runner and pipeline draw them."""
    render, chunked = TR.mate_illu_render, module.chunked_render
    state = {"i": 0}

    def mate(model, cfg, o, d, near, far, generator=None, **kw):
        u = jax_vis_draws(jax.random.fold_in(key, state["i"]),
                          cfg.material.num_lgt_sgs, cfg.material.vis_nsamp)
        state["i"] += 1
        return render(model, cfg, o, d, near, far, u_theta=t(u[0]),
                      u_phi=t(u[1]))

    def chunks(*args, **kw):
        state["i"] = 0
        return chunked(*args, **kw)

    monkeypatch.setattr(TR, "mate_illu_render", mate)
    monkeypatch.setattr(module, "chunked_render", chunks)


def _close_images(a, b, name):
    assert a is not None and b is not None and a.shape == b.shape, name
    d = np.abs(a.astype(int) - b.astype(int))
    assert np.mean(d <= 1) >= LEVEL_SHARE, (name, d.max())


# -- steps ---------------------------------------------------------------------

def test_stage3_linear_step_matches_jax():
    """A stage-3 step with tonemap 'none' (the synthetic and Shiny
    types'): loss and every material gradient at 6e-4 + 3e-3 max|g|, and
    one Adam step, as test_torch_stage3 holds the sRGB step."""
    jcfg, jparams, cfg, _ = pair3()
    jcfg = dataclasses.replace(jcfg, material=dataclasses.replace(
        jcfg.material, tonemap="none"))
    cfg = dataclasses.replace(cfg, material=dataclasses.replace(
        cfg.material, tonemap="none"))
    model = TR.Stage3Model(cfg)
    bridge.load_jax_params(model, jparams)
    assert model.material.cfg.tonemap == "none"
    tcfg = TC.TrainConfig(warm_up_end=0.0, end_iter=100)
    jtx = JC.make_optimizer(JC.TrainConfig(warm_up_end=0.0, end_iter=100),
                            stage=3)
    check_next_step(jparams, jcfg, jtx, jtx.init(jparams), model, cfg, tcfg,
                    TC.make_optimizer(model, tcfg, stage=3), 0)


def test_w2c_stage1_step_matches_jax(tmp_path):
    """A stage-1 step on rays of a glossy-synthetic (w2c) scene, the same
    pixels through each package's loader: loss and every gradient at
    3e-4 + 2e-3 max|g|."""
    data = write_glossy_synthetic_scene(str(tmp_path / "glossy"),
                                        n_views=2, H=24, W=32)
    from factored_neus_tpu.data import datasets as JD
    from factored_neus_tpu.data import rays as JRAYS
    jd = JD.make_dataset("glossy_synthetic", {"data_dir": data})
    td = TD.make_dataset("glossy_synthetic", {"data_dir": data}, CPU)
    rng = np.random.RandomState(4)
    px, py = rng.randint(0, 32, 24), rng.randint(0, 24, 24)
    o, d, rgb, mask = (v.numpy() for v in TRAYS.rays_from_pixels(
        t(px), t(py), td.images, td.masks, td.intrinsics_all_inv,
        td.pose_all, 1, "w2c"))
    p = np.stack([px, py, np.ones_like(px)], -1).astype(np.float32)
    jdir = JRAYS.pixel_to_dir_w2c(jd.intrinsics_all_inv[1], jd.pose_all[1], p)
    np.testing.assert_allclose(d, np.asarray(jdir), atol=1e-6)
    np.testing.assert_allclose(o[0], np.asarray(JRAYS.origin_w2c(
        jd.pose_all[1])), atol=1e-6)
    assert 0.1 < mask.mean() < 0.9

    jcfg, jparams, cfg, model = build_pair()
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)
    key = jax.random.PRNGKey(11)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(key)[0], (24, 1)) - 0.5))
    (jl, jg), _ = _jax_loss_and_grads(jcfg, jparams, tcfg, o, d, rgb, mask,
                                      key, 20)
    tl, _ = TS1.loss_on_batch(model, cfg, tcfg, t(o), t(d), t(rgb),
                              t(mask), 20, t_rand=t_rand)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tl.backward()
    tg = bridge.jax_tree(model, grads=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree_util.tree_leaves(
                                {k: jg[k] for k in GROUPS})):
        b = np.asarray(b)
        tol = 3e-4 + 2e-3 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (jax.tree_util.keystr(path),
                                            np.abs(a - b).max(), tol)


# -- runner modes on one JAX checkpoint ------------------------------------------

def test_stage1_synthetic_panels_match_jax(chain):
    _, _, j1, t1, _, _ = chain
    assert t1.iter_step == j1.iter_step == 0
    j1.validate_synthetic_img(idx=1, resolution_level=2)
    res = t1.validate_synthetic_img(idx=4, resolution_level=2)  # wraps to 1
    assert res["color_fine"].shape == (8, 10, 3)
    for d, p in (("validations_fine", "v"), ("normals", "n"),
                 ("diffuse", "d"), ("specular", "s")):
        name = os.path.join(d, f"{p}_0_1.png")
        _close_images(cv2.imread(os.path.join(t1.base_exp_dir, name)),
                      cv2.imread(os.path.join(j1.base_exp_dir, name)), name)


def test_shiny_mesh_and_evaluation_match_jax(chain, monkeypatch):
    """validate_mesh_shiny of type shiny_refneus: the 64^3 intermediate
    mesh against the JAX runner's, and the Shiny evaluation of that mesh
    (scale_mat, dense_pcd.ply, test_info.json) against the JAX
    evaltools'; at iteration 10000 the full branch (its 512^3 grid cut to
    24^3 here) writes the meshes and result.txt."""
    tmp, conf, _, _, _, _ = chain
    jr = JRunner1(conf, mode="validate_mesh_shiny", case=CASE,
                  is_continue=True, type="shiny_refneus")
    tr = TR1.Runner(conf, mode="validate_mesh_shiny", case=CASE,
                    is_continue=True, type="shiny_refneus", device="cpu")
    np.testing.assert_array_equal(tr.dataset.scale_mat, jr.dataset.scale_mat)
    jr.validate_mesh_shiny()
    jv, jf = jread_ply_mesh(os.path.join(jr.base_exp_dir, "meshes",
                                         "inter_mesh.ply"))
    path = tr.validate_mesh_shiny()
    assert path == os.path.join(tr.base_exp_dir, "meshes", "inter_mesh.ply")
    v, f = read_ply_mesh(path)
    assert len(v) > 100 and v.shape == jv.shape
    np.testing.assert_array_equal(f, jf)
    # vertices interpolated between f32 grid values of two sweeps: within
    # 1e-4 (0.3% of a 64^3 cell)
    np.testing.assert_allclose(v, jv, atol=1e-4)

    from factored_neus_tpu_torch.evaltools.shiny import \
        evaluation_shinyblender
    data = os.path.join(str(tmp), "data", CASE)
    import json
    info = json.load(open(os.path.join(data, "test_info.json")))
    args = dict(max_dist_d=info["max_dist_d"], max_dist_t=info["max_dist_t"],
                points_for_plane=info["points"])
    s = tr.dataset.scale_mat
    ve = v @ s[:3, :3].T + s[:3, 3]
    got = evaluation_shinyblender(ve, f, os.path.join(data, "dense_pcd.ply"),
                                  str(tmp / "vis_t"), **args)
    want = jevaluation_shinyblender(ve, f,
                                    os.path.join(data, "dense_pcd.ply"),
                                    str(tmp / "vis_j"), **args)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(np.isfinite(got)) and got[0] < 1.0

    extract = MEXT.extract_geometry
    monkeypatch.setattr(MEXT, "extract_geometry",
                        lambda lo, hi, res, *a, **k: extract(
                            lo, hi, 24 if res == 512 else res, *a, **k))
    tr.iter_step = TR1.SHINY_EVAL_EVERY
    out = tr.validate_mesh_shiny()
    assert out.endswith("00010000_eval.ply") and os.path.exists(
        os.path.join(tr.base_exp_dir, "meshes", "00010000.ply"))
    line = open(os.path.join(tr.base_exp_dir, "result.txt")).read()
    assert line.startswith("10000: ") and len(tr.shiny_scores) == 3
    assert all(np.isfinite(tr.shiny_scores))
    assert {"fill_s", "march_s", "eval_s"} <= set(tr.mesh_times)


def test_stage3_psnr_and_relighting_match_jax(chain, monkeypatch):
    """cal_synthetic_psnr's three PSNRs within PSNR_TOL dB and
    relgt_synthetic_img's images within one level of the JAX runner's,
    on the same visibility draws; the two envmaps give two images and the
    learned lgtSGs come back."""
    tmp, _, _, _, j3, t3 = chain
    assert t3.cfg.material.tonemap == j3.cfg.material.tonemap == "none"
    _inject_jax_draws(monkeypatch, jax.random.PRNGKey(0))
    # (the ground truth is at full resolution: level 1 only, in both)
    want = j3.cal_synthetic_psnr(idx=1, resolution_level=1)
    got = t3.cal_synthetic_psnr(idx=3, resolution_level=1)   # wraps to 1
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=PSNR_TOL)
    text = open(os.path.join(t3.base_exp_dir, "psnr", "albedo.txt")).read()
    assert [float(x.split(":")[1]) for x in text.split()] == list(got)

    learned = t3.model.material.lgtSGs.detach().clone()
    envmaps = []
    for name, sgs in (("envA", learned.numpy()),
                      ("envB", learned.numpy() * [1, 1, 1, 1, 3, 0, 0])):
        os.makedirs(tmp / "env" / name, exist_ok=True)
        np.save(tmp / "env" / name / "sg_128.npy", sgs)
        envmaps.append(str(tmp / "env" / name))
    j3.relgt_synthetic_img(idx=0, resolution_level=2, envmap_paths=envmaps)
    relit = t3.relgt_synthetic_img(idx=0, resolution_level=2,
                                   envmap_paths=envmaps)
    assert len(relit) == 2 and not np.array_equal(relit[0], relit[1])
    torch.testing.assert_close(t3.model.material.lgtSGs.detach(), learned,
                               rtol=0, atol=0)
    for name in ("envA", "envB"):
        f = os.path.join("video", f"reLgtRGB_{name}.png")
        _close_images(cv2.imread(os.path.join(t3.base_exp_dir, f)),
                      cv2.imread(os.path.join(j3.base_exp_dir, f)), f)


def test_pipeline_of_a_shiny_stage3_renders_linear_like_jax(chain,
                                                            monkeypatch):
    _, conf, _, _, _, _ = chain
    import factored_neus_tpu_torch.pipeline as TP
    pipe = Pipeline.from_experiment(conf, case=CASE, type="shiny", stage=3,
                                    device="cpu", batch_size=256)
    jpipe = JPipeline.from_experiment(conf, case=CASE, type="shiny",
                                      stage=3, batch_size=256)
    assert pipe.cfg.material.tonemap == jpipe.cfg.material.tonemap == "none"
    assert Pipeline.from_experiment(conf, case=CASE, type="shiny", stage=2,
                                    device="cpu").cfg.material.tonemap == \
        "srgb"
    _inject_jax_draws(monkeypatch, jax.random.PRNGKey(0), TP)
    got, want = pipe.render_decomposition(1, 2), jpipe.render_decomposition(
        1, 2)
    for k in ("rgb", "diffuse_albedo", "roughness"):
        np.testing.assert_allclose(got[k], want[k], atol=3e-4, err_msg=k)
    # linear, not the sRGB curve
    srgb = Pipeline.from_experiment(conf, case=CASE, type="shiny", stage=3,
                                    device="cpu", batch_size=256)
    mat = srgb.model.material
    mat.cfg = dataclasses.replace(mat.cfg, tonemap="srgb")
    assert not np.allclose(srgb.render_decomposition(1, 2)["rgb"],
                           got["rgb"], atol=1e-3)


# -- the CLIs --------------------------------------------------------------------

def test_every_new_cli_mode_dispatches(tmp_path, monkeypatch):
    """The three CLIs on an 8 x 10 scene: stage 1 trains indisg_synthetic
    (synthetic panels at val_freq), validate_image (the synthetic panels
    of view 57, wrapped), validate_mesh_shiny (shiny_refneus); stage 2
    trains synthetic and validate_synthetic_img; stage 3 trains synthetic
    in linear space and runs indiSG_psnr, cal_psnr, relgt_img,
    relgt_video, validate_synthetic_video, Shiny's validate_image and
    cal_nerfactor_psnr."""
    write_blender_scene(str(tmp_path / "data" / CASE), n_train=2, n_test=2,
                        H=8, W=10)
    conf = _tiny_conf(tmp_path, "cli", val_freq=4)
    base = ["--conf", conf, "--case", CASE, "--device", "cpu"]
    r1 = exp_runner.main(["--mode", "train", "--type", "indisg_synthetic",
                          *base])
    assert r1.iter_step == 4 and r1.history
    out1 = r1.base_exp_dir
    assert os.listdir(os.path.join(out1, "validations_fine"))
    exp_runner.main(["--mode", "validate_image", "--is_continue", "--type",
                     "indisg_synthetic", *base])
    assert os.path.exists(os.path.join(out1, "validations_fine",
                                       f"v_4_{57 % 2}.png"))
    r = exp_runner.main(["--mode", "validate_mesh_shiny", "--is_continue",
                         "--type", "shiny_refneus", *base])
    assert r.last_mesh.endswith("inter_mesh.ply")

    r2 = lvis.main(["--mode", "train", "--type", "synthetic", *base])
    assert r2.iter_step == 4
    lvis.main(["--mode", "validate_synthetic_img", "--is_continue",
               "--type", "synthetic", *base])
    assert os.listdir(os.path.join(r2.base_exp_dir, "trace_radiance", "4"))

    r3 = mateIllu.main(["--mode", "train", "--type", "synthetic", *base])
    assert r3.iter_step == 4 and r3.cfg.material.tonemap == "none"
    out3 = r3.base_exp_dir
    assert os.listdir(os.path.join(out3, "indi_light"))
    cont = ["--is_continue", "--type", "synthetic", *base]
    mateIllu.main(["--mode", "indiSG_psnr", *cont])
    mateIllu.main(["--mode", "cal_psnr", "--idx", "1", *cont])
    for i in (1, 55 % 2):
        assert os.path.exists(os.path.join(out3, "psnr", f"preRGB_{i}.png"))
    monkeypatch.chdir(tmp_path)
    sgs = r3.model.material.lgtSGs.detach().numpy()
    for name in ("envmap6", "envmap12"):
        os.makedirs(tmp_path / "envmaps" / name)
        np.save(tmp_path / "envmaps" / name / "sg_128.npy", sgs)
    mateIllu.main(["--mode", "relgt_img", *cont])
    for name in ("envmap6", "envmap12"):
        assert os.path.exists(os.path.join(out3, "video",
                                           f"reLgtRGB_{name}.png"))
    v = mateIllu.main(["--mode", "relgt_video", *cont])
    assert [os.path.basename(p).split(".")[0].replace("_frames", "")
            for p in v.videos] == ["relgt_envmap6_img", "relgt_envmap12_img"]
    v = mateIllu.main(["--mode", "validate_synthetic_video", *cont])
    assert len(v.videos) == 5 and all(os.path.exists(p) for p in v.videos)
    mateIllu.main(["--mode", "validate_image", "--is_continue", "--type",
                   "shiny", *base])
    assert os.path.exists(os.path.join(out3, "normal", "n_4_0.png"))
    r = mateIllu.main(["--mode", "cal_nerfactor_psnr", *cont])
    assert os.path.exists(os.path.join(out3, "psnr", "r_0.png"))
