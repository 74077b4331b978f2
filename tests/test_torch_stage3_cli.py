"""The port's stage 1 -> 2 -> 3 CLI chain on a fabricated DTU scene (CPU):
stage-3 training, its panels, logs, envmap EXR and checkpoint,
validate_image and validate_video; the Pipeline on those checkpoints
beside the JAX package's; the quality tool's stage-3 leg; chip_smoke.py's
stage-3 conf; and the profile tool's grouping of the visibility sweep."""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene
from test_torch_stage3 import _conf

from factored_neus_tpu.pipeline import Pipeline as JPipeline
from factored_neus_tpu_torch import exp_runner, lvis, mateIllu
from factored_neus_tpu_torch.data.exr import read_exr
from factored_neus_tpu_torch.pipeline import Pipeline
from factored_neus_tpu_torch.tools import quality as Q
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import runner2 as TR2
from factored_neus_tpu_torch.train import runner3 as TR3
from factored_neus_tpu_torch.utils import checkpoints as CK
from factored_neus_tpu_torch.utils import config as TCFG


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def test_cli_stages_1_2_3_then_validate_and_pipeline(tmp_path):
    # 16 x 20 views: a full-width visibility sweep is 131,072 rows a ray on
    # the CPU
    make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"), n_views=3,
                        H=16, W=20)
    conf = _conf(tmp_path, "cli", val_chunk=True)
    base = ["--conf", conf, "--case", "fake_scan", "--type", "dtu",
            "--device", "cpu"]
    exp_runner.main(["--mode", "train", *base])
    r2 = lvis.main(["--mode", "train", *base])
    r = mateIllu.main(["--mode", "train", *base])
    assert r.iter_step == 4 and len(r.history) == 1
    m = r.history[0]
    assert np.isfinite(m["loss"]) and m["n_hit"] > 0 and m["psnr"] > 0
    out = r.base_exp_dir
    for sub, name in (("rgb", "rgb_4_*.png"), ("rgb", "rgbPre_4_*.png"),
                      ("diffuse", "d_4_*.png"), ("specular", "s_4_*.png"),
                      ("roughness", "r_4_*.png"),
                      ("lvis_mean", "lvis_4_*.png"),
                      ("indiLgt", "indiLgt_4_*.png"),
                      ("normal", "n_4_*.png")):
        assert glob.glob(os.path.join(out, sub, name)), (sub, name)
    assert os.listdir(os.path.join(out, "logs"))
    env = read_exr(os.path.join(out, "env_light", "iter_step_4.exr"))
    assert env.shape == (256, 512, 3) and np.isfinite(env).all()
    # the frozen groups leave stage 3 as they came from stage 2
    ck2 = CK.load_checkpoint(r2.last_checkpoint)
    ck3 = CK.load_checkpoint(r.last_checkpoint)
    for ck in TR2.STAGE2_KEYS.values():
        for a, b in zip(_leaves(ck3[ck]), _leaves(ck2[ck]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=ck)

    v = mateIllu.main(["--mode", "validate_image", "--is_continue",
                       "--idx", "1", *base])
    assert v.iter_step == 4
    for a, b in zip(v.model.state_dict().values(),
                    r.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert os.path.exists(os.path.join(out, "rgb", "rgb_4_1.png"))
    np.testing.assert_array_equal(read_exr(v.last_envmap), env)
    vid = mateIllu.main(["--mode", "validate_video", "--is_continue", *base])
    names = ("cs", "cd", "albedo", "img_pre", "img_gt", "indiLgt",
             "lvisMean")
    assert len(vid.videos) == len(names)
    for name, path in zip(names, vid.videos):
        assert os.path.basename(path).startswith(name) and \
            os.path.exists(path), path

    # the Pipeline on these checkpoints, beside the JAX package's
    pipe = Pipeline.from_experiment(conf, case="fake_scan", device="cpu",
                                    batch_size=256)
    jpipe = JPipeline.from_experiment(conf, case="fake_scan",
                                      batch_size=256)
    np.testing.assert_allclose(pipe.render_view(0, 4),
                               jpipe.render_view(0, 4), atol=3e-4)
    np.testing.assert_allclose(pipe.envmap(16, 32), jpipe.envmap(16, 32),
                               atol=1e-4)
    np.testing.assert_allclose(pipe.sdf(np.zeros((3, 3), np.float32)),
                               jpipe.sdf(np.zeros((3, 3), np.float32)),
                               atol=1e-5)
    maps = pipe.render_decomposition(0, 4)
    assert set(maps) == set(TR3.VAL_KEYS)
    assert maps["rgb"].shape == (4, 5, 3)
    sg_dir = tmp_path / "envmap"
    sg_dir.mkdir()
    learned = pipe.model.material.lgtSGs.detach().clone()
    np.save(sg_dir / "sg_128.npy", learned.numpy())
    np.testing.assert_array_equal(pipe.relight(str(sg_dir), 0, 4),
                                  maps["rgb"])
    np.save(sg_dir / "sg_128.npy", learned.numpy() * [1, 1, 1, 1, 3, 0, 0])
    relit = pipe.relight(str(sg_dir), 0, 4)
    assert not np.array_equal(relit, maps["rgb"])
    torch.testing.assert_close(pipe.model.material.lgtSGs.detach(), learned,
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        pipe.extract_mesh(resolution=16, mesh=object())
    with pytest.raises(FileNotFoundError, match="trained groups"):
        Pipeline.from_experiment(_conf(tmp_path, "empty"), case="fake_scan",
                                 device="cpu")


def test_quality_stage3_leg_scores_a_run(tmp_path):
    """The quality tool's stage-3 leg: the run conf's stage-3 directory,
    and the tail rgb loss, PSNR and rays/s of a stage-3 log."""
    repo = os.path.dirname(os.path.dirname(__file__))
    path = Q.write_run_conf(os.path.join(repo, "confs", "wmask.conf"),
                            str(tmp_path / "wmask.conf"),
                            str(tmp_path / "data"), str(tmp_path / "e"),
                            20000)
    c = TCFG.load(path, "fake_scan")
    assert c["general.base_exp_dir_mateIllu"] == str(
        tmp_path / "e" / "fake_scan" / "wmask" / "mateIllu")
    assert TC.TrainConfig.from_conf(c, stage=3).end_iter == 40000
    log = tmp_path / "mateIllu.log"
    log.write_text("\n".join(
        f"x INFO iter {i} rgb={v:.5f} psnr={30 + i:.2f} rays/s={r}"
        for i, (v, r) in enumerate(zip([0.5, 0.1, 0.2, 0.3, 0.4, 0.5],
                                       [10, 20, 30, 40, 50, 60]))))
    row = Q.score_stage3(str(tmp_path / "exp"), str(log))
    assert row["rgb_loss_tail"] == pytest.approx(0.3)
    assert row["stage3_psnr_tail"] == pytest.approx(33.0)
    assert row["stage3_rays_per_sec_median"] == pytest.approx(35.0)
    assert row["stage3_panels"] == str(tmp_path / "exp" / "rgb")


def test_chip_smoke_points_stage3_into_its_run(tmp_path):
    """chip_smoke.write_conf sends stage 3's directory and its 40k-step
    schedule into the run, as it does stages 1 and 2."""
    import chip_smoke
    c = TCFG.load(chip_smoke.write_conf(str(tmp_path), steps=7), "sphere")
    assert c["general.base_exp_dir_mateIllu"] == str(
        tmp_path / "exp" / "sphere" / "mateIllu")
    assert [TC.TrainConfig.from_conf(c, stage=s).end_iter
            for s in (1, 2, 3)] == [7, 7, 7]
    u = chip_smoke.s3_draws(np.random.RandomState(0),
                            TCFG.renderer_config(c, "model.lvis_renderer"))
    assert [tuple(v.shape) for v in u] == [(128, 32), (128, 32)]


def test_profile_tool_groups_the_visibility_sweep():
    """tools/profile_torch_stage1.outer_kernels sums the kernels of every
    op below the "Lvis.outer" range, at any depth, and nothing else."""
    import importlib.util
    from types import SimpleNamespace as NS
    spec = importlib.util.spec_from_file_location(
        "profile_torch_stage1", os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "tools",
            "profile_torch_stage1.py"))
    prof_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof_tool)
    cpu = torch.autograd.DeviceType.CPU
    outer = NS(name=prof_tool.OUTER, cpu_parent=None, device_type=cpu,
               kernels=[])
    mm = NS(name="aten::mm", cpu_parent=outer, device_type=cpu, kernels=[])
    launch = NS(name="cudaLaunchKernel", cpu_parent=mm, device_type=cpu,
                kernels=[NS(name="gemm", duration=5.0)])
    relu = NS(name="aten::relu_", cpu_parent=outer, device_type=cpu,
              kernels=[NS(name="relu", duration=2.0),
                       NS(name="gemm", duration=1.0)])
    other = NS(name="aten::mm", cpu_parent=None, device_type=cpu,
               kernels=[NS(name="gemm", duration=7.0)])
    device = NS(name="gemm", cpu_parent=None,
                device_type=torch.autograd.DeviceType.CUDA,
                kernels=[NS(name="gemm", duration=9.0)])
    fake = NS(events=lambda: [outer, mm, launch, relu, other, device])
    assert prof_tool.outer_kernels(fake) == {"gemm": [6.0, 2],
                                             "relu": [2.0, 1]}
