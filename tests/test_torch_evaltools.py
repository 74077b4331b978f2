"""The port's evaluation half of the mesh path against the JAX package:
the native KD-tree and downsample, mesh sampling, the DTU, EPFL and Shiny
protocols, mask cleaning (with its cv2-free ellipse dilation), the eval
CLIs, EXR files, the scene writer, videos, the TensorBoard writer and the
quality tool's scoring (CPU)."""
import os
import sys
import types

import cv2
import numpy as np
import pytest

from make_fake_dtu import make_fake_dtu_scene

from factored_neus_tpu import native as JN
from factored_neus_tpu.data import exr as JEXR
from factored_neus_tpu.evaltools import clean_mesh as JCM
from factored_neus_tpu.evaltools import dtu as JDTU
from factored_neus_tpu.evaltools import epfl as JEPFL
from factored_neus_tpu.evaltools import pointcloud as JPC
from factored_neus_tpu.evaltools import shiny as JSHINY
from factored_neus_tpu.meshing.ply import write_ply as jwrite_ply
from factored_neus_tpu.utils.video import write_video as jwrite_video
from factored_neus_tpu_torch import clean_mesh_pose, eval_mesh
from factored_neus_tpu_torch import native as TN
from factored_neus_tpu_torch.data import exr as TEXR
from factored_neus_tpu_torch.data.fake_scene import write_sphere_scene
from factored_neus_tpu_torch.evaltools import clean_mesh as TCM
from factored_neus_tpu_torch.evaltools import dtu as TDTU
from factored_neus_tpu_torch.evaltools import epfl as TEPFL
from factored_neus_tpu_torch.evaltools import pointcloud as TPC
from factored_neus_tpu_torch.evaltools import shiny as TSHINY
from factored_neus_tpu_torch.meshing.ply import read_ply_mesh, write_ply
from factored_neus_tpu_torch.tools import quality as Q
from factored_neus_tpu_torch.utils import config as CFG
from factored_neus_tpu_torch.utils import logging as TLOG
from factored_neus_tpu_torch.utils.video import write_video

HERE = os.path.dirname(os.path.abspath(__file__))


def _sphere_mesh(res=40, r=0.5, scale=10.0, center=(0, 0, 0)):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    xx, yy, zz = np.meshgrid(x, x, x, indexing="ij")
    v, t = TN.marching_cubes(-(np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - r))
    return (v / (res - 1.0) * 2.0 - 1.0) * scale + np.asarray(center), t


def _sphere_points(n, r, seed):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return (r * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(
        np.float32)


def test_kdtree_and_downsample_equal_the_jax_natives():
    rng = np.random.RandomState(0)
    pts = rng.rand(5000, 3).astype(np.float32)
    q = rng.rand(3000, 3).astype(np.float32)
    jd, ji = JN.KDTree(pts).query(q)
    td, ti = TN.KDTree(pts).query(q)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(TN.KDTree(pts).query_radius_count(q, 0.05),
                                  JN.KDTree(pts).query_radius_count(q, 0.05))
    np.testing.assert_array_equal(TN.greedy_downsample(pts, 0.03),
                                  JN.greedy_downsample(pts, 0.03))
    brute = np.sqrt(((q[:200, None].astype(np.float64) - pts[None]) ** 2)
                    .sum(-1).min(1))
    np.testing.assert_allclose(td[:200], brute, atol=1e-6)
    with pytest.raises(ValueError, match="points"):
        TN.KDTree(pts[:, :2])


def test_pointcloud_equals_jax():
    v, t = _sphere_mesh(res=24)
    np.testing.assert_array_equal(TPC.sample_mesh_points(v, t, 0.2),
                                  JPC.sample_mesh_points(v, t, 0.2))
    pts = TPC.sample_mesh_points(v, t, 0.2)
    np.testing.assert_array_equal(TPC.downsample(pts, 0.2),
                                  JPC.downsample(pts, 0.2))
    gt = _sphere_points(3000, 5.0, 1)
    d = TPC.nn_distances(pts, gt)
    np.testing.assert_array_equal(d, JPC.nn_distances(pts, gt))
    active = np.arange(0, len(pts), 3)
    np.testing.assert_array_equal(
        TPC.error_colors(len(pts), active, d[active] * 30, 1.0, 20.0),
        JPC.error_colors(len(pts), active, d[active] * 30, 1.0, 20.0))


def _dtu_fixture(root, scene=97):
    """tests/test_eval_protocols.py's fabricated DTU eval data."""
    from scipy.io import savemat
    os.makedirs(root / "dtu" / "ObsMask")
    os.makedirs(root / "dtu" / "Points" / "stl")
    verts, tris = _sphere_mesh(scale=10.0)
    mesh = str(root / "pred.ply")
    write_ply(mesh, verts, tris)
    write_ply(str(root / "dtu" / "Points" / "stl" /
                  f"stl{scene:03}_total.ply"), _sphere_points(50000, 5.0, 0))
    bb = np.array([[-12.0, -12.0, -12.0], [12.0, 12.0, 12.0]])
    obs = np.ones((24, 24, 24), dtype=np.uint8)
    obs[:3] = 0                                   # an unobserved slab
    savemat(str(root / "dtu" / "ObsMask" / f"ObsMask{scene}_10.mat"),
            {"ObsMask": obs, "BB": bb, "Res": np.array([[1.0]])})
    savemat(str(root / "dtu" / "ObsMask" / f"Plane{scene}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [4.0]])})
    return mesh, str(root / "dtu")


def _same_files(a, b, names):
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n


def test_dtu_protocol_and_eval_cli_equal_jax(tmp_path):
    mesh, data = _dtu_fixture(tmp_path)
    want = JDTU.eval(mesh, 97, data, str(tmp_path / "j"))
    got = TDTU.eval(mesh, 97, data, str(tmp_path / "t"))
    assert got == want
    _same_files(tmp_path / "j", tmp_path / "t",
                ["result.txt", "vis_097_d2s.ply", "vis_097_s2d.ply"])
    # the CLI: exp/<case>/<setting>/meshes_clean/<suffix>.ply
    exp = tmp_path / "exp" / "scan97" / "wmask" / "geometry"
    os.makedirs(exp / "meshes_clean")
    os.replace(mesh, exp / "meshes_clean" / "00300000.ply")
    assert eval_mesh.main(["--scene", "97", "--setting", "wmask/geometry",
                           "--dataset_dir", data, "--exp_dir",
                           str(tmp_path / "exp"), "--case", "scan97"]) == want
    assert (exp / "result.txt").exists()


def test_shiny_protocols_equal_jax(tmp_path):
    verts, tris = _sphere_mesh(scale=2.0)
    gt = str(tmp_path / "dense_pcd.ply")
    write_ply(gt, _sphere_points(30000, 1.0, 1))
    kw = dict(downsample_density=0.05, max_dist_d=10.0, max_dist_t=10.0,
              points_for_plane=[[1, 0, -0.5], [0, 0, -0.5], [0, 1, -0.5]])
    for bbox in (None, [[3.0, 3.0, 0.5], [-3.0, -3.0, 0.2]]):
        want = JSHINY.evaluation_shinyblender(verts, tris, gt,
                                              str(tmp_path / "j"),
                                              nonvalid_bbox=bbox, **kw)
        got = TSHINY.evaluation_shinyblender(verts, tris, gt,
                                             str(tmp_path / "t"),
                                             nonvalid_bbox=bbox, **kw)
        assert got == want
        _same_files(tmp_path / "j", tmp_path / "t",
                    ["vis_d2s.ply", "vis_s2d.ply"])
    assert TSHINY.evaluation(verts, tris, gt, str(tmp_path), 0.05) == \
        JSHINY.evaluation(verts, tris, gt, str(tmp_path), 0.05)


def test_epfl_protocol_equals_jax(tmp_path):
    scene = "fountain"
    dense = tmp_path / f"{scene}_dense"
    os.makedirs(dense)
    verts, tris = _sphere_mesh(res=24, scale=2.0)
    mesh = str(tmp_path / "pred.ply")
    write_ply(mesh, verts, tris)
    full = _sphere_points(20000, 1.0, 2)
    write_ply(str(dense / "gt_full.ply"), full)
    write_ply(str(dense / "gt_center.ply"), full[full[:, 2] > 0])
    np.save(str(dense / "bbox.npy"), full[full[:, 2] > 0.2])
    want = JEPFL.eval(mesh, scene, str(tmp_path), str(tmp_path / "j"))
    got = TEPFL.eval(mesh, scene, str(tmp_path), str(tmp_path / "t"))
    assert got == want
    _same_files(tmp_path / "j", tmp_path / "t", ["result.txt"])


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 7, 25])
def test_ellipse_dilation_equals_cv2(ksize):
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    np.testing.assert_array_equal(TCM.ellipse_kernel(ksize), kernel)
    rng = np.random.RandomState(ksize)
    for img in ((rng.rand(50, 70) > 0.99).astype(np.uint8) * 255,
                rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(TCM.dilate_ellipse(img, ksize),
                                      cv2.dilate(img, kernel))


def test_clean_mesh_and_its_cli_equal_jax(tmp_path):
    """A 49-view scan (the CLI's count below scan 83): the sphere's mesh
    plus a blob outside every mask; both packages keep the same
    vertices and faces."""
    scan = 24
    data = tmp_path / "data_DTU" / f"dtu_scan{scan}"
    make_fake_dtu_scene(str(data), n_views=49, H=24, W=32)
    v, t = _sphere_mesh(res=24, r=0.5, scale=1.0)
    bv, bt = _sphere_mesh(res=12, r=0.5, scale=0.2, center=(0.0, 0.0, 1.4))
    verts = np.concatenate([v, bv]).astype(np.float64)
    faces = np.concatenate([t, bt + len(v)]).astype(np.int64)
    masks = sorted(str(p) for p in (data / "mask").iterdir())
    cams = str(data / "cameras_sphere.npz")
    want = JCM.clean_mesh(verts, faces, cams, masks, 49)
    got = TCM.clean_mesh(verts, faces, cams, masks, 49)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(got[0]) < len(verts)

    exp = tmp_path / "exp" / f"scan{scan}" / "wmask" / "geometry"
    jwrite_ply(str(exp / "meshes" / "00300000.ply"), verts, faces)
    out = clean_mesh_pose.main(["--scene", str(scan), "--setting",
                                "wmask/geometry", "--data_dir",
                                str(tmp_path / "data_DTU"), "--exp_dir",
                                str(tmp_path / "exp"), "--case",
                                f"scan{scan}"])
    cv, cf = read_ply_mesh(out)
    np.testing.assert_allclose(cv, want[0], atol=1e-6)
    np.testing.assert_array_equal(cf, want[1])


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_exr_files_cross_bit_for_bit(tmp_path, half, C):
    img = np.random.RandomState(C).randn(9, 13, C).astype(np.float32) * 40
    img = img[..., 0] if C == 1 else img
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    JEXR.write_exr(jp, img, half=half)
    TEXR.write_exr(tp, img, half=half)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(TEXR.read_exr(jp), JEXR.read_exr(tp))
    np.testing.assert_array_equal(TEXR.read_exr(tp), JEXR.read_exr(jp))
    want = img.reshape(9, 13, C)
    if half:
        want = want.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(TEXR.read_exr(tp), want)


def test_scene_writer_equals_make_fake_dtu_scene(tmp_path):
    kw = dict(n_views=9, H=24, W=32, y_range=(0.2, 1.2))
    a = make_fake_dtu_scene(str(tmp_path / "a"), **kw)
    b = write_sphere_scene(str(tmp_path / "b"), **kw)
    for d in ("image", "mask"):
        names = sorted(os.listdir(os.path.join(a, d)))
        assert names == sorted(os.listdir(os.path.join(b, d)))
        for n in names:
            np.testing.assert_array_equal(cv2.imread(os.path.join(b, d, n)),
                                          cv2.imread(os.path.join(a, d, n)))
    ca = np.load(os.path.join(a, "cameras_sphere.npz"))
    cb = np.load(os.path.join(b, "cameras_sphere.npz"))
    assert sorted(ca.files) == sorted(cb.files)
    for k in ca.files:
        np.testing.assert_array_equal(cb[k], ca[k])


def _frames():
    out = []
    for i in range(4):
        f = np.zeros((16, 24, 3), np.uint8)
        f[..., 0], f[..., 1], f[..., 2] = 200, 90, 30 + i
        out.append(f)
    return out


def test_write_video_falls_back_to_png_frames(tmp_path, monkeypatch):
    """With neither imageio nor cv2 (as on a machine without them) the
    frames land in <name>_frames/ in RGB order, as the JAX package's
    fallback writes them."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for bgr in (False, True):
        out = write_video(str(tmp_path / f"v{bgr}.mp4"), _frames(), bgr=bgr)
        assert out == str(tmp_path / f"v{bgr}_frames")
        names = sorted(os.listdir(out))
        assert names == [f"{i:04d}.png" for i in range(4)]
        monkeypatch.undo()
        for i, n in enumerate(names):
            rgb = cv2.imread(os.path.join(out, n))[..., ::-1]
            want = _frames()[i][..., ::-1] if bgr else _frames()[i]
            np.testing.assert_array_equal(rgb, want)
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v2", None)
        monkeypatch.setitem(sys.modules, "cv2", None)


def test_write_video_uses_an_encoder_when_there_is_one(tmp_path):
    out = write_video(str(tmp_path / "v.mp4"), _frames(), fps=10)
    want = jwrite_video(str(tmp_path / "j.mp4"), _frames(), fps=10)
    assert os.path.isdir(out) == os.path.isdir(want)
    assert os.path.isdir(out) or os.path.getsize(out) > 0


def test_metrics_writer_and_meter(tmp_path, monkeypatch):
    w = TLOG.MetricsWriter(str(tmp_path / "logs"))
    w.scalars({"Loss/loss": 0.5, "Perf/rays_per_sec": 1e4}, 3)
    w.close()
    assert any(f.startswith("events") for f in os.listdir(tmp_path / "logs"))
    monkeypatch.setattr(TLOG, "_summary_writer_class", lambda: None)
    w = TLOG.MetricsWriter(str(tmp_path / "none"))
    w.scalars({"Loss/loss": 0.5}, 3)          # a no-op
    w.close()
    assert os.listdir(tmp_path / "none") == []

    m = TLOG.ThroughputMeter(window=2)
    m.step(100)                                 # starts the clock
    m.step(100)
    assert m.rays_per_sec == 0.0
    m.step(100)
    assert m.rays_per_sec > 0.0


def test_quality_scoring_equals_the_jax_protocol(tmp_path, monkeypatch):
    """chamfer_vs_sphere against tools/e2e_torch_parity._chamfer_vs_sphere
    on the same mesh; the run confs; the tail PSNR; the gap rule."""
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(HERE),
                                             "tools"))
    from e2e_torch_parity import _chamfer_vs_sphere

    v, t = _sphere_mesh(res=48, r=0.5 * 0.96, scale=1.0)
    mesh_dir = tmp_path / "exp" / "meshes"
    write_ply(str(mesh_dir / "00000500.ply"), v, t)
    write_ply(str(mesh_dir / "00001000.ply"), v, t)
    want = _chamfer_vs_sphere(str(mesh_dir / "00001000.ply"))
    got = Q.chamfer_vs_sphere(*read_ply_mesh(str(mesh_dir / "00001000.ply")))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert 0.015 < got[0] < 0.025             # the radius is 4% short

    log = tmp_path / "run.log"
    log.write_text("\n".join(f"x INFO iter {i} loss=0.1 psnr={p:.2f} "
                             f"rays/s=1000" for i, p in
                             enumerate([10, 20, 30, 40, 50, 60, 70])))
    row = Q.score_run(str(tmp_path / "exp"), str(log))
    assert row["mesh"] == "00001000.ply"
    assert row["train_psnr_tail"] == pytest.approx(50.0)
    np.testing.assert_allclose([row["chamfer_d2s"], row["chamfer_s2d"]],
                               want, rtol=1e-12)

    bars = {"chamfer_d2s": [0.0109, 0.0008], "chamfer_s2d": [0.0105, 0.0009],
            "train_psnr_tail": [52.06, 0.27]}
    ok = Q.compare({"chamfer_d2s": [0.0115, 0.0002],
                    "chamfer_s2d": [0.0105, 0.0], "train_psnr_tail":
                    [52.5, 0.1]}, bars)
    assert not any(ok[m]["fault"] for m in Q.METRICS)
    bad = Q.compare({"chamfer_d2s": [0.013, 0.0002], "chamfer_s2d":
                     [0.0105, 0.0], "train_psnr_tail": [50.0, 0.1]}, bars)
    assert bad["chamfer_d2s"]["fault"] and bad["train_psnr_tail"]["fault"]

    repo = os.path.dirname(HERE)
    for conf in ("wmask", "womask"):
        path = Q.write_run_conf(os.path.join(repo, "confs", f"{conf}.conf"),
                                str(tmp_path / f"{conf}.conf"),
                                str(tmp_path / "data"), str(tmp_path / "e"),
                                20000)
        c = CFG.load(path, "fake_scan")
        assert c["train.end_iter"] == 20000 and c["general.recording"] == []
        assert c["dataset.data_dir"] == str(tmp_path / "data" /
                                            "fake_scan") + "/"
        assert c["general.base_exp_dir_geo"] == str(
            tmp_path / "e" / "fake_scan" / conf / "geometry")
