"""Validation images of the PyTorch port against the JAX package on the
same weights and a fabricated DTU scene: ray grids, the bilinear resize,
the chunked render with its normal map, the five panels and their file
names, and the other runner modes (CPU, f32)."""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf

from factored_neus_tpu.data import rays as JRAYS
from factored_neus_tpu.meshing.ply import read_ply_mesh as jread_ply_mesh
from factored_neus_tpu.train.runner1 import Runner as JRunner
from factored_neus_tpu_torch import bridge, exp_runner
from factored_neus_tpu_torch.data import images as TI
from factored_neus_tpu_torch.data import rays as TRAYS
from factored_neus_tpu_torch.meshing.ply import write_ply
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train.runner1 import Runner

torch.backends.cuda.matmul.allow_tf32 = False
ITER = 7
KEYS = ("color_fine", "diffuse_color", "specular_color", "surface_color",
        "normals")
# the render tests' f32 tolerance (test_torch_render.test_render_matches_jax)
ATOL, RTOL = 2e-5, 1e-4
# over a whole image, a sample that lands on the other side of a ladder bin
# edge or of the unit sphere's edge moves its ray: at most RAY_SHARE of the
# rays may miss ATOL / RTOL, and none by more than RAY_MAX
RAY_SHARE, RAY_MAX = 1e-3, 2e-2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A fabricated scene and tiny conf; a JAX runner and a port runner on
    the same weights, both at iteration ITER."""
    tmp = tmp_path_factory.mktemp("val")
    make_fake_dtu_scene(str(tmp / "data" / "fake_scan"), n_views=3, H=48,
                        W=64)
    conf = write_tiny_conf(str(tmp / "tiny.conf"), str(tmp / "data" /
                                                       "CASE_NAME"),
                           str(tmp / "exp" / "CASE_NAME"), iters=8)
    jr = JRunner(conf, mode="validate_image", case="fake_scan")
    tr = Runner(conf, mode="validate_image", case="fake_scan", device="cpu")
    bridge.load_jax_params(tr.model, jax.tree_util.tree_map(np.asarray,
                                                            jr.params))
    jr.iter_step = tr.iter_step = ITER
    return conf, jr, tr


@pytest.mark.parametrize("level", [1, 2, 4])
def test_ray_grids_match_jax(scene, level):
    _, jr, tr = scene
    jd, td = jr.dataset, tr.dataset
    for idx in range(td.n_images):
        want = jd.gen_rays_at(idx, level)
        got = td.gen_rays_at(idx, level)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        want = JRAYS.gen_rays_grid(jd.intrinsics_all_inv[idx],
                                   jd.pose_all[idx], 37, 53, level)
        got = TRAYS.gen_rays_grid(td.intrinsics_all_inv[idx],
                                  td.pose_all[idx], 37, 53, level)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for ratio in (0.0, 0.3, 1.0):
        for a, b in zip(td.gen_rays_between(0, 2, ratio, level),
                        jd.gen_rays_between(0, 2, ratio, level)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("shape", [(1200, 1600, 300, 400), (37, 53, 9, 13),
                                   (48, 64, 48, 64), (10, 12, 21, 30),
                                   (30, 40, 7, 40)])
def test_imresize_matches_cv2(shape):
    """cv2.resize's INTER_LINEAR on 0-255 floats, to 1e-3."""
    H, W, h, w = shape
    img = np.random.RandomState(H).uniform(0, 255, (H, W, 3))
    np.testing.assert_allclose(TI.imresize(img, w, h),
                               cv2.resize(img, (w, h)), atol=1e-3)
    np.testing.assert_allclose(TI.imresize(img[..., 0], w, h),
                               cv2.resize(img[..., 0], (w, h)), atol=1e-3)


@pytest.mark.parametrize("level", [1, 4])
def test_image_at_matches_jax(scene, level):
    _, jr, tr = scene
    for idx in range(tr.dataset.n_images):
        np.testing.assert_allclose(tr.dataset.image_at(idx, level),
                                   jr.dataset.image_at(idx, level),
                                   atol=1e-3)


def test_chunked_render_pads_and_trims():
    """Chunks of 3 over 7 rays: the last padded with the last ray, every
    chunk seen once, the result trimmed; derived entries from post."""
    seen = []

    def fn(o, d, i):
        seen.append((i, o.shape[0]))
        return {"x": o[:, :1] + d[:, :1], "skip": o}

    o = torch.arange(21, dtype=torch.float32).reshape(1, 7, 3)
    res, H, W = TC.chunked_render(fn, o, torch.zeros_like(o), 3, ("x",),
                                  post=lambda out: {"y": 2 * out["x"]})
    assert (H, W) == (1, 7) and seen == [(0, 3), (3, 3), (6, 3)]
    assert set(res) == {"x", "y"}
    np.testing.assert_array_equal(res["x"][:, 0], np.arange(0, 21, 3))
    np.testing.assert_array_equal(res["y"], 2 * res["x"])
    assert TC.val_chunk_size(TC.TrainConfig(val_chunk=256,
                                            batch_size=512)) == 512


def test_render_image_matches_jax(scene):
    """The chunked no-grad render of a whole view (2 chunks of 2048 rays
    at level 1, the last padded) and the on-device normal map, against
    the JAX runner's _render_image, at the render tests' tolerance in all
    but RAY_SHARE of the rays."""
    _, jr, tr = scene
    jo, jd_ = jr.dataset.gen_rays_at(1, 1)
    to, td_ = tr.dataset.gen_rays_at(1, 1)
    want = jr._render_image(jo, jd_, keys=KEYS[:4])
    got = tr._render_image(to, td_, keys=KEYS[:4])
    n, chunk = to.shape[0] * to.shape[1], TC.val_chunk_size(tr.tcfg)
    assert n > chunk and n % chunk
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        a, b = got[k].reshape(n, -1), want[k].reshape(n, -1)
        off = ~np.isclose(a, b, atol=ATOL, rtol=RTOL).all(-1)
        assert off.mean() <= RAY_SHARE, (k, int(off.sum()))
        assert np.abs(a - b).max() <= RAY_MAX, (k, np.abs(a - b).max())


def _panels(base):
    out = {}
    for d in ("validations_fine", "normals", "diffuse", "specular",
              "CdPlusCs"):
        for f in sorted(os.listdir(os.path.join(base, d))):
            out[f"{d}/{f}"] = cv2.imread(os.path.join(base, d, f))
    return out


def test_validate_image_panels_match_jax(scene):
    """validate_image's five panels: the JAX runner's file names, and
    images within one grey level (rounding of the same floats)."""
    _, jr, tr = scene
    jr.validate_image(idx=2, resolution_level=2)
    res = tr.validate_image(idx=2, resolution_level=2)
    assert set(res) == set(KEYS)
    want, got = _panels(jr.base_exp_dir), _panels(tr.base_exp_dir)
    assert sorted(got) == sorted(want) == sorted(
        f"{d}/{p}_{ITER:08d}_0_2.png" for d, p in (
            ("validations_fine", "v"), ("normals", "n"), ("diffuse", "d"),
            ("specular", "s"), ("CdPlusCs", "DPlusS")))
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k


def test_random_view_and_synthetic_validation(scene, monkeypatch):
    """idx < 0 draws the view from np.random.randint, as the JAX runner
    does; the synthetic families' validation (sRGB panels named
    {iter}_{idx}) runs on the same runner and writes the JAX runner's
    images within one grey level."""
    _, jr, tr = scene
    monkeypatch.setattr(np.random, "randint", lambda n: n - 1)
    tr.validate_image(resolution_level=4)
    last = tr.dataset.n_images - 1
    assert os.path.exists(os.path.join(
        tr.base_exp_dir, "normals", f"n_{ITER:08d}_0_{last}.png"))
    jr.validate_synthetic_img(resolution_level=4)
    tr.validate_synthetic_img(resolution_level=4)
    for d, p in (("validations_fine", "v"), ("normals", "n"),
                 ("diffuse", "d"), ("specular", "s")):
        name = os.path.join(d, f"{p}_{ITER}_{last}.png")
        want = cv2.imread(os.path.join(jr.base_exp_dir, name))
        got = cv2.imread(os.path.join(tr.base_exp_dir, name))
        assert got is not None and got.shape == want.shape, name
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_novel_view_matches_jax(scene):
    _, jr, tr = scene
    np.testing.assert_allclose(
        tr.render_novel_image(0, 1, 0.4, 4).astype(int),
        jr.render_novel_image(0, 1, 0.4, 4).astype(int), atol=1)


def test_mesh_dtu_sphere2world_matches_jax(scene):
    """Both runners take meshes/dtu122-300000.ply through the scene's
    scale mat to meshes/00300000.ply: the same vertices and faces."""
    _, jr, tr = scene
    rng = np.random.RandomState(3)
    v = rng.rand(30, 3).astype(np.float32) - 0.5
    t = rng.randint(0, 30, (20, 3)).astype(np.int32)
    meshes = os.path.join(tr.base_exp_dir, "meshes")
    write_ply(os.path.join(meshes, "dtu122-300000.ply"), v, t)
    jr.mesh_dtu_sphere2world("dtu122-300000")
    want = jread_ply_mesh(os.path.join(meshes, "00300000.ply"))
    out = tr.mesh_dtu_sphere2world("dtu122-300000")
    assert out == os.path.join(meshes, "00300000.ply")
    for a, b in zip(jread_ply_mesh(out), want):
        np.testing.assert_array_equal(a, b)


def test_cli_modes_on_a_fabricated_scene(tmp_path):
    """train (validation panels at val_freq, scalars under logs/),
    validate_image, interpolate_0_1 and mesh_dtu_shpere2world through the
    port's CLI."""
    make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"), n_views=3,
                        H=32, W=40)
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    # no mesh; chunks of 64 rays, so the 60 small frames of the
    # interpolation are not each padded to 2048 rays
    with open(conf) as f:
        text = f.read().replace("val_mesh_freq = 4", "val_mesh_freq = 1000"
                                ).replace("report_freq = 4",
                                          "report_freq = 4\n val_chunk = 64")
    with open(conf, "w") as f:
        f.write(text)
    base = ["--conf", conf, "--case", "fake_scan", "--device", "cpu"]
    runner = exp_runner.main(["--mode", "train", *base])
    geo = runner.base_exp_dir
    assert os.listdir(os.path.join(geo, "logs"))
    for d in ("validations_fine", "normals", "diffuse", "specular",
              "CdPlusCs"):
        assert len(os.listdir(os.path.join(geo, d))) == 1, d

    runner = exp_runner.main(["--mode", "validate_image", "--is_continue",
                              "--idx", "1", *base])
    assert runner.iter_step == 4
    img = cv2.imread(os.path.join(geo, "validations_fine",
                                  "v_00000004_0_1.png"))
    assert img.shape == (64, 40, 3)        # level 1: render above truth

    runner = exp_runner.main(["--mode", "interpolate_0_1", "--is_continue",
                              *base])
    assert os.path.exists(runner.last_video)
    assert runner.last_video.startswith(os.path.join(geo, "render",
                                                     "00000004_0_1"))

    v = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    t = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    write_ply(os.path.join(geo, "meshes", "dtu122-300000.ply"), v, t)
    runner = exp_runner.main(["--mode", "mesh_dtu_shpere2world",
                              "--is_continue", *base])
    assert runner.last_mesh == os.path.join(geo, "meshes", "00300000.ply")
    v2, t2 = jread_ply_mesh(runner.last_mesh)     # identity scale mats
    np.testing.assert_allclose(v2, v, atol=1e-6)
    np.testing.assert_array_equal(t2, t)
