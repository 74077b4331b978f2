"""The port's data layer against the JAX package's, family by family: each
scene fabricated in its native layout (data/fake_scene.py), loaded by
both packages' make_dataset under every type name; the Synthetic test
split; the w2c and constant-mask draws at injected pixels; the Sk3d ROI
sampler; and the image codecs (TIFF, the "L" mask, the alpha mask, the
gamma-linearised and EXR rgb) against PIL and the JAX package's readers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from factored_neus_tpu.data import datasets as JD
from factored_neus_tpu.data import images as JI
from factored_neus_tpu.data import rays as JRAYS
from factored_neus_tpu_torch.data import datasets as TD
from factored_neus_tpu_torch.data import fake_scene as FS
from factored_neus_tpu_torch.data import images as TI
from factored_neus_tpu_torch.data import rays as TRAYS

CPU = torch.device("cpu")
TOL = 1e-6           # camera tables and rays
ROI_PROB = 0.5       # the Sk3d conf's sample_roi_prob
# the directory of each type's scene
SCENE_OF = {"dtu": "dtu", "sk3d": "sk3d", "indisg_synthetic": "blender",
            "synthetic": "blender", "indisg_shiny": "blender",
            "shiny": "blender", "shiny_refneus": "blender",
            "glossy_synthetic": "glossy", "glossy_real": "real"}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    return {
        "dtu": FS.write_sphere_scene(str(root / "dtu"), n_views=3, H=24,
                                     W=32),
        "blender": FS.write_blender_scene(str(root / "blender"), n_train=3,
                                          n_test=2, H=24, W=32),
        "glossy": FS.write_glossy_synthetic_scene(str(root / "glossy"),
                                                  n_views=3, H=24, W=32),
        "real": FS.write_glossy_real_scene(str(root / "real"), n_views=2,
                                           H=9, W=12),
        "sk3d": FS.write_sk3d_scene(str(root / "sk3d"), n_views=3, H=24,
                                    W=32)}


@pytest.fixture(scope="module")
def loaded(scenes):
    """(JAX dataset, port dataset) of every type, built once."""
    out = {}
    for typ, scene in SCENE_OF.items():
        conf = {"data_dir": scenes[scene], "sample_roi_prob": ROI_PROB}
        out[typ] = (JD.make_dataset(typ, conf),
                    TD.make_dataset(typ, conf, CPU))
    return out


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=tol, rtol=0)


def test_types_and_linear_space_match_jax():
    assert set(TD.DATASET_TYPES) == set(JD.DATASET_TYPES) == set(SCENE_OF)
    assert TD.LINEAR_SPACE_TYPES == JD.LINEAR_SPACE_TYPES
    for typ, cls in JD.DATASET_TYPES.items():
        assert TD.DATASET_TYPES[typ].__name__ == cls.__name__, typ
    assert [TD.tonemap_for(t) for t in ("dtu", "shiny_refneus", "synthetic",
                                        "glossy_real")] == \
        ["srgb", "none", "none", "srgb"]
    with pytest.raises(ValueError, match="unknown dataset type"):
        TD.make_dataset("nerfactor", {"data_dir": "."}, CPU)


@pytest.mark.parametrize("typ", sorted(SCENE_OF))
def test_loader_matches_jax(loaded, typ):
    jd, td = loaded[typ]
    assert (td.n_images, td.H, td.W) == (jd.n_images, jd.H, jd.W)
    assert (td.convention, td.mask_ones, td.color_bgr) == \
        (jd.convention, jd.mask_ones, jd.color_bgr)
    np.testing.assert_array_equal(td.images.numpy(), np.asarray(jd.images))
    np.testing.assert_array_equal(td.masks.numpy(), np.asarray(jd.masks))
    close(td.intrinsics_all.numpy(), jd.intrinsics_all)
    np.testing.assert_allclose(td.intrinsics_all_inv.numpy(),
                               np.asarray(jd.intrinsics_all_inv), rtol=1e-6,
                               atol=1e-7)
    close(td.pose_all.numpy(), jd.pose_all)
    assert td.focal == pytest.approx(jd.focal, rel=1e-7)
    close(td.object_bbox_min, jd.object_bbox_min)
    close(td.object_bbox_max, jd.object_bbox_max)
    for attr in ("scale_mat", "ref_points", "scale_rect", "R_rect"):
        assert hasattr(td, attr) == hasattr(jd, attr), attr
        if hasattr(jd, attr):
            close(getattr(td, attr), getattr(jd, attr))
    if jd.roi_boxes is not None:
        np.testing.assert_array_equal(np.stack(td.roi_boxes),
                                      np.stack(jd.roi_boxes))
        assert td.sample_roi_prob == jd.sample_roi_prob == ROI_PROB
    # a non-empty object in every view (the fabricated sphere; the glossy
    # real captures have no masks: all ones)
    if typ == "glossy_real":
        assert (td.masks == 1).all()
    elif not td.mask_ones:
        assert 0.05 < float(td.masks[..., 0].mean()) < 0.95, typ

    for level in (1, 2):
        for a, b in zip(td.gen_rays_at(1, level), jd.gen_rays_at(1, level)):
            close(a.numpy(), b)
    for a, b in zip(td.gen_rays_between(0, 1, 0.3, 2),
                    jd.gen_rays_between(0, 1, 0.3, 2)):
        close(a.numpy(), b)
    got, want = td.image_at(1, 2), jd.image_at(1, 2)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1.0


def test_synthetic_test_split_matches_jax(scenes):
    conf = {"data_dir": scenes["blender"]}
    jd = JD.SyntheticDataset(conf, split="test")
    td = TD.SyntheticDataset(conf, CPU, split="test")
    assert td.n_images == jd.n_images == 2
    np.testing.assert_array_equal(td.images.numpy(), np.asarray(jd.images))
    np.testing.assert_array_equal(td.masks.numpy(), np.asarray(jd.masks))
    np.testing.assert_array_equal(td.albedo, jd.albedo)
    np.testing.assert_array_equal(td.rough, jd.rough)
    close(td.pose_all.numpy(), jd.pose_all)
    # the fabricated ground truth: the sphere's albedo and roughness
    hit = td.albedo[..., 0] > 0
    close(td.albedo[hit].mean(0), FS.ALBEDO, 3e-3)
    close(td.rough[hit].mean(0), [FS.ROUGHNESS] * 3, 3e-3)


def _jax_pixels(key, B, H, W):
    kx, ky, _ = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(kx, (B,), 0, W)),
            np.asarray(jax.random.randint(ky, (B,), 0, H)))


@pytest.mark.parametrize("typ", ["glossy_synthetic", "glossy_real", "sk3d",
                                 "synthetic"])
def test_draw_at_injected_pixels_matches_jax(loaded, typ):
    """JAX's draw (ROI off) and the port's rays_from_pixels on its pixels:
    the w2c rays, the constant 255/256 mask, colours and masks."""
    jd, td = loaded[typ]
    key, B, idx = jax.random.PRNGKey(5), 64, 1
    px, py = _jax_pixels(key, B, jd.H, jd.W)
    want = JRAYS.gen_random_rays(
        key, jd.images, jd.masks, jd.intrinsics_all_inv, jd.pose_all,
        jnp.asarray(idx), B, convention=jd.convention,
        mask_ones=jd.mask_ones)
    got = TRAYS.rays_from_pixels(
        torch.tensor(px).long(), torch.tensor(py).long(), td.images,
        td.masks, td.intrinsics_all_inv, td.pose_all, idx, td.convention,
        td.mask_ones)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        close(a.numpy(), b)
    if td.mask_ones:
        assert (got[3] == 255.0 / 256.0).all()
    np.testing.assert_allclose(torch.linalg.norm(got[1], dim=-1).numpy(), 1.0,
                               atol=1e-6)


def _coded_images(n, H, W):
    """Images whose channels 0 and 1 are each pixel's x and y."""
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    img = torch.stack([xs, ys, torch.zeros_like(xs)], -1).float()
    return img.expand(n, H, W, 3).contiguous()


def test_roi_draw_stays_in_the_dilated_box(loaded):
    """roi_prob = 1: every pixel inside the box dilated by 10 px, in the
    port and in the JAX package; the pixels spread over the box."""
    jd, td = loaded["sk3d"]
    H, W = 60, 80
    images = _coded_images(td.n_images, H, W)
    box = np.array([30, 45, 25, 33])
    data = dict(td.train_data(), images=images,
                roi_boxes=[box] * td.n_images, roi_prob=1.0)
    gen = torch.Generator().manual_seed(3)
    _, _, color, mask = TRAYS.sample_batch(gen, data, 1, 4096)
    x, y = color[:, 0], color[:, 1]
    assert (x >= 20).all() and (x < 55).all() and (y >= 15).all() \
        and (y < 43).all()
    assert {int(x.min()), int(x.max()), int(y.min()), int(y.max())} == \
        {20, 54, 15, 42}
    assert (mask == 255.0 / 256.0).all()
    _, _, jcol, _ = JRAYS.gen_random_rays(
        jax.random.PRNGKey(0), jnp.asarray(images.numpy()), jd.masks,
        jd.intrinsics_all_inv, jd.pose_all, jnp.asarray(1), 4096,
        convention="c2w", mask_ones=True,
        roi_boxes=jnp.asarray(np.stack([box] * td.n_images)), roi_prob=1.0)
    jx, jy = np.asarray(jcol[:, 0]), np.asarray(jcol[:, 1])
    assert (jx.min(), jx.max(), jy.min(), jy.max()) == (20, 54, 15, 42)
    assert TRAYS.roi_bounds(box, H, W) == (20, 55, 15, 43)
    assert TRAYS.roi_bounds([2, 78, 3, 57], H, W) == (0, 80, 0, 60)


def test_roi_off_draw_is_the_uniform_draw(loaded):
    """roi_prob = 0 (or no box): bitwise the uniform draw, its px then py
    from the generator and nothing else drawn; the DTU tables' draw is
    that draw."""
    _, td = loaded["sk3d"]
    images = _coded_images(td.n_images, 24, 32)
    masks = torch.rand(td.n_images, 24, 32, 3)
    B, idx = 256, 2

    def uniform(seed):
        gen = torch.Generator().manual_seed(seed)
        px = torch.randint(0, 32, (B,), generator=gen)
        py = torch.randint(0, 24, (B,), generator=gen)
        return TRAYS.rays_from_pixels(px, py, images, masks,
                                      td.intrinsics_all_inv, td.pose_all,
                                      idx), gen

    want, gen_want = uniform(7)
    for roi_box, prob in ((None, 0.0), (td.roi_boxes[idx], 0.0),
                          (None, 0.8)):
        gen = torch.Generator().manual_seed(7)
        got = TRAYS.gen_random_rays(gen, images, masks,
                                    td.intrinsics_all_inv, td.pose_all, idx,
                                    B, roi_box=roi_box, roi_prob=prob)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert torch.equal(gen.get_state(), gen_want.get_state())
    data = {"images": images, "masks": masks,
            "intr_inv": td.intrinsics_all_inv, "poses": td.pose_all}
    got = TRAYS.sample_batch(torch.Generator().manual_seed(7), data, idx, B)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, dtu = loaded["dtu"]
    assert dtu.train_data()["roi_boxes"] is None
    assert dtu.train_data()["roi_prob"] == 0.0


# -- image codecs -------------------------------------------------------------

@pytest.mark.parametrize("compression", [None, "tiff_deflate",
                                         "tiff_adobe_deflate", "tiff_lzw"])
def test_tiff_reader_matches_pil(tmp_path, compression):
    rng = np.random.RandomState(0)
    disp = np.where(rng.rand(45, 61) > 0.4, rng.rand(45, 61), 0).astype(
        np.float32)
    path = str(tmp_path / "disp.tiff")
    Image.fromarray(disp, mode="F").save(
        path, **({"compression": compression} if compression else {}))
    got = TI.imread_tiff(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, JI.imread_tiff(path))
    rgb = (rng.rand(7, 9, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(path, **({"compression": compression}
                                       if compression else {}))
    np.testing.assert_array_equal(TI.imread_tiff(path), rgb)


def test_tiff_writer_and_unsupported_codecs(tmp_path):
    disp = np.random.RandomState(1).rand(13, 17).astype(np.float32)
    path = str(tmp_path / "w.tiff")
    TI.write_tiff(path, disp)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), disp)
    np.testing.assert_array_equal(TI.imread_tiff(path), disp)
    rgb = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(rgb).save(path, compression="packbits")
    with pytest.raises(ValueError, match="PackBits"):
        TI.imread_tiff(path)
    with pytest.raises(ValueError, match="not a TIFF"):
        TI.imread_tiff(__file__)


def test_masks_and_rgb_match_pil_and_jax(tmp_path):
    """load_mask: PIL's "L" of an RGB, RGBA or grey png above 0.5;
    load_nerfactor_mask: the alpha channel; load_rgb: (x / 255) ** 2.2 of
    an 8-bit png and an EXR as it is."""
    rng = np.random.RandomState(2)
    rgba = (rng.rand(11, 14, 4) * 255).astype(np.uint8)
    rgba[..., 3] = np.where(rng.rand(11, 14) > 0.5, 255, 0)
    for name, img in (("rgb.png", rgba[..., :3]), ("rgba.png", rgba),
                      ("grey.png", rgba[..., 0])):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path)
        luma = np.asarray(Image.open(path).convert("L"))
        np.testing.assert_array_equal(
            TI.to_luma(TI.png_decode(open(path, "rb").read())), luma)
        np.testing.assert_array_equal(TI.load_mask(path),
                                      JI.load_mask(path))
        if img.ndim == 3:
            np.testing.assert_array_equal(TI.load_rgb(path),
                                          JI.load_rgb(path))
    path = str(tmp_path / "rgba.png")
    np.testing.assert_array_equal(TI.load_nerfactor_mask(path),
                                  JI.load_nerfactor_mask(path))
    with pytest.raises(ValueError, match="alpha"):
        TI.load_nerfactor_mask(str(tmp_path / "rgb.png"))
    from factored_neus_tpu_torch.data.exr import write_exr
    lin = rng.rand(5, 6, 3).astype(np.float32) * 3
    write_exr(str(tmp_path / "lin.exr"), lin)
    np.testing.assert_array_equal(TI.load_rgb(str(tmp_path / "lin.exr")),
                                  lin)
    np.testing.assert_array_equal(TI.load_rgb(str(tmp_path / "lin.exr")),
                                  JI.load_rgb(str(tmp_path / "lin.exr")))
    assert os.path.getsize(str(tmp_path / "lin.exr")) > lin.nbytes


def test_16_bit_png_reads_like_cv2(tmp_path):
    """A 16-bit PNG (NeRO's depth maps) through imread_bgr_u8: the high
    byte of each sample, as cv2.imread gives it; the port's writer's file
    reads back in cv2 too."""
    import cv2
    rng = np.random.RandomState(3)
    for shape in ((9, 13), (9, 13, 3)):
        img = (rng.rand(*shape) * 65535).astype(np.uint16)
        path = str(tmp_path / "cv.png")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(TI.imread_bgr_u8(path),
                                      cv2.imread(path))
        ours = str(tmp_path / "ours.png")
        TI.imwrite(ours, img)
        np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                      img)
    with pytest.raises(ValueError, match="16-bit"):
        TI.load_mask(ours)
