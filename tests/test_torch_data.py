"""Data path of the PyTorch port against the JAX package and OpenCV: the
PNG codec, the DTU loader and ray generation from the same pixels."""
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene

from factored_neus_tpu.data import datasets as JD
from factored_neus_tpu.data import rays as JRAYS
from factored_neus_tpu.data.cameras import load_K_Rt_from_P as jload
from factored_neus_tpu_torch.data import cameras as TCAM
from factored_neus_tpu_torch.data import datasets as TD
from factored_neus_tpu_torch.data import images as TI
from factored_neus_tpu_torch.data import rays as TRAYS


def _image(H=13, W=17, C=3, seed=0):
    rng = np.random.RandomState(seed)
    smooth = np.linspace(0, 255, H * W * C).reshape(H, W, C)
    return np.clip(smooth + rng.randint(-20, 20, (H, W, C)), 0, 255
                   ).astype(np.uint8)


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_png_decodes_what_cv2_writes(tmp_path, C, level):
    img = _image(C=C)
    img = img[..., 0] if C == 1 else img
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    with open(path, "rb") as f:
        dec = TI.png_decode(f.read())
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want[..., None] if want.ndim == 2 else want
    order = {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[C]    # cv2 is BGR(A)
    np.testing.assert_array_equal(dec, want[..., order])
    np.testing.assert_array_equal(TI.imread_bgr_u8(path), cv2.imread(path))


def _encode_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses row filter ftype (reference encoder)."""
    H, W, C = img.shape
    raw = img.reshape(H, W * C).astype(np.int32)
    rows = []
    for y in range(H):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([ftype]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
    chunk = lambda t, b: (struct.pack(">I", len(b)) + t + b + struct.pack(
        ">I", zlib.crc32(t + b) & 0xFFFFFFFF))
    ct = {1: 0, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ct, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_row_filters(ftype):
    img = _image(C=3, seed=ftype)
    np.testing.assert_array_equal(
        TI.png_decode(_encode_with_filter(img, ftype)), img)


def test_png_writer_roundtrips_through_cv2(tmp_path):
    for C in (1, 3, 4):
        img = _image(C=C, seed=C)
        img = img[..., 0] if C == 1 else img
        path = str(tmp_path / f"w{C}.png")
        TI.imwrite(path, img)                     # BGR(A) in, like cv2
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_cameras_copy_matches():
    P = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    for a, b in zip(TCAM.load_K_Rt_from_P(P), jload(P)):
        np.testing.assert_array_equal(a, b)


def test_dtu_loader_and_rays_match_jax(tmp_path):
    path = make_fake_dtu_scene(str(tmp_path / "scan"), n_views=3, H=24, W=32)
    conf = {"data_dir": path}
    jds = JD.DTUDataset(conf)
    tds = TD.DTUDataset(conf, torch.device("cpu"))
    np.testing.assert_array_equal(tds.images.numpy(), np.asarray(jds.images))
    np.testing.assert_array_equal(tds.masks.numpy(), np.asarray(jds.masks))
    np.testing.assert_allclose(tds.pose_all.numpy(), np.asarray(jds.pose_all),
                               atol=1e-6)
    np.testing.assert_allclose(tds.intrinsics_all_inv.numpy(),
                               np.asarray(jds.intrinsics_all_inv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tds.object_bbox_min, jds.object_bbox_min)

    # the JAX draw, replayed: the same pixels go through rays_from_pixels
    key, B, idx = jax.random.PRNGKey(4), 64, 2
    kx, ky, _ = jax.random.split(key, 3)
    px = np.asarray(jax.random.randint(kx, (B,), 0, jds.W))
    py = np.asarray(jax.random.randint(ky, (B,), 0, jds.H))
    jo, jd, jc, jm = JRAYS.gen_random_rays(
        key, jds.images, jds.masks, jds.intrinsics_all_inv, jds.pose_all,
        jnp.asarray(idx), B)
    to, td, tc, tm = TRAYS.rays_from_pixels(
        torch.from_numpy(px).long(), torch.from_numpy(py).long(), tds.images,
        tds.masks, tds.intrinsics_all_inv, tds.pose_all, idx)
    for a, b in zip((to, td, tc, tm), (jo, jd, jc, jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    jn, jf = JRAYS.near_far_from_sphere(jo, jd)
    tn, tf = TRAYS.near_far_from_sphere(to, td)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-6)


def test_random_rays_draw_from_the_generator():
    images = torch.rand(2, 6, 7, 3)
    masks = torch.ones(2, 6, 7, 3)
    intr = torch.eye(4).expand(2, 4, 4).contiguous()
    poses = torch.eye(4).expand(2, 4, 4).contiguous()
    draw = lambda: TRAYS.gen_random_rays(
        torch.Generator().manual_seed(9), images, masks, intr, poses, 1, 32)
    a, b = draw(), draw()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a[2].shape == (32, 3) and a[3].shape == (32, 1)
