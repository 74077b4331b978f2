"""The port's COLMAP and IDR host tooling (factored_neus_tpu_torch/
colmap_tools, data/colmap_model.py, data/idr_cameras.py) and its PLY
writer's edge element and colour names, against the JAX package's: the
cases of tests/test_colmap_model.py, test_colmap_tools.py,
test_colmap_interchange.py and test_evaltools.py's IDR cases, each run
through both packages (``run_both``: each writes under its own directory),
the cases' own assertions held on the port's results, and the two
packages' arrays equal, their written files byte-equal and the IDR
functions within 1e-6."""
import gzip
import os
import struct
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_colmap_interchange import _pts, _write_bundle_out, _write_nvm
from test_colmap_model import _assert_models_equal

from factored_neus_tpu.colmap_tools import database as JDB
from factored_neus_tpu.colmap_tools import dense as JDN
from factored_neus_tpu.colmap_tools import export as JEX
from factored_neus_tpu.colmap_tools import fused as JFU
from factored_neus_tpu.colmap_tools import interchange as JIC
from factored_neus_tpu.colmap_tools import visualize as JVZ
from factored_neus_tpu.data import colmap_model as JCM
from factored_neus_tpu.data import idr_cameras as JIDR
from factored_neus_tpu.meshing import ply as JPLY
from factored_neus_tpu_torch.colmap_tools import database as TDB
from factored_neus_tpu_torch.colmap_tools import dense as TDN
from factored_neus_tpu_torch.colmap_tools import export as TEX
from factored_neus_tpu_torch.colmap_tools import fused as TFU
from factored_neus_tpu_torch.colmap_tools import interchange as TIC
from factored_neus_tpu_torch.colmap_tools import visualize as TVZ
from factored_neus_tpu_torch.data import colmap_model as TCM
from factored_neus_tpu_torch.data import idr_cameras as TIDR
from factored_neus_tpu_torch.meshing import ply as TPLY

PKGS = {
    "jax": types.SimpleNamespace(CM=JCM, DB=JDB, DN=JDN, EX=JEX, FU=JFU,
                                 IC=JIC, VZ=JVZ, PLY=JPLY),
    "port": types.SimpleNamespace(CM=TCM, DB=TDB, DN=TDN, EX=TEX, FU=TFU,
                                  IC=TIC, VZ=TVZ, PLY=TPLY),
}


def run_both(tmp_path, fn):
    """fn(namespace, directory) for each package, each in a directory of
    its own; returns {package: result}."""
    out = {}
    for name, ns in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = fn(ns, d)
    return out


def same_files(tmp_path) -> int:
    """Every file the JAX run wrote is byte-equal to the port run's under
    the same relative name, and the runs wrote the same names (sqlite
    databases, whose pages carry no content of their own to compare
    byte-wise, are compared by their tables elsewhere); returns the
    number of files."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs
                      if not f.endswith(".db"))
    a, b = files(tmp_path / "jax"), files(tmp_path / "port")
    assert a == b
    for rel in a:
        with open(tmp_path / "jax" / rel, "rb") as f, \
                open(tmp_path / "port" / rel, "rb") as g:
            assert f.read() == g.read(), rel
    return len(a)


def equal(a, b, path=""):
    """Arrays equal (also inside tuples, lists, dicts and dataclasses of
    records)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            equal(u, v, f"{path}/{i}")
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        for f in a.__dataclass_fields__:
            equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# -- data/colmap_model.py (tests/test_colmap_model.py) ------------------------

def make_model(CM):
    rng = np.random.RandomState(0)
    cameras = {
        1: CM.Camera(1, "PINHOLE", 1920, 1080,
                     np.array([1200.0, 1200.0, 960.0, 540.0])),
        2: CM.Camera(2, "SIMPLE_RADIAL", 640, 480,
                     np.array([500.0, 320.0, 240.0, 0.01])),
    }
    images = {}
    for i in (1, 2, 3):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        n2d = rng.randint(0, 5)
        images[i] = CM.Image(
            i, q, rng.randn(3), 1 + i % 2, f"img_{i:04d}.png",
            rng.rand(n2d, 2) * 100,
            rng.randint(-1, 50, size=n2d).astype(np.int64))
    points = {}
    for i in (10, 11):
        tl = rng.randint(1, 4)
        points[i] = CM.Point3D(
            i, rng.randn(3), rng.randint(0, 255, 3).astype(np.uint8),
            float(rng.rand()), rng.randint(1, 4, tl).astype(np.int64),
            rng.randint(0, 5, tl).astype(np.int64))
    return cameras, images, points


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_model_roundtrip(ext, tmp_path):
    def run(ns, d):
        model = make_model(ns.CM)
        ns.CM.write_model(*model, str(d), ext=ext)
        loaded = ns.CM.read_model(str(d), ext=ext)
        _assert_models_equal(model, loaded)
        return loaded
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 3


def test_cross_format(tmp_path):
    """text -> read -> write binary -> read must be identical."""
    def run(ns, d):
        ns.CM.write_model(*make_model(ns.CM), str(d / "t"), ext=".txt")
        m1 = ns.CM.read_model(str(d / "t"), ext=".txt")
        ns.CM.write_model(*m1, str(d / "b"), ext=".bin")
        m2 = ns.CM.read_model(str(d / "b"), ext=".bin")
        _assert_models_equal(m1, m2)
        return m2
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 6


def test_autodetect(tmp_path):
    def run(ns, d):
        model = make_model(ns.CM)
        ns.CM.write_model(*model, str(d), ext=".bin")
        loaded = ns.CM.read_model(str(d))
        _assert_models_equal(model, loaded)
        return loaded
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    same_files(tmp_path)


def test_qvec_rotmat_roundtrip():
    rng = np.random.RandomState(1)
    for _ in range(10):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = TCM.qvec2rotmat(q)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-10)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-10)
        q2 = TCM.rotmat2qvec(R)
        np.testing.assert_allclose(q2, q, atol=1e-8)
        equal(R, JCM.qvec2rotmat(q))
        equal(q2, JCM.rotmat2qvec(R))


# -- colmap_tools (tests/test_colmap_tools.py) --------------------------------

def test_database_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    kps1 = rng.rand(120, 6).astype(np.float32) * 100
    kps2 = rng.rand(80, 6).astype(np.float32) * 100
    desc = rng.randint(0, 255, (120, 128), np.uint8)
    matches = np.stack([np.arange(40), np.arange(40) + 5], -1)

    def run(ns, d):
        path = str(d / "db.db")
        with ns.DB.ColmapDatabase(path) as db:
            cam = db.add_camera("PINHOLE", 640, 480,
                                [500.0, 500.0, 320.0, 240.0])
            im1 = db.add_image("a.png", cam, prior_q=[1, 0, 0, 0],
                               prior_t=[0, 0, 3])
            im2 = db.add_image("b.png", cam)
            db.add_keypoints(im1, kps1)
            db.add_keypoints(im2, kps2)
            db.add_descriptors(im1, desc)
            # inserted in flipped order: canonicalization swaps columns
            db.add_matches(im2, im1, matches)
            db.add_two_view_geometry(im1, im2, matches, F=np.eye(3))
        with ns.DB.ColmapDatabase(path) as db:
            cams, ims = db.cameras(), db.images()
            assert cams[1][0] == "PINHOLE" and cams[1][1] == 640
            np.testing.assert_allclose(cams[1][3], [500, 500, 320, 240])
            assert ims[1] == ("a.png", 1) and ims[2] == ("b.png", 1)
            np.testing.assert_allclose(db.keypoints(1), kps1)
            np.testing.assert_allclose(db.keypoints(2), kps2)
            m12, m21 = db.matches(1, 2), db.matches(2, 1)
            np.testing.assert_array_equal(m12, m21[:, ::-1])
            np.testing.assert_array_equal(m12[:, 0], matches[:, 1])
            return (cams, ims, db.keypoints(1), db.keypoints(2), m12, m21)
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])


def test_pair_id_roundtrip():
    for a, b in ((1, 2), (2, 1), (7, 7), (1, TDB.MAX_IMAGE_ID - 1)):
        pid = TDB.image_ids_to_pair_id(a, b)
        assert pid == JDB.image_ids_to_pair_id(a, b)
        lo, hi = min(a, b), max(a, b)
        assert TDB.pair_id_to_image_ids(pid) == (lo, hi)
        assert JDB.pair_id_to_image_ids(pid) == (lo, hi)


def test_dense_roundtrip(tmp_path):
    def run(ns, d):
        rng = np.random.RandomState(1)
        backs = []
        for shape in ((17, 23), (9, 11, 3)):
            arr = rng.rand(*shape).astype(np.float32)
            p = str(d / f"d{len(shape)}.bin")
            ns.DN.write_array(arr, p)
            backs.append(ns.DN.read_array(p))
            np.testing.assert_array_equal(backs[-1], arr.squeeze())
        return backs
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 2


def test_model_to_ply_and_merge(tmp_path):
    def run(ns, d):
        rng = np.random.RandomState(2)
        pts = {i: ns.CM.Point3D(
            id=i, xyz=rng.randn(3), rgb=rng.randint(0, 255, 3), error=0.1,
            image_ids=np.arange(i % 4 + 1),
            point2D_idxs=np.arange(i % 4 + 1)) for i in range(50)}
        model_dir = str(d / "sparse")
        os.makedirs(model_dir)
        ns.CM.write_points3D_binary(pts, os.path.join(model_dir,
                                                      "points3D.bin"))
        out = str(d / "cloud.ply")
        n = ns.EX.model_to_ply(model_dir, out)
        assert n == 50
        xyz = ns.PLY.read_ply_points(out)
        assert xyz.shape == (50, 3)
        out2 = str(d / "cloud_f.ply")
        n2 = ns.EX.model_to_ply(model_dir, out2, min_track_len=3)
        assert 0 < n2 < 50
        merged = str(d / "merged.ply")
        total = ns.EX.merge_ply_files([out, out2], merged)
        assert total == n + n2
        assert ns.PLY.read_ply_points(merged).shape == (total, 3)
        return xyz, n2
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 4


def _mesh_points(FU, seed, n, visible):
    rng = np.random.RandomState(seed)
    pts = []
    for i in range(n):
        nrm = rng.randn(3)
        pts.append(FU.MeshPoint(
            position=rng.randn(3).astype(np.float32),
            normal=(nrm / np.linalg.norm(nrm)).astype(np.float32),
            color=rng.randint(0, 255, 3).astype(np.uint8),
            visible_image_idxs=visible(rng, i)))
    return pts


def test_fused_vis_roundtrip(tmp_path):
    def run(ns, d):
        pts = _mesh_points(ns.FU, 3, 20, lambda rng, i: rng.randint(
            0, 64, i % 5).astype(np.uint32))
        ply_p = str(d / "fused.ply")
        vis_p = ply_p + ".vis"
        ns.FU.write_fused(pts, ply_p, vis_p)
        back = ns.FU.read_fused(ply_p, vis_p)
        assert len(back) == 20
        for a, b in zip(pts, back):
            np.testing.assert_allclose(a.position, b.position, rtol=1e-6)
            np.testing.assert_allclose(a.normal, b.normal, rtol=1e-6)
            np.testing.assert_array_equal(a.color, b.color)
            np.testing.assert_array_equal(a.visible_image_idxs,
                                          b.visible_image_idxs)
            assert b.num_visible_images == len(a.visible_image_idxs)
        raw = open(vis_p, "rb").read()
        assert int(np.frombuffer(raw[:8], "<u8")[0]) == 20
        assert len(raw) == 8 + sum(4 + 4 * p.num_visible_images
                                   for p in pts)
        return back
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 2


def _tiny_model(ns, d, n_views=3, n_pts=40):
    CM = ns.CM
    rng = np.random.RandomState(4)
    cameras = {1: CM.Camera(id=1, model="PINHOLE", width=64, height=48,
                            params=np.array([70.0, 70.0, 32.0, 24.0]))}
    images = {i: CM.Image(
        id=i, qvec=np.array([1.0, 0, 0, 0]),
        tvec=rng.randn(3) * 0.1 + np.array([0, 0, 3.0]), camera_id=1,
        name=f"v{i}.png", xys=np.zeros((0, 2)),
        point3D_ids=np.zeros(0, np.int64)) for i in range(1, n_views + 1)}
    pts = {i: CM.Point3D(
        id=i, xyz=rng.randn(3) * 0.5, rgb=rng.randint(0, 255, 3),
        error=float(i % 7) * 0.3, image_ids=np.arange(i % 5 + 1),
        point2D_idxs=np.arange(i % 5 + 1)) for i in range(n_pts)}
    md = str(d / "model")
    os.makedirs(md, exist_ok=True)
    CM.write_model(cameras, images, pts, md, ext=".bin")
    return md, cameras, images, pts


def test_visualize_frustums_and_export(tmp_path):
    def run(ns, d):
        VZ = ns.VZ
        md, cameras, images, pts = _tiny_model(ns, d)
        K = VZ.camera_K(cameras[1])
        np.testing.assert_allclose(np.diag(K), [70, 70, 1])
        fv = VZ.frustum_vertices(K, np.eye(3), np.array([1.0, 2.0, 3.0]),
                                 64, 48, scale=2.0)
        assert fv.shape == (5, 3)
        np.testing.assert_allclose(fv[0], [1, 2, 3])
        np.testing.assert_allclose(fv[1:, 2], 5.0)
        np.testing.assert_allclose(fv[1, :2], [1 - 32 / 70 * 2,
                                               2 - 24 / 70 * 2], rtol=1e-6)
        verts, edges = VZ.model_frustums(cameras, images)
        assert verts.shape == (5 * 3, 3) and edges.shape == (8 * 3, 2)
        assert edges.max() == len(verts) - 1
        out = str(d / "viz.ply")
        info = VZ.export_model_ply(md, out, min_track_len=3,
                                   max_reproj_error=1.0)
        assert info["n_views"] == 3 and 0 < info["n_points"] < 40
        data = ns.PLY.read_ply(out)
        assert len(data["vertex"]["x"]) == info["n_points"] + 15
        assert len(data["edge"]["vertex1"]) == 24
        info = {k: v for k, v in info.items() if k != "out_path"}
        return K, fv, verts, edges, info, data
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 4


def test_database_rolls_back_on_exception(tmp_path):
    """A raising with-block must not persist partial writes."""
    def run(ns, d):
        path = str(d / "rb.db")
        with ns.DB.ColmapDatabase(path) as db:
            cam = db.add_camera("PINHOLE", 8, 8, [4.0, 4.0, 4.0, 4.0])
        with pytest.raises(RuntimeError):
            with ns.DB.ColmapDatabase(path) as db:
                db.add_image("orphan.png", cam)
                raise RuntimeError("boom")
        with ns.DB.ColmapDatabase(path) as db:
            assert db.images() == {}
            assert 1 in db.cameras()
            return db.cameras()
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])


def test_fused_read_as_arrays(tmp_path):
    def run(ns, d):
        rng = np.random.RandomState(7)
        pts = [ns.FU.MeshPoint(rng.randn(3).astype(np.float32),
                               rng.randn(3).astype(np.float32),
                               rng.randint(0, 255, 3).astype(np.uint8),
                               rng.randint(0, 9, i % 3).astype(np.uint32))
               for i in range(12)]
        ply_p = str(d / "f.ply")
        ns.FU.write_fused(pts, ply_p, ply_p + ".vis")
        xyz, nrm, rgb, counts, flat = ns.FU.read_fused(
            ply_p, ply_p + ".vis", as_arrays=True)
        assert xyz.shape == (12, 3) and counts.sum() == len(flat)
        np.testing.assert_array_equal(counts, [p.num_visible_images
                                               for p in pts])
        np.testing.assert_array_equal(flat, np.concatenate(
            [p.visible_image_idxs for p in pts]))
        return xyz, nrm, rgb, counts, flat
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 2


# -- colmap_tools.interchange (tests/test_colmap_interchange.py) --------------

def test_bundler_to_ply(tmp_path):
    xyz, rgb, track = _pts()

    def run(ns, d):
        src, dst = str(d / "bundle.out"), str(d / "cloud.ply")
        _write_bundle_out(src, xyz, rgb, track)
        n = ns.IC.bundler_to_ply(src, dst, normalize=False,
                                 min_track_length=3)
        keep = track >= 3
        assert n == int(keep.sum())
        ply = ns.PLY.read_ply(dst)["vertex"]
        got = np.stack([ply["x"], ply["y"], ply["z"]], 1)
        np.testing.assert_allclose(got, xyz[keep] * np.array([1, 1, -1.0]),
                                   rtol=1e-5)
        got_rgb = np.stack([ply["diffuse_red"], ply["diffuse_green"],
                            ply["diffuse_blue"]], 1)
        np.testing.assert_array_equal(got_rgb, rgb[keep])
        return got, got_rgb
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 2


def test_nvm_to_ply_normalized(tmp_path):
    xyz, rgb, track = _pts()

    def run(ns, d):
        src, dst = str(d / "model.nvm"), str(d / "cloud.ply")
        _write_nvm(src, xyz, rgb, track)
        n = ns.IC.nvm_to_ply(src, dst, normalize=True, min_track_length=2)
        keep = track >= 2
        assert n == int(keep.sum())
        ply = ns.PLY.read_ply(dst)["vertex"]
        got = np.stack([ply["x"], ply["y"], ply["z"]], 1)
        np.testing.assert_allclose(
            got, ns.IC.normalize_points(xyz[keep]).astype(np.float32),
            rtol=1e-4, atol=1e-5)
        return got
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 2


def test_normalize_points_properties():
    rng = np.random.RandomState(1)
    xyz = rng.randn(500, 3) * np.array([1.0, 5.0, 0.2]) + 7.0
    out = TIC.normalize_points(xyz)
    equal(out, JIC.normalize_points(xyz))
    np.testing.assert_allclose(out.mean(0), 0.0, atol=1e-9)
    srt = np.sort(out, axis=0)
    lo, hi = srt[int(0.2 * 500)], srt[int(0.8 * 500)]
    np.testing.assert_allclose(np.linalg.norm(hi - lo), 10.0, rtol=1e-6)
    assert np.isfinite(TIC.normalize_points(np.ones((4, 3)))).all()
    assert TIC.normalize_points(np.zeros((0, 3))).shape == (0, 3)


def _make_db(ns, d, n_images=3, n_kp=10, nested=False):
    rng = np.random.RandomState(2)
    db_path = str(d / "db.db")
    img_dir = d / "images"
    img_dir.mkdir()
    kps, descs = {}, {}
    with ns.DB.ColmapDatabase(db_path) as db:
        cam = db.add_camera("PINHOLE", 64, 48, [500.0, 480.0, 32.0, 24.0])
        iids = []
        for i in range(n_images):
            name = f"rig{i % 2}/im{i}.jpg" if nested else f"im{i}.jpg"
            (img_dir / name).parent.mkdir(exist_ok=True)
            (img_dir / name).write_bytes(b"fakejpg")
            iid = db.add_image(name, cam)
            kp = np.concatenate(
                [rng.rand(n_kp, 2) * 64, np.abs(rng.rand(n_kp, 1)) + 1.0,
                 rng.rand(n_kp, 1) * 6.28, np.zeros((n_kp, 2))],
                1).astype(np.float32)
            ds = rng.randint(0, 256, (n_kp, 128)).astype(np.uint8)
            db.add_keypoints(iid, kp)
            db.add_descriptors(iid, ds)
            kps[iid], descs[iid] = kp, ds
            iids.append(iid)
        m01 = np.array([[0, 1], [2, 3], [4, 5], [6, 7]], np.uint32)
        m12 = np.array([[1, 2], [3, 4]], np.uint32)
        db.add_two_view_geometry(iids[0], iids[1], m01)
        db.add_two_view_geometry(iids[1], iids[2], m12)
        db.commit()
    return db_path, str(img_dir), iids, kps, descs, {0: m01, 1: m12}


def test_export_to_bundler(tmp_path):
    def run(ns, d):
        db_path, img_dir, iids, kps, descs, ms = _make_db(ns, d)
        out = str(d / "bundler")
        assert ns.IC.export_to_bundler(db_path, img_dir, out,
                                       min_num_matches=3) == 3
        lst = open(os.path.join(out, "list.txt")).read().strip().split("\n")
        assert len(lst) == 3 and lst[0].startswith("./im0.jpg 0 500")
        assert os.path.exists(os.path.join(out, "im1.jpg"))
        with gzip.open(os.path.join(out, "im0.key.gz"), "rt") as f:
            lines = f.read().strip().split("\n")
        assert tuple(map(int, lines[0].split())) == (10, 128)
        np.testing.assert_allclose(list(map(float, lines[1].split())),
                                   kps[iids[0]][0, [1, 0, 2, 3]], rtol=1e-5)
        np.testing.assert_array_equal(
            np.array(" ".join(lines[2:9]).split(), int), descs[iids[0]][0])
        mi = open(os.path.join(out, "matches.init.txt")).read().split()
        assert list(map(int, mi[:3])) == [0, 1, 4]
        np.testing.assert_array_equal(np.array(mi[3:], int).reshape(-1, 2),
                                      ms[0])
        assert os.path.exists(os.path.join(out, "run_bundler.sh"))
        return lines
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    same_files_but_gzip_stamps(tmp_path)


def same_files_but_gzip_stamps(tmp_path) -> None:
    """same_files for a tree with .gz members, whose headers carry the
    time and name they were written with: their decompressed contents."""
    for name in ("jax", "port"):
        for r, _, fs in os.walk(tmp_path / name):
            for f in fs:
                if f.endswith(".gz"):
                    p = os.path.join(r, f)
                    with gzip.open(p, "rb") as z:
                        data = z.read()
                    os.remove(p)
                    with open(p[:-3] + ".ungz", "wb") as g:
                        g.write(data)
    same_files(tmp_path)


def test_export_nested_image_names(tmp_path):
    def run(ns, d):
        db_path, img_dir, *_ = _make_db(ns, d, nested=True)
        out_b = str(d / "bundler")
        assert ns.IC.export_to_bundler(db_path, img_dir, out_b,
                                       min_num_matches=3) == 3
        assert os.path.exists(os.path.join(out_b, "rig1", "im1.jpg"))
        assert os.path.exists(os.path.join(out_b, "rig0", "im0.key.gz"))
        out_v = str(d / "vsfm")
        assert ns.IC.export_to_visualsfm(db_path, img_dir, out_v,
                                         min_num_matches=1) == 3
        assert os.path.exists(os.path.join(out_v, "rig0", "im2.sift"))
    run_both(tmp_path, run)
    same_files_but_gzip_stamps(tmp_path)


def test_export_to_visualsfm_binary(tmp_path):
    def run(ns, d):
        IC = ns.IC
        db_path, img_dir, iids, kps, descs, ms = _make_db(ns, d)
        out = str(d / "vsfm")
        assert IC.export_to_visualsfm(db_path, img_dir, out,
                                      min_num_matches=1) == 3
        raw = open(os.path.join(out, "im2.sift"), "rb").read()
        assert struct.unpack("5i", raw[:20]) == (
            IC._SIFT_NAME, IC._SIFT_VERSION_V4, 10, 4, 128)
        nk = 10
        kp = np.frombuffer(raw[20:20 + nk * 16], "<f4").reshape(nk, 4)
        np.testing.assert_allclose(kp, kps[iids[2]][:, :4], rtol=1e-6)
        desc = np.frombuffer(raw[20 + nk * 16: 20 + nk * 16 + nk * 128],
                             np.uint8).reshape(nk, 128)
        np.testing.assert_array_equal(desc, descs[iids[2]])
        assert struct.unpack("i", raw[-4:])[0] == IC._SIFT_EOF
        lines = open(os.path.join(out, "matches.txt")).read().strip(
            ).split("\n")
        assert lines[0].split() == ["im0.jpg", "im1.jpg", "4"]
        np.testing.assert_array_equal(np.array(lines[1].split(), int),
                                      ms[0][:, 0])
        np.testing.assert_array_equal(np.array(lines[2].split(), int),
                                      ms[0][:, 1])
        assert lines[3].split() == ["im1.jpg", "im2.jpg", "2"]
    run_both(tmp_path, run)
    same_files(tmp_path)


def test_export_to_visualsfm_ascii(tmp_path):
    def run(ns, d):
        db_path, img_dir, iids, kps, descs, _ = _make_db(ns, d)
        out = str(d / "vsfm_ascii")
        ns.IC.export_to_visualsfm(db_path, img_dir, out,
                                  binary_feature_files=False)
        lines = open(os.path.join(out, "im0.sift")).read().strip().split(
            "\n")
        assert lines[0] == "10 128"
        first = lines[1].split()
        np.testing.assert_allclose(np.array(first[:2], float),
                                   kps[iids[0]][0, :2], rtol=1e-5)
        np.testing.assert_array_equal(np.array(first[4:], int),
                                      descs[iids[0]][0])
    run_both(tmp_path, run)
    same_files(tmp_path)


def test_export_inlier_matches_and_pairs(tmp_path):
    def run(ns, d):
        db_path, img_dir, iids, _kps, _descs, ms = _make_db(ns, d)
        mpath = str(d / "inliers.txt")
        assert ns.IC.export_inlier_matches(db_path, mpath,
                                           min_num_matches=3) == 1
        toks = open(mpath).read().split()
        assert toks[:3] == ["im0.jpg", "im1.jpg", "4"]
        np.testing.assert_array_equal(np.array(toks[3:], int).reshape(
            -1, 2), ms[0])
        ppath = str(d / "pairs.txt")
        assert ns.IC.export_inlier_pairs(db_path, ppath,
                                         min_num_matches=1) == 2
        assert open(ppath).read().strip().split("\n") == [
            "im0.jpg im1.jpg", "im1.jpg im2.jpg"]
    run_both(tmp_path, run)
    same_files(tmp_path)


def test_cli_smoke(tmp_path):
    """python -m factored_neus_tpu_torch.colmap_tools.interchange's main,
    against the JAX package's CLI's file."""
    xyz, rgb, track = _pts()

    def run(ns, d):
        src, dst = str(d / "bundle.out"), str(d / "c.ply")
        _write_bundle_out(src, xyz, rgb, track)
        assert ns.IC.main(["bundler_to_ply", "--bundler_path", src,
                           "--ply_path", dst, "--normalize", "0"]) == 0
        assert os.path.exists(dst)
    run_both(tmp_path, run)
    assert same_files(tmp_path) == 2


# -- meshing/ply.py's edges and colour names ----------------------------------

def test_ply_with_edges_and_color_names_is_byte_equal(tmp_path):
    rng = np.random.RandomState(9)
    v = rng.randn(11, 3)
    faces = rng.randint(0, 11, (4, 3))
    edges = rng.randint(0, 11, (7, 2))
    colors = rng.randint(0, 256, (11, 3))
    normals = rng.randn(11, 3)
    names = ("diffuse_red", "diffuse_green", "diffuse_blue")

    def run(ns, d):
        ns.PLY.write_ply(str(d / "a.ply"), v, faces, colors, normals,
                         edges=edges, color_names=names)
        ns.PLY.write_ply(str(d / "b.ply"), v, edges=edges)
        ns.PLY.write_ply(str(d / "c.ply"), v, faces, colors)
        data = ns.PLY.read_ply(str(d / "a.ply"))
        np.testing.assert_array_equal(data["edge"]["vertex1"], edges[:, 0])
        np.testing.assert_array_equal(data["vertex"]["diffuse_blue"],
                                      colors[:, 2])
        return data
    got = run_both(tmp_path, run)
    equal(got["jax"], got["port"])
    assert same_files(tmp_path) == 3


# -- data/idr_cameras.py (tests/test_evaltools.py's IDR cases) ----------------

def test_quat_rot_roundtrip():
    rng = np.random.RandomState(3)
    q = rng.randn(8, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1                    # canonical hemisphere
    q = q.astype(np.float32)
    R = TIDR.quat_to_rot(torch.from_numpy(q))
    eye = torch.einsum("bij,bkj->bik", R, R).numpy()
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (8, 1, 1)), atol=1e-5)
    q2 = TIDR.rot_to_quat(R).numpy()
    np.testing.assert_allclose(q2, q, atol=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(JIDR.quat_to_rot(
        jnp.asarray(q))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(q2, np.asarray(JIDR.rot_to_quat(
        jnp.asarray(R.numpy()))), atol=1e-6, rtol=0)


def test_sphere_intersection():
    cam = np.asarray([[0.0, 0.0, -2.0]], np.float32)
    dirs = np.asarray([[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]], np.float32)
    inter, mask = TIDR.get_sphere_intersection(torch.from_numpy(cam),
                                               torch.from_numpy(dirs), r=1.0)
    assert bool(mask[0, 0]) and not bool(mask[0, 1])
    np.testing.assert_allclose(inter[0, 0].numpy(), [1.0, 3.0], atol=1e-5)
    jinter, jmask = JIDR.get_sphere_intersection(jnp.asarray(cam),
                                                 jnp.asarray(dirs), r=1.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(inter.numpy(), np.asarray(jinter), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("pose_kind", ["quat", "matrix"])
def test_camera_params_lift_and_depth(pose_kind):
    """get_camera_params (lift inside it) and get_depth on both pose forms
    against the JAX package's, within 1e-6."""
    rng = np.random.RandomState(5)
    B, S = 3, 6
    q = rng.randn(B, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    loc = rng.randn(B, 3) * 2.0
    if pose_kind == "quat":
        pose = np.concatenate([q, loc], 1).astype(np.float32)
    else:
        R = np.asarray(JIDR.quat_to_rot(jnp.asarray(q)))
        pose = np.tile(np.eye(4), (B, 1, 1))
        pose[:, :3, :3], pose[:, :3, 3] = R, loc
        pose = pose.astype(np.float32)
    intr = np.tile(np.eye(3), (B, 1, 1)).astype(np.float32)
    intr[:, 0, 0], intr[:, 1, 1] = 1.1, 0.9
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 0, 1] = 0.3, -0.2, 0.05
    uv = rng.rand(B, S, 2).astype(np.float32)
    pts = rng.randn(B, S, 3).astype(np.float32)
    t = torch.from_numpy
    dirs, cam = TIDR.get_camera_params(t(uv), t(pose), t(intr))
    jdirs, jcam = JIDR.get_camera_params(jnp.asarray(uv), jnp.asarray(pose),
                                         jnp.asarray(intr))
    depth = TIDR.get_depth(t(pts), t(pose))
    jdepth = JIDR.get_depth(jnp.asarray(pts), jnp.asarray(pose))
    for a, b in ((dirs, jdirs), (cam, jcam), (depth, jdepth)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
