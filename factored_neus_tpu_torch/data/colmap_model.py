"""COLMAP sparse-model I/O: cameras / images / points3D in text and binary.

Role parity: the reference vendors COLMAP's scripts/python tree
(ref:colmap/read_write_model.py — the only part of the vendored code with
self-tests, ref:colmap/test_read_write_model.py).  This is an independent
implementation of the public COLMAP model format (documented at
colmap.github.io/format.html): same dataclasses-of-record API
(Camera/Image/Point3D), same .txt/.bin round-trip guarantees.

Numpy-vectorized where the format allows (points3D track parsing), plain
struct elsewhere.

The port's own copy of factored_neus_tpu/data/colmap_model.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# model_name -> (model_id, num_params)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
CAMERA_MODEL_IDS = {mid: (name, n) for name, (mid, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray          # [4] (w, x, y, z)
    tvec: np.ndarray          # [3]
    camera_id: int
    name: str
    xys: np.ndarray           # [n, 2]
    point3D_ids: np.ndarray   # [n]

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray           # [3]
    rgb: np.ndarray           # [3] uint8
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    # Shepperd's method via the symmetric 4x4 eigen problem
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


# -- text ------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = Camera(
                id=int(parts[0]), model=parts[1], width=int(parts[2]),
                height=int(parts[3]),
                params=np.array(parts[4:], dtype=np.float64))
    return cams


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        # keep empty points-lines (images with zero observations) so the
        # header/points pairing stays aligned
        lines = [l.strip() for l in f if not l.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        head = lines[i].split()
        img_id = int(head[0])
        qvec = np.array(head[1:5], np.float64)
        tvec = np.array(head[5:8], np.float64)
        cam_id = int(head[8])
        name = head[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(elems, np.float64).reshape(-1, 3) if elems else \
            np.zeros((0, 3))
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name,
                               arr[:, :2], arr[:, 2].astype(np.int64))
    return images


def write_images_text(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = []
            for xy, pid in zip(im.xys, im.point3D_ids):
                row += [repr(float(xy[0])), repr(float(xy[1])), str(int(pid))]
            f.write(" ".join(row) + "\n")


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            track = np.array(e[8:], np.float64).reshape(-1, 2)
            pts[int(e[0])] = Point3D(
                id=int(e[0]), xyz=np.array(e[1:4], np.float64),
                rgb=np.array(e[4:7], np.uint8), error=float(e[7]),
                image_ids=track[:, 0].astype(np.int64),
                point2D_idxs=track[:, 1].astype(np.int64))
    return pts


def write_points3D_text(points3D: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points3D)}\n")
        for p in points3D.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {track}\n")


# -- binary ----------------------------------------------------------------

def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, f.read(size))


def _write(f, fmt: str, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "iiQQ")
            name, num_params = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(f, "d" * num_params), np.float64)
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(cameras))
        for cam in cameras.values():
            model_id, num_params = CAMERA_MODELS[cam.model]
            _write(f, "iiQQ", cam.id, model_id, cam.width, cam.height)
            _write(f, "d" * num_params, *cam.params)


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            img_id = _read(f, "i")[0]
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            cam_id = _read(f, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * n2d),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            images[img_id] = Image(
                img_id, qvec, tvec, cam_id, name.decode(),
                np.stack([data["x"], data["y"]], -1) if n2d else
                np.zeros((0, 2)),
                data["id"].copy())
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(images))
        for im in images.values():
            _write(f, "i", im.id)
            _write(f, "dddd", *im.qvec)
            _write(f, "ddd", *im.tvec)
            _write(f, "i", im.camera_id)
            f.write(im.name.encode() + b"\x00")
            _write(f, "Q", len(im.xys))
            for xy, pid in zip(im.xys, im.point3D_ids):
                _write(f, "ddq", xy[0], xy[1], int(pid))


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            pid = _read(f, "Q")[0]
            xyz = np.array(_read(f, "ddd"))
            rgb = np.array(_read(f, "BBB"), np.uint8)
            (err,) = _read(f, "d")
            (track_len,) = _read(f, "Q")
            data = np.frombuffer(f.read(8 * track_len),
                                 dtype=[("img", "<i4"), ("p2d", "<i4")])
            pts[pid] = Point3D(pid, xyz, rgb, err,
                               data["img"].astype(np.int64),
                               data["p2d"].astype(np.int64))
    return pts


def write_points3D_binary(points3D: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(points3D))
        for p in points3D.values():
            _write(f, "Q", p.id)
            _write(f, "ddd", *p.xyz)
            _write(f, "BBB", *(int(v) for v in p.rgb))
            _write(f, "d", p.error)
            _write(f, "Q", len(p.image_ids))
            for i, j in zip(p.image_ids, p.point2D_idxs):
                _write(f, "ii", int(i), int(j))


# -- dispatch --------------------------------------------------------------

def read_model(path: str, ext: str = ""):
    if not ext:
        ext = ".bin" if os.path.exists(os.path.join(path, "cameras.bin")) \
            else ".txt"
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3D_text(os.path.join(path, "points3D.txt")))
    return (read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3D_binary(os.path.join(path, "points3D.bin")))


def write_model(cameras, images, points3D, path: str, ext: str = ".bin"):
    os.makedirs(path, exist_ok=True)
    if ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3D_text(points3D, os.path.join(path, "points3D.txt"))
    else:
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3D_binary(points3D, os.path.join(path, "points3D.bin"))
