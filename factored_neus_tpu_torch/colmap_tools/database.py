"""COLMAP sqlite database I/O — an independent implementation of the public
COLMAP database schema (colmap.github.io/database; ref:colmap/database.py is
the upstream script the reference vendors but never imports).

Lets a user fabricate a database with known cameras/poses (e.g. to run
COLMAP's matcher/triangulator on a captured scene before training), or read
keypoints/matches out of an existing reconstruction.

The port's own copy of factored_neus_tpu/colmap_tools/database.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

# camera model name -> (model_id, #params); the subset the pipeline's
# loaders understand (data/colmap_model.py)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {maxid}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
""".format(maxid=MAX_IMAGE_ID)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's canonical unordered pair key (smaller id first)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - image_id2) // MAX_IMAGE_ID, image_id2


def _blob(a: Optional[np.ndarray]) -> Optional[bytes]:
    return None if a is None else np.ascontiguousarray(a).tobytes()


def _unblob(b, dtype, shape=(-1,)) -> Optional[np.ndarray]:
    if b is None:
        return None
    return np.frombuffer(b, dtype).reshape(*shape)


class ColmapDatabase:
    """Thin typed layer over the COLMAP sqlite schema."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    # -- writers -------------------------------------------------------------

    def add_camera(self, model: str, width: int, height: int,
                   params, prior_focal_length: bool = False,
                   camera_id: Optional[int] = None) -> int:
        model_id, n_params = CAMERA_MODELS[model]
        params = np.asarray(params, np.float64)
        assert params.size == n_params, \
            f"{model} expects {n_params} params, got {params.size}"
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, int(width), int(height), _blob(params),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int, prior_q=None,
                  prior_t=None, image_id: Optional[int] = None) -> int:
        q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q)
        t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t)
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, int(camera_id), *map(float, q), *map(float, t)))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 2 and keypoints.shape[1] in (2, 4, 6)
        self.conn.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                          (int(image_id), *keypoints.shape, _blob(keypoints)))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        descriptors = np.asarray(descriptors, np.uint8)
        self.conn.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                          (int(image_id), *descriptors.shape,
                           _blob(descriptors)))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray) -> None:
        matches = np.asarray(matches, np.uint32)
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:        # canonical order flips the columns
            matches = matches[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2), *matches.shape,
             _blob(matches)))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=None, E=None, H=None,
                              qvec=None, tvec=None, config: int = 2) -> None:
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        as64 = lambda a: None if a is None else np.asarray(a, np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2), *matches.shape,
             _blob(matches), int(config), _blob(as64(F)), _blob(as64(E)),
             _blob(as64(H)), _blob(as64(qvec)), _blob(as64(tvec))))

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()

    # -- readers -------------------------------------------------------------

    def cameras(self):
        """{camera_id: (model_name, width, height, params)}"""
        inv = {v[0]: k for k, v in CAMERA_MODELS.items()}
        out = {}
        for cid, model, w, h, params, _ in self.conn.execute(
                "SELECT * FROM cameras"):
            out[cid] = (inv.get(model, model), w, h,
                        _unblob(params, np.float64))
        return out

    def images(self):
        """{image_id: (name, camera_id)}"""
        return {r[0]: (r[1], r[2]) for r in
                self.conn.execute("SELECT image_id, name, camera_id "
                                  "FROM images")}

    def keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (int(image_id),)).fetchone()
        return None if row is None else _unblob(row[2], np.float32,
                                                (row[0], row[1]))

    def descriptors(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?",
            (int(image_id),)).fetchone()
        return None if row is None else _unblob(row[2], np.uint8,
                                                (row[0], row[1]))

    def two_view_geometries(self, min_num_matches: int = 0):
        """Yields (image_id1, image_id2, inlier_matches [k,2] u32) for every
        verified pair with >= min_num_matches inliers."""
        for pid, rows, cols, data in self.conn.execute(
                "SELECT pair_id, rows, cols, data FROM two_view_geometries "
                "WHERE rows>=?", (int(min_num_matches),)):
            m = _unblob(data, np.uint32, (rows, cols))
            if m is None:
                continue
            i1, i2 = pair_id_to_image_ids(pid)
            yield i1, i2, m

    def matches(self, image_id1: int, image_id2: int) -> Optional[np.ndarray]:
        pid = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pid,)).fetchone()
        if row is None:
            return None
        m = _unblob(row[2], np.uint32, (row[0], row[1]))
        return m[:, ::-1] if image_id1 > image_id2 else m

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:   # roll back partial writes on error
            self.conn.rollback()
            self.conn.close()
        else:
            self.close()
