"""Host-side native code of the port, bound with ctypes: marching
tetrahedra over a dense grid (marching_cubes.cpp), the KD-tree and greedy
downsample of the Chamfer evaluations (kdtree.cpp), both the port's copies
of the JAX package's sources, and the PNG reader's row unfiltering
(png_filters.cpp).  Counterpart of factored_neus_tpu/native
(marching_cubes, KDTree, greedy_downsample).

The library is built with g++ at first use into ``build/native/`` beside
the package, with the JAX package's flags, and rebuilt when it is older
than a source.  A failed build raises with g++'s output.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, s) for s in
           ("marching_cubes.cpp", "kdtree.cpp", "png_filters.cpp")]
LIB = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native",
                   "libfneus_torch_native.so")
_LOCK = threading.Lock()
_LIB = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64


def build() -> str:
    """Compile the library (to a temporary path, then renamed into place,
    so a concurrent process never loads a half-written file)."""
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc={proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIB)
    return LIB


def _declare(lib: ctypes.CDLL) -> None:
    sigs = {
        "marching_cubes": (ctypes.c_int, [
            _f32p, _i64, _i64, _i64, ctypes.c_float, ctypes.POINTER(_f32p),
            ctypes.POINTER(_i64), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i64)]),
        "mc_free": (None, [ctypes.c_void_p]),
        "kdtree_build": (ctypes.c_void_p, [_f32p, _i64]),
        "kdtree_free": (None, [ctypes.c_void_p]),
        "kdtree_query": (None, [ctypes.c_void_p, _f32p, _i64, _f32p,
                                _i32p]),
        "kdtree_query_radius_count": (None, [ctypes.c_void_p, _f32p, _i64,
                                             ctypes.c_float, _i32p]),
        "kdtree_greedy_downsample": (None, [_f32p, _i64, ctypes.c_float,
                                            _u8p]),
        "png_unfilter": (_i64, [_u8p, _i64, _i64, _i64, _u8p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not os.path.exists(LIB) or os.path.getmtime(LIB) < max(
                    os.path.getmtime(s) for s in SOURCES):
                build()
            lib = ctypes.CDLL(LIB)
            _declare(lib)
            _LIB = lib
        return _LIB


def marching_cubes(grid: np.ndarray, iso: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] float32 in grid-index coordinates, triangles [T, 3]
    int32) of the surface grid == iso, wound so that normals point toward
    larger values; grid is indexed [x][y][z]."""
    lib = load()
    g = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = g.shape
    # the edge cache packs two corner ids into one uint64
    if (nx + 1) * (ny + 1) * (nz + 1) >= (1 << 32):
        raise ValueError(f"grid {g.shape} exceeds the 32-bit corner-id "
                         "limit of the edge cache (~1600^3)")
    vp, tp = _f32p(), _i32p()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.marching_cubes(g.ctypes.data_as(_f32p), nx, ny, nz,
                            ctypes.c_float(iso), ctypes.byref(vp),
                            ctypes.byref(nv), ctypes.byref(tp),
                            ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("marching_cubes allocation failed")
    try:
        verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
                if nt.value else np.zeros((0, 3), np.int32))
    finally:
        lib.mc_free(vp)
        lib.mc_free(tp)
    return verts, tris


def _points(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected points [N, 3], got {pts.shape}")
    return pts


class KDTree:
    """Nearest-neighbour queries on a fixed point cloud (threaded)."""

    def __init__(self, points: np.ndarray):
        self._lib = load()
        self._pts = _points(points)     # the tree keeps its own copy
        self._handle = self._lib.kdtree_build(
            self._pts.ctypes.data_as(_f32p), len(self._pts))

    def query(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(distances [M] float32, indices [M] int32) of the nearest tree
        point to each query."""
        q = _points(queries)
        dist = np.empty(len(q), np.float32)
        idx = np.empty(len(q), np.int32)
        self._lib.kdtree_query(self._handle, q.ctypes.data_as(_f32p), len(q),
                               dist.ctypes.data_as(_f32p),
                               idx.ctypes.data_as(_i32p))
        return dist, idx

    def query_radius_count(self, queries: np.ndarray, radius: float
                           ) -> np.ndarray:
        """[M] int32: the tree points within ``radius`` of each query."""
        q = _points(queries)
        cnt = np.empty(len(q), np.int32)
        self._lib.kdtree_query_radius_count(
            self._handle, q.ctypes.data_as(_f32p), len(q),
            ctypes.c_float(radius), cnt.ctypes.data_as(_i32p))
        return cnt

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kdtree_free(handle)
            self._handle = None


def greedy_downsample(points: np.ndarray, radius: float) -> np.ndarray:
    """Boolean keep-mask of the greedy radius suppression: in order, a
    point is kept unless a kept point lies within ``radius``."""
    pts = _points(points)
    keep = np.empty(len(pts), np.uint8)
    load().kdtree_greedy_downsample(pts.ctypes.data_as(_f32p), len(pts),
                                    ctypes.c_float(radius),
                                    keep.ctypes.data_as(_u8p))
    return keep.astype(bool)


def png_unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """The [H, stride] uint8 image bytes of H filtered PNG rows (a filter
    type byte, then stride bytes each)."""
    if len(raw) != H * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data, expected "
                         f"{H * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((H, stride), np.uint8)
    bad = load().png_unfilter(src.ctypes.data_as(_u8p), H, stride, bpp,
                              out.ctypes.data_as(_u8p))
    if bad:
        row = bad - 1
        raise ValueError(f"PNG: unknown row filter "
                         f"{src[row * (stride + 1)]} in row {row}")
    return out
