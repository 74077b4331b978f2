"""Host-side native code of the port: marching tetrahedra over a dense grid
(marching_cubes.cpp, the port's copy of the JAX package's source), bound
with ctypes.  Counterpart of factored_neus_tpu/native (marching_cubes).

The library is built with g++ at first use into ``build/native/`` beside
the package, and rebuilt when it is older than its source.  A failed build
raises with g++'s output.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "marching_cubes.cpp")
LIB = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native",
                   "libfneus_torch_mc.so")
_LOCK = threading.Lock()
_LIB = None


def build() -> str:
    """Compile the library (to a temporary path, then renamed into place,
    so a concurrent process never loads a half-written file)."""
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc={proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIB)
    return LIB


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not os.path.exists(LIB) or \
                    os.path.getmtime(LIB) < os.path.getmtime(SOURCE):
                build()
            lib = ctypes.CDLL(LIB)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64 = ctypes.c_int64
            lib.marching_cubes.restype = ctypes.c_int
            lib.marching_cubes.argtypes = [
                f32p, i64, i64, i64, ctypes.c_float, ctypes.POINTER(f32p),
                ctypes.POINTER(i64), ctypes.POINTER(i32p),
                ctypes.POINTER(i64)]
            lib.mc_free.restype = None
            lib.mc_free.argtypes = [ctypes.c_void_p]
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
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int32)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.marching_cubes(g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            nx, ny, nz, ctypes.c_float(iso), ctypes.byref(vp),
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
