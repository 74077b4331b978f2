"""COLMAP MVS dense-map I/O (depth_maps/*.bin, normal_maps/*.bin).

Format (colmap src/mvs/mat.h; ref:colmap/read_write_dense.py is the
upstream script): ASCII header "width&height&channels&" followed by
column-major (Fortran-order) float32 data.

The port's own copy of factored_neus_tpu/colmap_tools/dense.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import numpy as np


def read_array(path: str) -> np.ndarray:
    """-> [H,W] (channels squeezed) or [H,W,C] float32."""
    with open(path, "rb") as f:
        header = b""
        delims = 0
        while delims < 3:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"truncated dense-map header in {path}")
            header += byte
            if byte == b"&":
                delims += 1
        width, height, channels = (int(t) for t in
                                   header[:-1].split(b"&"))
        data = np.fromfile(f, np.float32, width * height * channels)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(array: np.ndarray, path: str) -> None:
    array = np.asarray(array, np.float32)
    if array.ndim == 2:
        array = array[:, :, None]
    assert array.ndim == 3, "expected [H,W] or [H,W,C]"
    h, w, c = array.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        flat = np.transpose(array, (1, 0, 2)).reshape(-1, order="F")
        flat.astype("<f4").tofile(f)
