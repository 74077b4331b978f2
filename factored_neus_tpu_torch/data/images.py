"""Self-contained 8-bit PNG codec (numpy + zlib) and the DTU image
conventions.  Counterpart of factored_neus_tpu/data/images.py, which reads
through cv2/imageio: the port keeps its own codec so it needs no image
library.

Reading covers what OpenCV and libpng write for 8-bit images: grey, grey +
alpha, RGB and RGBA, non-interlaced, with any of the five row filters
(unfiltered by the port's native host library, native/png_filters.cpp).
Arrays returned by ``imread_bgr_norm256`` follow cv2's BGR channel order and
the reference DTU loader's /256 normalisation; ``imwrite`` takes BGR like
``cv2.imwrite``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] in the file's channel order (C = 1 grey,
    2 grey+alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: only 8-bit non-interlaced grey/RGB(A) "
                         f"images are supported (depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    from ..native import png_unfilter
    return png_unfilter(zlib.decompress(b"".join(idat)), H, W * bpp,
                        bpp).reshape(H, W, bpp)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def png_encode(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1..4, file channel order) -> PNG."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"PNG: cannot write {C} channels")
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           arr.reshape(H, W * C)], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def imread_bgr_u8(path: str) -> np.ndarray:
    """8-bit image as [H, W, 3] BGR, like cv2.imread(path) (grey is
    replicated, alpha dropped)."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    C = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, -1) if C <= 2 else img[..., :3]
    return rgb[..., ::-1]


def imread_bgr_norm256(path: str) -> np.ndarray:
    """8-bit image as float BGR / 256 (the DTU convention)."""
    return np.asarray(imread_bgr_u8(path), np.float64) / 256.0


def _linear_taps(n_out: int, n_in: int):
    """Source index pairs and weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres, the source position clamped to [0, n_in - 1]."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s).astype(np.int64)
    f = s - i0
    low, high = i0 < 0, i0 >= n_in - 1
    i0[low], f[low] = 0, 0.0
    i0[high], f[high] = n_in - 1, 0.0
    return i0, np.minimum(i0 + 1, n_in - 1), f


def imresize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C] to [h, w], as cv2.resize's
    default (INTER_LINEAR) computes it for float images."""
    img = np.asarray(img)
    y0, y1, fy = _linear_taps(h, img.shape[0])
    x0, x1, fx = _linear_taps(w, img.shape[1])
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = img[y0] * (1.0 - fy) + img[y1] * fy
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    return rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx


def imwrite(path: str, img: np.ndarray) -> None:
    """uint8 image write taking BGR(A) or grey, like cv2.imwrite."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(img, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] in (3, 4):
        order = [2, 1, 0] + ([3] if arr.shape[-1] == 4 else [])
        arr = arr[..., order]
    with open(path, "wb") as f:
        f.write(png_encode(arr))
