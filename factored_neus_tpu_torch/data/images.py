"""Self-contained 8-bit PNG codec (numpy + zlib), a float TIFF reader and
writer, and the image conventions of the dataset families.  Counterpart of
factored_neus_tpu/data/images.py, which reads through cv2/imageio/PIL: the
port keeps its own codecs so it needs no image library.

Reading covers what OpenCV and libpng write for 8- and 16-bit images:
grey, grey + alpha, RGB and RGBA, non-interlaced, with any of the five row
filters (unfiltered by the port's native host library,
native/png_filters.cpp).
Arrays returned by ``imread_bgr_norm256`` follow cv2's BGR channel order and
the reference DTU loader's /256 normalisation; ``imwrite`` takes BGR like
``cv2.imwrite``.  ``load_rgb``, ``load_mask`` and ``load_nerfactor_mask``
are the Blender-layout conventions (RGB order; 8-bit images
gamma-linearised, EXR kept linear; masks from PIL's "L" conversion or the
alpha channel).

TIFF: ``imread_tiff`` reads the strips of a baseline TIFF (one image, any
byte order, 8/16/32-bit integers or 32/64-bit floats, chunky samples),
uncompressed, Deflate or LZW, without a predictor; any other layout or
codec raises with its name.  ``write_tiff`` writes an uncompressed float32
grey TIFF.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] in the file's channel order (C = 1 grey,
    2 grey+alpha, 3 RGB, 4 RGBA): uint8, or uint16 for a 16-bit file."""
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
    if depth not in (8, 16) or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: only 8- and 16-bit non-interlaced "
                         f"grey/RGB(A) images are supported (depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    C, nb = _CHANNELS[color], depth // 8
    from ..native import png_unfilter
    raw = png_unfilter(zlib.decompress(b"".join(idat)), H, W * C * nb,
                       C * nb)
    if nb == 2:
        raw = raw.view(">u2").astype(np.uint16)
    return raw.reshape(H, W, C)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def png_encode(img: np.ndarray) -> bytes:
    """uint8 or uint16 [H, W] or [H, W, C] (C = 1..4, file channel order)
    -> an 8- or 16-bit PNG."""
    arr = np.asarray(img)
    depth = 16 if arr.dtype == np.uint16 else 8
    arr = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"PNG: cannot write {C} channels")
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           arr.view(np.uint8).reshape(H, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def imread_bgr_u8(path: str) -> np.ndarray:
    """An image as [H, W, 3] uint8 BGR, like cv2.imread(path): grey is
    replicated, alpha dropped, a 16-bit sample keeps its high byte."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    C = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, -1) if C <= 2 else img[..., :3]
    return rgb[..., ::-1]


def imread_bgr_norm256(path: str) -> np.ndarray:
    """8-bit image as float BGR / 256 (the DTU convention)."""
    return np.asarray(imread_bgr_u8(path), np.float64) / 256.0


def _read_png(path: str) -> np.ndarray:
    """An 8-bit PNG's [H, W, C] samples."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG where an 8-bit image is "
                         "read")
    return img


def _rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, C] file channels -> [H, W, 3] RGB (grey replicated, alpha
    dropped)."""
    return np.repeat(img[..., :1], 3, -1) if img.shape[-1] <= 2 \
        else img[..., :3]


def load_rgb(path: str) -> np.ndarray:
    """float32 RGB [H, W, 3]: an EXR stays linear, an 8-bit image is
    linearised as (x / 255) ** 2.2."""
    if path.endswith(".exr"):
        from .exr import read_exr
        img = read_exr(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        return np.float32(img)[..., :3]
    img = np.float32(_rgb(_read_png(path))) / 255.0
    return np.power(img, 2.2)


def to_luma(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] file channels -> PIL's "L" image [H, W] uint8: grey
    as it is, RGB(A) as (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    if img.shape[-1] <= 2:
        return img[..., 0]
    r, g, b = (img[..., c].astype(np.uint32) for c in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def load_mask(path: str) -> np.ndarray:
    """bool object mask [H, W]: the image's "L" value / 255 above 0.5."""
    return (np.float32(to_luma(_read_png(path))) / 255.0) > 0.5


def load_nerfactor_mask(path: str) -> np.ndarray:
    """bool mask [H, W] from the alpha channel of an RGBA (or grey + alpha)
    image: alpha / 255 above 0.5."""
    img = _read_png(path)
    if img.shape[-1] not in (2, 4):
        raise ValueError(f"{path}: no alpha channel ({img.shape[-1]} "
                         "channels)")
    return (np.float32(img[..., -1]) / 255.0) > 0.5


# -- TIFF -------------------------------------------------------------------

_TIFF_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                     4: "CCITT Group 4", 5: "LZW", 6: "old JPEG", 7: "JPEG",
                     8: "Deflate", 32773: "PackBits", 32946: "Deflate",
                     34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h",
               9: "i", 11: "f", 12: "d", 16: "Q"}
_TIFF_DTYPE = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 8): "i1",
               (2, 16): "i2", (2, 32): "i4", (3, 32): "f4", (3, 64): "f8"}


def _tiff_tags(data: bytes, bo: str) -> Dict[int, List]:
    """The tags of a TIFF's first image file directory."""
    (ifd,) = struct.unpack_from(bo + "I", data, 4)
    (n,) = struct.unpack_from(bo + "H", data, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count, _ = struct.unpack_from(bo + "HHII", data,
                                                ifd + 2 + 12 * i)
        if typ not in _TIFF_TYPES:
            continue                   # rationals etc.: no tag read here
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        pos = ifd + 2 + 12 * i + 8
        if size > 4:
            (pos,) = struct.unpack_from(bo + "I", data, pos)
        tags[tag] = list(struct.unpack_from(f"{bo}{count}{fmt}", data, pos))
    return tags


def lzw_decode(data: bytes) -> bytes:
    """TIFF's LZW (codes MSB first, 9 to 12 bits, Clear 256, EOI 257, the
    code width growing one code early)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, pos, prev = 9, 0, None
    end = 8 * len(data)
    while pos + width <= end:
        byte = pos >> 3
        word = int.from_bytes(data[byte:byte + 3].ljust(3, b"\0"), "big")
        code = (word >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream (code {code})")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def imread_tiff(path: str) -> np.ndarray:
    """A TIFF's first image as [H, W] (one sample) or [H, W, S], in its
    stored type (float32 for the disparity maps of Shiny scenes)."""
    with open(path, "rb") as f:
        data = f.read()
    bo = {b"II": "<", b"MM": ">"}.get(data[:2])
    if bo is None or struct.unpack_from(bo + "H", data, 2)[0] != 42:
        raise ValueError(f"{path}: not a TIFF file (BigTIFF is not read)")
    tags = _tiff_tags(data, bo)
    get = lambda t, d: tags.get(t, [d])
    W, H = tags[256][0], tags[257][0]
    spp = get(277, 1)[0]
    bits = get(258, 1)[0]
    fmt = get(339, 1)[0]
    comp = get(259, 1)[0]
    if 322 in tags or 324 in tags:
        raise ValueError(f"{path}: tiled TIFF is not supported")
    if spp > 1 and get(284, 1)[0] != 1:
        raise ValueError(f"{path}: planar TIFF is not supported")
    if get(317, 1)[0] != 1:
        raise ValueError(f"{path}: TIFF predictor {get(317, 1)[0]} is not "
                         "supported")
    if (fmt, bits) not in _TIFF_DTYPE:
        raise ValueError(f"{path}: TIFF sample format {fmt} of {bits} bits "
                         "is not supported")
    if comp not in (1, 5, 8, 32946):
        raise ValueError(f"{path}: TIFF compression {comp} "
                         f"({_TIFF_COMPRESSION.get(comp, 'unknown')}) is not "
                         "supported")
    raw = bytearray()
    for off, n in zip(tags[273], tags[279]):
        strip = data[off:off + n]
        if comp == 5:
            strip = lzw_decode(strip)
        elif comp != 1:
            strip = zlib.decompress(strip)
        raw += strip
    dtype = np.dtype(_TIFF_DTYPE[(fmt, bits)]).newbyteorder(bo)
    img = np.frombuffer(bytes(raw), dtype, H * W * spp)
    img = img.astype(img.dtype.newbyteorder("=")).reshape(H, W, spp)
    return img[..., 0] if spp == 1 else img


def write_tiff(path: str, img: np.ndarray) -> None:
    """float32 [H, W] as an uncompressed little-endian grey TIFF (one
    strip)."""
    arr = np.ascontiguousarray(img, "<f4")
    if arr.ndim != 2:
        raise ValueError(f"write_tiff takes [H, W], got {arr.shape}")
    H, W = arr.shape
    entries = [(256, 4, W), (257, 4, H), (258, 3, 32), (259, 3, 1),
               (262, 3, 1), (273, 4, 0), (277, 3, 1), (278, 4, H),
               (279, 4, arr.nbytes), (339, 3, 3)]
    ifd = 8
    offset = ifd + 2 + 12 * len(entries) + 4
    body = struct.pack("<H", len(entries))
    for tag, typ, val in entries:
        val = offset if tag == 273 else val
        body += struct.pack("<HHI" + ("HH" if typ == 3 else "I"), tag, typ,
                            1, *((val, 0) if typ == 3 else (val,)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd) + body
                + struct.pack("<I", 0) + arr.tobytes())


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
    """Image write taking BGR(A) or grey, like cv2.imwrite: uint16 as a
    16-bit PNG, anything else clipped to [0, 255] as 8-bit."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint16:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] in (3, 4):
        order = [2, 1, 0] + ([3] if arr.shape[-1] == 4 else [])
        arr = arr[..., order]
    with open(path, "wb") as f:
        f.write(png_encode(arr))
