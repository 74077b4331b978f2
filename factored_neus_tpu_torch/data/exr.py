"""Minimal self-contained OpenEXR I/O (uncompressed FLOAT or HALF
scanlines) with numpy.  Counterpart of factored_neus_tpu/data/exr.py
(read_exr, write_exr): single-part scanline files, NO_COMPRESSION; the two
packages write the same bytes and read each other's files.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PT_HALF, _PT_FLOAT = 1, 2


def _write_attr(f, name: str, type_: str, payload: bytes):
    f.write(name.encode() + b"\x00" + type_.encode() + b"\x00")
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)


def write_exr(path: str, img: np.ndarray, half: bool = False) -> None:
    """Write [H,W,3] (RGB) or [H,W] float data as an uncompressed EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in (1, 3):
        raise ValueError(f"write_exr supports 1 or 3 channels, got {C}")
    names = ["Y"] if C == 1 else ["B", "G", "R"]   # alphabetical
    chan_idx = {"Y": 0} if C == 1 else {"B": 2, "G": 1, "R": 0}
    pt = _PT_HALF if half else _PT_FLOAT
    dtype = np.float16 if half else np.float32
    pixel_bytes = 2 if half else 4

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        # channels attribute
        chan = b""
        for n in names:
            chan += n.encode() + b"\x00"
            chan += struct.pack("<iiii", pt, 0, 1, 1)
        chan += b"\x00"
        _write_attr(f, "channels", "chlist", chan)
        _write_attr(f, "compression", "compression", struct.pack("B", 0))
        box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("B", 0))
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\x00")                            # end of header

        # scanline offset table
        table_pos = f.tell()
        line_size = 4 + 4 + W * pixel_bytes * C     # y + size + data
        first_line = table_pos + 8 * H
        offsets = [first_line + i * line_size for i in range(H)]
        f.write(struct.pack(f"<{H}Q", *offsets))

        data = img.astype(dtype)
        for y in range(H):
            f.write(struct.pack("<ii", y, W * pixel_bytes * C))
            for n in names:
                f.write(data[y, :, chan_idx[n]].tobytes())


def _read_attr_header(f) -> List[Tuple[str, str, bytes]]:
    attrs = []
    while True:
        name = b""
        c = f.read(1)
        if c == b"\x00":
            break
        while c != b"\x00":
            name += c
            c = f.read(1)
        type_ = b""
        c = f.read(1)
        while c != b"\x00":
            type_ += c
            c = f.read(1)
        (size,) = struct.unpack("<i", f.read(4))
        attrs.append((name.decode(), type_.decode(), f.read(size)))
    return attrs


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed single-part scanline EXR -> [H,W,C] float32
    (RGB order when R/G/B channels present)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError("multi-part EXR not supported")
        attrs = dict()
        for name, type_, payload in _read_attr_header(f):
            attrs[name] = (type_, payload)

        # channels
        chans: List[Tuple[str, int]] = []
        payload = attrs["channels"][1]
        pos = 0
        while payload[pos] != 0:
            end = payload.index(b"\x00", pos)
            cname = payload[pos:end].decode()
            pt, = struct.unpack_from("<i", payload, end + 1)
            chans.append((cname, pt))
            pos = end + 1 + 16
        comp = attrs["compression"][1][0]
        if comp != 0:
            raise ValueError(f"compression {comp} unsupported (NO only)")
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        W, H = x1 - x0 + 1, y1 - y0 + 1

        f.read(8 * H)                               # offset table
        out = {c: np.empty((H, W), np.float32) for c, _ in chans}
        for _ in range(H):
            y, _size = struct.unpack("<ii", f.read(8))
            for cname, pt in chans:                 # alphabetical order
                dt = _PIXELTYPE[pt]
                row = np.frombuffer(f.read(W * dt().itemsize), dtype=dt)
                out[cname][y - y0] = row.astype(np.float32)

    names = [c for c, _ in chans]
    if set("RGB").issubset(names):
        return np.stack([out["R"], out["G"], out["B"]], axis=-1)
    if len(names) == 1:
        return out[names[0]][..., None]
    return np.stack([out[n] for n in names], axis=-1)
