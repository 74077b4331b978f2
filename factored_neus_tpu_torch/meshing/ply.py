"""Minimal PLY mesh I/O (host side): binary-little-endian and ascii,
vertices with optional normals and colours, triangle faces.  Counterpart of
factored_neus_tpu/meshing/ply.py (write_ply, read_ply, read_ply_points,
read_ply_mesh): the port writes the same bytes for the same mesh.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def write_ply(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Binary-little-endian PLY with float32 xyz, optional float32 normals
    (nx/ny/nz), optional uchar rgb and int32 triangle faces."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(vertices, np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(v)}",
              "property float x", "property float y", "property float z"]
    fields = [("xyz", "<f4", 3)]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        fields.append(("n", "<f4", 3))
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
        fields.append(("rgb", "u1", 3))
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec = np.zeros(len(v), dtype=fields)
        rec["xyz"] = v
        if normals is not None:
            rec["n"] = np.asarray(normals, np.float32)
        if colors is not None:
            rec["rgb"] = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
        f.write(rec.tobytes())
        if faces is not None:
            fa = np.asarray(faces, np.int32)
            frec = np.zeros(len(fa), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            frec["n"] = 3
            frec["idx"] = fa
            f.write(frec.tobytes())


def _parse_header(f):
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, elements, cur = None, [], None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in header")
        tok = line.strip().split()
        if not tok:
            continue
        key = tok[0].decode()
        if key == "format":
            fmt = tok[1].decode()
        elif key == "element":
            # (name, count, [(prop, dtype, is_list, list count dtype)])
            cur = (tok[1].decode(), int(tok[2]), [])
            elements.append(cur)
        elif key == "property":
            if tok[1] == b"list":
                cur[2].append((tok[4].decode(), _PLY_TO_NP[tok[3].decode()],
                               True, _PLY_TO_NP[tok[2].decode()]))
            else:
                cur[2].append((tok[2].decode(), _PLY_TO_NP[tok[1].decode()],
                               False, None))
        elif key == "end_header":
            return fmt, elements


def read_ply(path: str):
    """element name -> property name -> np.ndarray; ascii or
    binary_little_endian, list properties only for faces."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out = {}
        if fmt == "ascii":
            text = f.read().decode().split("\n")
            row = 0
            for name, count, props in elements:
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    vals = text[row].split()
                    row += 1
                    j = 0
                    for pname, dt, is_list, _ in props:
                        if is_list:
                            n = int(vals[j])
                            cols[pname].append(np.array(vals[j + 1:j + 1 + n],
                                                        dtype=dt))
                            j += 1 + n
                        else:
                            cols[pname].append(np.array(vals[j], dtype=dt))
                            j += 1
                out[name] = {k: np.stack(vs) if len(vs) else np.empty(0)
                             for k, vs in cols.items()}
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if not any(p[2] for p in props):
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    rec = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    out[name] = {p[0]: np.ascontiguousarray(rec[p[0]])
                                 for p in props}
                    continue
                # one list property of uniform length (triangle faces): the
                # first row's count holds for every row
                pname, dt, _, cnt_t = props[0]
                cnt_size = np.dtype(cnt_t).itemsize
                head = f.read(cnt_size)
                if count == 0:
                    out[name] = {pname: np.empty((0, 3), dtype=dt)}
                    continue
                first_n = int(np.frombuffer(head, dtype="<" + cnt_t)[0])
                item = np.dtype([("n", "<" + cnt_t), ("v", "<" + dt, first_n)])
                body = head + f.read(item.itemsize * count - cnt_size)
                rec = np.frombuffer(body, dtype=item, count=count)
                out[name] = {pname: np.ascontiguousarray(rec["v"])}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return out


def read_ply_points(path: str) -> np.ndarray:
    """[N, 3] float64 vertex positions."""
    data = read_ply(path)["vertex"]
    return np.stack([np.asarray(data[c], np.float64)
                     for c in ("x", "y", "z")], axis=1)


def read_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] float64, faces [F, 3] int64)."""
    data = read_ply(path)
    verts = np.stack([np.asarray(data["vertex"][c], np.float64)
                      for c in ("x", "y", "z")], axis=1)
    faces = np.asarray(data["face"][next(iter(data["face"]))], np.int64)
    return verts, faces
