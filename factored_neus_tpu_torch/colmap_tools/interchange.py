"""Third-party SfM format interchange: Bundler / VisualSfM <-> COLMAP.

Re-implements the remaining vendored COLMAP scripts the pipeline's tooling
had not yet covered (SURVEY §2.1 #19; ref:colmap/bundler_to_ply.py,
nvm_to_ply.py, export_to_bundler.py, export_to_visualsfm.py,
export_inlier_matches.py, export_inlier_pairs.py) as library functions over
this package's own infrastructure (`colmap_tools.database.ColmapDatabase`,
`meshing.ply.write_ply`) — vectorized parsing instead of the upstream
per-point Python loops, binary-LE PLY output instead of ascii (same data,
legacy `diffuse_*` color naming preserved).

CLI: ``python -m factored_neus_tpu_torch.colmap_tools.interchange <cmd> ...``
with cmds bundler_to_ply / nvm_to_ply / export_bundler / export_visualsfm /
export_inlier_matches / export_inlier_pairs (flag names match the upstream
scripts).

The port's own copy of factored_neus_tpu/colmap_tools/interchange.py
(numpy and the standard library; no JAX).
"""
from __future__ import annotations

import gzip
import os
import shutil
import struct
from typing import Optional, Tuple

import numpy as np

from ..meshing.ply import write_ply
from .database import ColmapDatabase

# VisualSfM .sift binary format magic numbers (public format; the constants
# name/version/eof are part of the format spec, ref:export_to_visualsfm.py)
_SIFT_NAME = 1413892435
_SIFT_VERSION_V4 = 808334422
_SIFT_EOF = 1179600383


# ---------------------------------------------------------------------------
# Reconstruction-file parsing (Bundler bundle.out, VisualSfM .nvm)
# ---------------------------------------------------------------------------

def read_bundler_points(path: str) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Points from a Bundler ``bundle.out``: (xyz [N,3] f64, rgb [N,3] u16,
    track_lengths [N] u32).

    Layout (Bundler v0.3): comment line; "<num_cameras> <num_points>";
    5 lines per camera; then per point 3 lines (position / color /
    view list whose first token is the track length)."""
    with open(path) as f:
        lines = f.read().split("\n")
    n_images, n_points = map(int, lines[1].split())
    base = 2 + 5 * n_images
    pts = lines[base: base + 3 * n_points]
    xyz = np.loadtxt([pts[i] for i in range(0, 3 * n_points, 3)],
                     dtype=np.float64).reshape(n_points, 3)
    rgb = np.loadtxt([pts[i] for i in range(1, 3 * n_points, 3)],
                     dtype=np.float64).astype(np.uint16).reshape(n_points, 3)
    track = np.array([int(pts[i].split(None, 1)[0])
                      for i in range(2, 3 * n_points, 3)], np.uint32)
    return xyz, rgb, track


def read_nvm_points(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Points from a VisualSfM ``.nvm``: (xyz, rgb, track_lengths).

    Layout: header line; blank; <num_images>; one line per image; blank;
    <num_points>; then one line per point: x y z r g b track_len ..."""
    with open(path) as f:
        lines = f.read().split("\n")
    n_images = int(lines[2])
    pt_hdr = 3 + n_images + 1
    n_points = int(lines[pt_hdr])
    rows = lines[pt_hdr + 1: pt_hdr + 1 + n_points]
    first7 = np.loadtxt([" ".join(r.split()[:7]) for r in rows],
                        dtype=np.float64).reshape(n_points, 7)
    xyz = first7[:, :3]
    rgb = first7[:, 3:6].astype(np.uint16)
    track = first7[:, 6].astype(np.uint32)
    return xyz, rgb, track


def normalize_points(xyz: np.ndarray, p0: float = 0.2, p1: float = 0.8
                     ) -> np.ndarray:
    """The upstream display normalization: center on the mean, scale so the
    [p0, p1] per-axis order-statistic bounding box has diagonal 10."""
    n = len(xyz)
    if n == 0:
        return xyz
    srt = np.sort(xyz, axis=0)
    lo = srt[min(int(p0 * n), n - 1)]
    hi = srt[min(int(p1 * n), n - 1)]
    extent = float(np.linalg.norm(hi - lo))
    scale = 10.0 / extent if extent > 0 else 1.0
    return (xyz - xyz.mean(0)) * scale


def _points_to_ply(xyz, rgb, track, ply_path, normalize, p0, p1,
                   min_track_length, flip_z):
    keep = track >= min_track_length
    xyz, rgb = xyz[keep], rgb[keep]
    if normalize:
        xyz = normalize_points(xyz, p0, p1)
    if flip_z:
        xyz = xyz * np.array([1.0, 1.0, -1.0])
    write_ply(ply_path, xyz.astype(np.float32),
              colors=np.clip(rgb, 0, 255),
              normals=np.zeros_like(xyz, dtype=np.float32),
              color_names=("diffuse_red", "diffuse_green", "diffuse_blue"))
    return int(len(xyz))


def bundler_to_ply(bundler_path: str, ply_path: str, normalize: bool = True,
                   normalize_p0: float = 0.2, normalize_p1: float = 0.8,
                   min_track_length: int = 3) -> int:
    """Bundler bundle.out -> PLY point cloud (track-length filter, optional
    normalization, z flipped into the viewer convention like upstream).
    Returns the number of points written."""
    xyz, rgb, track = read_bundler_points(bundler_path)
    return _points_to_ply(xyz, rgb, track, ply_path, normalize,
                          normalize_p0, normalize_p1, min_track_length,
                          flip_z=True)


def nvm_to_ply(nvm_path: str, ply_path: str, normalize: bool = True,
               normalize_p0: float = 0.2, normalize_p1: float = 0.8,
               min_track_length: int = 3) -> int:
    """VisualSfM .nvm -> PLY point cloud.  Returns points written."""
    xyz, rgb, track = read_nvm_points(nvm_path)
    return _points_to_ply(xyz, rgb, track, ply_path, normalize,
                          normalize_p0, normalize_p1, min_track_length,
                          flip_z=False)


# ---------------------------------------------------------------------------
# Database -> Bundler / VisualSfM input structures
# ---------------------------------------------------------------------------

def _ensure_parent(path: str) -> str:
    """COLMAP image names may contain subdirectories (e.g. ``rig1/0001.jpg``);
    create the parent directory under the output tree before writing."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


def _db_features(db: ColmapDatabase, image_id: int):
    kp = db.keypoints(image_id)
    if kp is None:
        kp = np.zeros((0, 6), np.float32)
    if kp.shape[1] < 4:                 # 2-col keypoints: pad scale/orient
        kp = np.concatenate(
            [kp, np.zeros((len(kp), 4 - kp.shape[1]), np.float32)], 1)
    desc = db.descriptors(image_id)
    if desc is None:
        desc = np.zeros((len(kp), 128), np.uint8)
    return kp, desc


def _image_index(db: ColmapDatabase):
    """{image_id: (0-based contiguous index, name)} in image_id order —
    the index both exporters use to reference images in match lists."""
    return {iid: (idx, name) for idx, (iid, (name, _cam)) in
            enumerate(sorted(db.images().items()))}


def export_to_bundler(database_path: str, image_path: str, output_path: str,
                      min_num_matches: int = 15,
                      copy_images: bool = True) -> int:
    """COLMAP database -> Bundler input structure: ``list.txt`` (image name
    + focal prior), gzipped ``.key`` feature files (y x scale orientation +
    128-d descriptors in rows of 20), ``matches.init.txt`` inlier match
    table, and a ``run_bundler.sh`` script.  Returns #images exported."""
    os.makedirs(output_path, exist_ok=True)
    with ColmapDatabase(database_path) as db:
        cams = db.cameras()
        images = db.images()
        index = _image_index(db)

        with open(os.path.join(output_path, "list.txt"), "w") as f:
            for iid, (idx, name) in sorted(index.items(),
                                           key=lambda kv: kv[1][0]):
                cam_id = images[iid][1]
                focal = float(cams[cam_id][3][0])
                f.write("./%s 0 %f\n" % (name, focal))
                src = os.path.join(image_path, name)
                dst = os.path.join(output_path, name)
                if copy_images and not os.path.exists(dst) \
                        and os.path.exists(src):
                    shutil.copyfile(src, _ensure_parent(dst))

        for iid, (idx, name) in index.items():
            key_gz = os.path.join(output_path,
                                  os.path.splitext(name)[0] + ".key.gz")
            if os.path.exists(key_gz):
                continue
            kp, desc = _db_features(db, iid)
            buf = ["%d %d" % (len(kp), desc.shape[1])]
            for r in range(len(kp)):
                # Bundler keys are (row, col) = (y, x)
                buf.append("%f %f %f %f" % (kp[r, 1], kp[r, 0],
                                            kp[r, 2], kp[r, 3]))
                row = desc[r]
                for i in range(0, desc.shape[1], 20):
                    buf.append(" ".join(str(int(v)) for v in row[i:i + 20]))
            with gzip.open(_ensure_parent(key_gz), "wt") as f:
                f.write("\n".join(buf) + "\n")

        with open(os.path.join(output_path, "matches.init.txt"), "w") as f:
            for i1, i2, m in db.two_view_geometries(min_num_matches):
                f.write("%d %d\n%d\n" % (index[i1][0], index[i2][0], len(m)))
                f.write("\n".join("%d %d" % (a, b) for a, b in m))
                f.write("\n")

    run = os.path.join(output_path, "run_bundler.sh")
    with open(run, "w") as f:
        f.write("bin/Bundler list.txt \\\n--run_bundle \\\n"
                "--use_focal_estimate \\\n--output_all bundle_ \\\n"
                "--constrain_focal \\\n--estimate_distortion \\\n"
                "--match_table matches.init.txt \\\n"
                "--variable_focal_length \\\n--output_dir bundle \\\n"
                "--output bundle.out \\\n--constrain_focal_weight 0.0001\n")
    return len(index)


def export_to_visualsfm(database_path: str, image_path: str,
                        output_path: str, min_num_matches: int = 15,
                        binary_feature_files: bool = True,
                        copy_images: bool = True) -> int:
    """COLMAP database -> VisualSfM input structure: per-image ``.sift``
    feature files (binary v4 layout or ascii) and a named-pair
    ``matches.txt``.  Returns #images exported."""
    os.makedirs(output_path, exist_ok=True)
    with ColmapDatabase(database_path) as db:
        index = _image_index(db)
        for iid, (idx, name) in index.items():
            src = os.path.join(image_path, name)
            dst = os.path.join(output_path, name)
            if copy_images and not os.path.exists(dst) \
                    and os.path.exists(src):
                shutil.copyfile(src, _ensure_parent(dst))
            sift_path = os.path.join(output_path,
                                     os.path.splitext(name)[0] + ".sift")
            if os.path.exists(sift_path):
                continue
            kp, desc = _db_features(db, iid)
            if binary_feature_files:
                with open(_ensure_parent(sift_path), "wb") as f:
                    f.write(struct.pack("5i", _SIFT_NAME, _SIFT_VERSION_V4,
                                        len(kp), 4, desc.shape[1]))
                    f.write(kp[:, :4].astype("<f4").tobytes())
                    f.write(desc.astype(np.uint8).tobytes())
                    f.write(struct.pack("i", _SIFT_EOF))
            else:
                with open(_ensure_parent(sift_path), "w") as f:
                    f.write("%d %d\n" % (len(kp), desc.shape[1]))
                    for r in range(len(kp)):
                        f.write("%f %f 0 0 " % (kp[r, 0], kp[r, 1]))
                        f.write(" ".join(str(int(v)) for v in desc[r]))
                        f.write("\n")

        names = {iid: name for iid, (idx, name) in index.items()}
        with open(os.path.join(output_path, "matches.txt"), "w") as f:
            for i1, i2, m in db.two_view_geometries(min_num_matches):
                f.write("%s %s %d\n" % (names[i1], names[i2], len(m)))
                f.write(" ".join(str(a) for a in m[:, 0]) + " \n")
                f.write(" ".join(str(b) for b in m[:, 1]) + " \n")
    return len(index)


# ---------------------------------------------------------------------------
# Database -> inlier match / pair text exports
# ---------------------------------------------------------------------------

def export_inlier_matches(database_path: str, output_path: str,
                          min_num_matches: int = 15) -> int:
    """``<name1> <name2> <k>`` then k ``idx1 idx2`` lines per verified pair
    (the upstream export_inlier_matches.py format).  Returns #pairs."""
    n = 0
    with ColmapDatabase(database_path) as db:
        names = {iid: name for iid, (name, _cam) in db.images().items()}
        with open(output_path, "w") as f:
            for i1, i2, m in db.two_view_geometries(min_num_matches):
                f.write("%s %s %d\n" % (names[i1], names[i2], len(m)))
                f.write("\n".join("%d %d" % (a, b) for a, b in m))
                f.write("\n")
                n += 1
    return n


def export_inlier_pairs(database_path: str, match_list_path: str,
                        min_num_matches: int = 15) -> int:
    """``<name1> <name2>`` per verified pair (a COLMAP matcher input list;
    the upstream export_inlier_pairs.py format).  Returns #pairs."""
    n = 0
    with ColmapDatabase(database_path) as db:
        names = {iid: name for iid, (name, _cam) in db.images().items()}
        with open(match_list_path, "w") as f:
            for i1, i2, _m in db.two_view_geometries(min_num_matches):
                f.write("%s %s\n" % (names[i1], names[i2]))
                n += 1
    return n


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="interchange", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in ("bundler_to_ply", "nvm_to_ply"):
        s = sub.add_parser(name)
        s.add_argument("--%s_path" % name.split("_")[0], required=True)
        s.add_argument("--ply_path", required=True)
        s.add_argument("--normalize", type=int, default=1)
        s.add_argument("--normalize_p0", type=float, default=0.2)
        s.add_argument("--normalize_p1", type=float, default=0.8)
        s.add_argument("--min_track_length", type=int, default=3)

    for name in ("export_bundler", "export_visualsfm"):
        s = sub.add_parser(name)
        s.add_argument("--database_path", required=True)
        s.add_argument("--image_path", required=True)
        s.add_argument("--output_path", required=True)
        s.add_argument("--min_num_matches", type=int, default=15)
        if name == "export_visualsfm":
            s.add_argument("--binary_feature_files", type=int, default=1)

    s = sub.add_parser("export_inlier_matches")
    s.add_argument("--database_path", required=True)
    s.add_argument("--output_path", required=True)
    s.add_argument("--min_num_matches", type=int, default=15)

    s = sub.add_parser("export_inlier_pairs")
    s.add_argument("--database_path", required=True)
    s.add_argument("--match_list_path", required=True)
    s.add_argument("--min_num_matches", type=int, default=15)

    a = p.parse_args(argv)
    if a.cmd == "bundler_to_ply":
        n = bundler_to_ply(a.bundler_path, a.ply_path, bool(a.normalize),
                           a.normalize_p0, a.normalize_p1,
                           a.min_track_length)
    elif a.cmd == "nvm_to_ply":
        n = nvm_to_ply(a.nvm_path, a.ply_path, bool(a.normalize),
                       a.normalize_p0, a.normalize_p1, a.min_track_length)
    elif a.cmd == "export_bundler":
        n = export_to_bundler(a.database_path, a.image_path, a.output_path,
                              a.min_num_matches)
    elif a.cmd == "export_visualsfm":
        n = export_to_visualsfm(a.database_path, a.image_path,
                                a.output_path, a.min_num_matches,
                                bool(a.binary_feature_files))
    elif a.cmd == "export_inlier_matches":
        n = export_inlier_matches(a.database_path, a.output_path,
                                  a.min_num_matches)
    else:
        n = export_inlier_pairs(a.database_path, a.match_list_path,
                                a.min_num_matches)
    print(f"{a.cmd}: {n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
