"""Mask-based DTU mesh cleaning CLI of the port, with the arguments of the
root clean_mesh_pose.py:

    python -m factored_neus_tpu_torch.clean_mesh_pose --scene 97 \
        --setting womask/geometry [--suffix 300000] \
        [--data_dir ./public_data/data_DTU] [--exp_dir ./exp] [--case C]

Reads <exp_dir>/<case>/<setting>/meshes/<suffix:08d>.ply, culls it by the
scan's masks (evaltools/clean_mesh.py) and writes
meshes_clean/<suffix:08d>.ply beside it.
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Sequence

from .evaltools.clean_mesh import clean_mesh
from .meshing.ply import read_ply_mesh, write_ply


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--setting", type=str, required=True)
    parser.add_argument("--suffix", type=int, default=300000)
    parser.add_argument("--data_dir", type=str,
                        default="./public_data/data_DTU")
    parser.add_argument("--exp_dir", type=str, default="./exp")
    parser.add_argument("--case", type=str, default=None,
                        help="experiment case under exp_dir (default "
                             "data_DTU/dtu_scan<scene>)")
    args = parser.parse_args(argv)
    scan = int(args.scene)
    case = args.case if args.case is not None else f"data_DTU/dtu_scan{scan}"
    old_dir = f"{args.exp_dir}/{case}/{args.setting}/meshes/"
    new_dir = f"{args.exp_dir}/{case}/{args.setting}/meshes_clean/"
    os.makedirs(new_dir, exist_ok=True)
    verts, faces = read_ply_mesh(os.path.join(old_dir,
                                              f"{args.suffix:08d}.ply"))
    cameras_npz = f"{args.data_dir}/dtu_scan{scan}/cameras_sphere.npz"
    mask_paths = sorted(glob(f"{args.data_dir}/dtu_scan{scan}/mask/*.png"))
    n_images = 49 if scan < 83 else 64
    new_verts, new_faces = clean_mesh(verts, faces, cameras_npz, mask_paths,
                                      n_images)
    out = os.path.join(new_dir, f"{args.suffix:08d}.ply")
    write_ply(out, new_verts, new_faces)
    print(f"cleaned: {len(verts)} -> {len(new_verts)} vertices")
    return out


if __name__ == "__main__":
    main()
