"""DTU Chamfer-L1 evaluation protocol.  Counterpart of
factored_neus_tpu/evaltools/dtu.py: mesh -> dense surface samples
(density 0.2) -> greedy downsample -> ObsMask bounding and visibility
filter -> KD-tree d2s / s2d with a 20 mm cutoff -> error-coloured PLYs and
result{suffix}.txt.  The ObsMask and Plane .mat files are read through
scipy.io.loadmat.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..meshing.ply import read_ply_mesh, read_ply_points, write_ply
from . import pointcloud as PC

MAX_DIST = 20.0
PATCH = 60.0
THRESH = 0.2         # downsample density


def eval(in_file: str, scene: int, dataset_dir: str, eval_dir: str,
         suffix: str = "") -> Tuple[float, float, float]:
    from scipy.io import loadmat

    vertices, triangles = read_ply_mesh(in_file)
    data_pcd = PC.sample_mesh_points(vertices, triangles, THRESH)
    data_down = PC.downsample(data_pcd, THRESH)

    obs = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scene}_10.mat")
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = ((data_down >= BB[:1] - PATCH)
               & (data_down < BB[1:] + PATCH * 2)).sum(-1) == 3
    data_in = data_down[inbound]

    data_grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_inbound = ((data_grid >= 0)
                    & (data_grid < np.expand_dims(ObsMask.shape, 0))
                    ).sum(-1) == 3
    data_grid_in = data_grid[grid_inbound]
    in_obs = ObsMask[data_grid_in[:, 0], data_grid_in[:, 1],
                     data_grid_in[:, 2]].astype(bool)
    data_in_obs = data_in[grid_inbound][in_obs]

    stl = read_ply_points(
        f"{dataset_dir}/Points/stl/stl{scene:03}_total.ply")

    dist_d2s = PC.nn_distances(data_in_obs, stl)
    mean_d2s = dist_d2s[dist_d2s < MAX_DIST].mean()

    ground_plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scene}.mat")["P"]
    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (ground_plane.reshape(1, 4) * stl_hom).sum(-1) > 0
    stl_above = stl[above]

    dist_s2d = PC.nn_distances(stl_above, data_in)
    mean_s2d = dist_s2d[dist_s2d < MAX_DIST].mean()

    # error visualizations
    os.makedirs(eval_dir, exist_ok=True)
    vis_dist = 1.0
    active_d = np.where(inbound)[0][grid_inbound][in_obs]
    colors_d = PC.error_colors(len(data_down), active_d, dist_d2s, vis_dist,
                               MAX_DIST)
    write_ply(f"{eval_dir}/vis_{scene:03}_d2s{suffix}.ply", data_down,
              colors=colors_d * 255)
    colors_s = PC.error_colors(len(stl), np.where(above)[0], dist_s2d,
                               vis_dist, MAX_DIST)
    write_ply(f"{eval_dir}/vis_{scene:03}_s2d{suffix}.ply", stl,
              colors=colors_s * 255)

    over_all = (mean_d2s + mean_s2d) / 2
    with open(f"{eval_dir}/result{suffix}.txt", "w") as f:
        f.write(f"{mean_d2s} {mean_s2d} {over_all}")
    return float(mean_d2s), float(mean_s2d), float(over_all)
