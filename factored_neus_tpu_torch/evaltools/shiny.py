"""Shiny-Blender / synthetic Chamfer evaluation.  Counterpart of
factored_neus_tpu/evaltools/shiny.py (evaluation_shinyblender,
evaluation): mesh -> surface samples (density 0.3) -> greedy downsample ->
bbox patch filter -> 3-point ground-plane culling -> optional
nonvalid-bbox mask -> asymmetric d2s / s2d cutoffs -> error PLYs.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..meshing.ply import read_ply_points, write_ply
from . import pointcloud as PC


def plane_from_points(points_for_plane: Sequence[Sequence[float]]):
    """Ground plane with +z normal from 3 annotated points
    (ref:shiny_eval.py:215-226)."""
    p1, p2, p3 = (np.asarray(p, np.float64) for p in points_for_plane)
    v1, v2 = p1 - p2, p3 - p2
    normal = np.cross(v1, v2)
    if normal[-1] < 0:
        normal = np.cross(v2, v1)
    D = float(np.dot(normal, p1))
    return normal, D


def evaluation_shinyblender(vertices: np.ndarray, triangles: np.ndarray,
                            gt_pcd_path: str, vis_out_dir: str,
                            downsample_density: float = 0.3,
                            patch_size: float = 60.0,
                            max_dist_d: float = 100.0,
                            max_dist_t: float = 10.0,
                            visualize_threshold: float = 10.0,
                            points_for_plane=None, nonvalid_bbox=None
                            ) -> Tuple[float, float, float]:
    thresh = downsample_density
    data_pcd = PC.sample_mesh_points(vertices, triangles, thresh)
    data_down = PC.downsample(data_pcd, thresh)

    stl = read_ply_points(gt_pcd_path)
    BB = np.array([stl.min(0), stl.max(0)], np.float32)

    normal, D = plane_from_points(points_for_plane)

    inbound = ((data_down >= BB[:1] - patch_size)
               & (data_down < BB[1:] + patch_size * 2)).sum(-1) == 3
    data_in = data_down[inbound]

    above = (data_in @ normal - D) > 0
    data_in_above = data_in[above]

    above_stl = (stl @ normal - D) > 0
    stl_above = stl[above_stl]

    if nonvalid_bbox is not None:
        # NOTE the reference's convention (ref:shiny_eval.py:243-248):
        # element 0 is the UPPER corner, element 1 the LOWER — a
        # conventional [min, max] box would silently disable the cull
        aa = np.asarray(nonvalid_bbox[0])
        bb = np.asarray(nonvalid_bbox[1])
        if np.any(aa < bb):
            import logging
            logging.getLogger("factored_neus_tpu_torch").warning(
                "nonvalid_bbox upper corner %s < lower %s on some axis — "
                "element 0 must be the UPPER corner (reference "
                "convention); the cull will match nothing", aa, bb)
        in_bad = ((data_in_above >= bb) & (data_in_above <= aa)).sum(-1) == 3
        mask_val = ~in_bad
    else:
        mask_val = np.ones(len(data_in_above), dtype=bool)
    data_in_above = data_in_above[mask_val]

    dist_d2s = PC.nn_distances(data_in_above, stl)
    mean_d2s = dist_d2s[dist_d2s < max_dist_d].mean()

    dist_s2d = PC.nn_distances(stl_above, data_in)
    mean_s2d = dist_s2d[dist_s2d < max_dist_t].mean()

    os.makedirs(vis_out_dir, exist_ok=True)
    active_d = np.where(inbound)[0][above][mask_val]
    colors_d = PC.error_colors(len(data_down), active_d, dist_d2s,
                               visualize_threshold, max_dist_d)
    write_ply(f"{vis_out_dir}/vis_d2s.ply", data_down, colors=colors_d * 255)
    colors_s = PC.error_colors(len(stl), np.where(above_stl)[0], dist_s2d,
                               visualize_threshold, max_dist_t)
    write_ply(f"{vis_out_dir}/vis_s2d.ply", stl, colors=colors_s * 255)

    over_all = (mean_d2s + mean_s2d) / 2
    return float(mean_d2s), float(mean_s2d), float(over_all)


def evaluation(vertices: np.ndarray, triangles: np.ndarray, gt_pcd_path: str,
               vis_out_dir: str, downsample_density: float = 0.2,
               patch_size: float = 60.0, max_dist: float = 20.0,
               visualize_threshold: float = 10.0
               ) -> Tuple[float, float, float]:
    """DTU-style symmetric variant (ref:shiny_eval.py:29-155)."""
    data_pcd = PC.sample_mesh_points(vertices, triangles, downsample_density)
    data_down = PC.downsample(data_pcd, downsample_density)
    stl = read_ply_points(gt_pcd_path)
    BB = np.array([stl.min(0), stl.max(0)], np.float32)
    inbound = ((data_down >= BB[:1] - patch_size)
               & (data_down < BB[1:] + patch_size * 2)).sum(-1) == 3
    data_in = data_down[inbound]
    dist_d2s = PC.nn_distances(data_in, stl)
    mean_d2s = dist_d2s[dist_d2s < max_dist].mean()
    dist_s2d = PC.nn_distances(stl, data_in)
    mean_s2d = dist_s2d[dist_s2d < max_dist].mean()
    return float(mean_d2s), float(mean_s2d), float((mean_d2s + mean_s2d) / 2)
