"""SDF grid fill on the device and iso-surface extraction on the host.
Counterpart of factored_neus_tpu/meshing/extract.py (extract_fields,
extract_geometry) on one device.

The grid is filled SLAB x-planes at a time (R^2 x SLAB points per
query, the last slab shorter where SLAB does not divide R); on the card
the query is K2 (fields.SDFNetwork.value_sweep, one weight pack per mesh),
and up to MAX_IN_FLIGHT slabs are queued ahead of the host, each copied back
into pinned memory behind its kernel, so the copy of one slab overlaps the
next slab's kernel.  Values cross to the host in float32 (the JAX
package's float16 wire works around a slow TPU host link; here it would
only move the vertices).  Marching tetrahedra runs on the host
(native.marching_cubes).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..native import marching_cubes

SLAB = 32
MAX_IN_FLIGHT = 4


def sdf_grid_query(sdf_net) -> Callable[[torch.Tensor], torch.Tensor]:
    """-sdf of points [N, 3] (the reference's grid convention, so the
    surface's normals point outward), without gradient: K2 on a CUDA
    tensor, its plain twin on a CPU tensor; one weight pack for every
    slab of the mesh."""
    with torch.no_grad():
        weights = sdf_net.kernel_weights(k1=False)
    return lambda pts: -sdf_net.value_sweep(pts, weights)


def extract_fields(bound_min, bound_max, resolution: int,
                   query_fn: Callable[[torch.Tensor], torch.Tensor],
                   device) -> np.ndarray:
    """Dense [R, R, R] float32 grid of query_fn over the box, indexed
    [x][y][z]; query_fn maps points [N, 3] on ``device`` to values [N]."""
    device = torch.device(device)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    R = resolution
    xs = np.linspace(bmin[0], bmax[0], R, dtype=np.float32)
    ys = torch.linspace(float(bmin[1]), float(bmax[1]), R, device=device)
    zs = torch.linspace(float(bmin[2]), float(bmax[2]), R, device=device)
    out = np.empty((R, R, R), np.float32)
    pending = []

    def drain_one():
        start, end, host, done = pending.pop(0)
        if done is not None:
            done.synchronize()
        out[start:end] = host.numpy()

    with torch.no_grad():
        for start in range(0, R, SLAB):
            end = min(start + SLAB, R)
            xb = torch.from_numpy(xs[start:end]).to(device)
            xx, yy, zz = torch.meshgrid(xb, ys, zs, indexing="ij")
            pts = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
            vals = query_fn(pts).reshape(end - start, R, R).float()
            if device.type == "cuda":
                host = torch.empty(vals.shape, dtype=torch.float32,
                                   pin_memory=True)
                host.copy_(vals, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = vals, None
            pending.append((start, end, host, done))
            if len(pending) >= MAX_IN_FLIGHT:
                drain_one()
        while pending:
            drain_one()
    return out


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn, device,
                     times: Optional[Dict[str, float]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] in the box's coordinates, triangles [T, 3]) of the
    surface query_fn == threshold.  ``times``, when given, receives the
    grid fill's and the marching tetrahedra's wall seconds (fill_s,
    march_s)."""
    t0 = time.perf_counter()
    u = extract_fields(bound_min, bound_max, resolution, query_fn, device)
    t1 = time.perf_counter()
    verts, tris = marching_cubes(u, float(threshold))
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    if times is not None:
        times["fill_s"] = t1 - t0
        times["march_s"] = time.perf_counter() - t1
    return verts, tris
