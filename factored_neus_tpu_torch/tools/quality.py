"""Quality of port-trained scenes: trains stage 1 on the 49-view analytic
sphere scene (384 x 512, camera heights 0.2-1.2) through the port's CLI
and scores each run's final mesh against the sphere, as the JAX package's
own protocol does (tools/tpu_chain_r5.sh, tools/multiseed_quality_eval.py):

    python -m factored_neus_tpu_torch.tools.quality [--confs wmask womask]
        [--seeds 0 1 2] [--end_iter 20000] [--parallel 3] [--stage2]
        [--stage3] [--from_stage N]
        [--out build/quality] [--summary FILE] [--device cuda]

Each run is confs/<conf>.conf with end_iter = --end_iter and recording =
[], validation images and meshes at the conf's frequencies; up to
--parallel runs share the device at a time.  The score of a run: Chamfer
d2s and s2d of its last mesh against the r = 0.5 sphere (mesh samples at
density 0.01 kept within |p| < 0.9, 100,000 sphere points; the port's
evaltools), and the tail train PSNR, the mean of the last five reports.
Per conf: mean and sample standard deviation over seeds, beside the JAX
package's bars (evidence/msq49_summary.json) when the checkout has them;
a conf whose mean lies outside the JAX mean +- 2 x the larger standard
deviation is flagged as a gap.  With --stage2, each run then trains the
conf's stage 2 (train.lvis.end_iter steps) on its last stage-1 checkpoint
through the port's stage-2 CLI, and its row adds the tail lvis and
trace-radiance losses (the mean of the last five reports), the median
stage-2 rays/s and the directory of its lvis panels.  With --stage3 (it
implies --stage2), each run then trains the conf's stage 3
(train.metaIllu.end_iter steps) on its last stage-2 checkpoint through
the port's stage-3 CLI, and its row adds the tail rgb loss and train
PSNR (the mean of the last five reports), the median stage-3 rays/s and
the directory of its rgb panels.  --from_stage N starts each run at
stage N on what the earlier stages left under --out (their checkpoints,
logs and last mesh), which are scored as they are: a run longer than one
sitting can go in two.  The runs take the render core's and the sweeps'
modes from FNEUS_CORE_ACT_BF16, FNEUS_SWEEP_ACT_BF16 and
FNEUS_PALLAS_SAMPLING as this process finds them, and the summary
records them.  Prints one JSON object and writes it to
<out>/summary.json (and to --summary when given).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.fake_scene import SPHERE_R, write_sphere_scene
from ..evaltools.pointcloud import nn_distances, sample_mesh_points
from ..meshing.ply import read_ply_mesh
from ..models.renderer import RendererConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BARS = os.path.join(REPO, "evidence", "msq49_summary.json")
METRICS = ("chamfer_d2s", "chamfer_s2d", "train_psnr_tail")
STAGE2_METRICS = ("lvis_loss_tail", "trace_radiance_loss_tail")
STAGE3_METRICS = ("rgb_loss_tail", "stage3_psnr_tail")
SCENE = (49, 384, 512)          # views, H, W: the JAX runs' scene
Y_RANGE = (0.2, 1.2)            # camera heights: a DTU scan's arc


def chamfer_vs_sphere(verts: np.ndarray, faces: np.ndarray,
                      radius: float = SPHERE_R, density: float = 0.01,
                      keep_within: float = 0.9, n_gt: int = 100_000,
                      seed: int = 1) -> Tuple[float, float]:
    """(d2s, s2d): mean distances from the mesh's surface samples (density
    ``density``, those with |p| < keep_within) to ``n_gt`` points on the
    sphere of ``radius``, and back."""
    pts = sample_mesh_points(verts, faces, density)
    pts = pts[np.linalg.norm(pts, axis=-1) < keep_within]
    v = np.random.RandomState(seed).randn(n_gt, 3)
    gt = radius * v / np.linalg.norm(v, axis=-1, keepdims=True)
    d2s = float(np.mean(nn_distances(pts.astype(np.float32),
                                     gt.astype(np.float32))))
    s2d = float(np.mean(nn_distances(gt.astype(np.float32),
                                     pts.astype(np.float32))))
    return d2s, s2d


def write_run_conf(src: str, dst: str, data_dir: str, exp_dir: str,
                   end_iter: int) -> str:
    """confs/<conf> pointed at the scene and the run's directory, with
    end_iter and an empty recording list."""
    with open(src) as f:
        text = f.read()
    subs = {r"base_exp_dir_geo = \./exp/CASE_NAME":
            f"base_exp_dir_geo = {exp_dir}/CASE_NAME",
            r"base_exp_dir_lvis = \./exp/CASE_NAME":
            f"base_exp_dir_lvis = {exp_dir}/CASE_NAME",
            r"base_exp_dir_mateIllu = \./exp/CASE_NAME":
            f"base_exp_dir_mateIllu = {exp_dir}/CASE_NAME",
            r"data_dir = \S+": f"data_dir = {data_dir}/CASE_NAME/",
            r"end_iter = 300000": f"end_iter = {end_iter}",
            r"recording = \[[^]]*\]": "recording = []"}
    for pat, rep in subs.items():
        text, n = re.subn(pat, rep, text, count=1)
        if n != 1:
            raise ValueError(f"{src}: {pat!r} matched {n} times")
    with open(dst, "w") as f:
        f.write(text)
    return dst


def score_run(exp_dir: str, log_path: str) -> Dict[str, object]:
    """The scores of one finished run (its last mesh and its log)."""
    mesh_dir = os.path.join(exp_dir, "meshes")
    meshes = sorted(f for f in os.listdir(mesh_dir) if f.endswith(".ply"))
    if not meshes:
        raise RuntimeError(f"{mesh_dir}: no mesh")
    t0 = time.perf_counter()
    d2s, s2d = chamfer_vs_sphere(*read_ply_mesh(os.path.join(mesh_dir,
                                                             meshes[-1])))
    with open(log_path) as f:
        log = f.read()
    psnrs = [float(m) for m in re.findall(r"psnr=([-0-9.]+)", log)]
    rays = [float(m) for m in re.findall(r"rays/s=([0-9.]+)", log)]
    return {"mesh": meshes[-1], "chamfer_d2s": d2s, "chamfer_s2d": s2d,
            "train_psnr_tail": float(np.mean(psnrs[-5:])),
            "rays_per_sec_median": float(np.median(rays)),
            "eval_s": time.perf_counter() - t0}


def score_stage2(exp_dir: str, log_path: str) -> Dict[str, object]:
    """The scores of one finished stage-2 run (its log and panels)."""
    with open(log_path) as f:
        reports = re.findall(r"lvis=([-0-9.]+) trace=([-0-9.]+) "
                             r"rays/s=([0-9.]+)", f.read())
    if not reports:
        raise RuntimeError(f"{log_path}: no stage-2 report")
    lv, tr, rays = (np.asarray(c, np.float64) for c in zip(*reports))
    return {"lvis_loss_tail": float(lv[-5:].mean()),
            "trace_radiance_loss_tail": float(tr[-5:].mean()),
            "stage2_rays_per_sec_median": float(np.median(rays)),
            "stage2_panels": os.path.join(exp_dir, "lvis")}


def score_stage3(exp_dir: str, log_path: str) -> Dict[str, object]:
    """The scores of one finished stage-3 run (its log and panels)."""
    with open(log_path) as f:
        reports = re.findall(r"rgb=([-0-9.]+) psnr=([-0-9.]+) "
                             r"rays/s=([0-9.]+)", f.read())
    if not reports:
        raise RuntimeError(f"{log_path}: no stage-3 report")
    rgb, psnr, rays = (np.asarray(c, np.float64) for c in zip(*reports))
    return {"rgb_loss_tail": float(rgb[-5:].mean()),
            "stage3_psnr_tail": float(psnr[-5:].mean()),
            "stage3_rays_per_sec_median": float(np.median(rays)),
            "stage3_panels": os.path.join(exp_dir, "rgb")}


def mean_sd(values: Sequence[float]) -> List[float]:
    a = np.asarray(values, np.float64)
    return [float(a.mean()), float(a.std(ddof=1)) if len(a) > 1 else 0.0]


def compare(port: Dict[str, List[float]], bars: Dict[str, List[float]]
            ) -> Dict[str, object]:
    """Per metric: the port's and the JAX package's mean +- sd, the
    allowed gap 2 x max(sd) and whether the means lie further apart."""
    out = {}
    for m in METRICS:
        (pm, ps), (jm, js) = port[m], bars[m]
        allowed = 2.0 * max(ps, js)
        out[m] = {"port": [pm, ps], "jax": [jm, js],
                  "gap": abs(pm - jm), "allowed": allowed,
                  "fault": bool(abs(pm - jm) > allowed)}
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--confs", nargs="+", default=["wmask", "womask"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--end_iter", type=int, default=20000)
    p.add_argument("--parallel", type=int, default=3)
    p.add_argument("--out", default=os.path.join(REPO, "build", "quality"))
    p.add_argument("--summary", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--stage2", action="store_true",
                   help="train and score stage 2 after each run")
    p.add_argument("--stage3", action="store_true",
                   help="train and score stages 2 and 3 after each run")
    p.add_argument("--from_stage", type=int, default=1, choices=(1, 2, 3),
                   help="start each run at this stage, on the earlier "
                        "stages' results under --out")
    args = p.parse_args(argv)
    args.stage2 = args.stage2 or args.stage3

    out = os.path.abspath(args.out)
    data = os.path.join(out, "data")
    write_sphere_scene(os.path.join(data, "fake_scan"), *SCENE,
                       y_range=Y_RANGE)
    # the native library and the kernels are built once, here, before the
    # runs share the build directory
    from ..native import load
    load()
    if args.device.startswith("cuda"):
        from ..ops import _cuda
        _cuda.build_all()
    jobs = []
    for conf in args.confs:
        for seed in args.seeds:
            name = f"{conf}_s{seed}"
            exp = os.path.join(out, f"exp_{name}")
            cpath = write_run_conf(
                os.path.join(REPO, "confs", f"{conf}.conf"),
                os.path.join(out, f"{name}.conf"), data, exp, args.end_iter)
            geo = os.path.join(exp, "fake_scan", conf, "geometry")
            jobs.append((conf, seed, name, cpath, geo))
    stages = (["exp_runner"] + (["lvis"] if args.stage2 else [])
              + (["mateIllu"] if args.stage3 else []))
    if args.from_stage > len(stages):
        raise SystemExit(f"--from_stage {args.from_stage}: the run has "
                         f"{len(stages)} stages")

    def start(job, stage: int):
        """The job's stage-th CLI in a process of its own, logged to
        <name>.log (stage 1), <name>_lvis.log or <name>_mateIllu.log."""
        conf, seed, name, cpath, _ = job
        log = f"{name}.log" if stage == 0 else f"{name}_{stages[stage]}.log"
        logf = open(os.path.join(out, log), "w")
        cmd = [sys.executable, "-m",
               f"factored_neus_tpu_torch.{stages[stage]}", "--mode", "train",
               "--conf", cpath, "--case", "fake_scan", "--type", "dtu",
               "--seed", str(seed), "--device", args.device]
        print(f"run {name} {stages[stage]} started", flush=True)
        return (job, subprocess.Popen(cmd, cwd=REPO, stdout=logf,
                                      stderr=subprocess.STDOUT),
                time.perf_counter(), logf, stage)

    # each run is scored as soon as it ends, its row printed at once, so
    # the rows of finished runs survive a later failure
    running: List[Tuple[tuple, subprocess.Popen, float, object, int]] = []
    walls: Dict[str, Dict[str, float]] = {}
    rows: Dict[str, List[Dict[str, object]]] = {c: [] for c in args.confs}
    failed: List[str] = []

    def reap_one() -> None:
        while True:
            for item in running:
                job, proc, t0, logf, stage = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                logf.close()
                conf, seed, name, _, geo = job
                wall = time.perf_counter() - t0
                walls.setdefault(name, {})[stages[stage]] = wall
                if proc.returncode != 0:
                    failed.append(name)
                    print(f"run {name} failed rc={proc.returncode} after "
                          f"{wall:.1f} s; see {logf.name}", flush=True)
                    return
                if stage + 1 < len(stages):
                    running.append(start(job, stage + 1))
                    return
                w = walls[name]
                row = {"seed": seed, "wall_s": w.get("exp_runner"),
                       **score_run(geo, os.path.join(out, f"{name}.log"))}
                if args.stage2:
                    row.update(stage2_wall_s=w.get("lvis"), **score_stage2(
                        geo.replace(os.sep + "geometry", os.sep + "lvis"),
                        os.path.join(out, f"{name}_lvis.log")))
                if args.stage3:
                    row.update(stage3_wall_s=w.get("mateIllu"), **score_stage3(
                        geo.replace(os.sep + "geometry", os.sep + "mateIllu"),
                        os.path.join(out, f"{name}_mateIllu.log")))
                rows[conf].append(row)
                print(f"run {name}: {json.dumps(row)}", flush=True)
                return
            time.sleep(1.0)

    for job in jobs:
        while len(running) >= args.parallel:
            reap_one()
        running.append(start(job, args.from_stage - 1))
    while running:
        reap_one()

    summary: Dict[str, object] = {
        "card": card_line() if args.device.startswith("cuda") else "cpu",
        "scene": {"n_views": SCENE[0], "H": SCENE[1], "W": SCENE[2],
                  "y_range": list(Y_RANGE)},
        "end_iter": args.end_iter, "parallel": args.parallel,
        # the render core's bf16 operand mode (K1 and K3) and the sweeps'
        # modes (stage 2's coarse sweep on K2-bf16; every sampling sweep
        # on K2-bf16), as the runs (children of this process) read them
        # from FNEUS_CORE_ACT_BF16, FNEUS_SWEEP_ACT_BF16 and
        # FNEUS_PALLAS_SAMPLING
        "core_act_bf16": RendererConfig().core_act_bf16,
        "sweep_act_bf16": RendererConfig().sweep_act_bf16,
        "use_pallas_sampling": RendererConfig().use_pallas_sampling,
        "stage2": args.stage2, "stage3": args.stage3,
        "from_stage": args.from_stage, "failed": failed}
    bars = {}
    if os.path.exists(BARS):
        with open(BARS) as f:
            bars = json.load(f)
    for conf in args.confs:
        if not rows[conf]:
            continue
        rs = sorted(rows[conf], key=lambda r: r["seed"])
        stats = {m: mean_sd([r[m] for r in rs]) for m in METRICS
                 + (STAGE2_METRICS if args.stage2 else ())
                 + (STAGE3_METRICS if args.stage3 else ())}
        entry: Dict[str, object] = {"seeds": rs, **{
            f"{m}_mean_sd": v for m, v in stats.items()}}
        if conf in bars:
            entry["against_jax"] = compare(stats, {
                m: bars[conf][f"{m}_mean_sd"] for m in METRICS})
        summary[conf] = entry
    text = json.dumps(summary, indent=1)
    with open(os.path.join(out, "summary.json"), "w") as f:
        f.write(text)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)),
                    exist_ok=True)
        with open(args.summary, "w") as f:
            f.write(text)
    print(text)
    if failed:
        raise SystemExit(f"runs failed: {failed}")
    return summary


if __name__ == "__main__":
    main()
