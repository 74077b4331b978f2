"""Stage-1 CLI of the port, with the JAX package's modes and arguments:

    python -m factored_neus_tpu_torch.exp_runner --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]
    ... --mode validate_mesh --is_continue [--mcube_threshold 0.0]
    ... --mode validate_mesh_shiny --is_continue
    ... --mode validate_image --is_continue [--idx 0]
    ... --mode mesh_dtu_shpere2world --is_continue
    ... --mode interpolate_<i>_<j> --is_continue

``train`` trains stage 1 (wmask or womask confs), with validation panels
at val_freq and meshes at val_mesh_freq; ``validate_mesh`` writes the
512^3 mesh of the latest checkpoint (with --is_continue) to
meshes/{iter:08d}.ply in world space; ``validate_mesh_shiny`` writes the
64^3 mesh and, at every 10,000th iteration, the 512^3 mesh scored against
the Shiny scene's point cloud; ``validate_image`` writes the validation
panels of view --idx at full resolution (for the types other than dtu and
sk3d the synthetic panels, of view 57 by default);
``mesh_dtu_shpere2world`` takes meshes/dtu122-300000.ply to world space as
meshes/00300000.ply; ``interpolate_<i>_<j>`` renders 60 views between
cameras i and j, there and back, as render/{iter:08d}_<i>_<j>.mp4 (a
directory of PNG frames where no video encoder is installed).  --type is
one of data.datasets.DATASET_TYPES.  Runs on the CUDA device unless
--device says otherwise.  The JAX CLI's --gpu (ignored), --shard (a no-op
on one device), --profile DIR (a torch.profiler trace of the run) and
--debug_nans (stop at the first non-finite loss or gradient) are
accepted too (utils/cli.py).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .train.runner1 import MODES, Runner
from .utils import cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", help=", ".join(MODES))
    p.add_argument("--mcube_threshold", type=float, default=0.0)
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--type", default="dtu")
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--surface_weight", type=float, default=0.1)
    p.add_argument("--idx", type=int, default=-1,
                   help="view of validate_image (default 0 for dtu and "
                        "sk3d, else 57)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    cli.add_jax_options(p)
    return p


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    args = build_parser().parse_args(argv)
    with cli.run_scope(args):
        return _run(args)


def _run(args: argparse.Namespace) -> Runner:
    runner = Runner(args.conf, mode=args.mode, case=args.case,
                    is_continue=args.is_continue, type=args.type,
                    surface_weight=args.surface_weight, seed=args.seed,
                    device=args.device)
    if args.mode == "train":
        runner.train()
    elif args.mode == "validate_mesh":
        runner.validate_mesh(world_space=True,
                             threshold=args.mcube_threshold)
    elif args.mode == "validate_mesh_shiny":
        runner.validate_mesh_shiny()
    elif args.mode == "validate_image":
        if args.type in ("dtu", "sk3d"):
            runner.validate_image(idx=max(args.idx, 0), resolution_level=1)
        else:
            runner.validate_synthetic_img(
                idx=args.idx if args.idx >= 0 else 57, resolution_level=1)
    elif args.mode == "validate_synthetic_img":
        runner.validate_synthetic_img(idx=args.idx, resolution_level=1)
    elif args.mode == "mesh_dtu_shpere2world":
        runner.mesh_dtu_sphere2world(mesh_name="dtu122-300000")
    else:
        _, i0, i1 = args.mode.split("_")
        runner.interpolate_view(int(i0), int(i1))
    return runner


if __name__ == "__main__":
    main()
