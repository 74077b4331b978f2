"""Stage-1 CLI of the port:

    python -m factored_neus_tpu_torch.exp_runner --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]
    python -m factored_neus_tpu_torch.exp_runner --mode validate_mesh \
        --is_continue --conf ... --case <scan> [--mcube_threshold 0.0]

``train`` trains stage 1 (wmask or womask confs); ``validate_mesh`` writes
the 512^3 mesh of the latest checkpoint (with --is_continue) to
meshes/{iter:08d}.ply in world space.  Runs on the CUDA device unless
--device says otherwise.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from .train.runner1 import MODES, Runner


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", choices=MODES)
    p.add_argument("--mcube_threshold", type=float, default=0.0)
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--type", default="dtu")
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--surface_weight", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    runner = Runner(args.conf, mode=args.mode, case=args.case,
                    is_continue=args.is_continue, type=args.type,
                    surface_weight=args.surface_weight, seed=args.seed,
                    device=args.device)
    if args.mode == "train":
        runner.train()
    else:
        runner.validate_mesh(world_space=True,
                             threshold=args.mcube_threshold)
    return runner


if __name__ == "__main__":
    main()
