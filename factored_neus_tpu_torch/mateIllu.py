"""Stage-3 CLI of the port, with the JAX package's modes and arguments that
apply to DTU scenes:

    python -m factored_neus_tpu_torch.mateIllu --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]
    ... --mode validate_image --is_continue [--idx i]
    ... --mode validate_video --is_continue

``train`` learns the materials and the envmap on the newest stage-2
checkpoint under general.base_exp_dir_lvis (train stage 2 first,
``python -m factored_neus_tpu_torch.lvis``) into
general.base_exp_dir_mateIllu, with the decomposition panels and the
envmap's EXR at val_freq; ``validate_image`` writes the panels of view
--idx at full resolution, ``validate_video`` every view's decomposition
as videos, for the latest stage-3 checkpoint (with --is_continue).  The
synthetic and NeRFactor modes need loaders the port does not have yet and
raise.  Runs on the CUDA device unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from .train.runner3 import MODES, Runner


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", help=", ".join(MODES))
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--type", default="dtu")
    p.add_argument("--idx", type=int, default=0)
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    runner = Runner(args.conf, mode=args.mode, case=args.case,
                    is_continue=args.is_continue, type=args.type,
                    seed=args.seed, device=args.device)
    if args.mode == "train":
        runner.train()
    elif args.mode == "validate_image":
        runner.validate_image(idx=args.idx, resolution_level=1)
    else:
        runner.validate_video()
    return runner


if __name__ == "__main__":
    main()
