"""Stage-1 CLI of the port:

    python -m factored_neus_tpu_torch.exp_runner --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]

Runs on the CUDA device unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from .train.runner1 import Runner


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train")
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
    runner.train()
    return runner


if __name__ == "__main__":
    main()
