"""Stage-2 CLI of the port, with the JAX package's modes and arguments:

    python -m factored_neus_tpu_torch.lvis --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]
    ... --mode validate_image --is_continue
    ... --mode validate_synthetic_img --is_continue

``train`` distils light visibility and indirect light from the newest
stage-1 checkpoint under general.base_exp_dir_geo (train stage 1 first,
``python -m factored_neus_tpu_torch.exp_runner``) into
general.base_exp_dir_lvis, with the lvis/ and trace_radiance/ panels at
val_freq; ``validate_image`` writes those panels of a random view at full
resolution for the latest stage-2 checkpoint (with --is_continue), in
sRGB for the types other than dtu and sk3d (``validate_synthetic_img``,
the same panels).  --type is one of data.datasets.DATASET_TYPES.  Runs
on the CUDA device unless --device says otherwise.  The JAX CLI's
--mcube_threshold (unused), --gpu, --shard, --profile DIR and
--debug_nans are accepted too (utils/cli.py).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .train.runner2 import MODES, Runner
from .utils import cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train", help=", ".join(MODES))
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--type", default="dtu")
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    cli.add_jax_options(p, mcube_threshold=True)
    return p


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    args = build_parser().parse_args(argv)
    with cli.run_scope(args):
        return _run(args)


def _run(args: argparse.Namespace) -> Runner:
    runner = Runner(args.conf, mode=args.mode, case=args.case,
                    is_continue=args.is_continue, type=args.type,
                    seed=args.seed, device=args.device)
    if args.mode == "train":
        runner.train()
    else:       # validate_synthetic_img is validate_image (by the type)
        runner.validate_image(resolution_level=1)
    return runner


if __name__ == "__main__":
    main()
