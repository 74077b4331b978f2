"""Stage-3 CLI of the port, with the JAX package's modes and arguments:

    python -m factored_neus_tpu_torch.mateIllu --mode train \
        --conf confs/wmask.conf --case <scan> --type dtu [--device cuda]
    ... --mode validate_image --is_continue [--idx i]
    ... --mode validate_video --is_continue
    ... --mode indiSG_psnr | cal_psnr [--idx i] --is_continue
    ... --mode relgt_synthetic_img | relgt_img [--idx i] --is_continue
    ... --mode relgt_synthetic_video | relgt_video --is_continue
    ... --mode validate_synthetic_video --is_continue

``train`` learns the materials and the envmap on the newest stage-2
checkpoint under general.base_exp_dir_lvis (train stage 2 first,
``python -m factored_neus_tpu_torch.lvis``) into
general.base_exp_dir_mateIllu, with the decomposition panels and the
envmap's EXR at val_freq.  With --is_continue on the latest stage-3
checkpoint: ``validate_image`` writes the panels of view --idx at full
resolution (Shiny scenes: the case's view of _SHINY_IDX; the other types
than dtu, sk3d and shiny: the synthetic panels); ``validate_video`` every
view's decomposition as videos; ``indiSG_psnr`` (the case's view of
_SYNTH_IDX, else 55) and ``cal_psnr`` (view --idx) the albedo, render and
roughness PSNRs on the test split; ``relgt_synthetic_img`` /
``relgt_img`` that test view under ./envmaps/envmap6 and
./envmaps/envmap12 (sg_128.npy each), ``relgt_synthetic_video`` /
``relgt_video`` every test view so; ``validate_synthetic_video`` the test
split's videos.  --type is one of data.datasets.DATASET_TYPES.  Runs on
the CUDA device unless --device says otherwise.  The JAX CLI's
--mcube_threshold (unused), --gpu, --shard, --profile DIR and
--debug_nans are accepted too (utils/cli.py).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .train.runner3 import MODES, Runner
from .utils import cli

# the test view of each Shiny case, and the evaluation view of each
# synthetic case (the reference CLI's tables)
_SHINY_IDX = {"car": 37, "helmet": 60, "toaster": 141, "teapot": 199,
              "coffee": 46}
_SYNTH_IDX = {"hotdog": 190, "jugs": 0}
# the CLI's mode names -> the runner's
CLI_MODES = {"indiSG_psnr": "cal_synthetic_psnr",
             "cal_psnr": "cal_synthetic_psnr",
             "relgt_img": "relgt_synthetic_img",
             "relgt_video": "relgt_synthetic_video"}


def _case_idx(case: str, table: dict, default: int) -> int:
    for name, idx in table.items():
        if name in case:
            return idx
    return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="train",
                   help=", ".join(MODES + tuple(CLI_MODES)))
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--type", default="dtu")
    p.add_argument("--idx", type=int, default=0)
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
    mode = CLI_MODES.get(args.mode, args.mode)
    runner = Runner(args.conf, mode=mode, case=args.case,
                    is_continue=args.is_continue, type=args.type,
                    seed=args.seed, device=args.device)
    synth_idx = (_case_idx(args.case, _SYNTH_IDX, 55)
                 if args.mode in ("indiSG_psnr", "relgt_synthetic_img")
                 else args.idx)
    if mode == "train":
        runner.train()
    elif mode == "validate_image":
        if args.type in ("dtu", "sk3d"):
            runner.validate_image(idx=args.idx, resolution_level=1)
        elif args.type == "shiny":
            runner.validate_image(idx=_case_idx(args.case, _SHINY_IDX, 0),
                                  resolution_level=1)
        else:
            runner.validate_synthetic_img(idx=args.idx, resolution_level=1)
    elif mode == "validate_synthetic_img":
        runner.validate_synthetic_img(idx=args.idx, resolution_level=1)
    elif mode == "cal_synthetic_psnr":
        runner.cal_synthetic_psnr(idx=synth_idx, resolution_level=1)
    elif mode == "cal_nerfactor_psnr":
        runner.cal_nerfactor_psnr(idx=args.idx, resolution_level=1)
    elif mode == "relgt_synthetic_img":
        runner.relgt_synthetic_img(idx=synth_idx, resolution_level=1)
    elif mode == "relgt_synthetic_video":
        runner.relgt_synthetic_video()
    elif mode == "validate_synthetic_video":
        runner.validate_synthetic_video()
    else:
        runner.validate_video()
    return runner


if __name__ == "__main__":
    main()
