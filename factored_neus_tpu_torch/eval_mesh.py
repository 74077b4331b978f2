"""Offline DTU mesh evaluation CLI of the port, with the arguments of the
root eval_mesh.py:

    python -m factored_neus_tpu_torch.eval_mesh --scene 97 \
        [--setting womask/geometry] [--suffix 00300000] \
        [--dataset_dir ./public_data/dtu_eval] [--exp_dir ./exp] [--case C]

Runs the DTU Chamfer protocol (evaltools/dtu.py) on
<exp_dir>/<case>/<setting>/meshes_clean/<suffix>.ply and prints
"d2s s2d overall".
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

from .evaltools import dtu


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", type=int, required=True)
    parser.add_argument("--setting", type=str, default="womask/geometry")
    parser.add_argument("--suffix", default="00300000")
    parser.add_argument("--dataset_dir", type=str,
                        default="./public_data/dtu_eval")
    parser.add_argument("--exp_dir", type=str, default="./exp")
    parser.add_argument("--case", type=str, default=None,
                        help="experiment case under exp_dir (default "
                             "data_DTU/dtu_scan<scene>)")
    args = parser.parse_args(argv)
    case = args.case if args.case is not None \
        else f"data_DTU/dtu_scan{args.scene}"
    exp = os.path.join(args.exp_dir, case, args.setting)
    mesh = os.path.join(exp, "meshes_clean", f"{args.suffix}.ply")
    d2s, s2d, overall = dtu.eval(mesh, args.scene, args.dataset_dir, exp)
    print(d2s, s2d, overall)
    return d2s, s2d, overall


if __name__ == "__main__":
    main()
