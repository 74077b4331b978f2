"""The options every stage CLI of the port shares with the JAX package's
(exp_runner.py, lvis.py, mateIllu.py at the repository root), and the
scope they run the CLI in: ``--gpu`` (accepted, ignored: the device is
``--device``'s), ``--shard`` (one device: nothing to shard), ``--profile
DIR`` (a torch.profiler trace of the run) and ``--debug_nans`` (stop at
the first non-finite loss or gradient)."""
from __future__ import annotations

import argparse
import contextlib

import torch

from . import logging as LOG


def add_jax_options(p: argparse.ArgumentParser,
                    mcube_threshold: bool = False) -> None:
    """Adds the JAX CLIs' --gpu, --shard, --profile and --debug_nans (and
    --mcube_threshold, accepted and unused as in the JAX stage-2 and
    stage-3 CLIs)."""
    if mcube_threshold:
        p.add_argument("--mcube_threshold", type=float, default=0.0,
                       help="accepted and unused, as in the JAX CLI")
    p.add_argument("--gpu", type=int, default=0,
                   help="accepted and ignored (the device is --device's)")
    p.add_argument("--shard", action="store_true",
                   help="shard the ray batch over the visible devices: a "
                        "no-op on one")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    p.add_argument("--debug_nans", action="store_true",
                   help="stop at the first non-finite loss or gradient")


def check_shard(shard: bool) -> None:
    """--shard on one visible device is a no-op, as in the JAX runners,
    which build a mesh only over more than one; over more it raises: the
    port has no multi-GPU path yet (ROADMAP.md §1, "Multi-GPU")."""
    n = torch.cuda.device_count()
    if shard and n > 1:
        raise NotImplementedError(
            f"--shard over {n} visible devices: the port trains on one "
            f"device; sharding the ray batch is the multi-GPU item of "
            f"ROADMAP.md §1")


@contextlib.contextmanager
def run_scope(args: argparse.Namespace):
    """The JAX CLIs' ``main`` scope: log format, --shard's check, then the
    run under --debug_nans and --profile."""
    LOG.setup_logging()
    check_shard(args.shard)
    with LOG.debug_nans(args.debug_nans), LOG.profiler_trace(args.profile):
        yield
