"""Shared training plumbing: the train-config schema and Adam with the
warmup + cosine schedule.  Counterpart of factored_neus_tpu/train/common.py
(TrainConfig.from_conf, make_optimizer); ``optax.adam``'s defaults equal
``torch.optim.Adam``'s (betas 0.9/0.999, eps 1e-8)."""
from __future__ import annotations

import dataclasses

import torch

from ..utils import schedule
from ..utils.hocon import ConfigTree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300000
    batch_size: int = 512
    warm_up_end: float = 5000.0
    anneal_end: float = 0.0
    use_white_bkgd: bool = False
    save_freq: int = 2500
    val_freq: int = 2500
    val_mesh_freq: int = 5000
    report_freq: int = 100
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    surface_weight: float = 0.1
    block_steps: int = 1

    @classmethod
    def from_conf(cls, c: ConfigTree,
                  surface_weight: float = 0.1) -> "TrainConfig":
        """Stage-1 fields; warm_up_end defaults to 0 like the reference."""
        t = c.get("train", ConfigTree())
        return cls(
            learning_rate=float(t.get("learning_rate", 5e-4)),
            learning_rate_alpha=float(t.get("learning_rate_alpha", 0.05)),
            end_iter=int(t.get("end_iter", 300000)),
            batch_size=int(t.get("batch_size", 512)),
            warm_up_end=float(t.get("warm_up_end", 0.0)),
            anneal_end=float(t.get("anneal_end", 0.0)),
            use_white_bkgd=bool(t.get("use_white_bkgd", False)),
            save_freq=int(t.get("save_freq", 2500)),
            val_freq=int(t.get("val_freq", 2500)),
            val_mesh_freq=int(t.get("val_mesh_freq", 5000)),
            report_freq=int(t.get("report_freq", 100)),
            igr_weight=float(t.get("igr_weight", 0.1)),
            mask_weight=float(t.get("mask_weight", 0.0)),
            surface_weight=surface_weight,
            block_steps=int(t.get("block_steps", 1)),
        )


def make_optimizer(model: torch.nn.Module,
                   tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam over every stage-1 parameter; set_lr() applies the schedule."""
    return torch.optim.Adam(model.parameters(), lr=tcfg.learning_rate)


def set_lr(opt: torch.optim.Optimizer, tcfg: TrainConfig, step: int) -> float:
    """Learning rate of update number ``step`` (0 for the first update,
    the count optax's schedule sees)."""
    lr = schedule.learning_rate(step, tcfg.learning_rate, tcfg.warm_up_end,
                                tcfg.end_iter, tcfg.learning_rate_alpha)
    for g in opt.param_groups:
        g["lr"] = lr
    return lr
