"""Shared training plumbing: the train-config schema, Adam with the
warmup + cosine schedule over a stage's trainable groups and its state as
the JAX package's optax leaves, and the chunked full-image render of
validation images and novel views.  Counterpart of
factored_neus_tpu/train/common.py (STAGE_TRAINABLE, TrainConfig.from_conf,
make_optimizer, val_chunk_size, fetch_concat, chunked_render);
``optax.adam``'s defaults equal ``torch.optim.Adam``'s (betas 0.9/0.999,
eps 1e-8)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..utils import checkpoints as CK
from ..utils import schedule
from ..utils.hocon import ConfigTree

# the params groups each stage trains; the others stay frozen
STAGE_TRAINABLE = {
    1: ("nerf", "sdf", "variance", "color", "ref_color"),
    2: ("lvis", "indirect"),
    3: ("material",),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300000
    batch_size: int = 512
    validate_resolution_level: int = 4
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
    val_chunk: int = 2048       # rays a chunk of a validation render
    block_steps: int = 1

    @classmethod
    def from_conf(cls, c: ConfigTree, stage: int = 1,
                  surface_weight: float = 0.1) -> "TrainConfig":
        """The stage's fields; warm_up_end defaults to 0 like the
        reference.  Stage 2 takes end_iter, batch_size and warm_up_end
        from train.lvis and the rest, the learning rate too, from
        train; stage 3 takes end_iter and batch_size from train.metaIllu
        (or train.mateIllu) and keeps the global warm_up_end."""
        t = c.get("train", ConfigTree())
        base = cls(
            learning_rate=float(t.get("learning_rate", 5e-4)),
            learning_rate_alpha=float(t.get("learning_rate_alpha", 0.05)),
            end_iter=int(t.get("end_iter", 300000)),
            batch_size=int(t.get("batch_size", 512)),
            validate_resolution_level=int(
                t.get("validate_resolution_level", 4)),
            val_chunk=int(t.get("val_chunk", 2048)),
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
        if stage == 1:
            return base
        if stage == 2:
            lv = t.get("lvis", ConfigTree())
            return dataclasses.replace(
                base, end_iter=int(lv.get("end_iter", 10000)),
                batch_size=int(lv.get("batch_size", 512)),
                warm_up_end=float(lv.get("warm_up_end", 0.0)))
        if stage != 3:
            raise ValueError(f"no stage {stage}")
        mi = t.get("metaIllu", t.get("mateIllu", ConfigTree()))
        return dataclasses.replace(
            base, end_iter=int(mi.get("end_iter", 40000)),
            batch_size=int(mi.get("batch_size", 512)))


def make_optimizer(model: torch.nn.Module, tcfg: TrainConfig,
                   stage: int = 1) -> torch.optim.Adam:
    """Adam over the parameters of the stage's trainable groups (a
    Stage1Model's, a Stage2Model's lvis and indirect, or a Stage3Model's
    material); set_lr() applies the schedule."""
    return torch.optim.Adam(
        [p for g in STAGE_TRAINABLE[stage]
         for p in getattr(model, g).parameters()], lr=tcfg.learning_rate)


def _jax_leaves(tree) -> List[np.ndarray]:
    """A tree's leaves in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _jax_leaves(v)]
    return [tree]


def optimizer_leaves(model: torch.nn.Module, opt: torch.optim.Adam,
                     stage: int = 1) -> CK.Leaves:
    """Adam's state as the leaves of the JAX package's optax state of the
    stage (its ``multi_transform`` keeps moments of the trainable groups
    only): the update count, the first moments, the second moments (each
    in the params' tree order, groups sorted: color, nerf, ref_color, sdf,
    variance in stage 1; indirect, lvis in stage 2; material in stage 3)
    and the schedule's count.  A parameter without state (it has had no
    gradient) has zero moments."""
    def moment(name):
        return lambda p: (opt.state[p][name] if p in opt.state
                          else torch.zeros_like(p))
    steps = [float(s["step"]) for s in opt.state.values()]
    count = np.asarray(int(max(steps, default=0)), np.int32)
    groups = STAGE_TRAINABLE[stage]
    return CK.Leaves([
        count, *_jax_leaves(bridge.jax_tree(model, value=moment("exp_avg"),
                                            groups=groups)),
        *_jax_leaves(bridge.jax_tree(model, value=moment("exp_avg_sq"),
                                     groups=groups)),
        count])


def load_optimizer_leaves(model: torch.nn.Module, opt: torch.optim.Adam,
                          leaves: Sequence[np.ndarray],
                          stage: int = 1) -> None:
    """Sets Adam's state from the JAX package's optax leaves of the stage
    (optimizer_leaves' layout).  A parameter whose two moments are zero
    has had no gradient and gets no state, as in torch."""
    groups = STAGE_TRAINABLE[stage]
    structure = bridge.jax_tree(model, groups=groups)
    n = len(_jax_leaves(structure))
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state: {len(leaves)} leaves, expected "
                         f"{2 * n + 2} for this model")
    count = int(leaves[0])

    def tree_of(flat):
        it = iter(flat)

        def fill(t):
            if isinstance(t, dict):
                return {k: fill(t[k]) for k in sorted(t)}
            if isinstance(t, list):
                return [fill(v) for v in t]
            return next(it)
        return fill(structure)

    moments: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
    for name, flat in (("exp_avg", leaves[1:1 + n]),
                       ("exp_avg_sq", leaves[1 + n:1 + 2 * n])):
        def keep(p, v, name=name):
            moments.setdefault(p, {})[name] = torch.empty_like(p).copy_(v)
        bridge.load_jax_params(model, tree_of(flat), keep, groups)
    opt.state.clear()
    for p, m in moments.items():
        if m["exp_avg"].any() or m["exp_avg_sq"].any():
            opt.state[p] = {"step": torch.tensor(float(count)), **m}


def set_lr(opt: torch.optim.Optimizer, tcfg: TrainConfig, step: int) -> float:
    """Learning rate of update number ``step`` (0 for the first update,
    the count optax's schedule sees)."""
    lr = schedule.learning_rate(step, tcfg.learning_rate, tcfg.warm_up_end,
                                tcfg.end_iter, tcfg.learning_rate_alpha)
    for g in opt.param_groups:
        g["lr"] = lr
    return lr


def val_chunk_size(tcfg: TrainConfig) -> int:
    """Rays a chunk of a validation or novel-view render: val_chunk, and
    at least the batch size."""
    return max(tcfg.val_chunk, tcfg.batch_size)


def fetch_concat(chunks: Sequence[torch.Tensor], n: int) -> np.ndarray:
    """The per-chunk device tensors concatenated, trimmed to the first n
    rows and fetched to the host, once every chunk has been queued."""
    return torch.cat(list(chunks)).cpu().numpy()[:n]


def chunked_render(fn: Callable[[torch.Tensor, torch.Tensor, int],
                                Dict[str, torch.Tensor]],
                   rays_o: torch.Tensor, rays_d: torch.Tensor, chunk: int,
                   keys: Sequence[str],
                   post: Optional[Callable[[Dict[str, torch.Tensor]],
                                           Dict[str, torch.Tensor]]] = None
                   ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Full-image render in chunks of ``chunk`` rays, the last one padded by
    repeating its last ray.  fn(o_c, d_c, i) -> dict of per-ray tensors on
    the device, i being the chunk's first ray; ``keys``: the entries kept;
    ``post``: out -> dict of derived per-ray tensors (the normal map).
    Every chunk is queued before anything is fetched.  Returns (dict of
    [H * W, ...] arrays, H, W)."""
    H, W = rays_o.shape[:2]
    ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = ro.shape[0]
    pad = (-n) % chunk
    if pad:
        ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
        rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
    acc: Dict[str, List[torch.Tensor]] = {k: [] for k in keys}
    for i in range(0, ro.shape[0], chunk):
        out = fn(ro[i:i + chunk], rd[i:i + chunk], i)
        for k in keys:
            acc[k].append(out[k])
        if post is not None:
            for k, v in post(out).items():
                acc.setdefault(k, []).append(v)
    return {k: fetch_concat(v, n) for k, v in acc.items()}, H, W
