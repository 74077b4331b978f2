"""Shared training plumbing: the train-config schema, Adam with the
warmup + cosine schedule over a stage's trainable groups and its state as
the JAX package's optax leaves, the training step that the three stages
share (StepTrainer), multi-step blocking (plan_block, BlockStepper,
boundary_metrics), the loops' reports, and the chunked full-image render
of validation images and novel views.  Counterpart of
factored_neus_tpu/train/common.py (STAGE_TRAINABLE, TrainConfig.from_conf,
make_optimizer, plan_block, BlockStepper, boundary_metrics,
val_chunk_size, fetch_concat, chunked_render); ``optax.adam``'s defaults
equal ``torch.optim.Adam``'s (betas 0.9/0.999, eps 1e-8).

Multi-step blocking (``train.block_steps`` = K > 1): the JAX package runs
K steps as one device program (a lax.scan); on a CUDA device the port
captures one training step into a CUDA graph and replays it, K times a
block, without a host sync between replays.  Everything the step reads
that changes from step to step sits in a device slot (StepTrainer.slot:
the learning rate, cos_anneal_ratio and the image index), filled before
each step by a copy from a per-block device table; the step's generator
is registered with the graph, so that each replay draws what the eager
step would.  The trajectory is that of single steps: the same images in
the same order, every report, save and validation at the same
iterations.  On the CPU the steps run eagerly.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..data import rays as RAYS
from ..ops import _cuda
from ..utils import checkpoints as CK
from ..utils import logging as LOG
from ..utils import schedule
from ..utils.hocon import ConfigTree

log = logging.getLogger("factored_neus_tpu_torch")
# eager steps (real training steps, on a side stream) before the step
# graph is captured: Adam's state, the packs' index tables, the kernels'
# libraries and cuBLAS's workspaces exist before the capture
WARMUP_STEPS = 3

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
                   stage: int = 1,
                   lr: Optional[torch.Tensor] = None) -> torch.optim.Adam:
    """Adam over the parameters of the stage's trainable groups (a
    Stage1Model's, a Stage2Model's lvis and indirect, or a Stage3Model's
    material).  On a CUDA device it is capturable (its update count and
    bias correction on the device, so a CUDA graph can hold the update)
    and reads its learning rate from ``lr``, a one-element tensor on the
    device (StepTrainer's slot); on the CPU it takes a float, which
    set_lr() writes."""
    params = [p for g in STAGE_TRAINABLE[stage]
              for p in getattr(model, g).parameters()]
    if params[0].is_cuda:
        if lr is None:
            lr = torch.tensor(tcfg.learning_rate, device=params[0].device)
        return torch.optim.Adam(params, lr=lr, capturable=True,
                                foreach=True)
    return torch.optim.Adam(params, lr=tcfg.learning_rate)


def _jax_leaves(tree) -> List[np.ndarray]:
    """A tree's leaves in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _jax_leaves(v)]
    return [tree]


def optimizer_leaves(model: torch.nn.Module, opt: torch.optim.Adam,
                     stage: int = 1, host: bool = True) -> CK.Leaves:
    """Adam's state as the leaves of the JAX package's optax state of the
    stage (its ``multi_transform`` keeps moments of the trainable groups
    only): the update count, the first moments, the second moments (each
    in the params' tree order, groups sorted: color, nerf, ref_color, sdf,
    variance in stage 1; indirect, lvis in stage 2; material in stage 3)
    and the schedule's count.  A parameter without state (it has had no
    gradient) has zero moments.  With ``host`` False the leaves are the
    tensors themselves, the count an int32 tensor, and nothing is fetched
    (checkpoints.save_checkpoint_async)."""
    def moment(name):
        return lambda p: (opt.state[p][name] if p in opt.state
                          else torch.zeros_like(p))
    steps = [s["step"] for s in opt.state.values()]
    if host or not steps:
        count = np.asarray(int(max(map(float, steps), default=0)), np.int32)
    else:
        count = torch.stack([t.reshape(()) for t in steps]).max().to(
            torch.int32)
    groups = STAGE_TRAINABLE[stage]
    tree = lambda name: _jax_leaves(bridge.jax_tree(
        model, value=moment(name), groups=groups, host=host))
    return CK.Leaves([count, *tree("exp_avg"), *tree("exp_avg_sq"), count])


def load_optimizer_leaves(model: torch.nn.Module, opt: torch.optim.Adam,
                          leaves: Sequence[np.ndarray],
                          stage: int = 1) -> None:
    """Sets Adam's state from the JAX package's optax leaves of the stage
    (optimizer_leaves' layout).  A parameter whose two moments are zero
    has had no gradient and gets no state, as in torch; the update count
    lives on the parameter's device (capturable Adam's place for it)."""
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
            opt.state[p] = {"step": torch.tensor(float(count),
                                                 device=p.device), **m}


def learning_rate(tcfg: TrainConfig, step: int) -> float:
    """Learning rate of update number ``step`` (0 for the first update,
    the count optax's schedule sees)."""
    return schedule.learning_rate(step, tcfg.learning_rate,
                                  tcfg.warm_up_end, tcfg.end_iter,
                                  tcfg.learning_rate_alpha)


def set_lr(opt: torch.optim.Optimizer, tcfg: TrainConfig, step: int) -> float:
    """Sets the float learning rate of update number ``step``
    (learning_rate); on a CUDA device StepTrainer's slot holds it."""
    lr = learning_rate(tcfg, step)
    for g in opt.param_groups:
        g["lr"] = lr
    return lr


# -- the training step and multi-step blocking ------------------------------

class StepTrainer:
    """A stage's training step: the optimizer (make_optimizer), the
    step's random generator and ``slot``, the device tensor of what
    changes from step to step: (learning rate, cos_anneal_ratio, image
    index), filled before each step from a per-block device table.  A
    stage defines ``loss(step, img_idx, anneal) -> (loss, metrics)`` on
    the slot's image index and anneal ratio (0-dim tensors).

    ``run_block`` runs a block of steps: eagerly, or on a CUDA device
    through one captured step (``graph``): WARMUP_STEPS eager steps on a
    side stream the first time (real steps of the trajectory), then the
    capture, then one replay a step, the blocks' single steps included.
    A capture or replay that fails raises; nothing falls back to eager
    steps.  Kernel launches recorded in the capture count once a replay
    (_cuda.count); under ``debug_nans`` the graph's loss and gradients
    are checked after each replay."""

    def __init__(self, model: torch.nn.Module, tcfg: TrainConfig,
                 data: Dict, stage: int, seed: int):
        self.model, self.tcfg = model, tcfg
        self.data = RAYS.draw_tables(data)
        self.device = data["images"].device
        self.slot = torch.zeros(3, device=self.device)
        cuda = self.device.type == "cuda"
        self.opt = make_optimizer(model, tcfg, stage,
                                  lr=self.slot[0] if cuda else None)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._graph: Optional[Any] = None
        self._static: Optional[Tuple[torch.Tensor, Dict]] = None
        self._counts: List[Callable[[], None]] = []
        self._side: Optional[Any] = None
        self._warm = 0
        self.replays = 0            # steps run as replays of the graph

    def loss(self, step: int, img_idx: torch.Tensor,
             anneal: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def step(self, img_idx: int, step: int) -> Dict[str, torch.Tensor]:
        """One eager step of update number ``step`` on image img_idx;
        returns its metrics (0-dim tensors on the device)."""
        return self.run_block(step, [img_idx])

    def run_block(self, step0: int, idxs: Sequence[int],
                  graph: bool = False) -> Dict[str, torch.Tensor]:
        """len(idxs) steps from update number step0, step i on image
        idxs[i]; returns the last step's metrics (with ``graph``, the
        graph's own outputs, overwritten by its next replay)."""
        if graph and self.device.type != "cuda":
            raise ValueError("step graphs need a CUDA device")
        table = self._table(step0, idxs)
        for i in range(len(idxs)):
            step = step0 + i
            if not graph:
                metrics = self._eager(table[i], step)
            elif self._graph is None and self._warm < WARMUP_STEPS:
                metrics = self._warmup(table[i], step)
            else:
                if self._graph is None:
                    self._capture(step)
                metrics = self._replay(table[i], step)
        return metrics

    def _table(self, step0: int, idxs: Sequence[int]) -> torch.Tensor:
        """The block's slot rows [K, 3] on the device, copied from pinned
        memory without a host sync (the caching host allocator keeps the
        pinned rows until the copy is done)."""
        rows = torch.tensor(
            [[learning_rate(self.tcfg, step0 + i),
              schedule.cos_anneal_ratio(step0 + i, self.tcfg.anneal_end),
              float(idx)] for i, idx in enumerate(idxs)],
            dtype=torch.float32)
        if self.device.type != "cuda":
            return rows
        return rows.pin_memory().to(self.device, non_blocking=True)

    def _grads(self):
        return ((n, p.grad) for n, p in self.model.named_parameters())

    def _body(self, step: int) -> Tuple[torch.Tensor, Dict]:
        loss, metrics = self.loss(step, self.slot[2], self.slot[1])
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if not _cuda.capturing():
            LOG.check_finite(step, loss, self._grads())
        self.opt.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def _eager(self, row: torch.Tensor, step: int) -> Dict:
        self.slot.copy_(row)
        if self.device.type != "cuda":
            set_lr(self.opt, self.tcfg, step)
        return self._body(step)[1]

    def _warmup(self, row: torch.Tensor, step: int) -> Dict:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            metrics = self._eager(row, step)
        main.wait_stream(self._side)
        self._warm += 1
        return metrics

    def _capture(self, step: int) -> None:
        CK.join_writers()
        graph = torch.cuda.CUDAGraph()
        # each replay then takes the generator's next Philox offsets
        graph.register_generator_state(self.gen)
        with _cuda.recording() as counts:
            with torch.cuda.graph(graph):
                self._static = self._body(step)
        self._graph, self._counts = graph, counts
        log.info("training step captured into a CUDA graph at step %d "
                 "(%d counted kernel launches a replay)", step, len(counts))

    def _replay(self, row: torch.Tensor, step: int) -> Dict:
        self.slot.copy_(row)
        self._graph.replay()
        self.replays += 1
        for bump in self._counts:
            bump()
        loss, metrics = self._static
        LOG.check_finite(step, loss, self._grads())
        return metrics


def plan_block(iter_step: int, end_iter: int, block: int, freqs,
               image_perm, rng, n_images: int):
    """Host-side block planning: (K, idxs, image_perm').

    K is the largest block <= ``block`` that does not cross the end of
    training or any multiple of the event frequencies (report, save,
    validation), so every observable side effect fires at the same
    iterations as single stepping.  idxs are the K image indices,
    rotating the permutation at epoch boundaries with the caller's rng,
    the stream the single-step loop draws from."""
    fs = [f for f in freqs if f and f > 0]
    K = min([max(1, block), end_iter - iter_step]
            + [f - iter_step % f for f in fs])
    idxs, t, perm = [], iter_step, image_perm
    for _ in range(K):
        idxs.append(int(perm[t % len(perm)]))
        t += 1
        if t % len(perm) == 0:
            perm = rng.permutation(n_images)
    return K, idxs, perm


class BlockStepper:
    """Multi-step blocking of a stage's training loop: ``advance`` plans
    one block (plan_block: at most ``train.block_steps`` steps, ending at
    the next event) and runs it through the trainer, on a CUDA device
    through its step graph when block_steps > 1, else eagerly; returns
    the boundary step's metrics and K."""

    def __init__(self, trainer: StepTrainer, tcfg: TrainConfig,
                 n_images: int, freqs: Sequence[int]):
        self.trainer, self.tcfg = trainer, tcfg
        self.n_images, self.freqs = n_images, tuple(freqs)
        self.block = max(1, int(tcfg.block_steps))
        self.graph = self.block > 1 and trainer.device.type == "cuda"
        self._rng = self._perm = None

    def start(self, rng, image_perm) -> None:
        self._rng, self._perm = rng, image_perm

    def advance(self, iter_step: int) -> Tuple[Dict[str, torch.Tensor],
                                               int]:
        K, idxs, self._perm = plan_block(
            iter_step, self.tcfg.end_iter, self.block, self.freqs,
            self._perm, self._rng, self.n_images)
        return self.trainer.run_block(iter_step, idxs, self.graph), K


def boundary_metrics(metrics) -> Dict[str, float]:
    """Scalar metrics at a block's boundary step: of metrics stacked along
    a leading [K] axis the last sub-step's (the one on the report
    frequency), of scalars the value itself (one host fetch each)."""
    return {k: float(torch.as_tensor(v).reshape(-1)[-1])
            for k, v in metrics.items()}


class Reports:
    """A training loop's reports: ``steps(K)`` after each block; at a
    report iteration ``report(iter_step, metrics)`` reads the boundary
    step's metrics (boundary_metrics), adds the rays/s since the last
    report and the iteration, appends them to ``history``, writes the
    TensorBoard scalars (``scalars``: tag -> metric, and
    Perf/rays_per_sec from the meter) under ``log_dir`` and logs
    ``line`` (str.format over the metrics)."""

    def __init__(self, log_dir: str, batch_size: int,
                 history: List[Dict[str, float]], scalars: Dict[str, str],
                 line: str):
        self.writer = LOG.MetricsWriter(log_dir)
        self.meter = LOG.ThroughputMeter()
        self.meter.start()
        self.batch_size, self.history = batch_size, history
        self.scalars, self.line = scalars, line
        self._t, self._steps = time.perf_counter(), 0

    def steps(self, k: int) -> None:
        self.meter.step(self.batch_size * k)
        self._steps += k

    def report(self, iter_step: int, metrics) -> Dict[str, float]:
        m = boundary_metrics(metrics)                  # syncs
        now = time.perf_counter()
        m["rays_per_sec"] = self.batch_size * self._steps / (now - self._t)
        m["iter"] = iter_step
        self._t, self._steps = now, 0
        self.history.append(m)
        self.writer.scalars({**{tag: m[k] for tag, k in self.scalars.items()},
                             "Perf/rays_per_sec": self.meter.rays_per_sec},
                            iter_step)
        log.info(self.line.format(**m))
        return m

    def close(self) -> None:
        self.writer.close()


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
