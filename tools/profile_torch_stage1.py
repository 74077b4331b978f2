#!/usr/bin/env python3
"""Where the time of one stage-1 (or stage-2, or stage-3) step of the
PyTorch port goes, on a GPU.

    python3 tools/profile_torch_stage1.py            # K1-fwd / K1-bwd
    python3 tools/profile_torch_stage1.py --bf16     # K1's bf16 mode
    python3 tools/profile_torch_stage1.py --stash    # the HBM-stash pair
    python3 tools/profile_torch_stage1.py --womask [--split]
    python3 tools/profile_torch_stage1.py --stage2   # a stage-2 step
    python3 tools/profile_torch_stage1.py --stage2 --sweep-f32
    python3 tools/profile_torch_stage1.py --sampling # the ladder on K2-bf16
    python3 tools/profile_torch_stage1.py --stage3   # a stage-3 step

Trains full-width confs/wmask.conf (--womask: confs/womask.conf, with the
background NeRF) on the analytic-sphere scene of chip_smoke.py: WARMUP
steps, then a timed window of STEPS steps (host clock around steps that
end in torch.cuda.synchronize) and a torch.profiler window of as many;
--stage2 trains stage 2 of confs/wmask.conf instead (Lvis and
IndirectLight on the frozen stage-1 networks of the seed-0 init), and
--stage3 its stage 3 (EnvmapMaterial on the frozen stage-1 and stage-2
networks of the seed-0 init).  In a stage-3 step the device time of the
kernels launched inside Lvis' factorised visibility sweep (its cuBLAS
products and elementwise kernels, under the profiler range "Lvis.outer")
is grouped in one row.
Prints ms/step, rays/s, the device-busy share of the profiled window and
device time by kernel, each hand-written kernel named by its row of
PERF.md's table, and writes the table as JSON to build/profile/
profile_torch_stage1[_womask][_stash][_split][_stage2][_stage3].json.
Where the conf's stage has train.block_steps = K > 1 (read as the runners
read it), the same trainer then runs its steps as the runners do on the
card, through the step's CUDA graph in blocks of K (warm-up blocks first,
which capture it), and the timed and profiled windows are repeated for
it (the JSON's "graph"), beside the CUDA-event span of its timed window
(its replays run back to back: the span is the device's busy time).
--stash sets FNEUS_PG_HBM_STASH=1, --split FNEUS_PG_STACKED=0, --bf16
FNEUS_CORE_ACT_BF16=1 (the render core's bf16 operand mode, K1 and K3;
without it the tool sets 0) and --sweep-f32 FNEUS_SWEEP_ACT_BF16=0 (stage
2's coarse sweep on K2 in 3xTF32 rather than its default K2-bf16) and
--sampling FNEUS_PALLAS_SAMPLING=1 (every sampling sweep on K2-bf16;
without it the tool sets 0) before the port is imported (the switches
are read at import); --bf16 and --sampling combine with the other flags.
The table names each kernel's operand mode (-bf16) and records the
config's sweep modes.
"""
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "profile")
STEPS = 10
WARMUP = 5
# device-side kernel name -> PERF.md's row (the split and stash backwards
# of each mode share their pass and reduce, named by the run)
TABLE_ROWS = (("geometry_bwd_split_wg16_sweep", "K1-bwd-split-bf16 (sweep)"),
              ("geometry_bwd_stash_wg16_sweep", "K1-bwd-stash-bf16 (sweep)"),
              ("geometry_bwd_chains_wg16_wgrad",
               "K1-bwd-split-bf16 (weight-gradient pass)"),
              ("geometry_bwd_chains_wg16_reduce",
               "K1-bwd-split-bf16 (reduce)"),
              ("geometry_bwd_split_wgf_sweep", "K1-bwd-split (sweep)"),
              ("geometry_bwd_stash_wgf_sweep", "K1-bwd-stash (sweep)"),
              ("geometry_bwd_chains_wgf_wgrad",
               "K1-bwd-split (weight-gradient pass)"),
              ("geometry_bwd_chains_wgf_reduce", "K1-bwd-split (reduce)"),
              ("geometry_bwd_wgf_sweep", "K1-bwd (sweep)"),
              ("geometry_bwd_wgf_wgrad", "K1-bwd (weight-gradient pass)"),
              ("geometry_bwd_wgf_reduce", "K1-bwd (reduce)"),
              ("geometry_bwd_wg_sweep", "K1-bwd-bf16 (sweep)"),
              ("geometry_bwd_wg_wgrad", "K1-bwd-bf16 (weight-gradient pass)"),
              ("geometry_bwd_wg_reduce", "K1-bwd-bf16 (reduce)"),
              ("radiance_bwd_wg_sweep", "K3-bwd-bf16 (sweep)"),
              ("radiance_bwd_wg_wgrad", "K3-bwd-bf16 (weight-gradient pass)"),
              ("radiance_bwd_wg_reduce", "K3-bwd-bf16 (reduce)"),
              ("radiance_bwd_wgf_sweep", "K3-bwd (sweep)"),
              ("radiance_bwd_wgf_wgrad", "K3-bwd (weight-gradient pass)"),
              ("radiance_bwd_wgf_reduce", "K3-bwd (reduce)"),
              ("geometry_fwd_wgf_sweep", "K1-fwd"),
              ("geometry_fwd_bf16_sweep", "K1-fwd-bf16"),
              ("geometry_fwd_stash_wgf_sweep", "K1-fwd-stash"),
              ("geometry_fwd_stash_bf16_sweep", "K1-fwd-stash-bf16"),
              ("sdf_fwd_wgf_sweep", "K2"),
              ("sdf_fwd_bf16_kernel", "K2-bf16"),
              ("radiance_fwd_wgf_sweep", "K3-fwd"),
              ("radiance_fwd_bf16_sweep", "K3-fwd-bf16"),
              ("radiance_fwd_bf16_kernel", "K3-fwd-bf16"))
FLAGS = ("--womask", "--stash", "--split", "--stage2", "--stage3", "--bf16",
         "--sweep-f32", "--sampling")
OUTER = "Lvis.outer"        # the profiler range of the visibility sweep
OUTER_ROW = "Lvis.outer (visibility sweep, cuBLAS)"


def table_row(kernel: str, stash: bool) -> str:
    for key, row in TABLE_ROWS:
        if key in kernel:
            if stash and row.startswith("K1-bwd-split") and \
                    "(sweep)" not in row:
                row = row.replace("K1-bwd-split", "K1-bwd-stash")
            return row
    return ""


def outer_kernels(prof) -> dict:
    """[device us, launches] by kernel name of the kernels launched inside
    the OUTER range (a CPU op's kernels, with an ancestor of that name)."""
    import torch
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        p = e.cpu_parent
        while p is not None and p.name != OUTER:
            p = p.cpu_parent
        if p is not None:
            for k in e.kernels:
                acc = out.setdefault(k.name, [0.0, 0])
                acc[0] += k.duration
                acc[1] += 1
    return out


def main() -> int:
    args = sys.argv[1:]
    if not set(args) <= set(FLAGS) or len(set(args)) != len(args):
        print("usage: profile_torch_stage1.py [--womask] [--stash] "
              "[--split] [--bf16] [--sampling] [--stage2 [--sweep-f32] | "
              "--stage3]", file=sys.stderr)
        return 2
    womask, stash, split, stage2, stage3, bf16, sweep_f32, sampling = (
        f in args for f in FLAGS)
    if stash:
        os.environ["FNEUS_PG_HBM_STASH"] = "1"
    if split:
        os.environ["FNEUS_PG_STACKED"] = "0"
    os.environ["FNEUS_CORE_ACT_BF16"] = "1" if bf16 else "0"
    os.environ["FNEUS_SWEEP_ACT_BF16"] = "0" if sweep_f32 else "1"
    os.environ["FNEUS_PALLAS_SAMPLING"] = "1" if sampling else "0"
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from factored_neus_tpu_torch.data.datasets import make_dataset
    from factored_neus_tpu_torch.models.renderer import (Stage1Model,
                                                         Stage2Model,
                                                         Stage3Model)
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.train.common import TrainConfig
    from factored_neus_tpu_torch.train.stage1 import Stage1Trainer
    from factored_neus_tpu_torch.train.stage2 import Stage2Trainer
    from factored_neus_tpu_torch.train.stage3 import Stage3Trainer
    from factored_neus_tpu_torch.utils import config as CFG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if GK.STASH_BWD != stash or GK.STACKED_BWD == split:
        raise AssertionError("the switches disagree with the flags")
    card = chip_smoke.card_line()
    base = "womask.conf" if womask else "wmask.conf"
    print(card, base, "stage 2" if stage2 else "stage 3" if stage3
          else "HBM-stash pair" if stash
          else "K1-fwd / K1-bwd-split" if split else "K1-fwd / K1-bwd",
          "in the core's bf16 mode (K1, K3)" if bf16 else "",
          "coarse sweep on K2" if stage2 and sweep_f32
          else "coarse sweep on K2-bf16" if stage2 else "",
          "every sampling sweep on K2-bf16" if sampling else "")
    _cuda.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        conf = CFG.load(chip_smoke.write_conf(tmp, base=base), "sphere")
        ds = make_dataset("dtu", conf["dataset"], dev)
    data = {"images": ds.images, "masks": ds.masks,
            "intr_inv": ds.intrinsics_all_inv, "poses": ds.pose_all}
    stage = 2 if stage2 else 3 if stage3 else 1
    if stage2:
        cfg = CFG.renderer_config(conf, "model.lvis_renderer")
        tcfg = TrainConfig.from_conf(conf, stage=2)
        model = Stage2Model(cfg, CFG.variance_init_val(conf), seed=0,
                            device=dev)
        trainer = Stage2Trainer(model, cfg, tcfg, data, seed=2)
    elif stage3:
        cfg = CFG.renderer_config(conf, "model.lvis_renderer")
        tcfg = TrainConfig.from_conf(conf, stage=3)
        model = Stage3Model(cfg, CFG.variance_init_val(conf), seed=0,
                            device=dev)
        trainer = Stage3Trainer(model, cfg, tcfg, data, seed=3)
    else:
        cfg = CFG.renderer_config(conf)
        tcfg = TrainConfig.from_conf(conf)
        model = Stage1Model(cfg, CFG.variance_init_val(conf), seed=0,
                            device=dev)
        trainer = Stage1Trainer(model, cfg, tcfg, data, seed=1)
    step = 0

    def run(n):
        nonlocal step
        for _ in range(n):
            trainer.step(step % ds.n_images, step)
            step += 1
        torch.cuda.synchronize()

    def run_graph(n):
        nonlocal step
        for _ in range(n // block):
            trainer.run_block(step, [(step + i) % ds.n_images
                                     for i in range(block)], graph=True)
            step += block
        torch.cuda.synchronize()

    run(WARMUP)
    out = {"card": card, "conf": base, "stash": stash, "split": split,
           "bf16": bf16, "sweep_act_bf16": cfg.sweep_act_bf16,
           "use_pallas_sampling": cfg.use_pallas_sampling, "stage": stage,
           "block_steps": tcfg.block_steps,
           **measure(run, STEPS, stage, stash, card, tcfg.batch_size,
                     "eager steps")}
    block = tcfg.block_steps
    if block > 1:
        steps = block * -(-STEPS // block)
        run_graph(2 * block)
        out["graph"] = measure(run_graph, steps, stage, stash, card,
                               tcfg.batch_size,
                               f"CUDA graph, blocks of {block}")
        print(f"graph against eager: {out['graph']['step_ms']:.2f} against "
              f"{out['step_ms']:.2f} ms/step wall on {card}")
    else:
        print("block_steps = 1 in the conf: eager steps only")
    os.makedirs(OUT, exist_ok=True)
    name = "profile_torch_stage1" + "".join(
        f.replace("--", "_") for f in FLAGS if f in args) + ".json"
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def measure(run, steps: int, stage: int, stash: bool, card: str,
            batch: int, label: str) -> dict:
    """A timed window of ``steps`` steps (host clock, and the span between
    two CUDA events) and a torch.profiler window of as many: ms/step,
    device busy and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(steps)
    end.record()
    wall = (time.perf_counter() - t0) / steps
    span = start.elapsed_time(end) / steps
    print(f"stage-{stage} step, {label}: {1e3 * wall:.2f} ms, "
          f"{batch / wall:.0f} rays/s; CUDA-event span {span:.2f} ms/step, "
          f"on {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        window = time.perf_counter() - t0
    rows, spans = [], {}
    grouped = outer_kernels(prof) if stage == 3 else {}
    for e in prof.key_averages():
        # device-side events only: CPU ops also carry their kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        # a profiler range (record_function: the sweep, the optimizer's
        # step) shows on the device as the span of its kernels, which are
        # rows of their own: keep it apart from the kernels' busy time
        if (getattr(e, "is_user_annotation", False) or e.key == OUTER
                or e.key.startswith("Optimizer.")):
            spans[e.key] = dev_us / 1e3 / steps
            continue
        us, n = grouped.get(e.key, (0.0, 0))
        if e.count > n:
            rows.append({"name": e.key, "row": table_row(e.key, stash),
                         "calls": e.count - n,
                         "ms_per_step": (dev_us - us) / 1e3 / steps})
    if grouped:
        rows.append({"name": OUTER, "row": OUTER_ROW,
                     "calls": sum(n for _, n in grouped.values()),
                     "ms_per_step": sum(us for us, _ in grouped.values())
                     / 1e3 / steps,
                     "kernels": {k: us / 1e3 / steps
                                 for k, (us, _) in grouped.items()}})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    step_ms = 1e3 * window / steps
    print(f"profiled window, {label}: {step_ms:.2f} ms/step wall, device "
          f"busy {busy:.2f} ms/step ({100 * busy / step_ms:.1f}%)")
    for r in rows[:25]:
        print(f"  {r['ms_per_step']:9.3f} ms  {r['calls'] // steps:5d}x "
              f" {r['row'] or '-':>26}  {r['name'][:80]}")
    print(f"  launches a step: {sum(r['calls'] for r in rows) // steps}; "
          f"profiler ranges on the device (spans, not busy time): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in spans.items()))
    return {"step_ms": 1e3 * wall, "span_ms": span,
            "profiled_step_ms": step_ms, "busy_ms": busy,
            "spans_ms": spans, "kernels": rows}


if __name__ == "__main__":
    sys.exit(main())
