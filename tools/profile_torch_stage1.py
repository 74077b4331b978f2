#!/usr/bin/env python3
"""Where the time of one stage-1 step of the PyTorch port goes, on a GPU.

    python3 tools/profile_torch_stage1.py

Trains full-width confs/wmask.conf on the analytic-sphere scene of
chip_smoke.py: WARMUP steps, then a timed window of STEPS steps (host clock
around steps that end in torch.cuda.synchronize) and a torch.profiler
window of as many. Prints ms/step, rays/s, the device-busy share of the
profiled window and device time by kernel, and writes the table as JSON to
build/profile/profile_torch_stage1.json.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from factored_neus_tpu_torch.data.datasets import make_dataset
    from factored_neus_tpu_torch.models.renderer import Stage1Model
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.train.common import TrainConfig
    from factored_neus_tpu_torch.train.stage1 import Stage1Trainer
    from factored_neus_tpu_torch.utils import config as CFG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    _cuda.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        conf = CFG.load(chip_smoke.write_conf(tmp), "sphere")
        ds = make_dataset("dtu", conf["dataset"], dev)
    cfg = CFG.renderer_config(conf)
    tcfg = TrainConfig.from_conf(conf)
    model = Stage1Model(cfg, CFG.variance_init_val(conf), seed=0, device=dev)
    trainer = Stage1Trainer(model, cfg, tcfg, {
        "images": ds.images, "masks": ds.masks,
        "intr_inv": ds.intrinsics_all_inv, "poses": ds.pose_all}, seed=1)
    step = 0

    def run(n):
        nonlocal step
        for _ in range(n):
            trainer.step(step % ds.n_images, step)
            step += 1
        torch.cuda.synchronize()

    run(WARMUP)
    t0 = time.perf_counter()
    run(STEPS)
    wall = (time.perf_counter() - t0) / STEPS
    print(f"stage-1 step: {1e3 * wall:.2f} ms, "
          f"{tcfg.batch_size / wall:.0f} rays/s on {card}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(STEPS)
        window = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: CPU ops also carry their kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "ms_per_step": dev_us / 1e3 / STEPS})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    step_ms = 1e3 * window / STEPS
    print(f"profiled window: {step_ms:.2f} ms/step wall, device busy "
          f"{busy:.2f} ms/step ({100 * busy / step_ms:.1f}%)")
    for r in rows[:25]:
        print(f"  {r['ms_per_step']:9.3f} ms  {r['calls'] // STEPS:5d}x "
              f" {r['name'][:100]}")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profile_torch_stage1.json"), "w") as f:
        json.dump({"card": card, "step_ms": 1e3 * wall,
                   "profiled_step_ms": step_ms, "busy_ms": busy,
                   "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
