#!/usr/bin/env python3
"""Per-phase time of K2-bf16 (csrc/sdf_fwd_bf16.cu) on a GPU.

    python3 tools/k2_bf16_phases.py [--rows N] [--clocks]

Builds copies of the kernel into build/phases/sdf_fwd_bf16/, each with
one part of its work cut out, and times them with CUDA events on the
full-width SDF network, the last layer narrowed, at the stage-2 coarse
sweep's 1,048,576 rows (--rows: another count), on the full network's
slab pack as a stage-2 run has it:
- ``all``: the kernel as it is;
- ``no_softplus``: each softplus replaced by its argument (the bias add
  and the bf16 rounding stay): the products and the slab stream;
- ``no_products``: without the wgmma products (the slabs still stream
  and are waited for and released): the epilogue and the slab stream;
- ``no_slab_copies``: the producer copies nothing (each full barrier
  completes on its arrival alone; the products read stale slabs): the
  products and the epilogue without the L2 traffic.
A cut copy computes garbage: only its time is read.  ``all`` is timed
first and last, as a measure of the spread.  ``--clocks``: each of
``all``, ``no_softplus`` and ``no_products`` also runs back to back for
CLOCK_SECONDS while nvidia-smi samples the SM clock and the power draw
every 100 ms (the mean over the window after its first second): whether
the card holds its clock when the tensor cores and the SFUs are busy
together.  Prints one line per phase with the slab bytes read from L2
and the softplus count, the card's name and power limit, and a JSON
summary.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "phases", "sdf_fwd_bf16")
SRC = "sdf_fwd_bf16.cu"
ROWS = 512 * 4 * 512
CLOCK_SECONDS = 4.0
# phase: (file, regular expression, replacement) triples; each must match
# (every match is replaced).  K2-bf16's forward is csrc/sweep16.cuh's
# (which K1-fwd-bf16 shares), its slab ring csrc/wg_bwd.cuh's.
SW, RING = "sweep16.cuh", "wg_bwd.cuh"
CUTS = {
    "all": [],
    "no_softplus": [(SW, r"return fmaxf\(a, 0\.f\) \+ lg2_approx\([^;]*;",
                     "return a;")],
    "no_products": [(SW, r"wgmma_n256\(acc,[^;]*;", ";"),
                    (SW, r"wgmma_n8\(acc8,[^;]*;", ";")],
    "no_slab_copies": [(RING, r"mbar_expect_tx\(full \+ st, bytes\);",
                        "mbar_expect_tx(full + st, 0);"),
                       (RING, r"bulk_g2s\(ring \+ st[^;]*;", ";")],
}
ORDER = ["all", "no_softplus", "no_products", "no_slab_copies", "all"]


def build() -> dict:
    """Writes and compiles the cut copies; returns {phase: library}."""
    sys.path.insert(0, HERE)
    from factored_neus_tpu_torch.ops import _cuda
    csrc = _cuda.CSRC
    libs, procs = {}, []
    for phase, cuts in CUTS.items():
        files = {SRC, *(f for f in os.listdir(csrc) if f.endswith(".cuh"))}
        texts = {f: open(os.path.join(csrc, f)).read() for f in files}
        for f, pat, rep in cuts:
            texts[f], k = re.subn(pat, rep, texts[f], flags=re.S)
            if k == 0:
                raise RuntimeError(f"{phase}: {pat!r} matches nothing")
        d = os.path.join(OUT, phase)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        libs[phase] = os.path.join(d, "lib.so")
        procs.append((phase, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", libs[phase],
             os.path.join(d, SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for phase, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {phase}:\n{log}")
    return libs


def clocks_under(call, torch) -> dict:
    """Mean SM clock (MHz) and power draw (W) that nvidia-smi reads while
    ``call`` runs back to back for CLOCK_SECONDS (after the first second),
    and the calls made."""
    import time
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0, calls = time.time(), 0
        while time.time() - t0 < CLOCK_SECONDS:
            for _ in range(10):
                call()
            calls += 10
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(",")]
               for line in out.strip().splitlines() if "," in line]
    steady = samples[10:] or samples
    return {"sm_mhz": sum(v[0] for v in steady) / len(steady),
            "power_w": sum(v[1] for v in steady) / len(steady),
            "samples": len(steady), "calls": calls}


def main() -> int:
    args = sys.argv[1:]
    rows, clocks = ROWS, "--clocks" in args
    args = [a for a in args if a != "--clocks"]
    if args[:1] == ["--rows"] and len(args) == 2:
        rows = int(args[1])
    elif args:
        print("usage: k2_bf16_phases.py [--rows N] [--clocks]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    from factored_neus_tpu_torch.ops import tc_pack as TP
    libs = build()

    dev = torch.device("cuda")
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    pack = SK.make_sweep_pack(cfg, list(ws))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, 3, device=dev, generator=gen) * 0.5
    call = lambda: SK.sdf_forward(wn, bn, cfg, x, pack, bf16=True)
    # what one call streams and evaluates: every 128-row pass (64 rows a
    # consumer warpgroup) reads each slab once
    iargs, grid = SK.sweep_iargs(cfg, wn, rows, pack[1], _sm(torch, dev))
    n_pass = iargs[6]
    lay = TP.sweep_layout([w.shape[1] for w in wn], [w.shape[0] for w in wn],
                          SK.skip_layers(cfg, len(wn)), cfg.d_embed)
    slab_bytes = n_pass * sum(TP.SLAB_ROW * c * s
                              for c, s in zip(lay.cols, lay.nslab))
    softplus = rows * sum(w.shape[0] for w in wn[:-1])
    print(f"K2-bf16 at {rows} rows: {n_pass} passes over {grid} blocks, "
          f"{slab_bytes / 1e9:.2f} GB of slabs from L2, {softplus / 1e9:.3f}"
          f" G softplus")
    kernel = SK.SDF_FWD_BF16
    times = []
    for phase in ORDER:
        fn = getattr(ctypes.CDLL(libs[phase]), "sdf_fwd_bf16")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_float,
                       ctypes.c_ulonglong]
        fn.restype = ctypes.c_int
        kernel._fn = fn
        ms = chip_smoke.cuda_ms(call, 10)
        times.append({"phase": phase, "ms": ms})
        print(f"K2-bf16 {phase}: {ms:.4f} ms "
              f"({slab_bytes / ms / 1e9:.2f} TB/s of slabs)")
        if clocks and phase in ("all", "no_softplus", "no_products") and \
                not any("sm_mhz" in t for t in times[:-1]
                        if t["phase"] == phase):
            times[-1].update(clocks_under(call, torch))
            print(f"  under load: SM clock {times[-1]['sm_mhz']:.0f} MHz, "
                  f"{times[-1]['power_w']:.1f} W "
                  f"({times[-1]['samples']} samples)")
    kernel._fn = None
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"rows": rows, "slab_bytes": slab_bytes,
                      "softplus": softplus, "card": card, "times": times}))
    return 0


def _sm(torch, dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


if __name__ == "__main__":
    sys.exit(main())
