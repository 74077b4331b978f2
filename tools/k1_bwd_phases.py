#!/usr/bin/env python3
"""Per-phase time of K1-bwd and K1-fwd (csrc/geometry_{bwd,fwd}.cu) on a GPU.

    python3 tools/k1_bwd_phases.py [--root DIR]

Builds copies of DIR's factored_neus_tpu_torch/csrc kernels (default: this
checkout) into build/phases/, each with one phase cut out, and times them
with CUDA events at the main path's shapes (full-width SDF, 65,536 points,
as chip_smoke.py).  K1-bwd (stacked):
- ``all``: the kernel as it is;
- ``no_weight_grad``: without the weight-gradient products X^T R and their
  read-modify-write of the per-block partial slice;
- ``no_slice_traffic``: with the products but without the slice's copies
  between device and shared memory;
- ``no_input_cot``: without the input-cotangent products R W^T;
- ``no_forward``: without the stacked forward products X W;
- ``no_products``: without all three (what is left: encoding, elementwise
  work, scratch traffic, bias sums, barriers).
K1-fwd: ``all`` and ``no_products``.  The cuts match the tensor-core
kernels (tc_mma.cuh's products).  A cut copy computes garbage: only its
time is read.  The kernels are called through DIR's own wrappers
(ops/geometry_kernel.launch_backward, launch_forward), so DIR may hold
another version of the port, e.g. a parent commit unpacked with ``git
archive``; a phase whose code the version does not have (a version whose
K1 multiplies on the CUDA cores has none but ``all``) is reported as not
applicable.  ``all`` is timed first and last, as a measure of the
spread.  Prints one line per phase,
the card's name and power limit, and a JSON summary.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "phases")
N_CORE = 512 * 128
BWD, FWD = "geometry_bwd.cu", "geometry_fwd.cu"
WG = [(BWD, r"\n\s*tc_weight_grad\(.*?\);")]
IC = [(BWD, r"\n\s*bwd_input_cot<MODE>\(.*?\);")]
FW = [(BWD, r"\n\s*bwd_forward<MODE>\(.*?\);")]
# (kernel source, phase): (file, regular expression) pairs whose matches are
# cut (the tensor-core kernels of tc_mma.cuh); at least one must match
CUTS = {
    (BWD, "all"): [],
    (BWD, "no_weight_grad"): WG,
    (BWD, "no_slice_traffic"): [("tc_mma.cuh",
                                 r"rows\.copy<(?:true|false)>\(\);")],
    (BWD, "no_input_cot"): IC,
    (BWD, "no_forward"): FW,
    (BWD, "no_products"): WG + IC + FW,
    (FWD, "all"): [],
    (FWD, "no_products"): [(FWD, r"\n\s*tc_product<2>\(.*?\);")],
}
ORDER = [(BWD, p) for p in ("all", "no_weight_grad", "no_slice_traffic",
                            "no_input_cot", "no_forward", "no_products",
                            "all")] + [(FWD, "all"), (FWD, "no_products")]


def build(root: str) -> dict:
    """Writes and compiles the cut copies; returns {(source, phase):
    library}, without the phases this version has no code for."""
    sys.path.insert(0, root)
    from factored_neus_tpu_torch.ops import _cuda
    csrc = os.path.join(root, "factored_neus_tpu_torch", "csrc")
    libs, procs = {}, []
    for (src, phase), cuts in CUTS.items():
        files = {src, *(f for f, _ in cuts)}
        if not all(os.path.exists(os.path.join(csrc, f)) for f in files):
            continue
        texts = {f: open(os.path.join(csrc, f)).read() for f in files}
        n = 0
        for f, pat in cuts:
            texts[f], k = re.subn(pat, ";", texts[f], flags=re.S)
            n += k
        if cuts and n == 0:
            continue
        d = os.path.join(OUT, os.path.splitext(src)[0], phase)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, "lib.so")
        libs[(src, phase)] = lib
        procs.append((phase, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(d, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for phase, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {phase}:\n{log}")
    return libs


def main() -> int:
    args = sys.argv[1:]
    root = HERE
    if args[:1] == ["--root"] and len(args) == 2:
        root = os.path.abspath(args[1])
    elif args:
        print("usage: k1_bwd_phases.py [--root DIR]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    libs = build(root)
    from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from factored_neus_tpu_torch.ops import geometry_kernel as GK

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(N_CORE, 3, device=dev, generator=gen) * 0.5
    ct_out = torch.randn(N_CORE, ws[-1].shape[0], device=dev, generator=gen)
    ct_g = torch.randn(N_CORE, 3, device=dev, generator=gen)

    kernels = {BWD: (GK.K1_BWD, "geometry_bwd", lambda: GK.launch_backward(
        cfg, x, ws, bs, ct_out, ct_g)),
               FWD: (GK.K1_FWD, "geometry_fwd", lambda: GK.launch_forward(
                   cfg, x, ws, bs))}
    times = []
    for src, phase in ORDER:
        label = f"K1-{'bwd' if src == BWD else 'fwd'} {phase}"
        if (src, phase) not in libs:
            print(f"{label}: not applicable")
            continue
        kernel, symbol, call = kernels[src]
        fn = getattr(ctypes.CDLL(libs[(src, phase)]), symbol)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_float,
                       ctypes.c_ulonglong]
        fn.restype = ctypes.c_int
        kernel._fn = fn
        ms = chip_smoke.cuda_ms(call, 5)
        times.append({"kernel": label[:6], "phase": phase, "ms": ms})
        print(f"{label}: {ms:.3f} ms")
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"root": root, "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
