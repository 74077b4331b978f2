#!/usr/bin/env python3
"""Per-phase time of K3-bwd-bf16 (csrc/radiance_bwd_bf16_wg.cu) or, with
--f32, K3-bwd (csrc/radiance_bwd_wg.cu, 3xTF32) on a GPU.

    python3 tools/k3_bwd_phases.py [--f32] [--rows N] [--clocks]

Builds copies of the kernel into build/phases/radiance_bwd_bf16_wg/, each
with one part of its work cut out, and times them with CUDA events on the
full-width radiance MLP (289 -> 4 x 256 -> 3) at the stage-1 step's 65,536
rows (--rows: another count), on its two slab packs, as chip_smoke.py:
- ``all``: the kernel as it is;
- ``no_products``: without every wgmma of the sweep and of the
  weight-gradient pass (the slabs still stream and are waited for and
  released);
- ``no_wgrad_pass``: the weight-gradient pass not launched (the reduce
  reads stale slots);
- ``no_images``: the sweep writes no X_l / R_l image (the pass reads
  stale ones);
- ``no_layer0_epilogue``: no ct_feat store, no encoding Jacobian and no
  narrow cotangent stores (the layer-0 products stay);
- ``no_slab_copies``: the sweep's producer copies no slab (each full
  barrier completes on its arrival alone; the products read stale
  slabs): the sweep without its L2 slab stream and its latency.
--f32 cuts the same phases out of K3-bwd (its slab ring, products,
images and pass in csrc/wgf.cuh, which K1-bwd and K1-fwd share) and times
it on its two f32 slab packs.  A cut copy computes garbage: only its time
is read.  ``all`` is timed
first and last, as a measure of the spread.  ``--clocks``: ``all`` and
``no_products`` also run back to back while nvidia-smi samples the SM
clock and the power draw (k2_bf16_phases.clocks_under).  Prints one line
per phase, the card's name and power limit, and a JSON summary.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "radiance_bwd_bf16_wg.cu"
SH = "wg_bwd.cuh"
ROWS = 512 * 128
# phase: (files, regular expression, replacement) triples; each must match
CUTS = {
    "all": [],
    "no_products": [((SH,), r"wgmma_n256\(acc,[^;]*;", ";"),
                    ((SH,), r"wgmma_n48\(acc,[^;]*;", ";"),
                    ((SH,), r"wgmma_n8\(acc,[^;]*;", ";"),
                    ((SH,), r"wgmma_ss_n256\(acc,[^;]*;", ";"),
                    ((SH,), r"wgmma_ss_n64\(acc64,[^;]*;", ";")],
    "no_wgrad_pass": [((SRC,), r"radiance_bwd_wg_wgrad<<<[^;]*;", ";")],
    "no_images": [((SH,), r"\*\(uint32_t\*\)\(o \+[^;]*;", ";"),
                  ((SH,), r"\*\(uint4\*\)\(?o[^;]*;", ";")],
    "no_layer0_epilogue": [
        ((SRC,), r"\*\(float2\*\)\(d\.ct_feat[^;]*;", ";"),
        ((SRC,), r"encode_backward_row\(u, nullptr, d\.multires[^;]*;", ";"),
        ((SRC,), r"d\.ct_(?:pts|dirs|nrm)\[[^;]*;", ";")],
    "no_slab_copies": [((SH,), r"mbar_expect_tx\(full \+ st, bytes\);",
                        "mbar_expect_tx(full + st, 0);"),
                       ((SH,), r"bulk_g2s\(ring \+ st \* stage[^;]*;", ";")],
}
# K3-bwd (f32, 3xTF32 on wgmma)
SRCF = "radiance_bwd_wg.cu"
SHF = (SRCF, "wgf.cuh")
CUTS_F32 = {
    "all": [],
    "no_products": [(SHF, r"tf32_mma(?:_ss)?<N>\([^;]*;", ";"),
                    (SHF, r"wgmma_tf32_(?:ss_)?n(?:128|8)\(acc8?,[^;]*;",
                     ";")],
    "no_wgrad_pass": [((SRCF,), r"radiance_bwd_wgf_wgrad<<<[^;]*;", ";")],
    "no_images": [(SHF, r"(?:im|x0)\[img_at\([^;]*;", ";")],
    "no_layer0_epilogue": [
        ((SRCF,), r"\*\(float2\*\)\(d\.ct_feat[^;]*;", ";"),
        ((SRCF,), r"encode_backward_row\(u, nullptr, d\.multires[^;]*;",
         ";"),
        ((SRCF,), r"d\.ct_(?:pts|dirs|nrm)\[[^;]*;", ";")],
    "no_slab_copies": [(SHF, r"mbar_expect_tx\(full \+ st, bytes\);\s*"
                        r"bulk_g2s\(ring \+ st \* (?:FW_)?STAGE[^;]*;",
                        "mbar_arrive_if(full + st, 1);")],
}
ORDER = ["all", "no_products", "no_wgrad_pass", "no_images",
         "no_layer0_epilogue", "no_slab_copies", "all"]
CLOCKED = ("all", "no_products")


def main() -> int:
    args = sys.argv[1:]
    rows, clocks, f32 = ROWS, "--clocks" in args, "--f32" in args
    args = [a for a in args if a not in ("--clocks", "--f32")]
    if args[:1] == ["--rows"] and len(args) == 2:
        rows = int(args[1])
    elif args:
        print("usage: k3_bwd_phases.py [--f32] [--rows N] [--clocks]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke
    import k1_bwd_phases
    import k2_bf16_phases
    from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                       RenderingNetwork)
    from factored_neus_tpu_torch.ops import radiance_kernel as RK

    libs = (k1_bwd_phases.build_cut(HERE, SRCF, CUTS_F32, "radiance_bwd_wg")
            if f32 else k1_bwd_phases.build_cut(HERE, SRC, CUTS,
                                                "radiance_bwd_bf16_wg"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = RenderingConfig()
    net = RenderingNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [torch.randn(rows, 3, device=dev, generator=gen) * 0.5,
              torch.randn(rows, 3, device=dev, generator=gen),
              torch.nn.functional.normalize(
                  torch.randn(rows, 3, device=dev, generator=gen), dim=-1),
              torch.randn(rows, cfg.d_feature, device=dev,
                          generator=gen) * 0.5]
    ct = torch.randn(rows, cfg.d_out, device=dev, generator=gen)
    slabs = RK.make_bwd_slabs(cfg, ws, bf16=not f32)
    kernel = RK.KERNELS["bwd", not f32]
    label = "K3-bwd" if f32 else "K3-bwd-bf16"

    def call():
        RK.launch_backward(cfg, ws, bs, *inputs, ct, pack=slabs,
                           bf16=not f32)
    times = []
    for phase in ORDER:
        k1_bwd_phases._bind(kernel, libs[phase], kernel.symbol)
        ms = chip_smoke.cuda_ms(call, 10)
        times.append({"phase": phase, "ms": ms})
        print(f"{label} {phase}: {ms:.3f} ms")
        if clocks and phase in CLOCKED and not any(
                "sm_mhz" in t for t in times[:-1] if t["phase"] == phase):
            times[-1].update(k2_bf16_phases.clocks_under(call, torch))
            print(f"  under load: SM clock {times[-1]['sm_mhz']:.0f} MHz, "
                  f"{times[-1]['power_w']:.1f} W "
                  f"({times[-1]['samples']} samples)")
    kernel._fn = None
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"kernel": label, "rows": rows, "card": card,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
