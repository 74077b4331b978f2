#!/usr/bin/env python3
"""The results of the f32 and bf16 wgmma kernels that share code with one
another, this checkout's builds against another version's, bit for bit,
on a GPU.

    python3 tools/k1_bwd_bitwise.py DIR

Builds DIR's factored_neus_tpu_torch/csrc/geometry_bwd_wg.cu (K1-bwd, f32),
geometry_bwd_bf16_wg.cu (K1-bwd-bf16), geometry_fwd_wg.cu (K1-fwd, f32),
radiance_bwd_wg.cu (K3-bwd, f32), sdf_fwd_bf16.cu (K2-bf16, its full
output), radiance_bwd_bf16_wg.cu (K3-bwd-bf16), geometry_fwd_bf16_wg.cu
(K1-fwd-bf16) and radiance_fwd_bf16_wg.cu (K3-fwd-bf16) (for example a
parent commit unpacked with ``git archive`` into a directory that
.gitignore lists) into build/bitwise/, and runs each and this checkout's
build through this checkout's wrapper (ops/geometry_kernel.launch_backward
and launch_forward, ops/sdf_kernel.sdf_forward,
ops/radiance_kernel.launch_backward and launch_forward, whose arguments
both versions take) on the same inputs and the mode's slab packs: the
full-width SDF network and radiance MLP at chip_smoke.py's 65,536 and
9,001 rows.  Every output (the backwards' input cotangents, each dW and
db; the forwards' out and grad, or rgb) must be equal bit for bit.  A
kernel whose source DIR does not hold (a version before it was written)
is skipped, and said so.  Prints one line a kernel and size, the card's
name and power limit, and a JSON summary; exits 1 on any difference.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, source, C function)
KERNELS = (("K1-bwd", "geometry_bwd_wg.cu", "geometry_bwd"),
           ("K1-bwd-bf16", "geometry_bwd_bf16_wg.cu", "geometry_bwd_bf16"),
           ("K1-fwd", "geometry_fwd_wg.cu", "geometry_fwd"),
           ("K3-bwd", "radiance_bwd_wg.cu", "radiance_bwd"),
           ("K2-bf16", "sdf_fwd_bf16.cu", "sdf_fwd_bf16"),
           ("K3-bwd-bf16", "radiance_bwd_bf16_wg.cu", "radiance_bwd_bf16"),
           ("K1-fwd-bf16", "geometry_fwd_bf16_wg.cu", "geometry_fwd_bf16"),
           ("K3-fwd-bf16", "radiance_fwd_bf16_wg.cu", "radiance_fwd_bf16"))
OUT = os.path.join(HERE, "build", "bitwise")


def main() -> int:
    if len(sys.argv) != 2:
        print("usage: k1_bwd_bitwise.py DIR", file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("bitwise: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke
    import k1_bwd_phases
    from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                       RenderingNetwork,
                                                       SDFConfig, SDFNetwork)
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    cfg, rcfg = SDFConfig(), RenderingConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    rnet = RenderingNetwork(rcfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = (list(t) for t in net.effective_weights())
        rws, rbs = (list(t) for t in rnet.effective_weights())
    flat = lambda r: [r[0], *r[1], *r[2]]

    def inputs(label, n, gen):
        """The kernel, its slab packs and a call on n random rows."""
        bf16 = label.endswith("-bf16")
        if label.startswith("K3"):
            slabs = RK.make_bwd_slabs(rcfg, rws, bf16=bf16)
            rin = [torch.randn(n, 3, device=dev, generator=gen) * 0.5,
                   torch.randn(n, 3, device=dev, generator=gen),
                   torch.nn.functional.normalize(torch.randn(
                       n, 3, device=dev, generator=gen), dim=-1),
                   torch.randn(n, rcfg.d_feature, device=dev,
                               generator=gen) * 0.5]
            if label == "K3-fwd-bf16":
                return RK.K3_FWD_BF16, lambda: [RK.launch_forward(
                    rcfg, rws, rbs, *rin, pack=slabs[0], bf16=True)]
            ct = torch.randn(n, rcfg.d_out, device=dev, generator=gen)

            def k3_bwd():
                *cts, dws, dbs = RK.launch_backward(rcfg, rws, rbs, *rin, ct,
                                                    pack=slabs, bf16=bf16)
                return [*cts, *dws, *dbs]
            return RK.KERNELS["bwd", bf16], k3_bwd
        slabs = GK.make_bwd_slabs(cfg, ws, bf16)
        x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
        if label == "K2-bf16":
            return SK.SDF_FWD_BF16, lambda: [SK.sdf_forward(
                ws, bs, cfg, x, slabs[0], bf16=True)]
        if label.startswith("K1-fwd"):
            return GK.KERNELS["fwd", bf16], lambda: list(GK.launch_forward(
                cfg, x, ws, bs, slabs, bf16=bf16))
        ct_out = torch.randn(n, ws[-1].shape[0], device=dev, generator=gen)
        ct_g = torch.randn(n, 3, device=dev, generator=gen)
        return GK.KERNELS["bwd", bf16], lambda: flat(GK.launch_backward(
            cfg, x, ws, bs, ct_out, ct_g, slabs, bf16=bf16))

    sizes, skipped = [], []
    for label, src, symbol in KERNELS:
        path = os.path.join(other, "factored_neus_tpu_torch", "csrc", src)
        if not os.path.exists(path):
            print(f"{label}: {other} holds no {src}: skipped")
            skipped.append(label)
            continue
        lib = os.path.join(OUT, f"lib_other_{symbol}.so")
        p = subprocess.run(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, path],
            capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {other}:\n{p.stdout}"
                               f"{p.stderr}")
        gen = torch.Generator(device=dev).manual_seed(5)
        for n in (chip_smoke.N_CORE, chip_smoke.N_RAGGED):
            kernel, call = inputs(label, n, gen)

            def run():
                return [t.clone() for t in call()]
            kernel._fn = None
            mine = run()
            k1_bwd_phases._bind(kernel, lib, symbol)
            theirs = run()
            kernel._fn = None
            torch.cuda.synchronize()
            differ = [i for i, (a, b) in enumerate(zip(mine, theirs))
                      if not torch.equal(a, b)]
            sizes.append({"kernel": label, "rows": n, "tensors": len(mine),
                          "differ": differ})
            print(f"{label} N={n}: {len(mine) - len(differ)} of "
                  f"{len(mine)} output tensors bitwise equal to {other}'s")
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"other": other, "card": card, "sizes": sizes,
                      "skipped": skipped}))
    return 1 if any(s["differ"] for s in sizes) else 0


if __name__ == "__main__":
    sys.exit(main())
