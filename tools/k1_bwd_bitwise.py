#!/usr/bin/env python3
"""The results of the f32 and bf16 wgmma kernels that share code with one
another, this checkout's builds against another version's, bit for bit,
on a GPU.

    python3 tools/k1_bwd_bitwise.py DIR

Builds DIR's factored_neus_tpu_torch/csrc/ sources of the kernels below
(K1-bwd, K1-bwd-bf16, K1-fwd, K1-fwd-bf16, K2, K2-bf16 (its full output),
K3-fwd, K3-fwd-bf16, K3-bwd, K3-bwd-bf16, and the split and stash
backwards of both modes; for example a parent commit unpacked with ``git
archive`` into a directory that .gitignore lists) into build/bitwise/,
one nvcc each, all started together, and runs each and this checkout's
build through this checkout's wrapper (ops/geometry_kernel.launch_backward,
launch_backward_split, launch_backward_stash and launch_forward,
ops/sdf_kernel.sdf_forward, ops/radiance_kernel.launch_backward and
launch_forward, whose arguments both versions take) on the same inputs
and the mode's slab packs: the full-width SDF network and radiance MLP at
chip_smoke.py's 65,536 and 9,001 rows; the stash backwards read the stash
this checkout's K1-fwd-stash (or K1-fwd-stash-bf16) writes for those
points.  Every output (the backwards' input cotangents, each dW and db;
the forwards' out and grad, or rgb) must be equal bit for bit.  A kernel
whose source DIR does not hold (a version before it was written) is
skipped, and said so.  Then, for each source both builds hold, whether
each function's SASS (cuobjdump) is DIR's instruction for instruction
(printed only: a source may change on purpose).  Prints one line a kernel
and size, the card's name and power limit, and a JSON summary; exits 1
on any difference of bits.
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
           ("K3-fwd-bf16", "radiance_fwd_bf16_wg.cu", "radiance_fwd_bf16"),
           ("K2", "sdf_fwd_wg.cu", "sdf_fwd"),
           ("K3-fwd", "radiance_fwd_wg.cu", "radiance_fwd"),
           ("K1-bwd-split", "geometry_bwd_chains_wg.cu", "geometry_bwd_split"),
           ("K1-bwd-stash", "geometry_bwd_chains_wg.cu", "geometry_bwd_stash"),
           ("K1-bwd-split-bf16", "geometry_bwd_chains_bf16_wg.cu",
            "geometry_bwd_split_bf16"),
           ("K1-bwd-stash-bf16", "geometry_bwd_chains_bf16_wg.cu",
            "geometry_bwd_stash_bf16"))
OUT = os.path.join(HERE, "build", "bitwise")


def sass(lib: str, tool: str) -> dict:
    """{function: [its SASS instructions]} of a shared library."""
    import re
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if fn and m:
            out[fn].append(m.group(1).strip())
    return out


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
            if label.startswith("K3-fwd"):
                return RK.KERNELS["fwd", bf16], lambda: [RK.launch_forward(
                    rcfg, rws, rbs, *rin, pack=slabs[0], bf16=bf16)]
            ct = torch.randn(n, rcfg.d_out, device=dev, generator=gen)

            def k3_bwd():
                *cts, dws, dbs = RK.launch_backward(rcfg, rws, rbs, *rin, ct,
                                                    pack=slabs, bf16=bf16)
                return [*cts, *dws, *dbs]
            return RK.KERNELS["bwd", bf16], k3_bwd
        slabs = GK.make_bwd_slabs(cfg, ws, bf16)
        x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
        if label.startswith("K2"):
            return SK.KERNELS[bf16], lambda: [SK.sdf_forward(
                ws, bs, cfg, x, slabs[0], bf16=bf16)]
        if label.startswith("K1-fwd"):
            return GK.KERNELS["fwd", bf16], lambda: list(GK.launch_forward(
                cfg, x, ws, bs, slabs, bf16=bf16))
        ct_out = torch.randn(n, ws[-1].shape[0], device=dev, generator=gen)
        ct_g = torch.randn(n, 3, device=dev, generator=gen)
        if label.startswith("K1-bwd-split"):
            return GK.KERNELS["bwd_split", bf16], lambda: flat(
                GK.launch_backward_split(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                         bf16))
        if label.startswith("K1-bwd-stash"):
            st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)[2]
            return GK.KERNELS["bwd_stash", bf16], lambda: flat(
                GK.launch_backward_stash(cfg, x, ws, st, ct_out, ct_g, slabs,
                                         bf16))
        return GK.KERNELS["bwd", bf16], lambda: flat(GK.launch_backward(
            cfg, x, ws, bs, ct_out, ct_g, slabs, bf16=bf16))

    sizes, skipped, libs, built = [], [], {}, {}
    for label, src, symbol in KERNELS:
        path = os.path.join(other, "factored_neus_tpu_torch", "csrc", src)
        if not os.path.exists(path):
            print(f"{label}: {other} holds no {src}: skipped")
            skipped.append(label)
            continue
        libs[label] = os.path.join(OUT, f"lib_other_{src[:-3]}.so")
        built.setdefault(src, (path, libs[label]))
    k1_bwd_phases.nvcc_all([(f"{other}'s {src}", path, lib) for src, (
        path, lib) in built.items()], _cuda.SOURCES, spills=False)
    for label, src, symbol in KERNELS:
        if label in skipped:
            continue
        lib = libs[label]
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
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    same_sass = {}
    for src, (_, lib) in built.items():
        mine, theirs = sass(_cuda._lib_path(src), tool), sass(lib, tool)
        for fn, ins in theirs.items():
            same_sass[f"{src}:{fn}"] = mine.get(fn) == ins
            print(f"SASS of {src} {fn}: {len(ins)} instructions in {other}'s"
                  f" build, {len(mine.get(fn, []))} in this one; the same: "
                  f"{mine.get(fn) == ins}")
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"other": other, "card": card, "sizes": sizes,
                      "skipped": skipped, "same_sass": same_sass}))
    return 1 if any(s["differ"] for s in sizes) else 0


if __name__ == "__main__":
    sys.exit(main())
