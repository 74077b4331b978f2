#!/usr/bin/env python3
"""K1-bwd-split-bf16 and K1-bwd-stash-bf16 (csrc/geometry_bwd_chains_bf16_wg.cu)
built from other copies of the port's csrc/, against each other on a GPU.

    python3 tools/k1_chains16_ab.py NAME=DIR [NAME=DIR ...] [--seeds K]

Each DIR holds a copy of factored_neus_tpu_torch/csrc/ (this checkout's, a
parent's unpacked with ``git archive``, or an edited copy, in a directory
that .gitignore lists); its geometry_bwd_chains_bf16_wg.cu is compiled with
nvcc beside DIR's headers into build/ab/NAME.so and launched through this
checkout's wrappers (ops/geometry_kernel.launch_backward_split and
launch_backward_stash, bf16=True), with a scratch 1.5x this version's plan
so that a layout with a larger one runs too.  On the full-width SDF
network:
- for K input draws (``--seeds``, default 8) at 9,001 points and 2 at
  65,536, each variant's and K1-bwd-bf16's worst ratio to
  chip_smoke.check_flips' limits over the output tensors (1 fails; the
  twins and the f64 function as chip_smoke.py holds them), and whether the
  split's ct_x, dW and db are K1-bwd-bf16's bit for bit;
- each variant's time (CUDA events) at 9,001 and 65,536 points, the
  variants in turns (A, B, ..., B, A), beside K1-bwd-bf16's.
Prints one line a measurement, the card's name and power limit, and a JSON
summary of the times.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "geometry_bwd_chains_bf16_wg.cu"


def gains(got, twin, ref, flip_gain):
    """check_flips' first ratio (the error from the f64 function against
    FLIP_GAIN x the twin's) per tensor."""
    out = []
    for g, t, r in zip(got, twin, ref):
        g, t, r = g.double(), t.double(), r.double()
        scale = float(r.abs().max())
        out.append(float((g - r).abs().max())
                   / (flip_gain * float((t - r).abs().max()) + 1e-5 * scale))
    return out


def main() -> int:
    args = sys.argv[1:]
    seeds = 8
    if "--seeds" in args:
        i = args.index("--seeds")
        seeds = int(args[i + 1])
        del args[i:i + 2]
    if not args or not all("=" in a for a in args):
        print("usage: k1_chains16_ab.py NAME=DIR [NAME=DIR ...] [--seeds K]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke
    from k1_bwd_phases import _bind, nvcc_all, time_in_turns
    from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    variants = dict(a.split("=", 1) for a in args)
    libs = {name: os.path.join(HERE, "build", "ab", f"{name}.so")
            for name in variants}
    os.makedirs(os.path.join(HERE, "build", "ab"), exist_ok=True)
    nvcc_all([(name, os.path.join(os.path.abspath(d), SRC), libs[name])
              for name, d in variants.items()],
             ("geometry_bwd_bf16_wg.cu", "geometry_fwd_bf16_wg.cu", SRC))
    plan = GK.chains_wg16_plan
    GK.chains_wg16_plan = lambda *a, **k: {
        **plan(*a, **k),
        "scratch_floats": plan(*a, **k)["scratch_floats"] * 3 // 2}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    slabs = GK.make_bwd_slabs(cfg, ws)
    flat = lambda r: [r[0], *r[1], *r[2]]
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    w64, b64 = [w.double() for w in ws], [b.double() for b in bs]

    def inputs(n, gen):
        x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
        ct_out = torch.randn(n, ws[-1].shape[0], device=dev, generator=gen)
        ct_g = torch.randn(n, 3, device=dev, generator=gen)
        st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16=True)[2]
        return x, ct_out, ct_g, st

    def launch(v, x, ct_out, ct_g, st):
        if v == "split":
            return flat(GK.launch_backward_split(cfg, x, ws, bs, ct_out,
                                                 ct_g, slabs, bf16=True))
        return flat(GK.launch_backward_stash(cfg, x, ws, st, ct_out, ct_g,
                                             slabs, bf16=True))
    try:
        for n, k in ((9001, seeds), (65536, 2)):
            for seed in range(k):
                gen = torch.Generator(device=dev).manual_seed(100 + seed)
                x, ct_out, ct_g, st = inputs(n, gen)
                twins = {
                    "split": (flat(GK.geometry_bwd_plain(
                        ws, bs, x, ct_out, ct_g, cfg, bf16=True)),
                        [t.float() for t in flat(GK.geometry_bwd_plain(
                            w64, b64, x.double(), ct_out.double(),
                            ct_g.double(), cfg))]),
                    "stash": (flat(GK.geometry_bwd_stash_plain(
                        ws, x, st, ct_out, ct_g, cfg, bf16=True)),
                        [t.float() for t in flat(GK.geometry_bwd_stash_plain(
                            w64, x.double(), st, ct_out.double(),
                            ct_g.double(), cfg))])}
                k1 = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g,
                                             slabs, bf16=True))
                rows = {"K1-bwd-bf16": gains(k1, *twins["split"],
                                             chip_smoke.FLIP_GAIN)}
                for v in ("split", "stash"):
                    kernel = GK.KERNELS[f"bwd_{v}", True]
                    for name in variants:
                        _bind(kernel, libs[name], kernel.symbol)
                        got = launch(v, x, ct_out, ct_g, st)
                        rows[f"{name} {v}"] = gains(got, *twins[v],
                                                    chip_smoke.FLIP_GAIN)
                        if v == "split":
                            eq = [torch.equal(a, b) for a, b in zip(got, k1)]
                            print(f"  {name} split N={n} draw {seed}: bit "
                                  f"for bit K1-bwd-bf16's: ct_x {eq[0]}, dW "
                                  f"{all(eq[1:1 + L])}, db {all(eq[1 + L:])}")
                    kernel._fn = None
                for label, g in rows.items():
                    i = max(range(len(g)), key=g.__getitem__)
                    print(f"N={n} draw {seed} {label}: worst ratio "
                          f"{g[i]:.3f} ({names[i]})")
        times = {}
        gen = torch.Generator(device=dev).manual_seed(5)
        for n in (9001, 65536):
            x, ct_out, ct_g, st = inputs(n, gen)
            for v in ("split", "stash"):
                got = time_in_turns(
                    GK.KERNELS[f"bwd_{v}", True],
                    [*variants, *reversed(variants)], libs,
                    lambda: launch(v, x, ct_out, ct_g, st), 10)
                for name, ms in got.items():
                    times[f"{v} {n} {name}"] = ms
                    print(f"  {v} N={n} {name}: "
                          f"{' / '.join(f'{t:.3f}' for t in ms)} ms")
            ms = chip_smoke.cuda_ms(lambda: GK.launch_backward(
                cfg, x, ws, bs, ct_out, ct_g, slabs, bf16=True), 10)
            times[f"K1-bwd-bf16 {n}"] = [ms]
            print(f"  K1-bwd-bf16 N={n}: {ms:.3f} ms")
    finally:
        GK.chains_wg16_plan = plan
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"card": card, "variants": variants, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
