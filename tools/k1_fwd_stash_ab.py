#!/usr/bin/env python3
"""K1-fwd-stash and K1-fwd-stash-bf16 (csrc/geometry_fwd_wg.cu,
csrc/geometry_fwd_bf16_wg.cu) built from other copies of the port's csrc/,
against each other and this checkout's build on a GPU.

    python3 tools/k1_fwd_stash_ab.py NAME=DIR [NAME=DIR ...]

Each DIR holds a copy of factored_neus_tpu_torch/csrc/ (a parent's
unpacked with ``git archive``, or an edited copy, in a directory that
.gitignore lists); its two sources are compiled with nvcc beside DIR's
headers into build/ab/NAME_*.so, all at once, and launched through this
checkout's wrappers (ops/geometry_kernel.launch_forward_stash) on the
full-width SDF network and its slab packs.  For each mode at 65,536 and
9,001 points:
- whether each variant's out, grad and stash are this checkout's bit for
  bit (a variant of the stores must be);
- the time (CUDA events) of K1-fwd (K1-fwd-bf16), of this checkout's
  stash kernel (``this``) and of each variant, in turns (K1-fwd, this,
  A, B, ..., B, A, this, K1-fwd).
Prints one line a measurement, the card's name and power limit, and a
JSON summary of the times.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRCS = ("geometry_fwd_wg.cu", "geometry_fwd_bf16_wg.cu")


def main() -> int:
    args = sys.argv[1:]
    if not args or not all("=" in a for a in args):
        print("usage: k1_fwd_stash_ab.py NAME=DIR [NAME=DIR ...]",
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
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {(name, src): os.path.join(out_dir, f"{name}_{src[:-3]}.so")
            for name in variants for src in SRCS}
    nvcc_all([(f"{name}'s {src}", os.path.join(os.path.abspath(d), src),
               libs[name, src]) for name, d in variants.items()
              for src in SRCS], SRCS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ws, bs = list(ws), list(bs)
    gen = torch.Generator(device=dev).manual_seed(1)
    times = []
    for bf16 in (False, True):
        src = SRCS[bf16]
        stash_k = GK.KERNELS["fwd_stash", bf16]
        slabs = GK.make_bwd_slabs(cfg, ws, bf16=bf16)
        mode = "bf16" if bf16 else "f32"
        for n in (chip_smoke.N_CORE, chip_smoke.N_RAGGED):
            x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
            stash = lambda: GK.launch_forward_stash(cfg, x, ws, bs, slabs,
                                                    bf16)
            mine = stash()
            for name in variants:
                _bind(stash_k, libs[name, src], stash_k.symbol)
                same = all(torch.equal(a, b) for a, b in zip(stash(), mine))
                stash_k._fn = None
                print(f"{mode} N={n} {name}: out, grad and stash bit for "
                      f"bit this checkout's: {same}")
            got = time_in_turns(
                stash_k, ["fwd", "this", *variants, *reversed(variants),
                          "this", "fwd"],
                {name: libs[name, src] for name in variants}, stash,
                10 if n >= chip_smoke.N_CORE else 20,
                {"fwd": lambda: GK.launch_forward(cfg, x, ws, bs, slabs,
                                                  bf16)})
            for name, ms in got.items():
                times.append({"mode": mode, "rows": n, "variant": name,
                              "ms": ms})
            print(f"{mode} N={n} ms: " + ", ".join(
                f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                for k, v in got.items()))
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"variants": variants, "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
