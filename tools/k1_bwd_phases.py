#!/usr/bin/env python3
"""Per-phase time of K1's wgmma kernels (csrc/geometry_{bwd,fwd}_wg.cu,
their bf16 sources and the chains' sources) on a GPU.

    python3 tools/k1_bwd_phases.py [--root DIR] [--bf16] [--clocks]
    python3 tools/k1_bwd_phases.py [--root DIR] [--bf16] --fwd [--stash]
                                   [--clocks]
    python3 tools/k1_bwd_phases.py [--root DIR] [--bf16] [--split] [--stash]
                                   [--clocks]

Each run builds copies of one source with parts cut out (each in
build/phases/, every header beside it; a cut copy computes garbage: only
its time is read), launches each through this checkout's wrappers on the
full-width SDF network at 65,536 points and prints its time (CUDA
events); ``all`` (nothing cut) runs first and last, as a measure of the
spread.  DIR: another version of the port (e.g. a parent commit unpacked
with ``git archive`` into a directory that .gitignore lists) whose
sources are cut instead; a cut its code does not have fails the build.
``--clocks``: ``all`` and ``no_products`` (and K1-bwd-bf16's
``no_softplus``) also run back to back while nvidia-smi samples the SM
clock and the power draw (k2_bf16_phases.clocks_under).  Prints one line
a phase, the card's name and power limit, and a JSON summary.

Without ``--fwd``, ``--split`` or ``--stash``: K1-bwd (3xTF32 on wgmma,
geometry_bwd_wg.cu: a stacked sweep, a split-K weight-gradient pass, a
reduce), or with ``--bf16`` K1-bwd-bf16 (geometry_bwd_bf16_wg.cu), on its
two slab packs, with these cuts:
- ``no_products``: without every wgmma of the sweep and the pass;
- ``no_wgrad_pass``: the weight-gradient pass not launched;
- ``no_images``: the sweep writes no X_l / R_l image (the pass reads
  stale ones);
- ``no_scratch``: the sweep neither writes nor reads its f32 scratch;
- ``no_slabs`` (f32): the producer copies no weight slab (each stage is
  marked full at once: the products read stale slabs);
- ``no_softplus`` (bf16): each softplus replaced by its argument.

``--fwd``: K1-fwd in f32 (geometry_fwd_wg.cu: the forward through all
nine layers and the reverse sweep from e0 / scale), or with ``--bf16``
K1-fwd-bf16 (geometry_fwd_bf16_wg.cu: K2-bf16's forward, csrc/sweep16.cuh,
and the reverse sweep), on its two slab packs; with ``--stash``
K1-fwd-stash (K1-fwd-stash-bf16), the same sweep with the bf16 stash
stored.  The cuts:
- ``no_products``: without every wgmma;
- ``no_scratch``: without the f32 scratch of sigma(100 a);
- ``no_slabs``: the producer copies no weight slab;
- ``no_softplus``: softplus and sigma(100 a) replaced by the argument and
  0.5;
- ``no_stash`` (``--stash``): without the stash's stores.

``--split``, ``--stash`` (either or both, without ``--fwd``):
K1-bwd-split and K1-bwd-stash in f32, on wgmma in 3xTF32
(geometry_bwd_chains_wg.cu: a sweep of 64-point tiles, each chain's rows
one product, K1-bwd's split-K pass and reduce), on K1-bwd's two f32 slab
packs (the stash's fed K1-fwd-stash's stash), from one set of cut copies
of the source, with these cuts:
- ``no_products``: without every wgmma of the sweep and the pass;
- ``no_wgrad_pass``: the weight-gradient pass not launched;
- ``no_images``: the sweep writes no X_l / R_l image (the pass and the
  read-backs read stale ones);
- ``no_readback``: the second chain's input is not read back from its
  image (zeros go into the A tile);
- ``no_scratch``: the sweep neither writes nor reads its f32 scratch
  (sigma(100 a), ad, the first chain's r W);
- ``no_epilogues``: softplus and sigma(100 a) replaced by the argument and
  0.5;
- ``no_slabs``: the sweep's producer copies no weight slab.
With ``--bf16``: K1-bwd-split-bf16 and K1-bwd-stash-bf16 on bf16 wgmma
(geometry_bwd_chains_bf16_wg.cu: a sweep of 64-point tiles, a consumer
warpgroup a chain, K1-bwd-bf16's split-K pass and reduce), on
K1-bwd-bf16's two slab packs (the stash's fed K1-fwd-stash-bf16's stash),
with these cuts:
- ``no_products``, ``no_wgrad_pass``, ``no_images``, ``no_slabs``: as
  above;
- ``no_scratch``: the sweep neither writes nor reads its f32 scratch
  (sigma(100 a) and ad: the forward's exchange and the reverse's reads);
- ``no_exchange_bars``: without the forward's bar.sync of the two
  consumers at each exchange (a race: only the time is read);
- ``no_epilogues``: softplus and sigma(100 a) replaced by the argument and
  0.5;
- ``no_stash_reads``: the stash's pre-activations read as 0 (the stash
  alone).
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
# K1-bwd-bf16 on wgmma: (files, regular expression, replacement) triples;
# a cut applies to each of its files that the version has (the slab ring,
# image writers and pass moved from the kernel's source into wg_bwd.cuh,
# which K3-bwd-bf16 shares) and must match in one of them
WG = "geometry_bwd_bf16_wg.cu"
SHARED = (WG, "wg_bwd.cuh")
CUTS_WG = {
    "all": [],
    "no_products": [(SHARED, r"wgmma_n256\(acc,[^;]*;", ";"),
                    (SHARED, r"wgmma_n48\(acc,[^;]*;", ";"),
                    (SHARED, r"wgmma_ss_n256\(acc,[^;]*;", ";"),
                    (SHARED, r"wgmma_ss_n64\(acc64,[^;]*;", ";")],
    "no_wgrad_pass": [((WG,), r"geometry_bwd_wg_wgrad<<<[^;]*;", ";")],
    "no_images": [(SHARED, r"\*\(uint32_t\*\)\(o \+[^;]*;", ";"),
                  (SHARED, r"\*\(uint4\*\)\(?o[^;]*;", ";")],
    "no_scratch": [((WG,), r"sc\[q \* 128\] = make_float4[^;]*;", ";"),
                   (SHARED, r"const float4 v = sc\[q \* 128\];",
                    "const float4 v = make_float4(0.5f, 0.5f, 1.f, 1.f);"),
                   (SHARED, r"l2_prefetch_if\([^;]*;", ";")],
    "no_softplus": [((WG, "sweep16.cuh"),
                     r"return fmaxf\(a, 0\.f\) \+ (?:gw_lg2|lg2_approx)"
                     r"\([^;]*;", "return a;")],
}
ORDER_WG = ["all", "no_products", "no_wgrad_pass", "no_images",
            "no_scratch", "no_softplus", "all"]
CLOCKED = ("all", "no_products", "no_softplus")
# K1-bwd on wgmma in 3xTF32: (files, regular expression, replacement); the
# f32 engine's pieces, the pass and the reduce moved from the kernel's
# source into wgf.cuh, which K1-fwd and K3-bwd share
WGF = "geometry_bwd_wg.cu"
SHARED_F = (WGF, "wgf.cuh")
CUTS_WGF = {
    "all": [],
    "no_products": [(SHARED_F, r"tf32_mma(?:_ss)?<N>\([^;]*;", ";"),
                    (SHARED_F, r"wgmma_tf32_(?:ss_)?n(?:128|8)\(acc8?,[^;]*;",
                     ";")],
    "no_wgrad_pass": [((WGF,), r"geometry_bwd_wgf_wgrad<<<[^;]*;", ";")],
    "no_images": [(SHARED_F, r"(?:im|x0)\[img_at\([^;]*;", ";")],
    "no_scratch": [((WGF,), r"sl\[q \* 256\] = make_float4[^;]*;", ";"),
                   ((WGF,), r"const float4 v = sl\[q \* 256\];",
                    "const float4 v = make_float4(0.5f, 0.5f, 1.f, 1.f);"),
                   ((WGF,), r"l2_prefetch_if\([^;]*;", ";")],
    "no_slabs": [(SHARED_F, r"mbar_expect_tx\(full \+ st, bytes\);\s*"
                  r"bulk_g2s\(ring \+ st \* (?:FW_)?STAGE[^;]*;",
                  "mbar_arrive_if(full + st, 1);")],
}
# K1-fwd on wgmma in 3xTF32 (--fwd)
GFW = "geometry_fwd_wg.cu"
SHARED_G = (GFW, "wgf.cuh")
CUTS_GFW = {
    "all": [],
    "no_products": [(SHARED_G, r"tf32_mma(?:_ss)?<N>\([^;]*;", ";"),
                    (SHARED_G, r"wgmma_tf32_(?:ss_)?n(?:128|8)\(acc8?,"
                     r"[^;]*;", ";")],
    "no_scratch": [((GFW,), r"sl\[q \* 256\] = make_float4[^;]*;", ";"),
                   ((GFW,), r"const float4 v = sl\[q \* 256\];",
                    "const float4 v = make_float4(0.5f, 0.5f, 0.5f, 0.5f);"),
                   ((GFW,), r"l2_prefetch_if\([^;]*;", ";")],
    "no_slabs": [(SHARED_G, r"mbar_expect_tx\(full \+ st, bytes\);\s*"
                  r"bulk_g2s\(ring \+ st \* (?:FW_)?STAGE[^;]*;",
                  "mbar_arrive_if(full + st, 1);")],
    "no_softplus": [((GFW,), r"sp_sig100\(a, sp, s4\[e\]\);",
                     "sp = a; s4[e] = 0.5f;")],
}
ORDER_GFW = ["all", "no_products", "no_scratch", "no_slabs", "no_softplus",
             "all"]
# K1-fwd-bf16 on wgmma (--fwd --bf16): its forward is sweep16.cuh's (K2-bf16
# shares it), its slab ring wg_bwd.cuh's
G16 = "geometry_fwd_bf16_wg.cu"
SHARED_16 = (G16, "sweep16.cuh", "wg_bwd.cuh")
CUTS_G16 = {
    "all": [],
    "no_products": [(SHARED_16, r"wgmma_n(?:256|48)\(acc,[^;]*;", ";"),
                    (SHARED_16, r"wgmma_n8\(acc8,[^;]*;", ";")],
    "no_scratch": [(SHARED_16, r"if \(SIG\) sc\[128 \* q\] = "
                    r"make_float4[^;]*;", ";"),
                   ((G16,), r"const float4 v = sc\[128 \* q\];",
                    "const float4 v = make_float4(0.5f, 0.5f, 0.5f, 0.5f);"),
                   (SHARED_16, r"l2_prefetch_if\([^;]*;", ";")],
    "no_slabs": [(SHARED_16, r"mbar_expect_tx\(full \+ st, bytes\);\s*"
                  r"bulk_g2s\(ring \+ st \* stage[^;]*;",
                  "mbar_arrive_if(full + st, 1);")],
    "no_softplus": [(SHARED_16, r"sp_sig100_sfu\(pre, v\[e\], s\[e\]\);",
                     "{ v[e] = pre; s[e] = 0.5f; }")],
}
# --fwd --stash: K1-fwd-stash's (K1-fwd-stash-bf16's) stash stores cut
NO_STASH = {False: [((GFW,), r"if \(st\) st\[col\] = __float2bfloat16_rn"
                     r"\(a\);", ";")],
            True: [(SHARED_16, r"if \(st && c < W\) st\[c\] = "
                    r"__float2bfloat16_rn\(pre\);", ";")]}
ORDER_WGF = ["all", "no_products", "no_wgrad_pass", "no_images",
             "no_scratch", "no_slabs", "all"]
# K1-bwd-split and K1-bwd-stash on wgmma in 3xTF32 (--split, --stash): one
# source of both, on the f32 engine of wgf.cuh
CH = "geometry_bwd_chains_wg.cu"
SHARED_CH = (CH, "wgf.cuh")
CUTS_CH = {
    "all": [],
    "no_products": CUTS_WGF["no_products"][:1] + [
        (SHARED_CH, r"wgmma_tf32_(?:ss_)?n(?:128|8)\(acc8?,[^;]*;", ";")],
    "no_wgrad_pass": [((CH,), r"geometry_bwd_chains_wgf_wgrad<<<[^;]*;",
                       ";")],
    "no_images": [((CH,), r"(?:im|x0|ro)\[img_at\([^;]*;", ";")],
    "no_readback": [((CH,), r"src\[img_at\([^\]]*\)\]", "0.f")],
    "no_scratch": [((CH,), r"(?:ss|sa|held)\[q \* 256\] = make_float4\("
                    r"[^;]*;", ";"),
                   ((CH,), r"= (?:ss|sa|held)\[q \* 256\]",
                    "= make_float4(0.5f, 0.5f, 1.f, 1.f)"),
                   ((CH,), r"l2_prefetch_if\([^;]*;", ";")],
    "no_epilogues": [((CH,), r"sp_sig100\(a, sp, s\);",
                      "sp = a; s = 0.5f;")],
    "no_slabs": CUTS_WGF["no_slabs"],
}
ORDER_CH = ["all", "no_products", "no_wgrad_pass", "no_images",
            "no_readback", "no_scratch", "no_epilogues", "no_slabs", "all"]
CLOCKED_WGF = ("all", "no_products")
# K1-bwd-split-bf16 and K1-bwd-stash-bf16 on bf16 wgmma (--bf16 --split,
# --bf16 --stash): one source of both, on wg_bwd.cuh's ring, image writers
# and pass
CH16 = "geometry_bwd_chains_bf16_wg.cu"
SHARED_CH16 = (CH16, "wg_bwd.cuh")
CUTS_CH16 = {
    "all": [],
    "no_products": [(SHARED_CH16, pat, rep)
                    for _, pat, rep in CUTS_WG["no_products"]],
    "no_wgrad_pass": [((CH16,), r"geometry_bwd_chains_wg16_wgrad<<<[^;]*;",
                       ";")],
    "no_images": [(SHARED_CH16, pat, rep)
                  for _, pat, rep in CUTS_WG["no_images"]],
    "no_scratch": [((CH16,), r"\*\(\(?float2\*\)\(s[ab] \+ q \* 128\)"
                    r"(?: \+ 1\))? =[^;]*;", ";"),
                   ((CH16,), r"s[ab]\[q \* 128\] = make_float4[^;]*;", ";"),
                   ((CH16,), r"__ldcg\(\(const float2\*\)\(s[ab] \+ q \* "
                    r"128\)\)", "make_float2(0.5f, 0.5f)"),
                   (SHARED_CH16, r"const float4 v = sc\[q \* 128\];",
                    "const float4 v = make_float4(0.5f, 0.5f, 1.f, 1.f);"),
                   (SHARED_CH16, r"l2_prefetch_if\([^;]*;", ";")],
    "no_exchange_bars": [((CH16,), r"bar_sync\(2, 256\);", ";")],
    "no_epilogues": [((CH16,), r"\bsp100(?:_sfu)?\(", "("),
                     ((CH16,), r"\bsig100(?:_sfu)?\(", "0.5f + 0.f * (")],
    "no_stash_reads": [((CH16,), r"return st && c < W \? "
                        r"__bfloat162float\(st\[c\]\) : 0\.f;",
                        "return 0.f;"),
                       ((CH16,), r"asm volatile\(\"prefetch\.global\.L2"
                        r"[^)]*\(at\)\);", ";")],
    "no_slabs": CUTS_G16["no_slabs"],
}
ORDER_CH16 = ["all", "no_products", "no_wgrad_pass", "no_images",
              "no_scratch", "no_exchange_bars", "no_epilogues",
              "no_stash_reads", "no_slabs", "all"]


def build_cut(root: str, src: str, cuts: dict, name: str) -> dict:
    """The cut copies of a wgmma kernel's source ``src`` (cuts: {phase:
    [(files, pattern, replacement)]}), where DIR has it, each in
    build/phases/<name>/<phase>/ with every header beside it: {phase:
    library}; each cut must match."""
    sys.path.insert(0, root)
    csrc = os.path.join(root, "factored_neus_tpu_torch", "csrc")
    if not os.path.exists(os.path.join(csrc, src)):
        return {}
    libs, jobs = {}, []
    for phase, phase_cuts in cuts.items():
        files = {src, *(f for f in os.listdir(csrc) if f.endswith(".cuh"))}
        texts = {f: open(os.path.join(csrc, f)).read() for f in files}
        for names, pat, rep in phase_cuts:
            k = 0
            for f in names:
                if f in texts:
                    texts[f], kf = re.subn(pat, rep, texts[f], flags=re.S)
                    k += kf
            if k == 0:
                raise RuntimeError(f"{phase}: {pat!r} matches nothing")
        d = os.path.join(OUT, name, phase)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        libs[phase] = os.path.join(d, "lib.so")
        jobs.append((phase, os.path.join(d, src), libs[phase]))
    nvcc_all(jobs, spills=False)
    return libs


def nvcc_all(jobs, mine=(), spills: bool = True) -> None:
    """Compiles each (label, source, library) of ``jobs`` with nvcc, all
    started together and while this checkout's sources ``mine`` build
    (_cuda.build_all); raises with nvcc's output if one fails.
    ``spills``: prints each build's ptxas lines that report spills."""
    from factored_neus_tpu_torch.ops import _cuda
    procs = [(label, subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for label, src, lib in jobs]
    if mine:
        _cuda.build_all(mine)
    for label, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for line in log.splitlines():
            if spills and "spill" in line:
                print(f"  {label} ptxas: {line.strip()}")


def time_in_turns(kernel, order, libs: dict, run, reps: int,
                  others: dict = None) -> dict:
    """Each name of ``order`` timed once, in that order (CUDA events,
    chip_smoke.cuda_ms over ``reps`` calls): ``others[name]`` where
    given, else ``run`` with ``kernel`` bound to ``libs[name]`` (to this
    checkout's build for a name libs lacks): {name: [ms, ...]}."""
    import chip_smoke
    got = {}
    for name in order:
        kernel._fn = None
        if name in libs:
            _bind(kernel, libs[name], kernel.symbol)
        got.setdefault(name, []).append(
            chip_smoke.cuda_ms((others or {}).get(name, run), reps))
    kernel._fn = None
    return got


def build_wg(root: str, bf16: bool = True) -> dict:
    """The cut copies of K1-bwd-bf16 (CUTS_WG) or of K1-bwd (CUTS_WGF) on
    wgmma, where DIR has it: {phase: library}."""
    if bf16:
        return build_cut(root, WG, CUTS_WG, "geometry_bwd_bf16_wg")
    return build_cut(root, WGF, CUTS_WGF, "geometry_bwd_wg")


def _bind(kernel, lib: str, symbol: str) -> None:
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_float,
                   ctypes.c_ulonglong]
    fn.restype = ctypes.c_int
    kernel._fn = fn


def fwd_main(root: str, clocks: bool, bf16: bool = False,
             stash: bool = False) -> int:
    """--fwd: K1-fwd on wgmma, phase by phase (CUTS_GFW); with --bf16
    K1-fwd-bf16 (CUTS_G16); with --stash their stash variants, with the
    stash's stores cut too (NO_STASH)."""
    import torch
    import chip_smoke
    import k2_bf16_phases
    src, cuts = (G16, CUTS_G16) if bf16 else (GFW, CUTS_GFW)
    order = list(ORDER_GFW)
    if stash:
        cuts = {**cuts, "no_stash": NO_STASH[bf16]}
        order.insert(-1, "no_stash")
    libs = build_cut(root, src, cuts, os.path.splitext(src)[0]
                     + ("_stash" if stash else ""))
    if not libs:
        print(f"phases: {root} has no {src}", file=sys.stderr)
        return 2
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
    slabs = GK.make_bwd_slabs(cfg, list(ws), bf16=bf16)
    if stash:
        call = lambda: GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)
    else:
        call = lambda: GK.launch_forward(cfg, x, ws, bs, slabs, bf16=bf16)
    kernel = GK.KERNELS["fwd_stash" if stash else "fwd", bf16]
    label = (f"K1-fwd{'-stash' if stash else ''}"
             f"{'-bf16' if bf16 else ''}")
    times = []
    for phase in order:
        _bind(kernel, libs[phase], kernel.symbol)
        ms = chip_smoke.cuda_ms(call, 10)
        times.append({"kernel": label, "phase": phase, "ms": ms})
        print(f"{label} (wgmma) {phase}: {ms:.3f} ms")
        if clocks and phase in ("all", "no_products") and not any(
                "sm_mhz" in t for t in times[:-1] if t["phase"] == phase):
            times[-1].update(k2_bf16_phases.clocks_under(call, torch))
            print(f"  under load: SM clock {times[-1]['sm_mhz']:.0f} MHz, "
                  f"{times[-1]['power_w']:.1f} W "
                  f"({times[-1]['samples']} samples)")
    kernel._fn = None
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"root": root, "fwd": True, "bf16": bf16,
                      "stash": stash, "card": card, "times": times}))
    return 0


def chains_main(root: str, clocks: bool, variants, bf16: bool = False
                ) -> int:
    """--split, --stash: K1-bwd-split and K1-bwd-stash on wgmma, phase by
    phase (CUTS_CH; ``bf16``: their bf16 variants, CUTS_CH16), each cut
    copy built once for both."""
    import torch
    import chip_smoke
    import k2_bf16_phases
    src, cuts, order = ((CH16, CUTS_CH16, ORDER_CH16) if bf16
                        else (CH, CUTS_CH, ORDER_CH))
    libs = build_cut(root, src, cuts, os.path.splitext(src)[0])
    if not libs:
        print(f"phases: {root} has no {src}", file=sys.stderr)
        return 2
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
    slabs = GK.make_bwd_slabs(cfg, list(ws), bf16=bf16)
    st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)[2]
    calls = {"split": lambda: GK.launch_backward_split(
                 cfg, x, ws, bs, ct_out, ct_g, slabs=slabs, bf16=bf16),
             "stash": lambda: GK.launch_backward_stash(
                 cfg, x, ws, st, ct_out, ct_g, slabs=slabs, bf16=bf16)}
    times = []
    for v in variants:
        kernel, call = GK.KERNELS[f"bwd_{v}", bf16], calls[v]
        label = f"K1-bwd-{v}{'-bf16' if bf16 else ''}"
        for phase in order:
            if phase == "no_stash_reads" and v != "stash":
                continue
            _bind(kernel, libs[phase], kernel.symbol)
            ms = chip_smoke.cuda_ms(call, 5)
            times.append({"kernel": label, "phase": phase, "ms": ms})
            print(f"{label} (wgmma) {phase}: {ms:.3f} ms")
            if clocks and phase in CLOCKED_WGF and not any(
                    "sm_mhz" in t for t in times[:-1]
                    if t["phase"] == phase and t["kernel"] == label):
                times[-1].update(k2_bf16_phases.clocks_under(call, torch))
                print(f"  under load: SM clock {times[-1]['sm_mhz']:.0f} "
                      f"MHz, {times[-1]['power_w']:.1f} W "
                      f"({times[-1]['samples']} samples)")
        kernel._fn = None
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"root": root, "variants": list(variants),
                      "bf16": bf16, "card": card, "times": times}))
    return 0


def main() -> int:
    args = sys.argv[1:]
    bf16, clocks, fwd = ("--bf16" in args, "--clocks" in args,
                         "--fwd" in args)
    variants = [v for v in ("split", "stash") if f"--{v}" in args]
    args = [a for a in args if a not in ("--bf16", "--clocks", "--fwd",
                                         "--split", "--stash")]
    root = HERE
    if args[:1] == ["--root"] and len(args) == 2:
        root = os.path.abspath(args[1])
    elif args or (fwd and "split" in variants):
        print("usage: k1_bwd_phases.py [--root DIR] [--bf16] [--fwd "
              "[--stash] | --split | --stash] [--clocks]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    if fwd:
        return fwd_main(root, clocks, bf16, "stash" in variants)
    if variants:
        return chains_main(root, clocks, variants, bf16)
    import chip_smoke
    import k2_bf16_phases
    libs = build_wg(root, bf16)
    if not libs:
        print(f"phases: {root} has no {WG if bf16 else WGF}",
              file=sys.stderr)
        return 2
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
    slabs = GK.make_bwd_slabs(cfg, list(ws), bf16=bf16)
    kernel = GK.KERNELS["bwd", bf16]
    call = lambda: GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                      bf16=bf16)
    order, clocked = ((ORDER_WG, CLOCKED) if bf16
                      else (ORDER_WGF, CLOCKED_WGF))
    times = []
    for phase in order:
        _bind(kernel, libs[phase], kernel.symbol)
        ms = chip_smoke.cuda_ms(call, 5)
        times.append({"kernel": "K1-bwd", "phase": phase, "ms": ms})
        print(f"K1-bwd{'-bf16' if bf16 else ''} (wgmma) {phase}: "
              f"{ms:.3f} ms")
        if clocks and phase in clocked and not any(
                "sm_mhz" in t for t in times[:-1] if t["phase"] == phase):
            times[-1].update(k2_bf16_phases.clocks_under(call, torch))
            print(f"  under load: SM clock {times[-1]['sm_mhz']:.0f} "
                  f"MHz, {times[-1]['power_w']:.1f} W "
                  f"({times[-1]['samples']} samples)")
    kernel._fn = None
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"root": root, "bf16": bf16, "card": card,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
