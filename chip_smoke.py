#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (factored_neus_tpu_torch).

    python3 chip_smoke.py                 # the whole check, one CUDA device

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of factored_neus_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch twin at full width (f32,
   TF32 off; K3-bwd against its f64 twin on the ReLU masks of its own
   forward, which may differ from the f32 forward's only within rounding
   of 0), checks that two launches of K1-fwd, K1-bwd, K2, K3-fwd and
   K3-bwd agree bit for bit, and times each kernel and twin with CUDA
   events (each pack's own time beside it); the f32 kernels run in 3xTF32
   on wgmma (csrc/geometry_fwd_wg.cu, geometry_bwd_wg.cu,
   geometry_bwd_chains_wg.cu, sdf_fwd_wg.cu, radiance_fwd_wg.cu,
   radiance_bwd_wg.cu; each its ptxas report and SASS, which must hold
   HGMMA and no HMMA, K1-fwd's and K1-fwd-stash's, K1-bwd-split's and
   K1-bwd-stash's kernels each, and its kernels' registers and shared
   memory read from the device, "attrs"; no library built from csrc/ may
   hold an HMMA, no_hmma_anywhere): K1-fwd, K1-fwd-stash, K1-bwd,
   K1-bwd-split, K1-bwd-stash and K3-bwd at the step's 65,536 rows and a
   ragged 9,001, K1-fwd and K1-fwd-stash within 1e-5 abs of their twin
   (the stash entry by entry: equal, one bf16 ulp apart, or within 1e-5)
   and K1-fwd-stash's out and grad K1-fwd's bit for bit
   (k1_fwd_stash_bits), the backwards against their f64 twins
   (check_vjp; K1-bwd-stash's fed K1-fwd-stash's stash) with two launches
   bitwise equal, K1-bwd-split's ct_x, dW and db against K1-bwd's bit for
   bit or not (printed), timed at both ("shapes"), the bytes of each
   design and their f32 slab packs' build times; K2 (narrowed, on K1's
   forward slab
   pack as in the step, bitwise equal to K2 on its own narrowed pack, its
   sdf's distance from K1-fwd's printed) at both sweep shapes of a step
   and 9,001 rows, and its full 257-wide output at 9,001, and K3-fwd (on
   K3-bwd's forward slab pack) at 65,536 and 9,001, each within 1e-5 abs
   of its f32 and f64 twins (k2_check, k3_fwd_check); then K1-fwd, K3-fwd
   and K2 again at a validation chunk's shapes (262,144 and 131,072
   rows), each bitwise repeatable;
4. runs one full-width stage-1 step of confs/wmask.conf and one of
   confs/womask.conf (background NeRF) on the card (kernels) and the same
   steps on the CPU (twins), and compares the loss and every parameter
   gradient; then train.block_steps on the card (check_block_graph): for
   the f32 and bf16 wmask steps, womask with the split backward, stage 2
   and stage 3, 24 full-width steps with block_steps 8 (the step
   captured into a CUDA graph and replayed) and 1 (eager steps) from the
   same weights and seeds, the losses at each report, every parameter and
   both Adam moments bit for bit (or within 3e-4 + 2e-3 max|p|, the
   worst ratio printed), and 16 more steps of each timed (wall ms/step,
   the CUDA-event span of a window);
5. writes the analytic-sphere DTU scene (6 views, 128 x 160) with the
   port's PNG writer and trains 30 steps of confs/wmask.conf on it through
   the port's CLI, with every launch counter set to 0 just before (its
   block_steps = 8: blocks of 8, 2, 8, 2, 8, 2, three eager steps, then
   one replay of the step's CUDA graph a step; a launch, or a pack build,
   recorded in the capture counts once a replay; every CLI training run
   below goes through its graph alike, check_graph_run);
6. extracts the 512^3 mesh of that run's checkpoint through the CLI
   (--mode validate_mesh --is_continue; the grid fill on K2), counters at
   0 just before, checks it, and holds a 64^3 grid filled on the card
   against the CPU twin's;
   then renders view 0's validation panels through the CLI (--mode
   validate_image --is_continue --idx 0), counters at 0 just before: K2
   four times a chunk, K1-fwd and K3-fwd once, no backward kernel; holds
   one 2048-ray chunk of the card's render against the CPU twins'; times
   a validation image of a DTU-size view (1200 x 1600 at level 4, 59
   chunks); runs the modes interpolate_0_1 and mesh_dtu_shpere2world; and
   scores the 512^3 mesh against the r = 0.5 sphere through the port's
   evaltools, its native KD-tree held against brute force;
7. trains 10 more wmask steps in a subprocess with the HBM-stash switch on
   (FNEUS_PG_HBM_STASH=1, read at import), and 20 steps of
   confs/womask.conf in another with the split backward
   (FNEUS_PG_STACKED=0), counters at 0 there too;
8. checks finite losses, that each run launched exactly its kernels (the
   stash pair only in the stash run, K1-bwd-split only in the split run),
   that the checkpoint loads back, that no mma.sync pack exists in any
   run (count_pack_calls: tc_pack builds none, KernelWeights has no field
   for one), and that K1's reverse slab pack (tc_pack.pack_rev_f32, which
   every f32 K1 kernel reads) was built once a step in the 30-step wmask
   run, the stash run and the split run and never for the 512^3 mesh (its
   builds in the validation image and the stage-2 and stage-3 runs,
   items 5-6, 9-10, printed);
9. stage 2 on the 30-step stage-1 checkpoint: 30 full-width steps through
   the port's stage-2 CLI (python -m factored_neus_tpu_torch.lvis),
   counters at 0 just before: K2 five times a step, K2-bf16 once (the
   secondary coarse sweep, sweep_act_bf16 being on by default), K1-fwd
   three times, K3-fwd once, nothing else; the checkpoint loads back; K2
   at the secondary coarse sweep's 1,048,576 rows (its route with
   sweep_act_bf16 off) and the localisation sweep's 65,536, K1-fwd at 512
   and 2,048 rows and K3-fwd at 2,048, on the run's packs (the f32 slab
   packs Stage2Model.kernel_weights built without grad; no mma.sync pack),
   against their twins at 1e-5 abs (K2 at 65,536 and K3-fwd also against
   the f64 twins), bitwise repeatable and timed; one 64-ray stage-2 step
   with the coarse sweep in f32 on the card against the same step on the
   CPU twins (same
   rays and hemisphere draws), and one with the default bf16 sweep (item
   13); --mode validate_image through the CLI (counters at 0: K2 5,
   K2-bf16 1, K1-fwd 3, K3-fwd 1 a chunk); and one 2048-ray chunk of that
   view rendered by the card and by the CPU twins;
10. stage 3 on the 30-step stage-2 checkpoint: 30 full-width steps
   through the port's stage-3 CLI (python -m
   factored_neus_tpu_torch.mateIllu), counters at 0 just before: K2 five
   times a step, K1-fwd once, nothing else; the checkpoint read back into
   a fresh runner; Lvis' factorised visibility sweep (cuBLAS, not a
   kernel) against the flat forward and timed at a step's shape (4,096
   directions x 512 points) and a validation chunk's (x 2,048), beside
   its f32 bound; one 64-ray stage-3 step on the card against the same
   step on the CPU twins (same rays and visibility draws); --mode
   validate_image through the CLI (counters at 0: K2 5, K1-fwd 1 a
   chunk), its panels and its envmap EXR read back; and one 2048-ray
   chunk of that view rendered by the card and by the CPU twins;
11. the synthetic families: writes a Blender-layout scene (800 x 800,
   16 train and 4 test views, data/fake_scene.write_blender_scene) and
   trains 30 full-width steps of each stage through the CLIs, stage 1 as
   indisg_synthetic (the launches of item 5), stages 2 and 3 as
   synthetic (those of items 9 and 10, stage 3 in linear space),
   counters at 0 just before each; the synthetic panels of each stage
   (stage 1 through the CLI at level 1, stages 2 and 3 at level 4); a
   64-ray linear stage-3 step against the CPU twins; stage 3's
   cal_synthetic_psnr (level 1), relighting under two SG envmaps and
   test-split videos (level 8); validate_mesh_shiny of a shiny_refneus
   runner at iteration 10000 (the 512^3 fill on K2, the Shiny
   evaluation); and on fabricated glossy-synthetic and Sk3d scenes the
   w2c rays on the card against the CPU and an roi_prob = 1 draw inside
   its dilated box;
12. K1's bf16 operand mode (FNEUS_CORE_ACT_BF16=1; the JAX step's
   default): K1-fwd-bf16, K1-bwd-bf16, K1-bwd-split-bf16 and the stash
   pair in bf16 at 65,536 and 9,001 rows against their twins and an f64
   evaluation of the unrounded function (check_flips), two launches of
   each bitwise equal, timed against their bf16 bound; K1-fwd-bf16,
   K1-bwd-bf16, K1-bwd-split-bf16, K1-fwd-stash-bf16 and K1-bwd-stash-bf16
   (on wgmma: each source's ptxas report and SASS, which must hold HGMMA
   and no HMMA; K1-fwd-stash-bf16's out and grad K1-fwd-bf16's bit for bit
   at both shapes, k1_fwd_stash_bits) also
   timed at 9,001 rows ("shapes" in their kernels entries), their kernels'
   registers and shared memory read from the device ("attrs"), and the
   FLOP and the bytes each design moves by the source note's reckoning
   printed beside them; the split's ct_x, dW and db against K1-bwd-bf16's
   on the same inputs, bit for bit or not (printed); K1-fwd-bf16 also at a validation
   chunk's 262,144 rows (check_flips, bitwise repeat, timed), and its out
   at each size bit for bit K2-bf16's full 257-wide output on the same
   slab pack (k1_k2_bits); one 64-ray
   full-width wmask step with the mode on (K1 and K3 in bf16, item 13),
   card against CPU; then in a subprocess with the switch on (read at
   import) 30 wmask steps through the CLI (counters at 0: K1-fwd-bf16,
   K1-bwd-bf16, K3-fwd-bf16 and K3-bwd-bf16 once a step, K2 four times,
   no f32 K1 or K3), 10 with the stash switch and 10 with the split
   backward (their bf16 kernels once a step), one stage-1 CLI run with
   --gpu 0 --profile DIR whose trace names K1's and K3's bf16 kernels,
   and one with --debug_nans; no mma.sync pack exists there either, and
   K1's reverse bf16 slab pack (tc_pack.pack_rev_bf16) is built once a
   step or more in the 30 steps, the stash run and the split run;
13. the bf16 sweeps and the bf16 radiance MLP: K2-bf16 (on wgmma: its
   ptxas report and SASS, which must hold HGMMA and no HMMA.16816) at
   1,048,576, 65,536, 32,768, 9,001 and 8,192 rows (on the full network's
   slab pack, the last layer narrowed) and with the full 257-wide output
   at 65,536 rows, K3-fwd-bf16 and K3-bwd-bf16 at 65,536 and 9,001 rows
   and K3-fwd-bf16 also at 262,144 (a validation chunk), each against its
   twin and the f64 unrounded function (check_flips), two launches of
   each bitwise equal, timed against the bf16 bound (both on wgmma, as
   K1-bwd-bf16: each its ptxas report, SASS, attributes and every size's
   time; K3-bwd-bf16's twin on the ReLU masks the kernel itself keeps,
   k3_bwd_masks; K3-fwd-bf16 on K3-bwd-bf16's forward slab pack; the slab
   packs' build times); the
   64-ray wmask step of item 12 now runs K1 and K3 in
   bf16; a 64-ray stage-2 step with the default bf16 coarse sweep, card
   against CPU, held to the float64 step (item 9); the stage-2 CLI runs
   launch K2-bf16 once a step (items 9 and 11); the bf16 subprocess runs
   K3-fwd-bf16 and K3-bwd-bf16 in place of K3 (item 12); and in a
   subprocess with FNEUS_PALLAS_SAMPLING=1 (read at import) 10 wmask steps
   through the CLI (counters at 0: K2-bf16 four times a step, no K2);
14. prints {"kernels": [...]} (bound_ms: for the f32 kernels three TF32
   products' worth of the FLOPs over the tensor cores' TF32 peak, or the
   bytes if larger, with the f32 CUDA cores' bound as bound_f32_ms; each
   kernel's launches in the synthetic
   runs under "synthetic_launches"; K2-bf16's in the use_pallas_sampling
   run under "sampling_launches"), the card line, and as its last line
   {"ok": true, "device": {...}}.
Any failure raises; the script then exits non-zero without the last line.
"""
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12      # H100 SXM dense TF32 tensor-core FLOP/s
HBM_RATE = 3.35e12      # H100 SXM device memory bytes/s
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
N_CORE = 512 * 128      # render-core points of one wmask step
N_SWEEP = 512 * 64      # points of the ladder's first (largest) sweep
UP_SAMPLE_STEPS = 4     # the ladder's rounds: 3 more sweeps of new samples
N_SWEEP_NEW = 512 * 16  # points of each later sweep
TRAIN_STEPS = 30
STASH_STEPS = 10
SPLIT_STEPS = 20
STEP_RAYS = 64          # batch of the card-vs-CPU step checks
STASH_RUN = "--stash-run"
SPLIT_RUN = "--split-run"
BF16_RUN = "--bf16-run"
SAMPLING_RUN = "--sampling-run"
SAMPLING_STEPS = 10     # the use_pallas_sampling wmask run
BF16_STEPS = 30         # the bf16 mode's wmask run
BF16_VARIANT_STEPS = 10  # its stash and split runs, and the hook runs
N_RAGGED = 9001         # rows of the bf16 kernels' ragged check
# the bf16 kernels against their twins (check_flips): the kernel's error
# from the f64 function at most FLIP_GAIN x the twin's (max and rms) plus
# 1e-5 (1e-6 rms) x max|ref|, and |kernel - twin| within FLIP_SHARE_TOL x
# the twin's max error plus 1e-5 max|ref| in all but FLIP_OUTLIERS of the
# elements: the two sum in other orders, so a pre-activation within f32
# rounding of a bf16 rounding boundary rounds to one neighbour in one and
# to the other in the other, and that one-ulp step travels down the chain
FLIP_GAIN, FLIP_SHARE_TOL, FLIP_OUTLIERS = 1.25, 0.5, 1e-3
MESH_RES = 512
GRID_CHECK_RES = 64
# the 512^3 card mesh's mean vertex radius against the CPU twin's 64^3 mesh
# of the same weights (a smooth surface's mean radius barely moves between
# the two grids), and the range of the geometric init's radius over seeds
RADIUS_TOL = 0.01
RADIUS_BAND = (0.25, 0.8)
VAL_CHUNK = 2048        # rays a chunk of a validation render (val_chunk)
# a validation chunk, card against the CPU twin: at most CHUNK_TOL abs in
# at least CHUNK_SHARE of the rays, and CHUNK_MAX in every ray (a ladder
# sample that crosses a bin edge moves one ray)
CHUNK_TOL, CHUNK_SHARE, CHUNK_MAX = 1e-4, 0.999, 2e-2
VAL_KEYS = ("color_fine", "diffuse_color", "specular_color",
            "surface_color")
DTU_H, DTU_W, DTU_LEVEL = 1200, 1600, 4   # a DTU view, the conf's level
INTERP_FRAMES = 120     # interpolate_<i>_<j>: 60 views, there and back
KD_CHECK = 4096         # KD-tree queries held against brute force
# K3-bwd's ReLU masks against the f32 forward's: a pre-activation may take
# the other side of 0 only within MASK_MARGIN of its layer's max|a| (a few
# f32 roundings of a 289-term sum), and in at most MAX_MASK_FLIPS places of
# a check (67,108,864 pre-activations at full size)
MASK_MARGIN = 1e-6
MAX_MASK_FLIPS = 16
# K3-bwd-bf16's ReLU masks against its twin's bf16 forward: a
# pre-activation may take the other side of 0 only within BF16_MASK_ULP x
# sum_k |x_k w_k| of it (one bf16 ulp, at most 2^-7 of a value, of every
# rounded input term: the two round an activation to neighbours where
# their f32 sums part near a rounding boundary) plus MASK_MARGIN x max|a|;
# no count limit, as in bf16 such neighbours are common
BF16_MASK_ULP = 2.0 ** -7
STAGE2_STEPS = 30
# a stage-2 step at batch 512: launches per kernel (the secondary coarse
# sweep on K2-bf16, sweep_act_bf16 being on by default), and the rows of
# the sweeps that no stage-1 path runs (the secondary coarse sweep, 512
# rays x 4 directions x 512 samples, on K2 with sweep_act_bf16 off; the
# localisation sweep, 512 x 128; K1-fwd at the surface normals and at the
# secondary surface points; K3-fwd at the first-hit colour)
STAGE2_PER_STEP = {"sdf_fwd": 5, "sdf_fwd_bf16": 1, "geometry_fwd": 3,
                   "radiance_fwd": 1}
STAGE2_ROWS = {"sdf_fwd": (512 * 4 * 512, 512 * 128),
               "geometry_fwd": (512, 512 * 4), "radiance_fwd": (512 * 4,)}
# the stage-2 step, card against the CPU twins: the JAX package's stage-2
# gradient tolerance (tests/test_torch_parity.py), per tensor, and on the
# loss
S2_ATOL, S2_RTOL = 1.2e-3, 3e-3
# a stage-2 validation chunk, card against the CPU twins: at most
# S2_FLIP_SHARE of the rays may change sdf_mask (an sdf within rounding of
# 0 at a primary crossing), and of the others at least S2_CHUNK_SHARE must
# agree within S2_CHUNK_TOL abs (the JAX package's lvis_render tolerance)
# in all four maps: a secondary ray whose first crossing moves takes
# another surface's colour
S2_FLIP_SHARE, S2_CHUNK_SHARE, S2_CHUNK_TOL = 1e-3, 0.99, 3e-4
STAGE3_STEPS = 30
# a stage-3 step (or validation chunk): the ladder's four K2 sweeps and the
# localisation sweep, and K1-fwd once at the surface points
STAGE3_PER_STEP = {"sdf_fwd": 5, "geometry_fwd": 1}
# the stage-3 step, card against the CPU twins: the JAX package's stage-3
# gradient tolerance (tests/test_torch_parity.py), per tensor, and on the
# loss; a validation chunk as stage 2's, on every map of the decomposition
S3_ATOL, S3_RTOL = 6e-4, 3e-3
S3_FLIP_SHARE, S3_CHUNK_SHARE, S3_CHUNK_TOL = 1e-3, 0.99, 3e-4
# Lvis' factorised visibility sweep: 128 lobes x 32 samples, at the step's
# 512 surface points and a validation chunk's 2,048
OUTER_SHAPES = ((128 * 32, 512), (128 * 32, VAL_CHUNK))
# a stage-1 step: the ladder's four K2 sweeps, each other kernel once
STAGE1_PER_STEP = {"sdf_fwd": UP_SAMPLE_STEPS, "radiance_bwd": 1,
                   "geometry_fwd": 1, "geometry_bwd": 1, "radiance_fwd": 1}
# the synthetic families (item 11): a Blender-layout scene at the published
# Shiny Blender / NeRF-synthetic view size, 800 x 800, with 16 train and 4
# test views (a cut: the published scenes have 100 and 200)
SYN_CASE, SYN_H, SYN_W, SYN_TRAIN, SYN_TEST = "blender", 800, 800, 16, 4
# the stage-2 and stage-3 renders that the JAX CLI makes at level 1 run at
# level 4 here (a stage-3 chunk of 2048 rays costs ~0.13 s, so an 800^2
# view at level 1 takes ~40 s); the test-split videos at level 8.
# cal_synthetic_psnr needs level 1 (its ground truth is full size)
SYN_LEVEL, SYN_VIDEO_LEVEL = 4, 8
SYN_STAGES = ((1, "indisg_synthetic", STAGE1_PER_STEP),
              (2, "synthetic", STAGE2_PER_STEP),
              (3, "synthetic", STAGE3_PER_STEP))
W2C_TOL = 1e-6          # the w2c rays, card against the CPU


# the builds of K1's reverse slab packs (tc_pack.pack_rev_f32 and
# tc_pack.pack_rev_bf16, which only K1's kernels read), counted once
# count_pack_calls has run
PACK_CALLS = [0]
PACK16_CALLS = [0]
# the builders and KernelWeights fields an mma.sync pack had: none is left
MMA_SYNC_PACKS = ("pack_weights", "pack_weights_bf16", "make_pack",
                  "pack_for")


def mma_sync_packs_left() -> list:
    """What is left of the mma.sync packs: tc_pack's builders of one and
    fields.KernelWeights' fields for one (none: every kernel reads slab
    packs)."""
    from factored_neus_tpu_torch.models import fields as TF
    from factored_neus_tpu_torch.ops import tc_pack as TP
    return ([f"tc_pack.{n}" for n in MMA_SYNC_PACKS if hasattr(TP, n)]
            + [f"KernelWeights.{f}" for f in ("pack", "pack16")
               if f in TF.KernelWeights._fields])


def count_pack_calls() -> None:
    """Raises where an mma.sync pack is left (mma_sync_packs_left); then
    counts, once, every tc_pack.pack_rev_f32 call from now on in
    PACK_CALLS and every tc_pack.pack_rev_bf16 call in PACK16_CALLS: K1's
    reverse slab packs, which SDFNetwork.kernel_weights builds once a step
    wherever K1 runs, in either mode and under either switch, and never
    for the sweeps alone (a mesh); a build recorded into a step's CUDA
    graph counts at each replay, not at the capture."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import tc_pack as TP
    left = mma_sync_packs_left()
    if left:
        raise AssertionError(f"an mma.sync pack is left: {left}")
    if getattr(TP.pack_rev_f32, "counted", False):
        return
    inner, inner16 = TP.pack_rev_f32, TP.pack_rev_bf16

    def bump():
        PACK_CALLS[0] += 1

    def bump16():
        PACK16_CALLS[0] += 1

    # a build captured into a step's CUDA graph runs, and counts, once a
    # replay (_cuda.count)
    def counted(ws, d_embed):
        _cuda.count(bump)
        return inner(ws, d_embed)

    def counted16(ws, d_embed):
        _cuda.count(bump16)
        return inner16(ws, d_embed)
    counted.counted = counted16.counted = True
    TP.pack_rev_f32, TP.pack_rev_bf16 = counted, counted16


def pack_calls_during(label: str, packs: dict, fn, *args, **kw):
    """fn(*args, **kw), with the pack_rev_f32 calls it made in
    packs[label]."""
    before = PACK_CALLS[0]
    out = fn(*args, **kw)
    packs[label] = PACK_CALLS[0] - before
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worst(a, b, atol: float, rtol: float):
    """(max |a - b|, max |a - b| / (atol + rtol |b|)); the check passes
    when the second is <= 1."""
    d = (a - b).abs()
    return float(d.max()), float((d / (atol + rtol * b.abs())).max())


def worst_scaled(a, b, atol: float, rtol: float):
    """(max |a - b|, max |a - b| / (atol + rtol max|b|)): the tolerance of a
    sum over many rows scales with the size of the tensor, not of the
    entry, since a near-zero entry can be the sum of large terms."""
    d = (a - b).abs()
    return float(d.max()), float(d.max()) / (atol + rtol * float(b.abs().max()))


def check_vjp(label, got, ref64, ref32, names):
    """Per-tensor check of a backward kernel against the float64 twin at
    |err| <= 1e-4 + 1e-5 max|ref|; prints the f32 twin's own error beside
    it.  Returns the kernel's max |err|."""
    errs = [worst_scaled(a, b, 1e-4, 1e-5) for a, b in zip(got, ref64)]
    e = max(e for e, _ in errs)
    r, at = max((r, n) for (_, r), n in zip(errs, names))
    own = [worst_scaled(a, b, 1e-4, 1e-5) for a, b in zip(ref32, ref64)]
    print(f"{label}: max|err| {e:.3e} against the f64 twin; worst ratio to "
          f"(1e-4 + 1e-5 max|ref|) {r:.3f} in {at} (max|ref| "
          f"{float(ref64[names.index(at)].abs().max()):.3e}); the f32 "
          f"twin's own: max|err| {max(e for e, _ in own):.3e}, worst ratio "
          f"{max(r for _, r in own):.3f}")
    if r > 1.0:
        raise AssertionError(f"{label} disagrees with its plain twin")
    return e


def k3_bwd_masks(cfg, ws, bs, inputs, bf16: bool = False):
    """(masks, summary): the ReLU masks a_l > 0 [N, outs[l]] of K3-bwd's
    own forward recompute, for its f64 twin to differentiate the function
    the kernel computes.  Where a pre-activation lies within f32 rounding
    of 0, a forward summed in another order falls on the other side of the
    kink, one whole cotangent element apart.  The masks are the bits the
    sweep keeps in registers and applies, written out through
    launch_backward's ``masks`` (one launch over every row, ct_rgb = 0).
    They are held against the f32 forward's (cuBLAS), which does not
    depend on the kernel: they may differ only where |a_l| <= MASK_MARGIN
    max|a_l|, and in at most MAX_MASK_FLIPS places, else this raises, so a
    kernel fault that zeroes or flips activations cannot pass into the
    twin.  ``bf16``: K3-bwd-bf16's masks, for its bf16 twin, held against
    the twin's bf16 forward within BF16_MASK_ULP's margin of each element,
    in any number of places."""
    import torch
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import tc_pack as TP
    from factored_neus_tpu_torch.ops.embedder import positional_encoding
    pts, normals, dirs, feat = inputs
    dev, n, L = pts.device, pts.shape[0], len(ws)
    masks = []
    RK.launch_backward(cfg, ws, bs, *inputs,
                       torch.zeros(n, int(ws[-1].shape[0]), device=dev),
                       pack=RK.make_bwd_slabs(cfg, ws, bf16), bf16=bf16,
                       masks=masks)
    h = torch.cat([pts, positional_encoding(dirs, cfg.multires_view),
                   normals, feat], -1)
    flips = near = 0
    reach, over, margins = 0.0, 0.0, []
    with torch.no_grad():
        for l in range(L - 1):
            if bf16:
                a = TP.mm_bf16(h, ws[l].t()) + bs[l]
                margin = (BF16_MASK_ULP * (TP.bf16_round(h).abs()
                                           @ TP.bf16_round(ws[l]).abs().t())
                          + MASK_MARGIN * float(a.abs().max()))
            else:
                a = torch.nn.functional.linear(h, ws[l], bs[l])
                margin = torch.full_like(a, MASK_MARGIN
                                         * float(a.abs().max()))
            margins.append(float(margin.max()))
            flip = masks[l] != (a > 0)
            flips += int(flip.sum())
            near += int((a.abs() <= margin).sum())
            if flip.any():
                reach = max(reach, float(a[flip].abs().max()))
                over = max(over, float((a[flip].abs()
                                        / margin[flip]).max()))
            h = torch.relu(a)
            del margin
    limit = "no limit" if bf16 else f"at most {MAX_MASK_FLIPS}"
    rule = (f"{BF16_MASK_ULP:g} sum|x w| + {MASK_MARGIN:g} max|a_l|"
            if bf16 else f"{MASK_MARGIN:g} max|a_l|")
    text = (f"of {sum(int(m.numel()) for m in masks)} pre-activations "
            f"({sum(int(m.sum()) for m in masks)} positive), "
            f"{flips} on the other side of 0 in the "
            f"{'bf16 twin' if bf16 else 'f32'} forward ({limit}), all "
            f"within {reach:.3e} of 0 ({over:.3f} of the margin {rule}, at "
            f"most {max(margins):.3e}, inside which {near} lie)")
    if (flips > MAX_MASK_FLIPS and not bf16) or over > 1.0:
        raise AssertionError(f"K3-bwd's ReLU masks differ from the "
                             f"{'bf16 twin' if bf16 else 'f32'} forward's "
                             f"beyond rounding: {text}")
    return masks, text


def bf16_ulps(a, b):
    """|a - b| of two bf16 tensors in units of the larger one's last
    place (8 significant bits)."""
    import torch
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def k2_check(cfg, wn, bn, x, sweep32, own, label) -> float:
    """K2 (narrowed, on K1's f32 slab pack sweep32) at x's rows: within
    1e-5 abs of its f32 and f64 twins (f32 dots of <= 256 terms summed in
    another order), two launches bitwise equal, and bitwise equal to K2
    on its own narrowed pack (``own``; None: not checked).  Returns the
    larger error."""
    import torch
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    got = SK.sdf_forward(wn, bn, cfg, x, sweep32)
    again = SK.sdf_forward(wn, bn, cfg, x, sweep32)
    mine = True if own is None else torch.equal(
        got, SK.sdf_forward(wn, bn, cfg, x, own))
    with torch.no_grad():
        p32 = SK.sdf_forward_plain(wn, bn, cfg, x)
        p64 = SK.sdf_forward_plain([w.double() for w in wn],
                                   [b.double() for b in bn], cfg, x.double())
    torch.cuda.synchronize()
    e32 = worst(got, p32, 1e-5, 0.0)[0]
    e64 = float((got.double() - p64).abs().max())
    same = torch.equal(got, again)
    print(f"K2      {label}: max|sdf err| {e32:.3e} (f32 twin), {e64:.3e} "
          f"(f64 twin), tolerance 1e-5 abs; two launches bitwise equal: "
          f"{same}; on K1's pack bitwise equal to its own narrowed pack: "
          f"{mine if own is not None else 'not checked'}")
    if not max(e32, e64) <= 1e-5 or not (same and mine) or \
            not torch.isfinite(got).all():
        raise AssertionError(f"K2 disagrees with its twins or itself at "
                             f"{label}")
    return max(e32, e64)


def k3_fwd_check(rcfg, rws, rbs, rin, pack, label) -> float:
    """K3-fwd on its f32 slab pack at rin's rows: within 1e-5 abs of its
    f32 and f64 twins (f32 dots of <= 289 terms summed in another order),
    two launches bitwise equal.  Returns the larger error."""
    import torch
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    got = RK.launch_forward(rcfg, rws, rbs, *rin, pack=pack)
    again = RK.launch_forward(rcfg, rws, rbs, *rin, pack=pack)
    with torch.no_grad():
        p32 = RK.radiance_plain(rws, rbs, rcfg, *rin)
        p64 = RK.radiance_plain([w.double() for w in rws],
                                [b.double() for b in rbs], rcfg,
                                *(t.double() for t in rin))
    torch.cuda.synchronize()
    e32 = worst(got, p32, 1e-5, 0.0)[0]
    e64 = float((got.double() - p64).abs().max())
    same = torch.equal(got, again)
    print(f"K3-fwd  {label}: max|rgb err| {e32:.3e} (f32 twin), {e64:.3e} "
          f"(f64 twin), tolerance 1e-5 abs; two launches bitwise equal: "
          f"{same}")
    if not max(e32, e64) <= 1e-5 or not same or \
            not torch.isfinite(got).all():
        raise AssertionError(f"K3-fwd disagrees with its twins or itself "
                             f"at {label}")
    return max(e32, e64)


def check_kernels(device):
    """Each kernel against its plain twin at the wmask step's shapes."""
    import torch
    from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                       RenderingNetwork,
                                                       SDFConfig, SDFNetwork)
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    from factored_neus_tpu_torch.ops import tc_pack as TP
    from factored_neus_tpu_torch.ops.embedder import positional_encoding

    cfg = SDFConfig()                                   # 8 x 256, skip 4
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ins = [w.shape[1] for w in ws]
    outs = [w.shape[0] for w in ws]
    S = sum(i * o for i, o in zip(ins, outs))
    s_last = ins[-1] * outs[-1]
    wbytes = 4 * sum(i * o + o for i, o in zip(ins, outs))
    stash_cols = GK.stash_columns(ws)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(N_CORE, 3, device=device, generator=gen) * 0.5
    results, gflop = [], {}

    def entry(name, source, replaces, err, ms, plain_ms, flops, nbytes):
        """bound_ms (also bound_3xtf32_ms): three TF32 products' worth of
        the FLOPs over the TF32 tensor-core peak, or the bytes over the
        memory rate if larger, as every f32 kernel multiplies on the tensor
        cores in 3xTF32; bound_f32_ms: the same FLOPs over the f32
        CUDA-core peak, for comparison."""
        t_ops, t_bytes = 3 * flops / TF32_PEAK, nbytes / HBM_RATE
        gflop[name] = flops / 1e9
        bound = 1e3 * max(t_ops, t_bytes)
        results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "bound_3xtf32_ms": bound,
            "bound_f32_ms": 1e3 * max(flops / F32_PEAK, t_bytes)})

    # K1-fwd (3xTF32 on wgmma, from its two f32 slab packs, built once as a
    # step does, and shared with K1-bwd): f32 dots of width <= 257 summed
    # in another order than cuBLAS
    fbuild = wgmma_build_report("K1-fwd and K1-fwd-stash",
                                "geometry_fwd_wg.cu",
                                ("geometry_fwd_wgf_sweep",
                                 "geometry_fwd_stash_wgf_sweep"))
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    out_k, grad_k = GK.launch_forward(cfg, x, ws, bs, slabs)
    with torch.no_grad():
        out_p, grad_p = GK.geometry_plain(ws, bs, x, cfg)
    torch.cuda.synchronize()
    e_out, r_out = worst(out_k, out_p, 1e-5, 0.0)
    e_g, r_g = worst(grad_k, grad_p, 1e-5, 0.0)
    print(f"K1-fwd  N={N_CORE}: max|out err| {e_out:.3e}, max|grad err| "
          f"{e_g:.3e} (tolerance 1e-5 abs: reordered f32 sums of <= 257 "
          f"terms)")
    if max(r_out, r_g) > 1.0 or not torch.isfinite(out_k).all():
        raise AssertionError("K1-fwd disagrees with its plain twin")
    fwd_flops = 2 * S + 2 * (S - s_last)
    fwd_bytes = N_CORE * (12 + 4 * outs[-1] + 12) + wbytes

    def plain_fwd():
        with torch.no_grad():
            GK.geometry_plain(ws, bs, x, cfg)
    entry("geometry_fwd", "factored_neus_tpu_torch/csrc/geometry_fwd_wg.cu",
          "factored_neus_tpu/ops/pallas_geometry.py:729",
          max(e_out, e_g),
          cuda_ms(lambda: GK.launch_forward(cfg, x, ws, bs, slabs), 10),
          cuda_ms(lambda: plain_fwd(), 5),
          N_CORE * fwd_flops, fwd_bytes)
    k1f = results[-1]
    fshapes = []
    for n in (N_CORE, N_RAGGED):
        shape, e_n = k1_fwd_wgf_check(cfg, ws, bs, n, fwd_flops, slabs, gen)
        fshapes.append(shape)
        k1f["max_abs_err"] = max(k1f["max_abs_err"], e_n)
    # its slab packs (K1-bwd's, the forward pack with the last layer's
    # slabs appended), built by SDFNetwork.kernel_weights wherever K1 runs
    pack_ms = {"sweep_pack_f32_ms": cuda_ms(lambda: TP.pack_sweep_f32(
                   ws, sorted(SK.skip_layers(cfg, len(ws))), cfg.d_embed),
                   10),
               "rev_pack_f32_ms": cuda_ms(
                   lambda: TP.pack_rev_f32(ws, cfg.d_embed), 10)}
    print(f"K1's f32 slab packs at full width (every f32 K1 kernel reads "
          f"both, K2 the first): {pack_ms['sweep_pack_f32_ms']:.3f} ms "
          f"(forward) + {pack_ms['rev_pack_f32_ms']:.3f} ms (reverse) (CUDA "
          f"events around 10 builds each)")
    k1f.update(shapes=fshapes, sass=fbuild["sass"], ptxas=fbuild["ptxas"],
               attrs=wg_attrs("geometry_fwd_wg.cu", "geometry_fwd_attrs",
                              ("sweep",)), **pack_ms)

    # K1-bwd: adds weight-gradient sums over 131,072 stacked rows.  The
    # reference is the plain twin in float64: in float32 the twin's own
    # summation error (cuBLAS's order over 131,072 rows) is as large as the
    # kernel's, so the f64 twin measures the kernel's error alone.  It runs
    # on wgmma from its two f32 slab packs, built once as a step does.
    build = wgmma_build_report("K1-bwd", "geometry_bwd_wg.cu")
    ct_out = torch.randn(out_p.shape, device=device, generator=gen)
    ct_g = torch.randn(N_CORE, 3, device=device, generator=gen)
    ct_x, dws, dbs = GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs)
    L = len(ws)

    def plain_vjp(dtype):
        """The twin's whole function, as the kernel computes it: the
        forward with its graph, then the VJP of (out, grad)."""
        leaves = [t.to(dtype).clone().requires_grad_(True)
                  for t in [x, *ws, *bs]]
        cts = (ct_out.to(dtype), ct_g.to(dtype))

        def run():
            with torch.enable_grad():
                o, g = GK.geometry_plain(leaves[1:1 + L], leaves[1 + L:],
                                         leaves[0], cfg)
            return torch.autograd.grad((o, g), leaves, cts)
        return run

    ref64 = [r.float() for r in plain_vjp(torch.float64)()]
    plain32 = plain_vjp(torch.float32)
    ref32 = plain32()
    torch.cuda.synchronize()
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    e_b = check_vjp(f"K1-bwd  N={N_CORE}", [ct_x, *dws, *dbs], ref64, ref32,
                    names)
    # the weight-gradient sums run in a fixed order: a second launch gives
    # the same bits
    again = GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs)
    same = all(torch.equal(a, b) for a, b in zip(
        [ct_x, *dws, *dbs], [again[0], *again[1], *again[2]]))
    print(f"K1-bwd  two launches bitwise equal: {same}")
    if not same:
        raise AssertionError("K1-bwd is not deterministic")
    del again, ref32, ref64
    # primal and tangent forward (last layer not needed), the primal's
    # weight gradient and input cotangent, and the tangent's: its seed is
    # e0 / scale, so its last layer is a column of dW and a row of W
    bwd_flops = (4 * (S - s_last) + 2 * S + 2 * S
                 + 2 * (S - s_last) + 2 * ins[-1] + 2 * (S - s_last))
    bwd_bytes = N_CORE * (12 + 4 * outs[-1] + 12 + 12) + 2 * wbytes
    entry("geometry_bwd", "factored_neus_tpu_torch/csrc/geometry_bwd_wg.cu",
          "factored_neus_tpu/ops/pallas_geometry.py:846", e_b,
          cuda_ms(lambda: GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g,
                                             slabs), 5),
          cuda_ms(plain32, 3), N_CORE * bwd_flops, bwd_bytes)
    k1b = results[-1]
    shapes, attrs = [], None
    for n in (N_CORE, N_RAGGED):
        shape, attrs, e_n = k1_bwd_wgf_check(cfg, ws, bs, n, bwd_flops,
                                             slabs, gen)
        shapes.append(shape)
        k1b["max_abs_err"] = max(k1b["max_abs_err"], e_n)
    # what K1-bwd adds to a step besides its kernels: the two slab packs
    # it shares with K1-fwd (timed there)
    k1b.update(shapes=shapes, sass=build["sass"], ptxas=build["ptxas"],
               attrs=attrs, **pack_ms)
    # K1-bwd-split (3xTF32 on wgmma, on K1-bwd's two slab packs): K1-bwd's
    # function, each chain's rows one product, at the step's points and a
    # ragged count (k1_chains_check: the f64 twin, two launches bitwise
    # equal, its bits against K1-bwd's printed)
    chains = "factored_neus_tpu_torch/csrc/geometry_bwd_chains_wg.cu"
    cbuild = wgmma_build_report("K1-bwd-split and K1-bwd-stash",
                                "geometry_bwd_chains_wg.cu",
                                ("geometry_bwd_split", "geometry_bwd_stash",
                                 "geometry_bwd_chains_wgf_wgrad"))
    shapes, e_sp = [], 0.0
    for n in (N_CORE, N_RAGGED):
        shape, e_n = k1_chains_check(cfg, ws, bs, n, bwd_flops, slabs, gen,
                                     stash=False)
        shapes.append(shape)
        e_sp = max(e_sp, e_n)
    entry("geometry_bwd_split", chains,
          "factored_neus_tpu/ops/pallas_geometry.py:529", e_sp,
          cuda_ms(lambda: GK.launch_backward_split(cfg, x, ws, bs, ct_out,
                                                   ct_g, slabs=slabs), 5),
          cuda_ms(plain32, 3), N_CORE * bwd_flops, bwd_bytes)
    results[-1].update(shapes=shapes, attrs=shapes[0]["attrs"],
                       bits_vs_k1_bwd=[s["bits_vs_k1_bwd"] for s in shapes],
                       sass=cbuild["sass"],
                       ptxas=cbuild["ptxas"], **pack_ms)
    del plain32

    # K2 (3xTF32 on wgmma): the ladder's narrowed no-grad sweeps (last
    # layer = sdf column), on K1's f32 slab pack of the same weights as in
    # the step (sweep32), at the two shapes of a step (the first sweep over
    # N_SWEEP points and three of N_SWEEP_NEW) and a ragged one
    k2_build = wgmma_build_report("K2", "sdf_fwd_wg.cu")
    sweep32 = slabs[0]
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    own = SK.make_sweep_pack(cfg, wn, bf16=False)
    S_n = S - s_last + ins[-1]
    k2 = {}
    for n in (N_SWEEP, N_SWEEP_NEW, N_RAGGED):
        xs = x[:n].contiguous()
        e_s = k2_check(cfg, wn, bn, xs, sweep32, own, f"N={n}")
        with torch.no_grad():
            k1_sdf = GK.launch_forward(cfg, xs, ws, bs, slabs)[0][:, 0]
            d_k1 = float((SK.sdf_forward(wn, bn, cfg, xs, sweep32)[:, 0]
                          - k1_sdf).abs().max())
        print(f"K2      N={n}: max|sdf - K1-fwd's sdf| {d_k1:.3e} (printed "
              f"only)")

        def plain_sweep():
            with torch.no_grad():
                SK.sdf_forward_plain(wn, bn, cfg, xs)
        t_ops = n * 2 * S_n / F32_PEAK
        t_bytes = (n * (12 + 4) + 4 * sum(
            w.numel() + b.numel() for w, b in zip(wn, bn))) / HBM_RATE
        k2[n] = {"err": e_s, "k1_sdf_diff": d_k1,
                 "ms": cuda_ms(lambda: SK.sdf_forward(wn, bn, cfg, xs,
                                                      sweep32), 10),
                 "plain_ms": cuda_ms(plain_sweep, 10),
                 "flops": n * 2 * S_n, "bytes": t_bytes * HBM_RATE,
                 "bound_f32_ms": 1e3 * max(t_ops, t_bytes),
                 "bound_3xtf32_ms": 1e3 * max(3 * n * 2 * S_n / TF32_PEAK,
                                              t_bytes)}
    # the full 257-wide output (JAX's full_out=True) at the ragged shape
    xs = x[:N_RAGGED].contiguous()
    full = SK.sdf_forward(ws, bs, cfg, xs, sweep32)
    with torch.no_grad():
        f64 = SK.sdf_forward_plain([w.double() for w in ws],
                                   [b.double() for b in bs], cfg,
                                   xs.double())
        k1_out = GK.launch_forward(cfg, xs, ws, bs, slabs)[0]
    e_full = max(worst(full, SK.sdf_forward_plain(ws, bs, cfg, xs), 1e-5,
                       0.0)[0], float((full.double() - f64).abs().max()))
    same = torch.equal(full, SK.sdf_forward(ws, bs, cfg, xs, sweep32))
    print(f"K2      full output N={N_RAGGED}: max|err| {e_full:.3e} against "
          f"the f32 and f64 twins (1e-5 abs); two launches bitwise equal: "
          f"{same}; max|out - K1-fwd's out| "
          f"{float((full - k1_out).abs().max()):.3e} (printed only)")
    if not e_full <= 1e-5 or not same:
        raise AssertionError("K2's full output disagrees with its twins or "
                             "itself")
    big, small = k2[N_SWEEP], k2[N_SWEEP_NEW]
    entry("sdf_fwd", "factored_neus_tpu_torch/csrc/sdf_fwd_wg.cu",
          "factored_neus_tpu/ops/pallas_sdf.py:221",
          max(big["err"], small["err"], k2[N_RAGGED]["err"], e_full),
          big["ms"], big["plain_ms"], big["flops"], big["bytes"])
    sweeps = 1 + (UP_SAMPLE_STEPS - 1)
    results[-1].update({
        f"ms_{N_SWEEP_NEW}": small["ms"],
        f"plain_ms_{N_SWEEP_NEW}": small["plain_ms"],
        f"bound_f32_ms_{N_SWEEP_NEW}": small["bound_f32_ms"],
        f"bound_3xtf32_ms_{N_SWEEP_NEW}": small["bound_3xtf32_ms"],
        f"ms_{N_RAGGED}": k2[N_RAGGED]["ms"],
        f"bound_3xtf32_ms_{N_RAGGED}": k2[N_RAGGED]["bound_3xtf32_ms"],
        "k1_sdf_diff": max(v["k1_sdf_diff"] for v in k2.values()),
        "step_ms": big["ms"] + (UP_SAMPLE_STEPS - 1) * small["ms"],
        "step_plain_ms": big["plain_ms"] + (UP_SAMPLE_STEPS - 1) *
        small["plain_ms"], "sass": k2_build["sass"],
        "ptxas": k2_build["ptxas"],
        "attrs": wg_attrs("sdf_fwd_wg.cu", "sdf_fwd_attrs", ("sweep",))})
    print(f"K2 per step ({sweeps} sweeps: 1 x {N_SWEEP} + "
          f"{UP_SAMPLE_STEPS - 1} x {N_SWEEP_NEW} rows): "
          f"{results[-1]['step_ms']:.3f} ms (plain "
          f"{results[-1]['step_plain_ms']:.3f}); at {N_SWEEP} rows "
          f"{big['ms']:.3f} ms, {N_SWEEP_NEW} {small['ms']:.3f}, "
          f"{N_RAGGED} {k2[N_RAGGED]['ms']:.3f}, against 3xTF32 bounds "
          f"{big['bound_3xtf32_ms']:.3f}, {small['bound_3xtf32_ms']:.3f}, "
          f"{k2[N_RAGGED]['bound_3xtf32_ms']:.3f}; sweep "
          f"(cudaFuncGetAttributes): {results[-1]['attrs']['sweep']}")
    del own

    # K3-fwd (3xTF32 on wgmma): the radiance MLP of the same N points,
    # f32-accurate dots of width <= 289 summed in another order than
    # cuBLAS; on the forward slab pack a step builds once for K3-fwd and
    # K3-bwd (sweep32)
    k3_build = wgmma_build_report("K3-fwd", "radiance_fwd_wg.cu")
    rcfg = RenderingConfig()                            # 289 -> 4 x 256 -> 3
    rnet = RenderingNetwork(rcfg, torch.Generator().manual_seed(0)).to(
        device)
    with torch.no_grad():
        rws, rbs = rnet.effective_weights()
    d_feat = rcfg.d_feature
    rin = [x, torch.randn(N_CORE, 3, device=device, generator=gen),
           torch.nn.functional.normalize(
               torch.randn(N_CORE, 3, device=device, generator=gen), dim=-1),
           torch.randn(N_CORE, d_feat, device=device, generator=gen) * 0.5]
    rS = sum(w.numel() for w in rws)                   # 271,360
    rwbytes = 4 * sum(w.numel() + b.numel() for w, b in zip(rws, rbs))
    rslabs = RK.make_bwd_slabs(rcfg, rws, bf16=False)
    rpack = rslabs[0]
    e_r = k3_fwd_check(rcfg, rws, rbs, rin, rpack, f"N={N_CORE}")
    rgb_p = RK.radiance_plain(rws, rbs, rcfg, *rin).detach()
    rag = [t[:N_RAGGED].contiguous() for t in rin]
    e_r = max(e_r, k3_fwd_check(rcfg, rws, rbs, rag, rpack,
                                f"N={N_RAGGED}"))

    def plain_rad():
        with torch.no_grad():
            RK.radiance_plain(rws, rbs, rcfg, *rin)
    entry("radiance_fwd", "factored_neus_tpu_torch/csrc/radiance_fwd_wg.cu",
          "factored_neus_tpu/ops/pallas_radiance.py:209", e_r,
          cuda_ms(lambda: RK.launch_forward(rcfg, rws, rbs, *rin,
                                            pack=rpack), 10),
          cuda_ms(plain_rad, 10), N_CORE * 2 * rS,
          N_CORE * 4 * (9 + d_feat + 3) + rwbytes)
    results[-1].update({
        "pack_ms": cuda_ms(lambda: RK.make_fwd_pack(rcfg, rws), 10),
        f"ms_{N_RAGGED}": cuda_ms(lambda: RK.launch_forward(
            rcfg, rws, rbs, *rag, pack=rpack), 20),
        f"bound_3xtf32_ms_{N_RAGGED}": 1e3 * 3 * N_RAGGED * 2 * rS
        / TF32_PEAK, "sass": k3_build["sass"], "ptxas": k3_build["ptxas"],
        "attrs": wg_attrs("radiance_fwd_wg.cu", "radiance_fwd_attrs",
                          ("sweep",))})
    print(f"K3-fwd  N={N_RAGGED}: {results[-1][f'ms_{N_RAGGED}']:.3f} ms "
          f"against its 3xTF32 bound "
          f"{results[-1][f'bound_3xtf32_ms_{N_RAGGED}']:.3f}; its pack "
          f"{results[-1]['pack_ms']:.3f} ms; sweep "
          f"(cudaFuncGetAttributes): {results[-1]['attrs']['sweep']}")

    # K3-bwd (3xTF32 on wgmma, from its two f32 slab packs, built once as
    # a step does): dW and db sum 65,536 rows; against the f64 twin as
    # K1-bwd, with the ReLU masks of the kernel's own forward, held against
    # the f32 forward's (k3_bwd_masks)
    rbuild = wgmma_build_report("K3-bwd", "radiance_bwd_wg.cu")
    ct_rgb = torch.randn(rgb_p.shape, device=device, generator=gen)
    *rcts, rdws, rdbs = RK.launch_backward(rcfg, rws, rbs, *rin, ct_rgb,
                                           pack=rslabs)
    rL = len(rws)
    masks, text = k3_bwd_masks(rcfg, rws, rbs, rin)
    print(f"K3-bwd  ReLU masks of its own forward: {text}")

    def x0(pts, normals, dirs, feat):
        return torch.cat([pts, positional_encoding(dirs, rcfg.multires_view),
                          normals, feat], -1)

    def rad_pinned(ws_, bs_, *inputs):
        h = x0(*inputs)
        for l, (w, b) in enumerate(zip(ws_, bs_)):
            h = torch.nn.functional.linear(h, w, b)
            if l < rL - 1:
                h = h * masks[l].to(h.dtype)
        return torch.sigmoid(h)

    def plain_rad_vjp(dtype, fn):
        leaves = [t.to(dtype).clone().requires_grad_(True)
                  for t in [*rin, *rws, *rbs]]

        def run():
            with torch.enable_grad():
                rgb = fn(leaves[4:4 + rL], leaves[4 + rL:], *leaves[:4])
            return torch.autograd.grad(rgb, leaves, ct_rgb.to(dtype))
        return run

    ref64 = [r.float() for r in plain_rad_vjp(torch.float64, rad_pinned)()]
    ref32 = plain_rad_vjp(torch.float32, rad_pinned)()
    rplain32 = plain_rad_vjp(torch.float32, lambda w, b, *a:
                             RK.radiance_plain(w, b, rcfg, *a))
    torch.cuda.synchronize()
    rnames = ["ct_pts", "ct_normals", "ct_dirs", "ct_feat"] + [
        f"dW{l}" for l in range(rL)] + [f"db{l}" for l in range(rL)]
    e_rb = check_vjp(f"K3-bwd  N={N_CORE}", [*rcts, *rdws, *rdbs], ref64,
                     ref32, rnames)
    del ref32, ref64
    again = RK.launch_backward(rcfg, rws, rbs, *rin, ct_rgb, pack=rslabs)
    same = all(torch.equal(a, b) for a, b in zip(
        [*rcts, *rdws, *rdbs], [*again[:4], *again[4], *again[5]]))
    print(f"K3-bwd  two launches bitwise equal: {same}")
    if not same:
        raise AssertionError("K3-bwd is not deterministic")
    del again, rpack
    rbwd_flops = 6 * rS
    entry("radiance_bwd", "factored_neus_tpu_torch/csrc/radiance_bwd_wg.cu",
          "factored_neus_tpu/ops/pallas_radiance.py:227", e_rb,
          cuda_ms(lambda: RK.launch_backward(rcfg, rws, rbs, *rin, ct_rgb,
                                             pack=rslabs), 5),
          cuda_ms(rplain32, 5), N_CORE * rbwd_flops,
          N_CORE * 4 * (2 * (9 + d_feat) + 3) + 2 * rwbytes)
    del rplain32
    k3b = results[-1]
    shapes, attrs = [], None
    for n in (N_CORE, N_RAGGED):
        shape, attrs, e_n = k3_bwd_wgf_check(rcfg, rws, rbs, n, rbwd_flops,
                                             rslabs, gen)
        shapes.append(shape)
        k3b["max_abs_err"] = max(k3b["max_abs_err"], e_n)
    # what K3-bwd adds to a step besides its kernels: its two slab packs,
    # built by RenderingNetwork.kernel_weights beside the 3xTF32 pack
    rpack_ms = {"sweep_pack_f32_ms": cuda_ms(lambda: TP.pack_rad_sweep_f32(
                    rws, 6 + rcfg.d_view), 10),
                "rev_pack_f32_ms": cuda_ms(lambda: TP.pack_rad_rev_f32(
                    rws, 6 + rcfg.d_view), 10)}
    print(f"K3-bwd's slab packs at full width: "
          f"{rpack_ms['sweep_pack_f32_ms']:.3f} ms (forward) + "
          f"{rpack_ms['rev_pack_f32_ms']:.3f} ms (reverse) (CUDA events "
          f"around 10 builds each)")
    k3b.update(shapes=shapes, sass=rbuild["sass"], ptxas=rbuild["ptxas"],
               attrs=attrs, **rpack_ms)
    del rslabs

    # K1-fwd-stash (3xTF32 on wgmma: K1-fwd's sweep, which also stores the
    # bf16 stash, on K1-fwd's slab packs): its (out, grad) against the twin
    # at 1e-5 abs, the stash entry by entry (equal, one bf16 ulp apart
    # where the two f32 sums round to neighbours, or within 1e-5 near
    # zero), and out and grad K1-fwd's bit for bit at the step's points
    # and a ragged count (k1_fwd_stash_bits)
    out_k, grad_k, st_k = GK.launch_forward_stash(cfg, x, ws, bs, slabs)
    out_p, grad_p, st_p = GK.geometry_fwd_stash_plain(ws, bs, x, cfg)
    torch.cuda.synchronize()
    e_out, r_out = worst(out_k, out_p, 1e-5, 0.0)
    e_g, r_g = worst(grad_k, grad_p, 1e-5, 0.0)
    ulps = bf16_ulps(st_k, st_p)
    d_st = (st_k.float() - st_p.float()).abs()
    n1 = int((ulps == 1.0).sum())
    bad = int(((ulps > 1.0) & (d_st > 1e-5)).sum())
    print(f"K1-fwd-stash N={N_CORE}: max|out err| {e_out:.3e}, max|grad "
          f"err| {e_g:.3e} (1e-5 abs); stash [{N_CORE}, {stash_cols}] bf16: "
          f"{int((ulps == 0).sum())} entries equal, {n1} one ulp apart, "
          f"{int((ulps > 1.0).sum())} further apart but within 1e-5 (max "
          f"{float(d_st.max()):.3e}), {bad} outside both")
    if max(r_out, r_g) > 1.0 or bad:
        raise AssertionError("K1-fwd-stash disagrees with its plain twin")
    del out_p, grad_p, st_p, ulps, d_st
    sshapes = [k1_fwd_stash_bits(cfg, ws, bs, n, slabs, fwd_flops)
               for n in (N_CORE, N_RAGGED)]

    def plain_fwd_stash():
        GK.geometry_fwd_stash_plain(ws, bs, x, cfg)
    stash_bytes = N_CORE * 2 * stash_cols
    entry("geometry_fwd_stash",
          "factored_neus_tpu_torch/csrc/geometry_fwd_wg.cu",
          "factored_neus_tpu/ops/pallas_geometry.py:764", max(e_out, e_g),
          cuda_ms(lambda: GK.launch_forward_stash(cfg, x, ws, bs, slabs), 10),
          cuda_ms(plain_fwd_stash, 5), N_CORE * fwd_flops,
          fwd_bytes + stash_bytes)
    results[-1].update(shapes=sshapes, sass=fbuild["sass"],
                       ptxas=fbuild["ptxas"],
                       bits_vs_k1_fwd=[sh["bits_vs_k1_fwd"] for sh in sshapes],
                       attrs=wg_attrs("geometry_fwd_wg.cu",
                                      "geometry_fwd_stash_attrs",
                                      ("sweep",)), **pack_ms)

    # K1-bwd-stash (3xTF32 on wgmma, on K1-bwd's two slab packs): the
    # primal from K1-fwd-stash's stash, at the step's points and a ragged
    # count (k1_chains_check: its f64 twin fed the same bf16 stash, two
    # launches bitwise equal)
    stash_flops = bwd_flops - 2 * (S - s_last)
    shapes, e_sb = [], 0.0
    for n in (N_CORE, N_RAGGED):
        shape, e_n = k1_chains_check(cfg, ws, bs, n, stash_flops, slabs,
                                     gen, stash=True)
        shapes.append(shape)
        e_sb = max(e_sb, e_n)

    def splain32():
        GK.geometry_bwd_stash_plain(ws, x, st_k, ct_out, ct_g, cfg)
    entry("geometry_bwd_stash", chains,
          "factored_neus_tpu/ops/pallas_geometry.py:797", e_sb,
          cuda_ms(lambda: GK.launch_backward_stash(cfg, x, ws, st_k, ct_out,
                                                   ct_g, slabs=slabs), 5),
          cuda_ms(splain32, 3), N_CORE * stash_flops,
          bwd_bytes + stash_bytes)
    results[-1].update(shapes=shapes, attrs=shapes[0]["attrs"],
                       sass=cbuild["sass"],
                       ptxas=cbuild["ptxas"], **pack_ms)
    del st_k

    for r in results:
        f32 = r["bound_f32_ms"]
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
              f"ms) for {gflop[r['name']]:.1f} GFLOP, 3xTF32 tensor-core "
              f"bound {r['bound_ms']:.3f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of it); f32 CUDA-core "
              f"bound {f32:.3f} ms ({100 * f32 / r['ms']:.1f}% of it)")
    return results


def wg_attrs(src: str, symbol: str, kernels=("sweep", "wgrad")) -> dict:
    """A wgmma kernel's sweep and weight-gradient kernels (``kernels``:
    which of them the source has, in its ``symbol``'s order) as the device
    holds them after a launch (cudaFuncGetAttributes through the source's
    ``symbol``, its entry point's name with ``_attrs`` appended):
    registers a thread, dynamic shared memory a block as the launcher set
    it, static shared memory."""
    import ctypes
    from factored_neus_tpu_torch.ops import _cuda
    out = (ctypes.c_int * (3 * len(kernels)))()
    rc = getattr(_cuda._load(src), symbol)(out)
    if rc:
        raise RuntimeError(f"{symbol}: cudaError {rc}")
    return {k: {"regs": out[3 * i], "dynamic_smem": out[3 * i + 1],
                "static_smem": out[3 * i + 2]}
            for i, k in enumerate(kernels)}


def wg_shape(label, n, run, plain, bound_ms, plan, design, src,
             symbol, bound_name="bf16") -> tuple:
    """A wgmma backward at n rows: its time and its twin's (CUDA events)
    and its bound (``bound_name``: bf16, or 3xTF32), for the kernels line; printed beside them, the
    kernels' registers and shared memory as the device holds them
    (wg_attrs), the launch plan, and the bytes the design moves to and
    from device memory by the reckoning of its source note (``design``),
    a count, not a measurement."""
    import torch

    def twin():
        with torch.no_grad():
            plain()
    shape = {"rows": n, "ms": cuda_ms(run, 5),
             "plain_ms": cuda_ms(twin, 3), "bound_ms": bound_ms}
    attrs = wg_attrs(src, symbol)
    print(f"  {label} (wgmma) N={n}: {shape['ms']:.3f} ms (plain "
          f"{shape['plain_ms']:.3f} ms), {bound_name} bound "
          f"{shape['bound_ms']:.3f}"
          f" ms ({100 * shape['bound_ms'] / shape['ms']:.1f}% of it); by the "
          f"source note's reckoning the design moves {design / 1e9:.2f} GB "
          f"to and from device memory; {plan['grid']} sweep blocks of "
          f"{plan['nc']} consumers, {plan['units']} weight-gradient units x "
          f"{plan['chunks']} chunks of {plan['per']} tiles")
    for k, a in attrs.items():
        print(f"  {label} {k} kernel (cudaFuncGetAttributes): "
              f"{a['regs']} registers a thread, {a['dynamic_smem']} B "
              f"dynamic + {a['static_smem']} B static shared memory a block "
              f"(the plan's count: {plan[k + '_smem']} B)")
    return shape, attrs


def k1_fwd_wgf_check(cfg, ws, bs, n, fwd_flops, slabs, gen) -> tuple:
    """K1-fwd (3xTF32 on wgmma) at n points: (out, grad) against the f32
    twin at 1e-5 abs with two launches bitwise equal, its time and its
    twin's (CUDA events) against its 3xTF32 bound, the plan, the sweep's
    registers and shared memory as the device holds them, and the bytes of
    its design (geometry_fwd_wg.cu's note: the scratch of sigma(100 a)
    written and read, the points read, out and grad written), a count, not
    a measurement.  Returns (shape, max |err|)."""
    import torch
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    dev = ws[0].device
    x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
    run = lambda: GK.launch_forward(cfg, x, ws, bs, slabs)
    got, again = run(), run()
    with torch.no_grad():
        want = GK.geometry_plain(ws, bs, x, cfg)
    torch.cuda.synchronize()
    e, r = max(worst(a, b, 1e-5, 0.0) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"K1-fwd (wgmma) N={n}: max|err| {e:.3e} against the f32 twin "
          f"(1e-5 abs); two launches bitwise equal: {same}")
    if r > 1.0 or not same or not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"K1-fwd disagrees with its twin or itself at "
                             f"{n} points")
    del got, again, want

    def twin():
        with torch.no_grad():
            GK.geometry_plain(ws, bs, x, cfg)
    plan = GK.fwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
    L = len(ws)
    design = (2 * plan["tiles"] * (L - 1) * 64 * 256 * 4
              + n * 4 * (3 + ws[-1].shape[0] + 3))
    # every slab of the forward pack and the reverse pack's layers 0 ..
    # L - 2 a tile (the last layer's reverse slabs are not streamed)
    (_, flay), (_, rlay) = slabs
    stream = plan["tiles"] * (flay.nbytes + rlay.off[L - 1])
    shape = {"rows": n, "ms": cuda_ms(run, 5 if n >= N_CORE else 20),
             "plain_ms": cuda_ms(twin, 3),
             "bound_ms": 1e3 * n * 3 * fwd_flops / TF32_PEAK,
             "max_abs_err": e, "design_bytes": design,
             "slab_stream_bytes": stream}
    attrs = wg_attrs("geometry_fwd_wg.cu", "geometry_fwd_attrs",
                     ("sweep",))["sweep"]
    print(f"  K1-fwd (wgmma) N={n}: {shape['ms']:.3f} ms (plain "
          f"{shape['plain_ms']:.3f} ms), 3xTF32 bound {shape['bound_ms']:.3f}"
          f" ms ({100 * shape['bound_ms'] / shape['ms']:.1f}% of it); by the "
          f"source note's reckoning the design moves {design / 1e9:.2f} GB "
          f"to and from device memory and streams {stream / 1e9:.2f} GB of "
          f"slabs from L2; {plan['grid']} sweep blocks; sweep "
          f"(cudaFuncGetAttributes): {attrs['regs']} registers a thread, "
          f"{attrs['dynamic_smem']} B dynamic + {attrs['static_smem']} B "
          f"static shared memory a block (the plan's count: "
          f"{plan['sweep_smem']} B)")
    return shape, e


def k1_fwd_stash_bits(cfg, ws, bs, n, slabs, fwd_flops,
                      bf16: bool = False) -> dict:
    """K1-fwd-stash (``bf16``: K1-fwd-stash-bf16) at n random points (a
    generator of their own: the other checks' draws stay as they were): its
    out and grad against K1-fwd's (K1-fwd-bf16's) on the same inputs and
    slab packs, which must be equal bit for bit (the same sweep, the stash
    a side output), two launches bitwise equal, stash included; its time
    beside K1-fwd's (CUDA events) and its bound, 3xTF32 or bf16, by
    operations.  Raises otherwise; returns the shape's entry."""
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    dev = ws[0].device
    gen = torch.Generator(device=dev).manual_seed(22 + n)
    x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
    run = lambda: GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)
    fwd = lambda: GK.launch_forward(cfg, x, ws, bs, slabs, bf16)
    got, again, k1 = run(), run(), fwd()
    torch.cuda.synchronize()
    bits = torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    name = "K1-fwd-stash-bf16" if bf16 else "K1-fwd-stash"
    print(f"{name} (wgmma) N={n}: out and grad bit for bit "
          f"{'K1-fwd-bf16' if bf16 else 'K1-fwd'}'s on the same inputs: "
          f"{bits}; two launches bitwise equal: {same}")
    if not (bits and same):
        raise AssertionError(f"{name} is not its forward's sweep bit for "
                             f"bit, or not deterministic, at {n} points")
    del got, again, k1
    reps = 10 if n >= N_CORE else 20
    bound = 1e3 * n * (fwd_flops / BF16_PEAK if bf16
                       else 3 * fwd_flops / TF32_PEAK)
    shape = {"rows": n, "ms": cuda_ms(run, reps),
             "fwd_ms": cuda_ms(fwd, reps), "bound_ms": bound,
             "bits_vs_k1_fwd": bits}
    print(f"  {name} (wgmma) N={n}: {shape['ms']:.3f} ms, its forward "
          f"{shape['fwd_ms']:.3f} ms, {'bf16' if bf16 else '3xTF32'} bound "
          f"{bound:.3f} ms ({100 * bound / shape['ms']:.1f}% of it)")
    return shape


def k1_bwd_wg_shape(cfg, ws, n, run, plain, bwd_flops, slabs) -> tuple:
    """K1-bwd-bf16 (on wgmma) at n points (wg_shape); the design's bytes:
    the f32 scratch written and read, each tile's X_l and R_l images
    written, then read by the weight-gradient pass, R_l once for each of
    its units (geometry_bwd_bf16_wg.cu's note)."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    dev = ws[0].device
    plan = GK.bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
    ins = [w.shape[1] for w in ws]
    outs = [w.shape[0] for w in ws]
    L, tiles, blk = len(ws), plan["tiles"], GK.WG_BLOCK
    scratch = 2 * tiles * (L - 1) * 2 * GK.WG_POINTS * 256 * 4
    x_img = [(4 if l else 1) * blk for l in range(L)]
    r_img = [(5 if o > 256 else 4) * blk for o in outs]
    written = tiles * (sum(x_img) + sum(r_img))
    read = tiles * sum(-(-i // 64) * blk + (-(-i // 64) + 1) // 2 * r
                       for i, r in zip(ins, r_img))
    return wg_shape("K1-bwd-bf16", n, run, plain,
                    1e3 * n * bwd_flops / BF16_PEAK, plan,
                    scratch + written + read, "geometry_bwd_bf16_wg.cu",
                    "geometry_bwd_bf16_attrs")


def wg16_fwd_shape(label, n, run, plain, bound_ms, plan, design, src,
                   symbol) -> tuple:
    """A bf16 wgmma forward (K1-fwd-bf16, K3-fwd-bf16) at n rows: its time
    and its twin's (CUDA events) against its bf16 bound, for the kernels
    line; printed beside them, the sweep's registers and shared memory as
    the device holds them (wg_attrs through ``symbol``), the launch plan,
    and the bytes the design moves to and from device memory by the
    reckoning of its source note (``design``), a count, not a
    measurement."""
    import torch

    def twin():
        with torch.no_grad():
            plain()
    shape = {"rows": n, "ms": cuda_ms(run, 5 if n >= N_CORE else 20),
             "plain_ms": cuda_ms(twin, 3), "bound_ms": bound_ms,
             "design_bytes": design}
    attrs = wg_attrs(src, symbol, ("sweep",))["sweep"]
    print(f"  {label} (wgmma) N={n}: {shape['ms']:.3f} ms (plain "
          f"{shape['plain_ms']:.3f} ms), bf16 bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / shape['ms']:.1f}% of it); by the source "
          f"note's reckoning the design moves {design / 1e9:.3f} GB to and "
          f"from device memory; {plan['grid']} sweep blocks of {plan['nc']} "
          f"consumers, {plan['n_pass']} passes; sweep "
          f"(cudaFuncGetAttributes): {attrs['regs']} registers a thread, "
          f"{attrs['dynamic_smem']} B dynamic + {attrs['static_smem']} B "
          f"static shared memory a block (the plan's count: "
          f"{plan['sweep_smem']} B)")
    if attrs["dynamic_smem"] != plan["sweep_smem"]:
        raise AssertionError(f"{label}: the launcher's shared memory is not "
                             f"the plan's")
    return shape, attrs


def k1_fwd_bf16_shape(cfg, ws, bs, x, run, fwd_flops, slabs) -> tuple:
    """K1-fwd-bf16 at x's rows (wg16_fwd_shape); the design's bytes: the
    f32 scratch of sigma(100 a) written and read, the points read, out and
    grad written (geometry_fwd_bf16_wg.cu's note)."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    n, L = x.shape[0], len(ws)
    plan = GK.fwd_wg16_plan(cfg, ws, n, slabs, _cuda.sm_count(x.device))
    design = (2 * plan["tiles"] * (L - 1) * 64 * 256 * 4
              + n * 4 * (3 + ws[-1].shape[0] + 3))
    return wg16_fwd_shape(
        "K1-fwd-bf16", n, run,
        lambda: GK.geometry_plain(ws, bs, x, cfg, bf16=True),
        1e3 * n * fwd_flops / BF16_PEAK, plan, design,
        "geometry_fwd_bf16_wg.cu", "geometry_fwd_bf16_attrs")


def k1_bwd_held(cfg, ws, bs, n, slabs, gen, kind, bf16=False) -> dict:
    """A K1 backward on wgmma (``kind``: "stacked" K1-bwd, "split"
    K1-bwd-split, "stash" K1-bwd-stash; ``bf16``: its bf16 variant) at n
    points on random inputs from gen, the part that k1_bwd_wgf_check and
    k1_chains_check share: against its f64 twin (the stash's fed the stash
    K1-fwd-stash, or K1-fwd-stash-bf16, writes for the same points), beside
    its f32 twin (check_vjp) or its bf16 twin (check_flips), two launches
    bitwise equal; the split's ct_x, dW and db against the stacked
    kernel's on the same inputs, bit for bit or not (printed only).
    Returns {"name", "run" (a launch), "plain" (the f32 or bf16 twin),
    "err" (max |err|), "bits"}."""
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    name = {"stacked": "K1-bwd", "split": "K1-bwd-split",
            "stash": "K1-bwd-stash"}[kind] + ("-bf16" if bf16 else "")
    dev = ws[0].device
    x = torch.randn(n, 3, device=dev, generator=gen) * 0.5
    ct_out = torch.randn(n, ws[-1].shape[0], device=dev, generator=gen)
    ct_g = torch.randn(n, 3, device=dev, generator=gen)
    flat = lambda r: [r[0], *r[1], *r[2]]
    L = len(ws)
    names = ["ct_x"] + [f"dW{l}" for l in range(L)] + [
        f"db{l}" for l in range(L)]
    if kind == "stash":
        st = GK.launch_forward_stash(cfg, x, ws, bs, slabs, bf16)[2]
        run = lambda: flat(GK.launch_backward_stash(cfg, x, ws, st, ct_out,
                                                    ct_g, slabs, bf16))
        twin = lambda dt, b16: flat(GK.geometry_bwd_stash_plain(
            [w.to(dt) for w in ws], x.to(dt), st, ct_out.to(dt),
            ct_g.to(dt), cfg, b16))
    else:
        launch = (GK.launch_backward if kind == "stacked"
                  else GK.launch_backward_split)
        run = lambda: flat(launch(cfg, x, ws, bs, ct_out, ct_g, slabs, bf16))
        twin = lambda dt, b16: flat(GK.geometry_bwd_plain(
            [w.to(dt) for w in ws], [b.to(dt) for b in bs], x.to(dt),
            ct_out.to(dt), ct_g.to(dt), cfg, b16))
    got, again = run(), run()
    torch.cuda.synchronize()
    ref64 = [t.float() for t in twin(torch.float64, False)]
    if bf16:
        e = check_flips(f"{name} (wgmma) N={n}", got,
                        twin(torch.float32, True), ref64, names)
    else:
        e = check_vjp(f"{name} (wgmma) N={n}", got, ref64,
                      twin(torch.float32, False), names)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{name} (wgmma) N={n}: two launches bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{name} is not deterministic")
    bits = None
    if kind == "split":
        k1 = flat(GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g, slabs,
                                     bf16))
        eq = [torch.equal(a, b) for a, b in zip(got, k1)]
        bits = {"ct_x": eq[0], "dW": all(eq[1:1 + L]), "db": all(eq[1 + L:])}
        print(f"{name} (wgmma) N={n}: bit for bit "
              f"{'K1-bwd-bf16' if bf16 else 'K1-bwd'}'s on the same inputs: "
              f"ct_x {bits['ct_x']}, dW {bits['dW']}, db {bits['db']} "
              f"(printed only)")
        del k1
    return {"name": name, "run": run, "err": e, "bits": bits,
            "plain": lambda: twin(torch.float32, bf16)}


def k1_bwd_wgf_check(cfg, ws, bs, n, bwd_flops, slabs, gen) -> tuple:
    """K1-bwd (3xTF32 on wgmma) at n points: k1_bwd_held (the f64 twin,
    check_vjp, two launches bitwise equal), then wg_shape's times against
    its 3xTF32 bound, attributes and the bytes of its design: the f32
    scratch written and read, each tile's X_l and R_l images written, then
    read by the weight-gradient pass, X_l once for each R half and R_l once
    for each X pair, the slots and db slots (geometry_bwd_wg.cu's note).
    Returns (shape, attrs, max |err|)."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    dev = ws[0].device
    held = k1_bwd_held(cfg, ws, bs, n, slabs, gen, "stacked")
    L = len(ws)
    plan = GK.bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
    tiles, cx = plan["tiles"], [64] + [256] * (L - 1)
    cr = [264 if w.shape[0] > 256 else 256 for w in ws]
    scratch = 2 * tiles * (L - 1) * 16 * 256 * 16
    written = plan["image_bytes"]
    read = tiles * 4 * sum(2 * 2 * c * 32 + -(-c // 128) * 2 * r * 32
                           for c, r in zip(cx, cr))
    slots = 4 * (2 * plan["slot_floats"] + 2 * plan["db_floats"])
    shape, attrs = wg_shape("K1-bwd", n, held["run"], held["plain"],
                            1e3 * n * 3 * bwd_flops / TF32_PEAK, plan,
                            scratch + written + read + slots,
                            "geometry_bwd_wg.cu", "geometry_bwd_attrs",
                            "3xTF32")
    shape["max_abs_err"] = held["err"]
    return shape, attrs, held["err"]


def k1_chains_check(cfg, ws, bs, n, flops, slabs, gen, stash,
                    bf16=False) -> tuple:
    """K1-bwd-split (``stash`` False) or K1-bwd-stash (3xTF32 on wgmma,
    geometry_bwd_chains_wg.cu; ``bf16``: their bf16 variants on bf16
    wgmma, geometry_bwd_chains_bf16_wg.cu) at n points: k1_bwd_held (the
    f64 twin, check_vjp or check_flips, two launches bitwise equal, the
    split's bits against the stacked kernel's printed); then wg_shape's
    times against its 3xTF32 or bf16 bound (``flops`` a point), attributes
    and the bytes of its design: the f32 scratch written and read, the
    images written and read by the stacked kernel's pass, the stash read,
    the slots and db slots (the source note's reckoning), a count, not a
    measurement.  Returns (shape, max |err|)."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    dev = ws[0].device
    held = k1_bwd_held(cfg, ws, bs, n, slabs, gen,
                       "stash" if stash else "split", bf16)
    L = len(ws)
    sms = _cuda.sm_count(dev)
    k1_tiles, blk = -(-n // GK.WG_POINTS), GK.WG_BLOCK
    if bf16:
        plan = GK.chains_wg16_plan(cfg, ws, n, slabs, sms, stash)
        scratch = 2 * plan["tiles"] * (L - 1) * 2 * 32 * 128 * 16
        read = k1_tiles * sum(
            -(-w.shape[1] // 64) * blk + (-(-w.shape[1] // 64) + 1) // 2 * (
                5 if w.shape[0] > 256 else 4) * blk for w in ws)
        bound = 1e3 * n * flops / BF16_PEAK
    else:
        plan = GK.chains_wg_plan(cfg, ws, n, slabs, sms, stash)
        cx = [64] + [256] * (L - 1)
        cr = [264 if w.shape[0] > 256 else 256 for w in ws]
        scratch = 2 * plan["tiles"] * (L - 1) * GK.WGF_CHAIN_SQ * 256 * 16
        read = k1_tiles * 4 * sum(2 * 2 * c * 32 + -(-c // 128) * 2 * r * 32
                                  for c, r in zip(cx, cr))
        bound = 1e3 * n * 3 * flops / TF32_PEAK
    slots = 4 * (2 * plan["slot_floats"] + 2 * plan["db_floats"])
    design = (scratch + plan["image_bytes"] + read + slots
              + (n * 2 * GK.stash_columns(ws) if stash else 0))
    src = "geometry_bwd_chains_bf16_wg.cu" if bf16 else \
        "geometry_bwd_chains_wg.cu"
    symbol = (f"geometry_bwd_{'stash' if stash else 'split'}"
              f"{'_bf16' if bf16 else ''}_attrs")
    print(f"  {held['name']} (wgmma) N={n}: {n * flops / 1e9:.1f} GFLOP "
          f"({flops} a point) over the {'bf16' if bf16 else '3xTF32'} "
          f"peak; the design's {design / 1e9:.2f} GB over {HBM_RATE / 1e12} "
          f"TB/s: {1e3 * design / HBM_RATE:.3f} ms")
    shape, attrs = wg_shape(held["name"], n, held["run"], held["plain"],
                            bound, plan, design, src, symbol,
                            "bf16" if bf16 else "3xTF32")
    shape.update(max_abs_err=held["err"], attrs=attrs,
                 bits_vs_k1_bwd=held["bits"], design_bytes=design)
    return shape, held["err"]


def k3_bwd_wgf_check(cfg, ws, bs, n, bwd_flops, slabs, gen) -> tuple:
    """K3-bwd (3xTF32 on wgmma) at n rows: against the f64 twin (check_vjp)
    on the ReLU masks of its own forward (k3_bwd_masks) with two launches
    bitwise equal, then wg_shape's times against its 3xTF32 bound,
    attributes and the bytes of its design: each tile's X_l and R_l
    images written, then read by the weight-gradient pass, X_l once for
    each R half and R_l once for each X pair, the inputs read and the
    cotangents written once, the slots and db slots (radiance_bwd_wg.cu's
    note).  Returns (shape, attrs, max |err|)."""
    import torch
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    dev = ws[0].device
    inputs = [torch.randn(n, 3, device=dev, generator=gen) * 0.5,
              torch.randn(n, 3, device=dev, generator=gen),
              torch.nn.functional.normalize(
                  torch.randn(n, 3, device=dev, generator=gen), dim=-1),
              torch.randn(n, cfg.d_feature, device=dev, generator=gen) * 0.5]
    ct = torch.randn(n, cfg.d_out, device=dev, generator=gen)
    flat = lambda r: [*r[:4], *r[4], *r[5]]
    L = len(ws)
    names = ["ct_pts", "ct_normals", "ct_dirs", "ct_feat"] + [
        f"dW{l}" for l in range(L)] + [f"db{l}" for l in range(L)]
    run = lambda: flat(RK.launch_backward(cfg, ws, bs, *inputs, ct,
                                          pack=slabs))
    got, again = run(), run()
    masks, text = k3_bwd_masks(cfg, ws, bs, inputs)
    print(f"K3-bwd (wgmma) N={n}: ReLU masks of its own forward: {text}")
    torch.cuda.synchronize()
    ref64 = [t.float() for t in flat(RK.radiance_bwd_plain(
        [w.double() for w in ws], [b.double() for b in bs], cfg,
        *(v.double() for v in inputs), ct.double(), masks=masks))]
    ref32 = flat(RK.radiance_bwd_plain(ws, bs, cfg, *inputs, ct,
                                       masks=masks))
    e = check_vjp(f"K3-bwd (wgmma) N={n}", got, ref64, ref32, names)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"K3-bwd (wgmma) N={n}: two launches bitwise equal: {same}")
    if not same:
        raise AssertionError("K3-bwd is not deterministic")
    del got, again, ref64, ref32, masks
    plan = RK.bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
    tiles = plan["tiles"]
    cx, cr = [320] + [256] * (L - 1), [256] * (L - 1) + [8]
    written = plan["image_bytes"]
    read = tiles * 4 * 64 * sum((2 if r > 128 else 1) * x + -(-x // 128) * r
                                for x, r in zip(cx, cr))
    io = n * 4 * (2 * (9 + cfg.d_feature) + cfg.d_out)
    slots = 4 * (2 * plan["slot_floats"] + 2 * plan["db_floats"])
    shape, attrs = wg_shape("K3-bwd", n, run, lambda: RK.radiance_bwd_plain(
        ws, bs, cfg, *inputs, ct), 1e3 * n * 3 * bwd_flops / TF32_PEAK, plan,
        written + read + io + slots, "radiance_bwd_wg.cu",
        "radiance_bwd_attrs", "3xTF32")
    shape["max_abs_err"] = e
    return shape, attrs, e


def k3_bwd_wg_shape(cfg, ws, n, run, plain, bwd_flops, slabs) -> tuple:
    """K3-bwd-bf16 (on wgmma) at n rows (wg_shape); the design's bytes:
    each tile's X_l and R_l images written, then read by the
    weight-gradient pass, X_l once and R_l once for each of its units,
    the inputs read and the cotangents written once
    (radiance_bwd_bf16_wg.cu's note)."""
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    dev = ws[0].device
    plan = RK.bwd_wg_plan(cfg, ws, n, slabs, _cuda.sm_count(dev))
    ins = [w.shape[1] for w in ws]
    L, tiles, blk = len(ws), plan["tiles"], RK.WG_BLOCK
    x_img = [(4 if l else 5) * blk for l in range(L)]
    r_img = [(4 if l < L - 1 else 1) * blk for l in range(L)]
    nmb = [5] + [-(-i // 64) for i in ins[1:]]
    written = tiles * (sum(x_img) + sum(r_img))
    read = tiles * sum(b * blk + (b + 1) // 2 * r
                       for b, r in zip(nmb, r_img))
    io = n * 4 * (2 * (9 + cfg.d_feature) + cfg.d_out)
    return wg_shape("K3-bwd-bf16", n, run, plain,
                    1e3 * n * bwd_flops / BF16_PEAK, plan,
                    written + read + io, "radiance_bwd_bf16_wg.cu",
                    "radiance_bwd_bf16_attrs")


def check_flips(label, got, twin, ref64, names):
    """A bf16 kernel's tensors against its plain twin's (same inputs, same
    bf16 roundings, sums in another order) and an f64 evaluation of the
    unrounded function (ref64), per tensor (FLIP_GAIN, FLIP_SHARE_TOL,
    FLIP_OUTLIERS).  Returns the kernel's max |kernel - twin|."""
    worst_gain = worst_rms = worst_share = e_kt = 0.0
    at = names[0]
    for g, t, r, n in zip(got, twin, ref64, names):
        g, t, r = g.double(), t.double(), r.double()
        scale = float(r.abs().max())
        ek, et, d = (g - r).abs(), (t - r).abs(), (g - t).abs()
        gain = float(ek.max()) / (FLIP_GAIN * float(et.max()) + 1e-5 * scale)
        rms = float(ek.pow(2).mean().sqrt()) / (
            FLIP_GAIN * float(et.pow(2).mean().sqrt()) + 1e-6 * scale)
        tol = FLIP_SHARE_TOL * float(et.max()) + 1e-5 * scale
        share = float((d > tol).double().mean()) / FLIP_OUTLIERS
        e_kt = max(e_kt, float(d.max()))
        if max(gain, rms, share) > max(worst_gain, worst_rms, worst_share):
            at = n
        worst_gain, worst_rms = max(worst_gain, gain), max(worst_rms, rms)
        worst_share = max(worst_share, share)
    print(f"{label}: max|kernel - twin| {e_kt:.3e}; worst ratios to their "
          f"limits: error from f64 (max) {worst_gain:.3f}, (rms) "
          f"{worst_rms:.3f}, share beyond {FLIP_SHARE_TOL} x the twin's "
          f"error {worst_share:.3f} (worst tensor {at})")
    if max(worst_gain, worst_rms, worst_share) > 1.0:
        raise AssertionError(f"{label} disagrees with its plain twin")
    return e_kt


def k1_k2_bits(cfg, ws, bs, x, slabs) -> None:
    """K1-fwd-bf16's out against K2-bf16's full 257-wide output on the
    same forward slab pack (sweep16) and rows: the same slabs, sums and
    softplus (csrc/sweep16.cuh's sw_forward), so bit for bit; raises
    otherwise, after printing the largest difference."""
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    out = GK.launch_forward(cfg, x, ws, bs, slabs, bf16=True)[0]
    k2 = SK.sdf_forward(ws, bs, cfg, x, slabs[0], bf16=True)
    torch.cuda.synchronize()
    d = float((out - k2).abs().max())
    same = torch.equal(out, k2)
    print(f"K1-fwd-bf16's out against K2-bf16's full output N={x.shape[0]} "
          f"(one slab pack): bitwise equal {same}, max|diff| {d:.3e}")
    if not same:
        raise AssertionError("K1-fwd-bf16's out is not K2-bf16's full "
                             "output")


def check_bf16_kernels(device):
    """K1's bf16 operand mode: each bf16 kernel against its twin at the
    step's 65,536 rows and at N_RAGGED rows (check_flips), two launches of
    each bitwise equal, and its time against the bf16 bound; K1-fwd-bf16
    (on wgmma, its build report first) also at a validation chunk's
    VAL_CHUNK x 128 rows, and its out against K2-bf16's full output on the
    same slab pack and rows, bit for bit; K1-fwd-stash-bf16 (its sweep
    with the stash stored) its out and grad K1-fwd-bf16's bit for bit at
    both shapes (k1_fwd_stash_bits); K1-bwd-split-bf16 and
    K1-bwd-stash-bf16 (on wgmma, their build report first) through
    k1_chains_check, the split's bits against K1-bwd-bf16's printed."""
    import torch
    from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import tc_pack as TP

    cfg = SDFConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ins = [w.shape[1] for w in ws]
    outs = [w.shape[0] for w in ws]
    S = sum(i * o for i, o in zip(ins, outs))
    s_last = ins[-1] * outs[-1]
    wbytes = 2 * sum(i * o for i, o in zip(ins, outs)) + 4 * sum(outs)
    stash_bytes = 2 * GK.stash_columns(ws)
    fwd_flops = 2 * S + 2 * (S - s_last)
    bwd_flops = (4 * (S - s_last) + 2 * S + 2 * S
                 + 2 * (S - s_last) + 2 * ins[-1] + 2 * (S - s_last))
    # every bf16 K1 kernel runs on wgmma from the two slab packs
    fwd_build = wgmma_build_report("K1-fwd-bf16 and K1-fwd-stash-bf16",
                                   "geometry_fwd_bf16_wg.cu",
                                   ("geometry_fwd_bf16_sweep",
                                    "geometry_fwd_stash_bf16_sweep"))
    build = wgmma_build_report("K1-bwd-bf16", "geometry_bwd_bf16_wg.cu")
    cbuild = wgmma_build_report(
        "K1-bwd-split-bf16 and K1-bwd-stash-bf16",
        "geometry_bwd_chains_bf16_wg.cu",
        ("geometry_bwd_split_wg16", "geometry_bwd_stash_wg16",
         "geometry_bwd_chains_wg16_wgrad"))
    slabs = GK.make_bwd_slabs(cfg, list(ws))
    wg_shapes, fwd_shapes, stash_shapes = [], [], []
    chain_shapes = {"geometry_bwd_split_bf16": [],
                    "geometry_bwd_stash_bf16": []}
    w64 = [w.double() for w in ws]
    b64 = [b.double() for b in bs]
    fnames = ["out", "grad"]
    names = ["ct_x"] + [f"dW{l}" for l in range(len(ws))] + [
        f"db{l}" for l in range(len(ws))]
    flat = lambda r: [r[0], *r[1], *r[2]]
    gen = torch.Generator(device=device).manual_seed(5)
    results, errs = [], {}
    for n in (N_CORE, N_RAGGED):
        x = torch.randn(n, 3, device=device, generator=gen) * 0.5
        ct_out = torch.randn(n, outs[-1], device=device, generator=gen)
        ct_g = torch.randn(n, 3, device=device, generator=gen)
        pre64 = []
        with torch.no_grad():
            ref_f = [t.float() for t in GK.geometry_plain(w64, b64,
                                                          x.double(), cfg,
                                                          pre64)]
        ref_st = torch.cat(pre64, -1).float()
        del pre64
        ref_b = [t.float() for t in flat(GK.geometry_bwd_plain(
            w64, b64, x.double(), ct_out.double(), ct_g.double(), cfg))]
        tw_f = GK.geometry_plain(ws, bs, x, cfg, bf16=True)
        tw_b = flat(GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                          bf16=True))
        out_k, grad_k, st_k = GK.launch_forward_stash(cfg, x, ws, bs, slabs,
                                                      bf16=True)
        tw_sf = GK.geometry_fwd_stash_plain(ws, bs, x, cfg, bf16=True)
        runs = {
            "geometry_fwd_bf16": (lambda: GK.launch_forward(
                cfg, x, ws, bs, slabs, bf16=True), tw_f, ref_f, fnames),
            "geometry_fwd_stash_bf16": (lambda: GK.launch_forward_stash(
                cfg, x, ws, bs, slabs, bf16=True)[:2], tw_sf[:2], ref_f,
                fnames),
            "geometry_bwd_bf16": (lambda: flat(GK.launch_backward(
                cfg, x, ws, bs, ct_out, ct_g, slabs, bf16=True)), tw_b,
                ref_b, names)}
        # the stash itself: the bf16 forward's pre-activations rounded to
        # bf16, held as the outputs are (a flip upstream moves an entry by
        # more than one bf16 ulp, unlike the f32 mode's stash)
        ulps = bf16_ulps(st_k, tw_sf[2])
        print(f"K1-fwd-stash-bf16 N={n}: stash entries equal to the "
              f"twin's {int((ulps == 0).sum())}, one bf16 ulp apart "
              f"{int((ulps == 1).sum())}, further {int((ulps > 1).sum())}")
        del ulps
        check_flips(f"K1-fwd-stash-bf16 stash N={n}", [st_k.float()],
                    [tw_sf[2].float()], [ref_st], ["stash"])
        del ref_st
        for name, (run, twin, ref, tnames) in runs.items():
            got = run()
            again = run()
            torch.cuda.synchronize()
            e = check_flips(f"{name} N={n}", got, twin, ref, tnames)
            errs[name] = max(errs.get(name, 0.0), e)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
        print(f"bf16 K1 kernels N={n}: two launches of each bitwise equal")
        k1_k2_bits(cfg, ws, bs, x, slabs)
        stash_shapes.append(k1_fwd_stash_bits(cfg, ws, bs, n, slabs,
                                              fwd_flops, bf16=True))
        shape, fwd_attrs = k1_fwd_bf16_shape(
            cfg, ws, bs, x, runs["geometry_fwd_bf16"][0], fwd_flops, slabs)
        fwd_shapes.append(shape)
        shape, k1_attrs = k1_bwd_wg_shape(
            cfg, ws, n, runs["geometry_bwd_bf16"][0],
            lambda: GK.geometry_bwd_plain(ws, bs, x, ct_out, ct_g, cfg,
                                          bf16=True), bwd_flops, slabs)
        wg_shapes.append(shape)
        # K1-bwd-split-bf16 and K1-bwd-stash-bf16 on their own inputs
        # (k1_chains_check: the f64 twin by check_flips, two launches
        # bitwise equal, the split's bits against K1-bwd-bf16's)
        for name, stash in (("geometry_bwd_split_bf16", False),
                            ("geometry_bwd_stash_bf16", True)):
            shape, e = k1_chains_check(
                cfg, ws, bs, n, bwd_flops - (2 * (S - s_last) if stash
                                             else 0),
                slabs, gen, stash, bf16=True)
            chain_shapes[name].append(shape)
            errs[name] = max(errs.get(name, 0.0), e)
        if n != N_CORE:
            continue

        def plain(fn):
            def run():
                with torch.no_grad():
                    fn()
            return run
        plain_ms = {
            "geometry_fwd_bf16": cuda_ms(plain(lambda: GK.geometry_plain(
                ws, bs, x, cfg, bf16=True)), 5),
            "geometry_fwd_stash_bf16": cuda_ms(plain(
                lambda: GK.geometry_fwd_stash_plain(ws, bs, x, cfg,
                                                    bf16=True)), 5),
            "geometry_bwd_bf16": cuda_ms(plain(lambda: GK.geometry_bwd_plain(
                ws, bs, x, ct_out, ct_g, cfg, bf16=True)), 3)}
        # what the bf16 mode adds to a step besides its kernels: the two
        # slab packs SDFNetwork.kernel_weights(bf16=True) builds for every
        # bf16 K1 kernel
        pack_ms = {"sweep_pack_bf16_ms": cuda_ms(
                       lambda: GK.make_sweep_pack(cfg, ws), 10),
                   "rev_pack_bf16_ms": cuda_ms(
                       lambda: TP.pack_rev_bf16(ws, cfg.d_embed), 10)}
        print(f"the bf16 K1 kernels' slab packs at full width: "
              f"{pack_ms['sweep_pack_bf16_ms']:.3f} ms (forward)"
              f" + {pack_ms['rev_pack_bf16_ms']:.3f} ms (reverse) (CUDA "
              f"events around 10 builds each)")
        fwd_bytes = n * (12 + 4 * outs[-1] + 12) + wbytes
        bwd_bytes = n * (12 + 4 * outs[-1] + 12 + 12) + 2 * wbytes
        work = {"geometry_fwd_bf16": (fwd_flops, fwd_bytes, 729,
                                      "geometry_fwd_bf16_wg.cu"),
                "geometry_fwd_stash_bf16": (fwd_flops, fwd_bytes +
                                            n * stash_bytes, 764,
                                            "geometry_fwd_bf16_wg.cu"),
                "geometry_bwd_bf16": (bwd_flops, bwd_bytes, 846,
                                      "geometry_bwd_bf16_wg.cu"),
                "geometry_bwd_split_bf16": (bwd_flops, bwd_bytes, 529,
                                            "geometry_bwd_chains_bf16_wg.cu"),
                "geometry_bwd_stash_bf16": (bwd_flops - 2 * (S - s_last),
                                            bwd_bytes + n * stash_bytes,
                                            797,
                                            "geometry_bwd_chains_bf16_wg.cu")}
        for name, (flops, nbytes, line, src) in work.items():
            t_ops, t_bytes = n * flops / BF16_PEAK, nbytes / HBM_RATE
            if name in runs:
                ms = cuda_ms(runs[name][0], 5 if "bwd" in name else 10)
                p_ms = plain_ms[name]
            else:   # timed by k1_chains_check at this n
                ms = chain_shapes[name][-1]["ms"]
                p_ms = chain_shapes[name][-1]["plain_ms"]
            results.append({
                "name": name, "route": "cuda",
                "source": f"factored_neus_tpu_torch/csrc/{src}",
                "replaces": f"factored_neus_tpu/ops/pallas_geometry.py:{line}",
                "launches": 0, "max_abs_err": 0.0, "ms": ms,
                "plain_ms": p_ms,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None})
        results[0].update(pack_ms)
        del tw_f, tw_b, tw_sf, ref_f, ref_b
    # a validation chunk's rows (the mode on there: 1 a chunk)
    n = VAL_CHUNK * 128
    x = torch.randn(n, 3, device=device, generator=gen) * 0.5
    run = lambda: GK.launch_forward(cfg, x, ws, bs, slabs, bf16=True)
    with torch.no_grad():
        ref_f = [t.float() for t in GK.geometry_plain(w64, b64, x.double(),
                                                      cfg)]
        tw_f = GK.geometry_plain(ws, bs, x, cfg, bf16=True)
    got, again = run(), run()
    torch.cuda.synchronize()
    errs["geometry_fwd_bf16"] = max(errs["geometry_fwd_bf16"], check_flips(
        f"geometry_fwd_bf16 N={n}", got, tw_f, ref_f, fnames))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("geometry_fwd_bf16: two launches differ")
    del got, again, ref_f, tw_f
    k1_k2_bits(cfg, ws, bs, x, slabs)
    fwd_shapes.append(k1_fwd_bf16_shape(cfg, ws, bs, x, run, fwd_flops,
                                        slabs)[0])
    del x
    for r in results:
        r["max_abs_err"] = errs[r["name"]]
        if r["name"] == "geometry_bwd_bf16":
            r.update(shapes=wg_shapes, sass=build["sass"],
                     ptxas=build["ptxas"], attrs=k1_attrs)
        if r["name"] == "geometry_fwd_bf16":
            r.update(shapes=fwd_shapes, sass=fwd_build["sass"],
                     ptxas=fwd_build["ptxas"], attrs=fwd_attrs)
        if r["name"] == "geometry_fwd_stash_bf16":
            r.update(shapes=stash_shapes, sass=fwd_build["sass"],
                     ptxas=fwd_build["ptxas"],
                     bits_vs_k1_fwd_bf16=[sh["bits_vs_k1_fwd"]
                                          for sh in stash_shapes],
                     attrs=wg_attrs("geometry_fwd_bf16_wg.cu",
                                    "geometry_fwd_stash_bf16_attrs",
                                    ("sweep",)))
        if r["name"] in chain_shapes:
            sh = chain_shapes[r["name"]]
            r.update(shapes=sh, attrs=sh[0]["attrs"], sass=cbuild["sass"],
                     ptxas=cbuild["ptxas"])
            if "split" in r["name"]:
                r["bits_vs_k1_bwd_bf16"] = [x["bits_vs_k1_bwd"] for x in sh]
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
              f"ms) at {N_CORE} rows, bf16 bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of "
              f"it)")
    return results


# item 13: K2-bf16 at the stage-2 coarse sweep's rows, the localisation
# sweep's, the ladder's first sweep's, a ragged count and the ladder's later
# sweeps' (fewer 64-row tiles than SMs: one consumer warpgroup a block);
# K3-fwd-bf16 and K3-bwd-bf16 at the step's rows and a ragged count
K2_BF16_ROWS = (512 * 4 * 512, 512 * 128, N_SWEEP, N_RAGGED, N_SWEEP_NEW)
K2_BF16_FULL_ROWS = 512 * 128   # the full [sdf | feature] output's check


def sass_by_function(lib: str, opcodes) -> dict:
    """{function: {opcode: count}} of a shared library's SASS (cuobjdump
    -sass of the toolkit beside nvcc), each function by its mangled name,
    each opcode counting the instructions that start with it."""
    from factored_neus_tpu_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(opcodes, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if fn and m:
            for op in opcodes:
                out[fn][op] += m.group(1).startswith(op)
    return out


def wgmma_build_report(label: str, src: str, kernels=()) -> dict:
    """A wgmma kernel's registers, spills and shared memory as ptxas
    reported them at the build of its source, any wgmma serialization
    ptxas warned of, and its SASS HGMMA (warpgroup) and HMMA (mma.sync)
    counts ("sass": {name: counts}); raises unless each counted kernel
    has HGMMA and no function of the source has HMMA.  The counts are
    ``label``'s, over the source's functions, or, for a source of several
    kernels, each of ``kernels``'s (the functions whose names hold it)."""
    from factored_neus_tpu_torch.ops import _cuda
    log = _cuda.BUILD_LOG.get(src, "")
    info = [l.strip() for l in log.splitlines()
            if "registers" in l or "spill" in l or "smem" in l
            or "wgmma" in l.lower()]
    for line in info:
        print(f"  {label} ptxas: {line}")
    ops = ("HGMMA", "HMMA")
    fns = sass_by_function(_cuda._lib_path(src), ops)
    counts = {k: {op: sum(c[op] for f, c in fns.items() if k in f)
                  for op in ops} for k in (kernels or [""])}
    if not kernels:
        counts = {label: counts[""]}
    for k, c in counts.items():
        print(f"  {k} SASS: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
        if c["HGMMA"] == 0 or c["HMMA"] != 0:
            raise AssertionError(f"{k} must run on wgmma and not on "
                                 f"mma.sync")
    mma = [f for f, c in fns.items() if c["HMMA"]]
    if mma:
        raise AssertionError(f"{label}: mma.sync in {mma}")
    return {"ptxas": info, "sass": counts}


def no_hmma_anywhere() -> dict:
    """The HMMA (mma.sync) instructions of every library built from
    csrc/ (_cuda.SOURCES), by the functions' SASS: raises unless there is
    none.  Returns {source: [functions counted]}."""
    from factored_neus_tpu_torch.ops import _cuda
    seen, mma = {}, []
    for src in _cuda.SOURCES:
        fns = sass_by_function(_cuda._lib_path(src), ("HMMA",))
        seen[src] = sorted(fns)
        mma += [f"{src}: {f}" for f, c in fns.items() if c["HMMA"]]
    print(f"no library built from csrc/ has an HMMA: {not mma} "
          f"({len(seen)} libraries, {sum(len(v) for v in seen.values())} "
          f"functions)")
    if mma:
        raise AssertionError(f"mma.sync left in {mma}")
    return seen


K3_BF16_ROWS = (N_CORE, N_RAGGED)


def check_bf16_sweep_kernels(device):
    """Item 13: K2-bf16 (its build report first; on the full network's
    slab pack, the last layer narrowed, as a stage-2 run reads it) at
    K2_BF16_ROWS and with the full output at K2_BF16_FULL_ROWS,
    K3-fwd-bf16 and K3-bwd-bf16 (both on wgmma, their build reports first;
    on one pair of slab packs, as a step hands the forward pack from the
    forward to the backward) at K3_BF16_ROWS and K3-fwd-bf16 also at a
    validation chunk's VAL_CHUNK x 128 rows, each against its twin and the
    f64 unrounded function (check_flips), two launches of each bitwise
    equal, and timed against its bf16 bound at the first shape (K2-bf16,
    K3-fwd-bf16 and K3-bwd-bf16: every shape, under "shapes").  K3-bwd-bf16's twin
    differentiates on the kernel's own ReLU masks (k3_bwd_masks with
    bf16)."""
    import torch
    from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                       RenderingNetwork,
                                                       SDFConfig, SDFNetwork)
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    from factored_neus_tpu_torch.ops import tc_pack as TP

    cfg, rcfg = SDFConfig(), RenderingConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    rnet = RenderingNetwork(rcfg, torch.Generator().manual_seed(0)).to(
        device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
        rws, rbs = rnet.effective_weights()
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    S_n = sum(w.numel() for w in wn)                    # 459,008
    k2_wbytes = sum(2 * w.numel() + 4 * b.numel() for w, b in zip(wn, bn))
    build = wgmma_build_report("K2-bf16", "sdf_fwd_bf16.cu")
    # the full network's slab pack, read narrowed, as a stage-2 run has it
    pack = SK.make_sweep_pack(cfg, ws)
    gen = torch.Generator(device=device).manual_seed(13)
    shapes, errs = [], {}
    for n in K2_BF16_ROWS:
        x = torch.randn(n, 3, device=device, generator=gen) * 0.5
        run = lambda: [SK.sdf_forward(wn, bn, cfg, x, pack, bf16=True)]
        with torch.no_grad():
            twin = [SK.sdf_forward_plain(wn, bn, cfg, x, bf16=True)]
            ref = [SK.sdf_forward_plain([w.double() for w in wn],
                                        [b.double() for b in bn], cfg,
                                        x.double()).float()]
        got, again = run(), run()
        torch.cuda.synchronize()
        errs["sdf_fwd_bf16"] = max(errs.get("sdf_fwd_bf16", 0.0),
                                   check_flips(f"K2-bf16 N={n}", got, twin,
                                               ref, ["sdf"]))
        if not torch.equal(got[0], again[0]):
            raise AssertionError("K2-bf16: two launches differ")
        del twin, ref, got, again

        def plain():
            with torch.no_grad():
                SK.sdf_forward_plain(wn, bn, cfg, x, bf16=True)
        t_ops = n * 2 * S_n / BF16_PEAK
        t_bytes = (n * (12 + 4) + k2_wbytes) / HBM_RATE
        shapes.append({"rows": n, "ms": cuda_ms(run, 5 if n > N_CORE
                                                 else 20),
                       "plain_ms": cuda_ms(plain, 3),
                       "bound_ms": 1e3 * max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes"})
        print(f"K2-bf16 N={n}: {shapes[-1]['ms']:.3f} ms (plain "
              f"{shapes[-1]['plain_ms']:.3f}), bf16 bound "
              f"{shapes[-1]['bound_ms']:.3f} ms "
              f"({shapes[-1]['bound_ms'] / shapes[-1]['ms']:.1%} of it); "
              f"two launches bitwise equal")
        del x

    # the full [sdf | feature] output, 257 wide (m64n256 + m64n8 last)
    n = K2_BF16_FULL_ROWS
    x = torch.randn(n, 3, device=device, generator=gen) * 0.5
    full = lambda: SK.sdf_forward(ws, bs, cfg, x, pack, bf16=True)
    with torch.no_grad():
        twin = SK.sdf_forward_plain(ws, bs, cfg, x, bf16=True)
        ref = SK.sdf_forward_plain([w.double() for w in ws],
                                   [b.double() for b in bs], cfg,
                                   x.double()).float()
    got, again = full(), full()
    torch.cuda.synchronize()
    split = lambda t: [t[:, :1], t[:, 1:]]
    errs["sdf_fwd_bf16"] = max(errs["sdf_fwd_bf16"], check_flips(
        f"K2-bf16 full output N={n}", split(got), split(twin), split(ref),
        ["sdf", "feature"]))
    if not torch.equal(got, again):
        raise AssertionError("K2-bf16 full output: two launches differ")
    full_ms = cuda_ms(full, 20)
    print(f"K2-bf16 full output N={n}: {full_ms:.3f} ms; two launches "
          f"bitwise equal")
    del x, twin, ref, got, again
    results = [{"name": "sdf_fwd_bf16", "route": "cuda",
                "source": "factored_neus_tpu_torch/csrc/sdf_fwd_bf16.cu",
                "replaces": "factored_neus_tpu/ops/pallas_sdf.py:221",
                "launches": 0, "max_abs_err": errs["sdf_fwd_bf16"],
                **{k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
                "library_ms": None, "rows": shapes[0]["rows"],
                "shapes": shapes, "full_output_ms": full_ms,
                "build": build}]

    rS = sum(w.numel() for w in rws)                   # 271,360
    rwbytes = sum(2 * w.numel() + 4 * b.numel() for w, b in zip(rws, rbs))
    # K3-fwd-bf16 and K3-bwd-bf16 run on wgmma from their slab packs (the
    # forward's is the first of the backward's)
    build3f = wgmma_build_report("K3-fwd-bf16", "radiance_fwd_bf16_wg.cu")
    build3 = wgmma_build_report("K3-bwd-bf16", "radiance_bwd_bf16_wg.cu")
    rslabs = RK.make_bwd_slabs(rcfg, rws)
    rpack = rslabs[0]
    if not torch.equal(rpack[0], RK.make_fwd_pack(rcfg, rws, bf16=True)[0]):
        raise AssertionError("K3-fwd-bf16's pack is not K3-bwd-bf16's "
                             "forward pack")
    d_feat = rcfg.d_feature
    flat = lambda r: [*r[:4], *r[4], *r[5]]
    names = ["ct_pts", "ct_normals", "ct_dirs", "ct_feat"] + [
        f"{k}{l}" for k in ("dW", "db") for l in range(len(rws))]
    w64, b64 = [w.double() for w in rws], [b.double() for b in rbs]
    k3_shapes, k3f_shapes = [], []

    def k3_fwd_shape(rin, fwd):
        """K3-fwd-bf16 at rin's rows (wg16_fwd_shape); the design's bytes:
        the inputs read and rgb written once (radiance_fwd_bf16_wg.cu's
        note)."""
        from factored_neus_tpu_torch.ops import _cuda
        n = rin[0].shape[0]
        plan = RK.fwd_wg16_plan(rcfg, rws, n, rpack[1],
                                _cuda.sm_count(device))
        return wg16_fwd_shape(
            "K3-fwd-bf16", n, fwd,
            lambda: RK.radiance_plain(rws, rbs, rcfg, *rin, bf16=True),
            1e3 * n * 2 * rS / BF16_PEAK, plan,
            n * 4 * (9 + d_feat + rcfg.d_out), "radiance_fwd_bf16_wg.cu",
            "radiance_fwd_bf16_attrs")
    for n in K3_BF16_ROWS:
        rin = [torch.randn(n, 3, device=device, generator=gen) * 0.5,
               torch.randn(n, 3, device=device, generator=gen),
               torch.nn.functional.normalize(
                   torch.randn(n, 3, device=device, generator=gen), dim=-1),
               torch.randn(n, d_feat, device=device, generator=gen) * 0.5]
        ct = torch.randn(n, rcfg.d_out, device=device, generator=gen)
        in64 = [t.double() for t in rin]
        fwd = lambda: [RK.launch_forward(rcfg, rws, rbs, *rin, pack=rpack,
                                         bf16=True)]
        bwd = lambda: flat(RK.launch_backward(rcfg, rws, rbs, *rin, ct,
                                              pack=rslabs, bf16=True))
        with torch.no_grad():
            tw_f = [RK.radiance_plain(rws, rbs, rcfg, *rin, bf16=True)]
            ref_f = [RK.radiance_plain(w64, b64, rcfg, *in64).float()]
        # the backward's twin differentiates on the kernel's own ReLU
        # masks (k3_bwd_masks, guarded against the twin's bf16 forward):
        # where the two forwards round a pre-activation near 0 to opposite
        # sides, their cotangents part by a whole element
        masks, text = k3_bwd_masks(rcfg, rws, rbs, rin, bf16=True)
        print(f"K3-bwd-bf16 N={n}: ReLU masks of its own forward: {text}")
        tw_b = flat(RK.radiance_bwd_plain(rws, rbs, rcfg, *rin, ct,
                                          bf16=True, masks=masks))
        del masks
        ref_b = [t.float() for t in flat(RK.radiance_bwd_plain(
            w64, b64, rcfg, *in64, ct.double()))]
        for name, run, twin, ref, tn in (
                ("radiance_fwd_bf16", fwd, tw_f, ref_f, ["rgb"]),
                ("radiance_bwd_bf16", bwd, tw_b, ref_b, names)):
            got, again = run(), run()
            torch.cuda.synchronize()
            errs[name] = max(errs.get(name, 0.0), check_flips(
                f"{name} N={n}", got, twin, ref, tn))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
        print(f"K3 bf16 kernels N={n}: two launches of each bitwise equal")
        del tw_f, ref_f, tw_b, ref_b
        shape, k3f_attrs = k3_fwd_shape(rin, fwd)
        k3f_shapes.append(shape)
        shape, k3_attrs = k3_bwd_wg_shape(
            rcfg, rws, n, bwd, lambda: RK.radiance_bwd_plain(
                rws, rbs, rcfg, *rin, ct, bf16=True), 6 * rS, rslabs)
        k3_shapes.append(shape)
        if n != N_CORE:
            continue

        def plain(fn):
            def run():
                with torch.no_grad():
                    fn()
            return run
        in_bytes = n * 4 * (9 + d_feat)
        for name, run, plain_fn, flops, nbytes, line in (
                ("radiance_fwd_bf16", fwd, plain(lambda: RK.radiance_plain(
                    rws, rbs, rcfg, *rin, bf16=True)), 2 * rS,
                 in_bytes + n * 12 + rwbytes, 209),
                ("radiance_bwd_bf16", bwd, plain(lambda: RK.radiance_bwd_plain(
                    rws, rbs, rcfg, *rin, ct, bf16=True)), 6 * rS,
                 2 * in_bytes + n * 12 + 2 * rwbytes, 227)):
            t_ops, t_bytes = n * flops / BF16_PEAK, nbytes / HBM_RATE
            src = ("radiance_fwd_bf16_wg.cu" if "fwd" in name
                   else "radiance_bwd_bf16_wg.cu")
            results.append({
                "name": name, "route": "cuda",
                "source": f"factored_neus_tpu_torch/csrc/{src}",
                "replaces": f"factored_neus_tpu/ops/pallas_radiance.py:{line}",
                "launches": 0, "max_abs_err": 0.0,
                "ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain_fn, 5),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "rows": n})
        # what the bf16 mode adds to a step besides its kernels: the
        # radiance MLP's forward slab pack (K3-fwd-bf16, with or without
        # grad) and, where a backward can follow, K3-bwd-bf16's reverse one
        results[-1].update(
            sweep_pack_bf16_ms=cuda_ms(
                lambda: TP.pack_rad_sweep_bf16(rws, 6 + rcfg.d_view), 10),
            rev_pack_bf16_ms=cuda_ms(
                lambda: TP.pack_rad_rev_bf16(rws, 6 + rcfg.d_view), 10))
        print(f"radiance weight packs at full width: K3-fwd-bf16's and "
              f"K3-bwd-bf16's slab packs "
              f"{results[-1]['sweep_pack_bf16_ms']:.3f} ms (forward) "
              f"+ {results[-1]['rev_pack_bf16_ms']:.3f} ms (reverse) (CUDA "
              f"events around 10 builds each)")
    # a validation chunk's rows (the mode on there: 1 a chunk)
    n = VAL_CHUNK * 128
    rin = [torch.randn(n, 3, device=device, generator=gen) * 0.5,
           torch.randn(n, 3, device=device, generator=gen),
           torch.nn.functional.normalize(
               torch.randn(n, 3, device=device, generator=gen), dim=-1),
           torch.randn(n, d_feat, device=device, generator=gen) * 0.5]
    fwd = lambda: [RK.launch_forward(rcfg, rws, rbs, *rin, pack=rpack,
                                     bf16=True)]
    with torch.no_grad():
        tw_f = [RK.radiance_plain(rws, rbs, rcfg, *rin, bf16=True)]
        ref_f = [RK.radiance_plain(w64, b64, rcfg,
                                   *(t.double() for t in rin)).float()]
    got, again = fwd(), fwd()
    torch.cuda.synchronize()
    errs["radiance_fwd_bf16"] = max(errs["radiance_fwd_bf16"], check_flips(
        f"radiance_fwd_bf16 N={n}", got, tw_f, ref_f, ["rgb"]))
    if not torch.equal(got[0], again[0]):
        raise AssertionError("radiance_fwd_bf16: two launches differ")
    del got, again, tw_f, ref_f
    k3f_shapes.append(k3_fwd_shape(rin, fwd)[0])
    del rin
    for r in results:
        r["max_abs_err"] = errs[r["name"]]
        if r["name"] == "radiance_bwd_bf16":
            r.update(shapes=k3_shapes, sass=build3["sass"],
                     ptxas=build3["ptxas"], attrs=k3_attrs)
        if r["name"] == "radiance_fwd_bf16":
            r.update(shapes=k3f_shapes, sass=build3f["sass"],
                     ptxas=build3f["ptxas"], attrs=k3f_attrs)
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
              f"ms) at {r['rows']} rows, bf16 bound {r['bound_ms']:.3f} ms "
              f"by {r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of "
              f"it)")
    return results


def check_validation_shapes(device, results) -> None:
    """K1-fwd and K3-fwd at a validation chunk's VAL_CHUNK x 128 rows and
    K2 at its first sweep's VAL_CHUNK x 64 (the later three sweeps take
    the step's 32,768 rows, timed in check_kernels), on the weights and
    packs check_kernels builds, against their twins at 1e-5 abs (K2 and
    K3-fwd also against their f64 twins, k2_check, k3_fwd_check), each
    bitwise repeatable; the times and bounds go into each kernel's entry
    under *_val.  Every bound here is by operations, which scale with the
    rows."""
    import torch
    from factored_neus_tpu_torch.models.fields import (RenderingConfig,
                                                       RenderingNetwork,
                                                       SDFConfig, SDFNetwork)
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK

    cfg, rcfg = SDFConfig(), RenderingConfig()
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    rnet = RenderingNetwork(rcfg, torch.Generator().manual_seed(0)).to(
        device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
        rws, rbs = rnet.effective_weights()
    slabs = GK.make_bwd_slabs(cfg, ws, bf16=False)
    pack, rpack = slabs[0], RK.make_fwd_pack(rcfg, rws)
    gen = torch.Generator(device=device).manual_seed(2)
    n = VAL_CHUNK * 128
    x = torch.randn(n, 3, device=device, generator=gen) * 0.5
    rin = [x, torch.randn(n, 3, device=device, generator=gen),
           torch.nn.functional.normalize(
               torch.randn(n, 3, device=device, generator=gen), dim=-1),
           torch.randn(n, rcfg.d_feature, device=device, generator=gen) * 0.5]
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    xs = x[:VAL_CHUNK * 64].contiguous()

    def plain_k1():
        with torch.no_grad():
            return GK.geometry_plain(ws, bs, x, cfg)

    def plain_k3():
        with torch.no_grad():
            return RK.radiance_plain(rws, rbs, rcfg, *rin)

    def plain_k2():
        with torch.no_grad():
            return SK.sdf_forward_plain(wn, bn, cfg, xs)

    cases = {
        "geometry_fwd": (N_CORE, n, lambda: GK.launch_forward(
            cfg, x, ws, bs, slabs), plain_k1),
        "radiance_fwd": (N_CORE, n, lambda: RK.launch_forward(
            rcfg, rws, rbs, *rin, pack=rpack), plain_k3),
        "sdf_fwd": (N_SWEEP, VAL_CHUNK * 64, lambda: SK.sdf_forward(
            wn, bn, cfg, xs, pack), plain_k2)}
    by_name = {r["name"]: r for r in results}
    for name, (rows0, rows, kernel, plain) in cases.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(worst(a, b, 1e-5, 0.0)[0] for a, b in zip(got, want))
        if name == "geometry_fwd" and not all(
                torch.equal(a, b) for a, b in zip(got, kernel())):
            raise AssertionError("K1-fwd is not deterministic")
        if name == "sdf_fwd":
            err = max(err, k2_check(cfg, wn, bn, xs, pack, None,
                                    f"N={rows} (validation)"))
        if name == "radiance_fwd":
            err = max(err, k3_fwd_check(rcfg, rws, rbs, rin, rpack,
                                        f"N={rows} (validation)"))
        e = by_name[name]
        if e["bound_by"] != "operations":
            raise AssertionError(f"{name}: bound by bytes at the step")
        e.update({"rows_val": rows, "max_abs_err_val": err,
                  "ms_val": cuda_ms(kernel, 5),
                  "plain_ms_val": cuda_ms(plain, 3),
                  "bound_f32_ms_val": e["bound_f32_ms"] * rows / rows0,
                  "bound_3xtf32_ms_val": e["bound_3xtf32_ms"] * rows / rows0})
        print(f"validation shape {name} N={rows}: max|err| {err:.3e} "
              f"(tolerance 1e-5 abs), {e['ms_val']:.3f} ms (plain "
              f"{e['plain_ms_val']:.3f}), bounds {e['bound_f32_ms_val']:.3f} "
              f"f32, {e['bound_3xtf32_ms_val']:.3f} 3xTF32 "
              f"({e['bound_3xtf32_ms_val'] / e['ms_val']:.1%} of it)")
        if not err <= 1e-5 or not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"{name} disagrees with its twin at the "
                                 "validation shape")


def write_conf(tmp: str, steps: int = TRAIN_STEPS,
               base: str = "wmask.conf") -> str:
    """confs/<base> with the scene, experiment directories and a
    ``steps``-step schedule (stages 1, 2 and 3) pointed into tmp; writes
    the scene too."""
    from factored_neus_tpu_torch.data.fake_scene import write_sphere_scene
    write_sphere_scene(os.path.join(tmp, "data", "sphere"))
    with open(os.path.join(HERE, "confs", base)) as f:
        text = f.read()
    subs = {r"base_exp_dir_geo = \S+": f"base_exp_dir_geo = {tmp}/exp/"
            "CASE_NAME/geometry",
            r"base_exp_dir_lvis = \S+": f"base_exp_dir_lvis = {tmp}/exp/"
            "CASE_NAME/lvis",
            r"base_exp_dir_mateIllu = \S+": "base_exp_dir_mateIllu = "
            f"{tmp}/exp/CASE_NAME/mateIllu",
            r"data_dir = \S+": f"data_dir = {tmp}/data/CASE_NAME/",
            r"end_iter = 300000": f"end_iter = {steps}",
            r"end_iter = 10000": f"end_iter = {steps}",
            r"end_iter = 40000": f"end_iter = {steps}",
            r"save_freq = \d+": f"save_freq = {steps}",
            r"val_freq = \d+": "val_freq = 100000",
            r"val_mesh_freq = \d+": "val_mesh_freq = 100000",
            r"report_freq = \d+": "report_freq = 10"}
    for pat, rep in subs.items():
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise AssertionError(f"conf edit {pat!r} matched {n} times")
    conf = os.path.join(tmp, base)
    with open(conf, "w") as f:
        f.write(text)
    return conf


def all_kernels():
    """Every launch counter of the port, by the kernel's name."""
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    return {k.name: k for k in (*SK.KERNELS.values(), *RK.KERNELS.values(),
                                *GK.KERNELS.values())}


def zero_counters():
    """Sets every launch counter to 0; returns the kernels by name."""
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    return kernels


# the kernels each training run launches, and only those
SHARED = {"sdf_fwd", "radiance_fwd", "radiance_bwd"}
STASH_PAIR = {"geometry_fwd_stash", "geometry_bwd_stash"}
MAIN_SET = SHARED | {"geometry_fwd", "geometry_bwd"}
STASH_SET = SHARED | STASH_PAIR
SPLIT_SET = SHARED | {"geometry_fwd", "geometry_bwd_split"}
# the render core in bf16: K1 and K3 in their bf16 operand mode
BF16_SHARED = {"sdf_fwd", "radiance_fwd_bf16", "radiance_bwd_bf16"}
BF16_SET = BF16_SHARED | {"geometry_fwd_bf16", "geometry_bwd_bf16"}
BF16_STASH_SET = BF16_SHARED | {"geometry_fwd_stash_bf16",
                                "geometry_bwd_stash_bf16"}
BF16_SPLIT_SET = BF16_SHARED | {"geometry_fwd_bf16",
                                "geometry_bwd_split_bf16"}
# every sampling sweep on K2-bf16 (use_pallas_sampling)
SAMPLING_SET = (MAIN_SET - {"sdf_fwd"}) | {"sdf_fwd_bf16"}
# which run of the bf16 subprocess gives each bf16 kernel its launches
BF16_KERNEL_RUN = {"geometry_fwd_bf16": "main", "geometry_bwd_bf16": "main",
                   "geometry_fwd_stash_bf16": "stash",
                   "geometry_bwd_stash_bf16": "stash",
                   "geometry_bwd_split_bf16": "split",
                   "radiance_fwd_bf16": "main", "radiance_bwd_bf16": "main"}


def check_launched(label: str, launches, want) -> None:
    got = {n for n, c in launches.items() if c > 0}
    if got != want:
        raise AssertionError(f"{label}: launched {sorted(got)}, expected "
                             f"{sorted(want)} ({launches})")


def check_step_against_cpu(tmp: str, base: str = "wmask.conf",
                           atol: float = 1e-4, rtol: float = 1e-5,
                           bf16: bool = False):
    """One full-width stage-1 step of confs/<base> at STEP_RAYS rays: the
    card (kernels) against the CPU (twins), both float32, on the same
    weights, rays and jitters; the loss and every parameter gradient at
    |err| <= atol + rtol max|ref| per tensor (wmask: K1-bwd's tolerance;
    womask: test_torch_stage1's, 3e-4 + 2e-3, for the background NeRF's
    cuBLAS sums).  Each one's distance from a float64 CPU step is printed
    beside it: where a pre-activation of the radiance, RefColor or NeRF
    MLP lies within f32 rounding of 0, the float64 step falls on the other
    side of the ReLU's kink, so it is no closer to what the float32 step
    computes.  ``bf16``: all three with the core's bf16 mode on (K1 and
    K3 in bf16), the card held, as check_flips holds a bf16 kernel, to
    its distance from the float64 step: at most FLIP_GAIN x the float32
    CPU step's, plus atol + rtol
    max|ref| and FLIP_SHARE_TOL x the CPU's distance from its step with
    the mode off (the card and the CPU sum in other orders, so their bf16
    roundings part in single elements, and an sdf within that of 0 moves
    the first sign change that the surface branch reads)."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.data.datasets import make_dataset
    from factored_neus_tpu_torch.models.renderer import Stage1Model
    from factored_neus_tpu_torch.train import stage1 as TS1
    from factored_neus_tpu_torch.train.common import TrainConfig
    from factored_neus_tpu_torch.utils import config as CFG

    conf = CFG.load(write_conf(tmp, base=base), "sphere")
    cpu = torch.device("cpu")
    ds = make_dataset("dtu", conf["dataset"], cpu)
    cfg_off = CFG.renderer_config(conf)
    cfg = dataclasses.replace(cfg_off, core_act_bf16=bf16)
    tcfg = TrainConfig.from_conf(conf)
    rng = np.random.RandomState(0)
    H, W = ds.images.shape[1:3]
    px = torch.from_numpy(rng.randint(0, W, STEP_RAYS))
    py = torch.from_numpy(rng.randint(0, H, STEP_RAYS))
    batch = RAYS.rays_from_pixels(px, py, ds.images, ds.masks,
                                  ds.intrinsics_all_inv, ds.pose_all, 0)
    t_rand = torch.from_numpy(rng.uniform(-0.5, 0.5, (STEP_RAYS, 1)))
    t_out = torch.from_numpy(rng.uniform(0.0, 1.0, (STEP_RAYS,
                                                    cfg.n_outside)))
    model = Stage1Model(cfg, CFG.variance_init_val(conf), seed=0,
                        device=cpu)
    kernels = all_kernels()
    before = {n: k.launches for n, k in kernels.items()}

    def step(m, device, dtype, c=cfg):
        m = copy.deepcopy(m).to(device=device, dtype=dtype)
        args = [t.to(device=device, dtype=dtype) for t in batch]
        loss, _ = TS1.loss_on_batch(
            m, c, tcfg, *args, step=10,
            t_rand=t_rand.to(device=device, dtype=dtype),
            t_rand_out=t_out.to(device=device, dtype=dtype))
        loss.backward()
        # the background NeRF takes no part where n_outside = 0
        return float(loss.detach()), {
            n: p.grad.detach().to(cpu, torch.float64)
            for n, p in m.named_parameters() if p.grad is not None}

    l_card, g_card = step(model, torch.device("cuda"), torch.float32)
    torch.cuda.synchronize()
    launched = [n for n, k in kernels.items() if k.launches > before[n]]
    l32, g32 = step(model, cpu, torch.float32)
    l64, g64 = step(model, cpu, torch.float64)

    if set(g_card) != set(g32) or (cfg.n_outside > 0) != any(
            n.startswith("nerf.") for n in g_card):
        raise AssertionError("the card's and the CPU's steps reached "
                             "different parameters")

    def ratios(g, ref):
        return {n: worst_scaled(g[n], ref[n], atol, rtol)[1] for n in ref}

    def loss_ratio(a, ref):
        return abs(a - ref) / (atol + rtol * abs(ref))

    rc = ratios(g_card, g32)
    at = max(rc, key=rc.get)
    l_ratio = loss_ratio(l_card, l32)
    if bf16:
        l_off, g_off = step(model, cpu, torch.float32, cfg_off)
        dist = lambda a, b: float((a - b).abs().max())
        rc = {n: dist(g_card[n], g64[n]) / (
            atol + rtol * float(g64[n].abs().max())
            + FLIP_GAIN * dist(g32[n], g64[n])
            + FLIP_SHARE_TOL * dist(g32[n], g_off[n])) for n in g64}
        at = max(rc, key=rc.get)
        l_ratio = abs(l_card - l64) / (
            atol + rtol * abs(l64) + FLIP_GAIN * abs(l32 - l64)
            + FLIP_SHARE_TOL * abs(l32 - l_off))
        print(f"bf16 mode: CPU loss {l32:.8f} against {l_off:.8f} with it "
              f"off; the card's loss and gradients held to their distance "
              f"from the float64 step: worst ratio {max(l_ratio, rc[at]):.3f} "
              f"({at})")
    print(f"step check {base}, {STEP_RAYS} rays full width, {len(g32)} "
          f"parameter tensors (kernels {launched}): "
          f"loss card {l_card:.8f} CPU {l32:.8f} (ratio {l_ratio:.3f}); "
          f"worst gradient ratio to ({atol:g} + {rtol:g} max|ref|) "
          f"{rc[at]:.3f} in "
          f"{at}; from a float64 CPU step ({l64:.8f}): card loss ratio "
          f"{loss_ratio(l_card, l64):.3f}, gradients "
          f"{max(ratios(g_card, g64).values()):.3f}; CPU float32 loss ratio "
          f"{loss_ratio(l32, l64):.3f}, gradients "
          f"{max(ratios(g32, g64).values()):.3f}")
    if l_ratio > 1.0 or rc[at] > 1.0 or not math.isfinite(l_card):
        raise AssertionError("the card's stage-1 step disagrees with the "
                             "CPU's")
    if not (BF16_SET if bf16 else MAIN_SET) <= set(launched):
        raise AssertionError(f"the card's step ran only {launched}")


# check_block_graph: each run's steps (blocks of 8, 2, 8, 2, 4 with a
# report every 10 steps), then the steps of each timed window (two blocks
# of 8)
BLOCK_CHECK_STEPS, BLOCK_TIMED_STEPS = 24, 16
# the variants: (label, conf, stage, the core's bf16 mode, split backward)
BLOCK_VARIANTS = (("stage-1 wmask f32", "wmask.conf", 1, False, False),
                  ("stage-1 wmask bf16", "wmask.conf", 1, True, False),
                  ("stage-1 womask split", "womask.conf", 1, False, True),
                  ("stage 2", "wmask.conf", 2, False, False),
                  ("stage 3", "wmask.conf", 3, False, False))
# where graph and eager steps part, the stage-1 step's tolerance per
# tensor (3e-4 + 2e-3 max|p|)
BLOCK_ATOL, BLOCK_RTOL = 3e-4, 2e-3


def block_graph_variant(tmp: str, card: str, label: str, base: str,
                        stage: int, bf16: bool, split: bool) -> dict:
    """BLOCK_CHECK_STEPS full-width steps of one stage from the same
    seed-0 weights and seeds, with block_steps 8 (a CUDA graph) and 1
    (eager steps): the losses at each report, every parameter and both
    Adam moments bit for bit (or else within BLOCK_ATOL + BLOCK_RTOL
    max|p|, the worst ratio printed); then BLOCK_TIMED_STEPS more steps of
    each, timed: wall ms/step on the host clock and the device span
    ms/step between two CUDA events (a graph's replays run back to back,
    so its span is the step's device-busy time)."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.data.datasets import make_dataset
    from factored_neus_tpu_torch.models import renderer as R
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.train import common as TC
    from factored_neus_tpu_torch.train.stage1 import Stage1Trainer
    from factored_neus_tpu_torch.train.stage2 import Stage2Trainer
    from factored_neus_tpu_torch.train.stage3 import Stage3Trainer
    from factored_neus_tpu_torch.utils import config as CFG

    dev = torch.device("cuda")
    conf = CFG.load(write_conf(tmp, BLOCK_CHECK_STEPS, base), "sphere")
    ds = make_dataset("dtu", conf["dataset"], dev)
    n = ds.n_images
    cfg = CFG.renderer_config(conf, "model.lvis_renderer" if stage > 1
                              else "model.neus_renderer")
    cfg = dataclasses.replace(cfg, core_act_bf16=bf16)
    model_cls, trainer_cls = {1: (R.Stage1Model, Stage1Trainer),
                              2: (R.Stage2Model, Stage2Trainer),
                              3: (R.Stage3Model, Stage3Trainer)}[stage]
    runs = {}
    stacked = GK.STACKED_BWD
    GK.STACKED_BWD = not split
    try:
        for block in (8, 1):
            tcfg = dataclasses.replace(
                TC.TrainConfig.from_conf(conf, stage=stage),
                block_steps=block,
                end_iter=BLOCK_CHECK_STEPS + BLOCK_TIMED_STEPS)
            model = model_cls(cfg, CFG.variance_init_val(conf), seed=0,
                              device=dev)
            trainer = trainer_cls(model, cfg, tcfg, ds.train_data(),
                                  seed=stage)
            stepper = TC.BlockStepper(trainer, tcfg, n,
                                      (tcfg.report_freq, BLOCK_CHECK_STEPS))
            rng = np.random.RandomState(0)
            stepper.start(rng, rng.permutation(n))
            it, losses = 0, {}
            while it < BLOCK_CHECK_STEPS:
                metrics, k = stepper.advance(it)
                it += k
                if it % tcfg.report_freq == 0 or it == BLOCK_CHECK_STEPS:
                    losses[it] = TC.boundary_metrics(metrics)["loss"]
            torch.cuda.synchronize()
            state = {"param": [p.detach().clone() for p in
                               model.parameters()],
                     "exp_avg": [], "exp_avg_sq": []}
            for p in trainer.opt.param_groups[0]["params"]:
                st = trainer.opt.state.get(p, {})
                for m in ("exp_avg", "exp_avg_sq"):
                    if m in st:
                        state[m].append(st[m].clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(BLOCK_TIMED_STEPS // 8):
                trainer.run_block(it, [(it + i) % n for i in range(8)],
                                  graph=stepper.graph)
                it += 8
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / BLOCK_TIMED_STEPS
            span = start.elapsed_time(end) / BLOCK_TIMED_STEPS
            runs[block] = {"losses": losses, "state": state, "wall": wall,
                           "span": span, "replays": trainer.replays}
            del stepper, trainer, model
            torch.cuda.empty_cache()
    finally:
        GK.STACKED_BWD = stacked
    g, e = runs[8], runs[1]
    if g["replays"] != BLOCK_CHECK_STEPS + BLOCK_TIMED_STEPS \
            - TC.WARMUP_STEPS or e["replays"]:
        raise AssertionError(f"{label}: the blocked run did not replay its "
                             f"graph ({g['replays']} replays)")
    bitwise = g["losses"] == e["losses"] and all(
        len(g["state"][k]) == len(e["state"][k]) and all(
            torch.equal(a, b) for a, b in zip(g["state"][k], e["state"][k]))
        for k in g["state"])
    worst = max((float((a - b).abs().max()) / (
        BLOCK_ATOL + BLOCK_RTOL * float(b.abs().max()))
        for k in g["state"] for a, b in zip(g["state"][k], e["state"][k])),
        default=0.0)
    print(f"block graph, {label}: {BLOCK_CHECK_STEPS} steps, losses at "
          f"{sorted(g['losses'])} graph {list(g['losses'].values())} eager "
          f"{list(e['losses'].values())}; {len(g['state']['param'])} "
          f"parameters and {len(g['state']['exp_avg'])} x 2 Adam moments "
          + ("bit for bit" if bitwise else
             f"NOT bit for bit: worst ratio {worst:.3f} to ({BLOCK_ATOL:g}"
             f" + {BLOCK_RTOL:g} max|p|)"))
    print(f"block graph, {label}, {BLOCK_TIMED_STEPS} steps timed on "
          f"{card}: eager {e['wall']:.2f} ms/step wall, device span "
          f"{e['span']:.2f}; graph {g['wall']:.2f} ms/step wall, device "
          f"span (busy) {g['span']:.2f}; {512 / g['wall'] * 1e3:.0f} "
          f"against {512 / e['wall'] * 1e3:.0f} rays/s")
    if not bitwise and (worst > 1.0 or len(g["losses"]) != len(e["losses"])
                        or not all(math.isfinite(v)
                                   for v in g["losses"].values())):
        raise AssertionError(f"{label}: the graph's steps part from the "
                             f"eager steps")
    return {"label": label, "bitwise": bitwise, "worst_ratio": worst,
            "eager_wall_ms": e["wall"], "eager_span_ms": e["span"],
            "graph_wall_ms": g["wall"], "graph_span_ms": g["span"]}


def check_block_graph(card: str) -> list:
    """train.block_steps on the card: each of BLOCK_VARIANTS graph against
    eager (block_graph_variant)."""
    out = []
    for variant in BLOCK_VARIANTS:
        with tempfile.TemporaryDirectory() as tmp:
            out.append(block_graph_variant(tmp, card, *variant))
    return out


def check_graph_run(label: str, runner, steps: int) -> None:
    """A CLI training run of ``steps`` steps with block_steps > 1 went
    through its CUDA graph: WARMUP_STEPS eager steps, then one replay a
    step."""
    from factored_neus_tpu_torch.train.common import WARMUP_STEPS
    replays = runner.trainer.replays
    print(f"{label}: block_steps {runner.tcfg.block_steps}, "
          f"{WARMUP_STEPS} eager steps, {replays} replays of the step's "
          f"CUDA graph")
    if runner.tcfg.block_steps <= 1 or replays != steps - WARMUP_STEPS:
        raise AssertionError(f"{label} did not run its steps through a "
                             f"CUDA graph")


def train_run(tmp: str, steps: int, base: str = "wmask.conf"):
    """Trains ``steps`` steps of full-width confs/<base> through the CLI;
    returns (conf path, runner, launches per kernel during training)."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch import bridge, exp_runner
    from factored_neus_tpu_torch.utils import checkpoints as CK

    conf = write_conf(tmp, steps, base)
    kernels = zero_counters()
    runner = exp_runner.main(["--mode", "train", "--conf", conf, "--case",
                              "sphere", "--type", "dtu"])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}

    for m in runner.history:
        print(f"iter {m['iter']}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
              f"eikonal {m['eikonal_loss']:.5f} rays/s "
              f"{m['rays_per_sec']:.0f}")
        if not math.isfinite(m["loss"]):
            raise AssertionError("non-finite training loss")
    if runner.iter_step != steps or len(runner.history) != steps // 10:
        raise AssertionError("training did not run its steps")
    print(f"launches during {steps} training steps: {launches}")
    check_graph_run(f"{steps}-step {base} run", runner, steps)
    ckpt = CK.load_checkpoint(runner.last_checkpoint)
    if int(ckpt["iter_step"]) != steps:
        raise AssertionError("checkpoint iter_step")
    for i, (a, b) in enumerate(zip(ckpt["sdf_network_fine"],
                                   bridge.jax_tree_layers(runner.model.sdf),
                                   strict=True)):
        if any(not np.array_equal(a[k], b[k]) for k in b):
            raise AssertionError(f"checkpoint does not load back: sdf "
                                 f"layer {i}")
    print(f"checkpoint {os.path.basename(runner.last_checkpoint)} loads back")
    return conf, runner, launches


def check_mesh(conf: str) -> str:
    """--mode validate_mesh --is_continue at MESH_RES^3 on the checkpoint
    of the run trained from ``conf``, counters at 0 just before: a
    non-empty, closed mesh (every edge in two triangles) of finite
    vertices in world space (the scene's scale mat is the identity), on
    the SDF's zero set within a tenth of a grid cell (the plain twin
    evaluates it); then a GRID_CHECK_RES^3 grid filled on the card (K2)
    against the CPU twin's at 1e-5, and the mean vertex radius of the
    card's mesh against that of the CPU twin's GRID_CHECK_RES^3 mesh of
    the same checkpoint at RADIUS_TOL.  The geometric init (bias 0.5) is a
    noisy sphere whose mean radius depends on the seed: over seeds 0-39
    at full width, the port's init and the JAX package's both give mean
    0.457 and std 0.07, range 0.28-0.67 (tools/init_mesh_radius.py), so
    against the scene's 0.5 the radius is only held inside RADIUS_BAND."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.meshing import extract as MEXT
    from factored_neus_tpu_torch.meshing.ply import read_ply_mesh
    from factored_neus_tpu_torch.native import marching_cubes
    from factored_neus_tpu_torch.ops import sdf_kernel as SK

    kernels = zero_counters()
    t0 = time.perf_counter()
    runner = exp_runner.main(["--mode", "validate_mesh", "--is_continue",
                              "--conf", conf, "--case", "sphere", "--type",
                              "dtu"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    if {n for n, c in launches.items() if c > 0} != {"sdf_fwd"}:
        raise AssertionError(f"the mesh path launched {launches}")
    if runner.iter_step != TRAIN_STEPS:
        raise AssertionError("validate_mesh did not load the checkpoint")
    v, t = read_ply_mesh(runner.last_mesh)
    if len(t) == 0 or not np.isfinite(v).all():
        raise AssertionError(f"mesh: {len(v)} vertices, {len(t)} triangles, "
                             "or non-finite vertices")
    radius = float(np.linalg.norm(v, axis=-1).mean())
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]],
                                    t[:, [2, 0]]]), -1)
    _, uses = np.unique(edges[:, 0] * len(v) + edges[:, 1],
                        return_counts=True)
    closed = bool((uses == 2).all())
    ds, sdf = runner.dataset, runner.model.sdf
    cell = float(np.max(ds.object_bbox_max - ds.object_bbox_min)) / (
        MESH_RES - 1)
    with torch.no_grad():
        ws, bs = sdf.effective_weights()
        vt = torch.from_numpy(v).float().cuda()
        on = max(float(SK.sdf_forward_plain(ws, bs, sdf.cfg, c)[:, 0]
                       .abs().max()) for c in vt.split(1 << 18))
    times = runner.mesh_times
    print(f"mesh {MESH_RES}^3 (iter {runner.iter_step}): {len(v)} "
          f"vertices, {len(t)} triangles, closed {closed}; grid fill "
          f"{times['fill_s']:.3f} s ({launches['sdf_fwd']} K2 launches), "
          f"marching tetrahedra {times['march_s']:.3f} s, validate_mesh "
          f"{wall:.3f} s in all; mean vertex radius {radius:.4f}; max "
          f"|sdf(vertex)| {on:.3e} (cell {cell:.3e})")
    if (not closed or on > 0.1 * cell
            or not RADIUS_BAND[0] < radius < RADIUS_BAND[1]):
        raise AssertionError("the mesh is open, off the SDF's zero set or "
                             "outside the init's range of radii")

    box = (ds.object_bbox_min, ds.object_bbox_max)
    card = MEXT.extract_fields(*box, GRID_CHECK_RES,
                               MEXT.sdf_grid_query(sdf), "cuda")
    cpu = MEXT.extract_fields(*box, GRID_CHECK_RES, MEXT.sdf_grid_query(
        copy.deepcopy(sdf).cpu()), "cpu")
    err = float(np.abs(card - cpu).max())
    print(f"grid {GRID_CHECK_RES}^3 card (K2) against the CPU twin: max|err| "
          f"{err:.3e} (tolerance 1e-5 abs)")
    if not err <= 1e-5:
        raise AssertionError("the card's grid fill disagrees with the CPU's")
    cv, _ = marching_cubes(cpu, 0.0)
    lo, hi = (np.asarray(b, np.float32) for b in box)
    cv = cv / (GRID_CHECK_RES - 1.0) * (hi - lo) + lo
    cpu_radius = float(np.linalg.norm(cv, axis=-1).mean())
    print(f"mean vertex radius: card {MESH_RES}^3 {radius:.4f}, CPU twin "
          f"{GRID_CHECK_RES}^3 {cpu_radius:.4f} (tolerance {RADIUS_TOL})")
    if not abs(radius - cpu_radius) <= RADIUS_TOL:
        raise AssertionError("the card's mesh is off the CPU twin's surface")
    return runner.last_mesh


def check_val_launches(label: str, launches, chunks: int) -> None:
    """A validation render launches K2 four times a chunk (the ladder's
    sweeps), K1-fwd and K3-fwd once, and no backward kernel."""
    want = {"sdf_fwd": UP_SAMPLE_STEPS * chunks, "geometry_fwd": chunks,
            "radiance_fwd": chunks}
    got = {n: c for n, c in launches.items() if c}
    print(f"{label}: {chunks} chunks of {VAL_CHUNK} rays, launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launched {got}, expected {want}")


def spread(rays):
    """VAL_CHUNK rays spread evenly over a view's ray grid [H, W, 3] (every
    k-th ray in raster order), so that a chunk sees the object as well as
    the background: [VAL_CHUNK, 3]."""
    flat = rays.reshape(-1, 3)
    return flat[::max(1, flat.shape[0] // VAL_CHUNK)][:VAL_CHUNK]


def check_validation(conf: str):
    """--mode validate_image --is_continue --idx 0 through the CLI (level
    1), counters at 0 just before: the five panels and the launches; then
    one VAL_CHUNK-ray chunk spread over that view (spread) rendered by the
    card and by the CPU twins on the same weights, held at CHUNK_TOL /
    CHUNK_SHARE / CHUNK_MAX.  Returns the card's runner."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.train.runner1 import Runner

    kernels = zero_counters()
    t0 = time.perf_counter()
    runner = exp_runner.main(["--mode", "validate_image", "--is_continue",
                              "--idx", "0", "--conf", conf, "--case",
                              "sphere", "--type", "dtu"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    ds = runner.dataset
    check_val_launches(f"validate_image {ds.H}x{ds.W} level 1 ({wall:.3f} "
                       "s with the runner's start)", launches,
                       math.ceil(ds.H * ds.W / VAL_CHUNK))
    it = f"{runner.iter_step:08d}_0_0"
    panels = [f"validations_fine/v_{it}.png", f"normals/n_{it}.png",
              f"diffuse/d_{it}.png", f"specular/s_{it}.png",
              f"CdPlusCs/DPlusS_{it}.png"]
    missing = [p for p in panels if not os.path.exists(
        os.path.join(runner.base_exp_dir, p))]
    if runner.iter_step != TRAIN_STEPS or missing:
        raise AssertionError(f"validate_image: iter {runner.iter_step}, "
                             f"missing panels {missing}")

    o, d = (spread(r)[None] for r in ds.gen_rays_at(0, 1))
    card = runner._render_image(o, d, VAL_KEYS)
    twin = Runner(conf, mode="validate_image", case="sphere",
                  is_continue=True, device="cpu")
    cpu = twin._render_image(o.cpu(), d.cpu(), VAL_KEYS)
    bad = []
    for key in (*VAL_KEYS, "normals"):
        err = np.abs(card[key] - cpu[key]).reshape(VAL_CHUNK, -1).max(-1)
        tight = int((err <= CHUNK_TOL).sum())
        print(f"validation chunk {key}: card against the CPU twin, "
              f"{tight} of {VAL_CHUNK} rays within {CHUNK_TOL:g} abs, max "
              f"|err| {err.max():.3e} (need {CHUNK_SHARE:.1%} and "
              f"{CHUNK_MAX:g})")
        if tight < CHUNK_SHARE * VAL_CHUNK or not err.max() <= CHUNK_MAX:
            bad.append(key)
    if bad:
        raise AssertionError(f"the card's validation render disagrees "
                             f"with the CPU twin's in {bad}")
    return runner


def check_dtu_size_validation(tmp: str, conf: str, ckpt: str,
                              card: str) -> None:
    """A validation image of a DTU-size view (DTU_H x DTU_W, two views of
    the sphere scene) at the conf's level DTU_LEVEL, on the checkpoint's
    weights: seconds on a host clock ending in a synchronize, rays/s and
    the launches of the first call (counters at 0 just before)."""
    import torch
    from factored_neus_tpu_torch.data.fake_scene import write_sphere_scene
    from factored_neus_tpu_torch.train.runner1 import Runner

    write_sphere_scene(os.path.join(tmp, "data", "dtu_size"), n_views=2,
                       H=DTU_H, W=DTU_W)
    runner = Runner(conf, mode="validate_image", case="dtu_size")
    runner.load_checkpoint(ckpt)
    kernels = all_kernels()
    rays = (DTU_H // DTU_LEVEL) * (DTU_W // DTU_LEVEL)
    secs = []
    for _ in range(2):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.validate_image(idx=0, resolution_level=DTU_LEVEL)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if len(secs) == 1:
            check_val_launches(
                f"validation image {DTU_H}x{DTU_W} level {DTU_LEVEL}",
                {name: k.launches for name, k in kernels.items()},
                math.ceil(rays / VAL_CHUNK))
    print(f"validation image {DTU_H}x{DTU_W} at level {DTU_LEVEL}: {rays} "
          f"rays, validate_image {secs[0]:.3f} s ({rays / secs[0]:.0f} "
          f"rays/s), again {secs[1]:.3f} s ({rays / secs[1]:.0f} rays/s); "
          f"the PNG read and resize of the view and the five panels' "
          f"writes included; on {card}")


def check_other_modes(conf: str, mesh: str) -> None:
    """interpolate_0_1 (its frames) and mesh_dtu_shpere2world (the
    512^3 mesh copied in as dtu122-300000, taken through the identity
    scale mat) through the CLI."""
    import numpy as np
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.meshing.ply import read_ply_mesh

    base = ["--is_continue", "--conf", conf, "--case", "sphere", "--type",
            "dtu"]
    t0 = time.perf_counter()
    runner = exp_runner.main(["--mode", "interpolate_0_1", *base])
    wall = time.perf_counter() - t0
    out = runner.last_video
    n = (len([f for f in os.listdir(out) if f.endswith(".png")])
         if os.path.isdir(out) else None)
    print(f"interpolate_0_1: {out} ({n} PNG frames where it is a "
          f"directory), {wall:.3f} s")
    if not os.path.exists(out) or n not in (None, INTERP_FRAMES):
        raise AssertionError("interpolate_0_1 wrote no video or frames")
    src = os.path.join(os.path.dirname(mesh), "dtu122-300000.ply")
    shutil.copyfile(mesh, src)
    runner = exp_runner.main(["--mode", "mesh_dtu_shpere2world", *base])
    v0, t0_ = read_ply_mesh(src)
    v1, t1 = read_ply_mesh(runner.last_mesh)
    print(f"mesh_dtu_shpere2world: {runner.last_mesh}, {len(v1)} vertices")
    if not (np.array_equal(t0_, t1) and np.allclose(v0, v1, atol=1e-6)):
        raise AssertionError("mesh_dtu_shpere2world changed the mesh")


def check_eval(mesh: str) -> None:
    """Chamfer d2s / s2d of the 512^3 mesh against the r = 0.5 sphere
    through the port's evaltools (the native KD-tree); after 30 steps the
    mesh is not the sphere, so the numbers are only held finite.  Then
    KD_CHECK of the mesh's samples queried against the sphere's points,
    the KD-tree against a brute-force float64 nearest neighbour."""
    import numpy as np
    from factored_neus_tpu_torch.evaltools.pointcloud import \
        sample_mesh_points
    from factored_neus_tpu_torch.meshing.ply import read_ply_mesh
    from factored_neus_tpu_torch.native import KDTree
    from factored_neus_tpu_torch.tools.quality import chamfer_vs_sphere

    v, t = read_ply_mesh(mesh)
    t0 = time.perf_counter()
    d2s, s2d = chamfer_vs_sphere(v, t)
    secs = time.perf_counter() - t0
    print(f"eval of the {MESH_RES}^3 mesh against the r = 0.5 sphere: "
          f"chamfer d2s {d2s:.6f} s2d {s2d:.6f}, {secs:.3f} s")
    if not (math.isfinite(d2s) and math.isfinite(s2d)):
        raise AssertionError("non-finite Chamfer distances")
    pts = sample_mesh_points(v, t, 0.01)
    q = pts[np.random.RandomState(0).choice(len(pts), KD_CHECK,
                                            replace=False)]
    g = np.random.RandomState(1).randn(100_000, 3)
    g = 0.5 * g / np.linalg.norm(g, axis=-1, keepdims=True)
    q32, g32 = q.astype(np.float32), g.astype(np.float32)
    dist, idx = KDTree(g32).query(q32)
    q64, g64 = q32.astype(np.float64), g32.astype(np.float64)
    brute = np.concatenate([
        np.sqrt(((c[:, None] - g64[None]) ** 2).sum(-1).min(1))
        for c in np.array_split(q64, 64)])
    err = float(np.abs(dist - brute).max())
    hit = float(np.abs(np.linalg.norm(q64 - g64[idx], axis=-1)
                       - brute).max())
    print(f"KD-tree against brute force on {KD_CHECK} queries: max |dist "
          f"err| {err:.3e}, max |err| of the returned points' distance "
          f"{hit:.3e} (tolerance 1e-6)")
    if not (err <= 1e-6 and hit <= 1e-6):
        raise AssertionError("the KD-tree disagrees with brute force")


def check_stage2_launches(label: str, launches, units: int,
                          per_step=STAGE2_PER_STEP) -> None:
    """The kernels of ``per_step`` (K2, K1-fwd and K3-fwd STAGE2_PER_STEP
    times a stage-2 step or validation chunk) that many times a unit, over
    ``units`` of them, and no other kernel."""
    want = {n: c * units for n, c in per_step.items()}
    got = {n: c for n, c in launches.items() if c}
    print(f"{label}: launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launched {got}, expected {want}")


def stage2_run(conf: str, card: str):
    """STAGE2_STEPS full-width stage-2 steps through the port's stage-2 CLI
    on the stage-1 checkpoint of ``conf``'s run, counters at 0 just before;
    the launches, finite losses, and the checkpoint read back.  Returns
    (runner, launches)."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch import bridge, lvis
    from factored_neus_tpu_torch.utils import checkpoints as CK

    kernels = zero_counters()
    runner = lvis.main(["--mode", "train", "--conf", conf, "--case",
                        "sphere", "--type", "dtu"])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check_stage2_launches(f"stage-2 CLI, {STAGE2_STEPS} steps", launches,
                          STAGE2_STEPS)
    check_graph_run("stage-2 CLI", runner, STAGE2_STEPS)
    for m in runner.history:
        print(f"stage 2 iter {m['iter']}: lvis loss {m['lvis_loss']:.5f} "
              f"trace radiance loss {m['trace_radiance_loss']:.5f} hit rays "
              f"{m['n_hit']:.0f} of {runner.tcfg.batch_size}, rays/s "
              f"{m['rays_per_sec']:.0f}")
        if not (math.isfinite(m["loss"]) and m["n_hit"] > 0):
            raise AssertionError("stage 2: non-finite loss or no hit")
    if (runner.iter_step != STAGE2_STEPS or runner.tcfg.batch_size != 512
            or len(runner.history) != STAGE2_STEPS // 10):
        raise AssertionError("stage 2 did not run its steps")
    print(f"stage-2 rays/s at iter {runner.history[-1]['iter']}: "
          f"{runner.history[-1]['rays_per_sec']:.0f} on {card}")
    ckpt = CK.load_checkpoint(runner.last_checkpoint)
    tree = bridge.jax_tree(runner.model, groups=("lvis", "indirect"))
    for pk, ck in (("lvis", "lvis_network"), ("indirect", "indiLgt_network")):
        for i, (a, b) in enumerate(zip(ckpt[ck], tree[pk], strict=True)):
            if any(not np.array_equal(a[k], b[k]) for k in b):
                raise AssertionError(f"stage-2 checkpoint does not load "
                                     f"back: {ck} layer {i}")
    if int(ckpt["iter_step"]) != STAGE2_STEPS or len(ckpt["optimizer"]) != 42:
        raise AssertionError("stage-2 checkpoint: iter_step or optimizer")
    print(f"stage-2 checkpoint {os.path.basename(runner.last_checkpoint)} "
          f"loads back")
    return runner, launches


def check_stage2_shapes(device, results, model) -> None:
    """K2, K1-fwd and K3-fwd at the stage-2 step's new shapes
    (STAGE2_ROWS), on the stage-2 run's packs (their f32 slab packs: the
    run builds no 3xTF32 pack), against their twins at 1e-5 abs (K2 up to
    65,536 rows and K3-fwd also against their f64 twins, k2_check,
    k3_fwd_check), each bitwise repeatable; times, plain times and bounds
    (by operations, which scale with the rows: check_kernels' bounds at
    its rows) go into each kernel's entry under "stage2"."""
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import radiance_kernel as RK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK

    sdf_w, color_w = model.kernel_weights()
    ws, bs, pack = sdf_w.ws, sdf_w.bs, sdf_w.sweep32
    rws, rbs, rpack = color_w.ws, color_w.bs, color_w.sweep32
    if mma_sync_packs_left() or rpack is None:
        raise AssertionError("an mma.sync pack is left, or "
                             "Stage2Model.kernel_weights built no K3-fwd "
                             "slab pack")
    # K1-fwd's two f32 slab packs, built once a run by
    # Stage2Model.kernel_weights (no grad)
    slabs = (sdf_w.sweep32, sdf_w.rev32)
    if None in slabs:
        raise AssertionError("Stage2Model.kernel_weights built no K1-fwd "
                             "slabs")
    cfg, rcfg = model.stage1.sdf.cfg, model.stage1.color.cfg
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    gen = torch.Generator(device=device).manual_seed(3)
    by_name = {r["name"]: r for r in results}
    rows0 = {"sdf_fwd": N_SWEEP, "geometry_fwd": N_CORE,
             "radiance_fwd": N_CORE}

    def rand(n, d=3, scale=0.5):
        return torch.randn(n, d, device=device, generator=gen) * scale

    def case(name, rows):
        """(kernel, twin, the f64 and repeat check or None)"""
        x = rand(rows)
        label = f"N={rows} (stage 2)"
        if name == "sdf_fwd":
            return (lambda: SK.sdf_forward(wn, bn, cfg, x, pack),
                    lambda: SK.sdf_forward_plain(wn, bn, cfg, x),
                    (lambda: k2_check(cfg, wn, bn, x, pack, None, label))
                    if rows <= N_CORE else None)
        if name == "geometry_fwd":
            return (lambda: GK.launch_forward(cfg, x, ws, bs, slabs),
                    lambda: GK.geometry_plain(ws, bs, x, cfg), None)
        rin = [x, rand(rows), torch.nn.functional.normalize(rand(rows), dim=-1),
               rand(rows, rcfg.d_feature)]
        return (lambda: RK.launch_forward(rcfg, rws, rbs, *rin, pack=rpack),
                lambda: RK.radiance_plain(rws, rbs, rcfg, *rin),
                lambda: k3_fwd_check(rcfg, rws, rbs, rin, rpack, label))

    for name, shapes in STAGE2_ROWS.items():
        e = by_name[name]
        if e["bound_by"] != "operations":
            raise AssertionError(f"{name}: bound by bytes at the step")
        for rows in shapes:
            kernel, plain, check64 = case(name, rows)
            with torch.no_grad():
                got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(worst(a, b, 1e-5, 0.0)[0] for a, b in zip(got, want))
            with torch.no_grad():
                again = kernel()
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} is not deterministic")
            if check64 is not None:
                err = max(err, check64())
            reps = 5 if rows >= N_CORE else 20

            def plain_ng():
                with torch.no_grad():
                    plain()
            row = {"rows": rows, "max_abs_err": err,
                   "ms": cuda_ms(kernel, reps), "plain_ms": cuda_ms(plain_ng,
                                                                    3),
                   "bound_f32_ms": e["bound_f32_ms"] * rows / rows0[name],
                   "bound_3xtf32_ms": e["bound_3xtf32_ms"] * rows
                   / rows0[name]}
            e.setdefault("stage2", []).append(row)
            print(f"stage-2 shape {name} N={rows}: max|err| {err:.3e} "
                  f"(tolerance 1e-5 abs), {row['ms']:.3f} ms (plain "
                  f"{row['plain_ms']:.3f}), bounds {row['bound_f32_ms']:.3f} "
                  f"f32, {row['bound_3xtf32_ms']:.3f} 3xTF32 "
                  f"({row['bound_3xtf32_ms'] / row['ms']:.1%} of it)")
            if not err <= 1e-5 or not all(torch.isfinite(g).all()
                                          for g in got):
                raise AssertionError(f"{name} disagrees with its twin at "
                                     f"{rows} rows")
            del got, want


def stage2_draws(rng, n: int):
    import torch
    return [torch.from_numpy(rng.rand(n, 4).astype("float32"))
            for _ in range(2)]


def check_stage2_step_against_cpu(conf: str, sweep_bf16: bool = False
                                  ) -> None:
    """One full-width stage-2 step at STEP_RAYS rays of view 0: the card
    (kernels) against the CPU (twins), both float32, on the same weights,
    rays and hemisphere draws: sdf_mask equal (a flipped ray is printed
    with its sdf margin, the least |sdf| of its localisation sweep), the
    loss and every lvis and indirect gradient at S2_ATOL + S2_RTOL
    max|ref| per tensor, with the coarse sweep in f32 (sweep_act_bf16
    off).  ``sweep_bf16``: the default step, the coarse sweep on K2-bf16
    and its twin, the card held to its distance from a float64 CPU step
    (the same bf16 roundings, exact sums), as check_step_against_cpu holds
    the bf16 core: at most FLIP_GAIN x the float32 CPU step's, plus
    S2_ATOL + S2_RTOL max|ref| and FLIP_SHARE_TOL x the CPU's distance
    from its step with the sweep in f32."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.models import renderer as R
    from factored_neus_tpu_torch.train import losses as L
    from factored_neus_tpu_torch.train.runner2 import Runner

    card, cpu = (Runner(conf, mode="validate_image", case="sphere",
                        device=dev) for dev in ("cuda", "cpu"))
    ds = cpu.dataset
    rng = np.random.RandomState(0)
    H, W = ds.images.shape[1:3]
    px = torch.from_numpy(rng.randint(0, W, STEP_RAYS))
    py = torch.from_numpy(rng.randint(0, H, STEP_RAYS))
    o, d, _, _ = RAYS.rays_from_pixels(px, py, ds.images, ds.masks,
                                       ds.intrinsics_all_inv, ds.pose_all, 0)
    u = stage2_draws(rng, STEP_RAYS)

    def step(runner, dev, dtype=torch.float32, c=None):
        model = runner.model
        if dtype != torch.float32:
            model = copy.deepcopy(model).to(dtype=dtype)
        model.zero_grad(set_to_none=True)
        oo, dd = o.to(dev, dtype), d.to(dev, dtype)
        near, far = RAYS.near_far_from_sphere(oo, dd)
        out = R.lvis_render(model, c or cfg, oo, dd, near, far,
                            *(v.to(dev, dtype) for v in u))
        loss, m = L.stage2_losses(out)
        loss.backward()
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in model.named_parameters()
                 if p.grad is not None}
        return float(loss.detach()), grads, out["sdf_mask"].cpu(), m

    cfg = dataclasses.replace(card.cfg, sweep_act_bf16=sweep_bf16,
                              use_pallas_sampling=False)
    kernels = all_kernels()
    before = {n: k.launches for n, k in kernels.items()}
    l_card, g_card, m_card, met = step(card, "cuda")
    torch.cuda.synchronize()
    launched = {n: k.launches - before[n] for n, k in kernels.items()
                if k.launches > before[n]}
    l_cpu, g_cpu, m_cpu, _ = step(cpu, "cpu")
    flips = (m_card != m_cpu).nonzero()[:, 0].tolist()
    for i in flips:
        oo, dd = o[i:i + 1].cuda(), d[i:i + 1].cuda()
        near, far = RAYS.near_far_from_sphere(oo, dd)
        with torch.no_grad():
            _, sdf, _ = R._stage23_util(card.model.stage1, cfg, oo, dd,
                                        near, far,
                                        card.model.kernel_weights()[0])
        print(f"stage-2 step: ray {i} sdf_mask card {bool(m_card[i])} CPU "
              f"{bool(m_cpu[i])}, sdf margin {float(sdf.abs().min()):.3e}")
    if set(g_card) != set(g_cpu) or not all(
            n.startswith(("lvis.", "indirect.")) for n in g_card):
        raise AssertionError("the stage-2 steps reached other parameters")
    ratios = {n: worst_scaled(g_card[n], g_cpu[n], S2_ATOL, S2_RTOL)[1]
              for n in g_cpu}
    at = max(ratios, key=ratios.get)
    l_ratio = abs(l_card - l_cpu) / (S2_ATOL + S2_RTOL * abs(l_cpu))
    if sweep_bf16:
        l64, g64, _, _ = step(cpu, "cpu", torch.float64)
        l_off, g_off, _, _ = step(cpu, "cpu", c=dataclasses.replace(
            cfg, sweep_act_bf16=False))
        dist = lambda a, b: float((a - b).abs().max())
        ratios = {n: dist(g_card[n], g64[n]) / (
            S2_ATOL + S2_RTOL * float(g64[n].abs().max())
            + FLIP_GAIN * dist(g_cpu[n], g64[n])
            + FLIP_SHARE_TOL * dist(g_cpu[n], g_off[n])) for n in g64}
        at = max(ratios, key=ratios.get)
        l_ratio = abs(l_card - l64) / (
            S2_ATOL + S2_RTOL * abs(l64) + FLIP_GAIN * abs(l_cpu - l64)
            + FLIP_SHARE_TOL * abs(l_cpu - l_off))
        print(f"stage-2 bf16 coarse sweep: CPU loss {l_cpu:.8f} against "
              f"{l_off:.8f} with it in f32, float64 step {l64:.8f}; the "
              f"card's loss and gradients held to their distance from the "
              f"float64 step")
    want = {**STAGE2_PER_STEP, "sdf_fwd": 5 + (not sweep_bf16),
            "sdf_fwd_bf16": int(sweep_bf16)}
    want = {n: c for n, c in want.items() if c}
    print(f"stage-2 step check, {STEP_RAYS} rays full width, coarse sweep "
          f"{'bf16' if sweep_bf16 else 'f32'} (launches {launched}), "
          f"{int(met['n_hit'])} hit, {len(g_cpu)} parameter tensors: loss "
          f"card {l_card:.8f} CPU {l_cpu:.8f}; worst ratio to its limit: "
          f"loss {l_ratio:.3f}, gradients {ratios[at]:.3f} in {at}; "
          f"sdf_mask flips {len(flips)}")
    if flips or l_ratio > 1.0 or ratios[at] > 1.0 or not math.isfinite(
            l_card) or launched != want:
        raise AssertionError("the card's stage-2 step disagrees with the "
                             "CPU's")


def check_stage2_validation(conf: str) -> None:
    """--mode validate_image of stage 2 through the CLI (level 1, a random
    view; the default bf16 coarse sweep), counters at 0 just before: the
    two panels and the launches a chunk; then one VAL_CHUNK-ray chunk
    spread over view 0 (spread), rendered by the card and by the CPU twins
    on the same weights and hemisphere draws with the coarse sweep in f32
    (sweep_act_bf16 off), a tenth of its rays at least on the surface,
    held at S2_FLIP_SHARE, S2_CHUNK_SHARE and S2_CHUNK_TOL.  Not in bf16:
    two bf16 evaluations of the coarse sweep (K2-bf16 and its twin, each
    within check_flips of the f64 sweep) part by ~1e-3 in sdf where their
    sums round an activation to neighbouring bf16 values, which moves the
    fine samples and gt_lvis by up to ~1e-1 in a quarter of the rays; the
    bf16 sweep is held by the stage-2 step against the float64 step
    (check_stage2_step_against_cpu)."""
    import glob
    import numpy as np
    import torch
    from factored_neus_tpu_torch import lvis
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.models import renderer as R
    from factored_neus_tpu_torch.train.runner2 import PANEL_KEYS, Runner

    kernels = zero_counters()
    t0 = time.perf_counter()
    runner = lvis.main(["--mode", "validate_image", "--is_continue",
                        "--conf", conf, "--case", "sphere", "--type", "dtu"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = runner.dataset
    chunks = math.ceil(ds.H * ds.W / VAL_CHUNK)
    check_stage2_launches(
        f"stage-2 validate_image {ds.H}x{ds.W} level 1, {chunks} chunks "
        f"({wall:.3f} s with the runner's start)",
        {name: k.launches for name, k in kernels.items()}, chunks)
    it = runner.iter_step
    found = [glob.glob(os.path.join(runner.base_exp_dir, p)) for p in
             (f"lvis/lvis_{it}_*.png",
              f"trace_radiance/trace_radiance{it}_*.png")]
    if it != STAGE2_STEPS or not all(found):
        raise AssertionError(f"stage-2 validate_image: iter {it}, panels "
                             f"{found}")

    o, d = (spread(r) for r in ds.gen_rays_at(0, 1))
    u = stage2_draws(np.random.RandomState(1), VAL_CHUNK)
    twin = Runner(conf, mode="validate_image", case="sphere",
                  is_continue=True, device="cpu")
    outs = []
    for r, dev in ((runner, "cuda"), (twin, "cpu")):
        oo, dd = o.to(dev), d.to(dev)
        near, far = RAYS.near_far_from_sphere(oo, dd)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = R.lvis_render(
                r.model, dataclasses.replace(r.cfg, sweep_act_bf16=False),
                oo, dd, near, far, *(v.to(dev) for v in u))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
        print(f"stage-2 chunk of {VAL_CHUNK} rays on {dev}: "
              f"{time.perf_counter() - t0:.3f} s")
    card, cpu = outs
    if card["sdf_mask"].sum() < 0.1 * VAL_CHUNK:
        raise AssertionError("the stage-2 chunk hardly sees the surface")
    same = card["sdf_mask"] == cpu["sdf_mask"]
    err = np.max([np.abs(card[k] - cpu[k]).reshape(VAL_CHUNK, -1).max(-1)
                  for k in PANEL_KEYS], 0)[same]
    tight = int((err <= S2_CHUNK_TOL).sum())
    print(f"stage-2 validation chunk, card against the CPU twins: "
          f"{int(card['sdf_mask'].sum())} of {VAL_CHUNK} rays hit, "
          f"{VAL_CHUNK - int(same.sum())} sdf_mask flips (at most "
          f"{S2_FLIP_SHARE:.1%}); of the others {tight} within "
          f"{S2_CHUNK_TOL:g} abs in all four maps (need "
          f"{S2_CHUNK_SHARE:.0%}), max |err| {err.max():.3e}")
    if (VAL_CHUNK - same.sum() > S2_FLIP_SHARE * VAL_CHUNK
            or tight < S2_CHUNK_SHARE * same.sum()
            or not all(np.isfinite(card[k]).all() for k in PANEL_KEYS)):
        raise AssertionError("the card's stage-2 render disagrees with the "
                             "CPU twins'")


def stage3_run(conf: str, card: str):
    """STAGE3_STEPS full-width stage-3 steps through the port's stage-3 CLI
    on the stage-2 checkpoint of ``conf``'s run, counters at 0 just
    before; the launches, finite losses, and the checkpoint read back
    into a fresh runner.  Returns (runner, launches)."""
    import torch
    from factored_neus_tpu_torch import mateIllu
    from factored_neus_tpu_torch.train.runner3 import Runner
    from factored_neus_tpu_torch.utils import checkpoints as CK

    kernels = zero_counters()
    runner = mateIllu.main(["--mode", "train", "--conf", conf, "--case",
                            "sphere", "--type", "dtu"])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check_stage2_launches(f"stage-3 CLI, {STAGE3_STEPS} steps", launches,
                          STAGE3_STEPS, STAGE3_PER_STEP)
    check_graph_run("stage-3 CLI", runner, STAGE3_STEPS)
    for m in runner.history:
        print(f"stage 3 iter {m['iter']}: rgb loss {m['rgb_loss']:.5f} "
              f"encoder loss {m['encoder_loss']:.6f} psnr {m['psnr']:.2f} "
              f"hit rays {m['n_hit']:.0f} of {runner.tcfg.batch_size}, "
              f"rays/s {m['rays_per_sec']:.0f}")
        if not (math.isfinite(m["loss"]) and m["n_hit"] > 0):
            raise AssertionError("stage 3: non-finite loss or no hit")
    if (runner.iter_step != STAGE3_STEPS or runner.tcfg.batch_size != 512
            or len(runner.history) != STAGE3_STEPS // 10):
        raise AssertionError("stage 3 did not run its steps")
    print(f"stage-3 rays/s at iter {runner.history[-1]['iter']}: "
          f"{runner.history[-1]['rays_per_sec']:.0f} on {card}")
    ckpt = CK.load_checkpoint(runner.last_checkpoint)
    back = Runner(conf, mode="validate_image", case="sphere",
                  is_continue=True)
    if back.iter_step != STAGE3_STEPS or len(ckpt["optimizer"]) != 56:
        raise AssertionError("stage-3 checkpoint: iter_step or optimizer")
    for (name, a), b in zip(back.model.state_dict().items(),
                            runner.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"stage-3 checkpoint does not load back: "
                                 f"{name}")
    print(f"stage-3 checkpoint {os.path.basename(runner.last_checkpoint)} "
          f"loads back into a fresh runner")
    return runner, launches


def check_outer_sweep(device, model, card: str) -> None:
    """Lvis' factorised visibility sweep (Lvis.outer: PE and the first
    layer on the two factors, then [D P, 256] through three 256 x 256
    layers and 256 -> 1 on cuBLAS, f32) at OUTER_SHAPES: held against the
    flat forward on the same pairs of 64 points (2e-5 rel, 2e-6 abs) and
    timed with CUDA events beside the flat forward's time and its f32
    bound, the larger of its operations over F32_PEAK and its bytes (the
    inputs read once, the [D, P] output written once) over HBM_RATE."""
    import torch
    from factored_neus_tpu_torch.ops import sg as SG

    lvis = model.lvis
    lins = [m for m in lvis.lvis if isinstance(m, torch.nn.Linear)]
    dp = 3 * (1 + 2 * lvis.cfg.multires_pts)
    dd = 3 * (1 + 2 * lvis.cfg.multires_view)
    gen = torch.Generator(device=device).manual_seed(5)
    for D, P in OUTER_SHAPES:
        pts = torch.randn(P, 3, device=device, generator=gen) * 0.4
        dirs = SG._normalize(torch.randn(D, 3, device=device,
                                         generator=gen))
        with torch.no_grad():
            got = lvis.outer(pts[:64], dirs)
            flat = lvis(pts[:64][None].expand(D, 64, 3).reshape(-1, 3),
                        dirs[:, None].expand(D, 64, 3).reshape(-1, 3)
                        ).reshape(D, 64)
            err = float(((got - flat).abs()
                         / (2e-6 + 2e-5 * flat.abs())).max())
            if not err <= 1.0 or not torch.isfinite(got).all():
                raise AssertionError(f"Lvis.outer disagrees with the flat "
                                     f"forward at D={D} (ratio {err:.3f})")
            ms = cuda_ms(lambda: lvis.outer(pts, dirs), 5)
            fp = pts[None].expand(D, P, 3).reshape(-1, 3)
            fd = dirs[:, None].expand(D, P, 3).reshape(-1, 3)
            flat_ms = cuda_ms(lambda: lvis(fp, fd), 3)
        rows = D * P
        flops = (2.0 * rows * sum(l.in_features * l.out_features
                                  for l in lins[1:])
                 + 2.0 * (P * dp + D * dd) * lins[0].out_features)
        nbytes = 4.0 * (3 * (P + D) + rows + sum(l.weight.numel()
                                                 + l.bias.numel()
                                                 for l in lins))
        bound = 1e3 * max(flops / F32_PEAK, nbytes / HBM_RATE)
        print(f"visibility sweep Lvis.outer D={D} x P={P} ({rows} rows): "
              f"{ms:.3f} ms (flat forward {flat_ms:.3f}), f32 bound "
              f"{bound:.3f} ms by operations ({flops:.4g} FLOP; "
              f"{100 * bound / ms:.1f}% of it), against the flat forward "
              f"ratio {err:.3f} of (2e-6 + 2e-5 |ref|) on {card}")
        del got, flat


def s3_draws(rng, cfg):
    """The visibility uniforms (u_theta, u_phi) [num_lgt_sgs, vis_nsamp]."""
    import torch
    shape = (cfg.material.num_lgt_sgs, cfg.material.vis_nsamp)
    return [torch.from_numpy(rng.rand(*shape).astype("float32"))
            for _ in range(2)]


def check_stage3_step_against_cpu(conf: str, case: str = "sphere",
                                  type: str = "dtu") -> None:
    """One full-width stage-3 step at STEP_RAYS rays of view 0 on the
    30-step stage-3 checkpoint: the card (kernels) against the CPU
    (twins), both float32, on the same weights, rays, colours, binarised
    mask (the conf's mask_weight > 0) and visibility draws: sdf_mask
    equal, at least a tenth of the rays on the surface, the loss and every
    material gradient at S3_ATOL + S3_RTOL max|ref| per tensor.  The
    type's tonemap (linear for the synthetic types) is the runner's."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.models import renderer as R
    from factored_neus_tpu_torch.train import losses as L
    from factored_neus_tpu_torch.train.runner3 import Runner

    card, cpu = (Runner(conf, mode="validate_image", case=case,
                        is_continue=True, type=type, device=dev)
                 for dev in ("cuda", "cpu"))
    ds = cpu.dataset
    rng = np.random.RandomState(0)
    H, W = ds.images.shape[1:3]
    px = torch.from_numpy(rng.randint(0, W, STEP_RAYS))
    py = torch.from_numpy(rng.randint(0, H, STEP_RAYS))
    batch = RAYS.rays_from_pixels(px, py, ds.images, ds.masks,
                                  ds.intrinsics_all_inv, ds.pose_all, 0)
    u = s3_draws(rng, cpu.cfg)

    def step(runner, dev):
        o, d, color, mask = (v.to(dev) for v in batch)
        near, far = RAYS.near_far_from_sphere(o, d)
        out = R.mate_illu_render(runner.model, runner.cfg, o, d, near, far,
                                 *(v.to(dev) for v in u))
        loss, m = L.stage3_losses(out, color, (mask > 0.5).float())
        loss.backward()
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in runner.model.named_parameters()
                 if p.grad is not None}
        return float(loss.detach()), grads, out["sdf_mask"].cpu(), m

    l_card, g_card, s_card, m_card = step(card, "cuda")
    torch.cuda.synchronize()
    l_cpu, g_cpu, s_cpu, _ = step(cpu, "cpu")
    flips = int((s_card != s_cpu).sum())
    if set(g_card) != set(g_cpu) or not all(
            n.startswith("material.") for n in g_card):
        raise AssertionError("the stage-3 steps reached other parameters")
    ratios = {n: worst_scaled(g_card[n], g_cpu[n], S3_ATOL, S3_RTOL)[1]
              for n in g_cpu}
    at = max(ratios, key=ratios.get)
    l_ratio = abs(l_card - l_cpu) / (S3_ATOL + S3_RTOL * abs(l_cpu))
    n_hit = int(m_card["n_hit"])
    print(f"stage-3 step check ({type}, tonemap "
          f"{card.cfg.material.tonemap}), {STEP_RAYS} rays full width, "
          f"{n_hit} hit, "
          f"{flips} sdf_mask flips, {len(g_cpu)} parameter tensors: loss "
          f"card {l_card:.8f} CPU {l_cpu:.8f} (ratio {l_ratio:.3f}); worst "
          f"gradient ratio to ({S3_ATOL:g} + {S3_RTOL:g} max|ref|) "
          f"{ratios[at]:.3f} in {at}")
    if (flips or n_hit < 0.1 * STEP_RAYS or l_ratio > 1.0
            or ratios[at] > 1.0 or not math.isfinite(l_card)):
        raise AssertionError("the card's stage-3 step disagrees with the "
                             "CPU's")


def check_stage3_validation(conf: str) -> None:
    """--mode validate_image of stage 3 through the CLI (level 1, view 0),
    counters at 0 just before: the panels, the envmap EXR read back with
    the port's reader, and the launches a chunk; then one VAL_CHUNK-ray
    chunk spread over view 0 (spread), rendered by the card and by the CPU
    twins on the same weights and visibility draws, a tenth of its rays at
    least on the surface, held at S3_FLIP_SHARE, S3_CHUNK_SHARE and
    S3_CHUNK_TOL over every map of the decomposition."""
    import glob
    import numpy as np
    import torch
    from factored_neus_tpu_torch import mateIllu
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.data.exr import read_exr
    from factored_neus_tpu_torch.models import renderer as R
    from factored_neus_tpu_torch.models.materials import get_light
    from factored_neus_tpu_torch.train.runner3 import VAL_KEYS, Runner

    kernels = zero_counters()
    t0 = time.perf_counter()
    runner = mateIllu.main(["--mode", "validate_image", "--is_continue",
                            "--conf", conf, "--case", "sphere", "--type",
                            "dtu", "--idx", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = runner.dataset
    chunks = math.ceil(ds.H * ds.W / VAL_CHUNK)
    check_stage2_launches(
        f"stage-3 validate_image {ds.H}x{ds.W} level 1, {chunks} chunks "
        f"({wall:.3f} s with the runner's start)",
        {name: k.launches for name, k in kernels.items()}, chunks,
        STAGE3_PER_STEP)
    it = runner.iter_step
    found = [glob.glob(os.path.join(runner.base_exp_dir, p)) for p in
             (f"rgb/rgb_{it}_0.png", f"rgb/rgbPre_{it}_0.png",
              f"diffuse/d_{it}_0.png", f"specular/s_{it}_0.png",
              f"roughness/r_{it}_0.png", f"lvis_mean/lvis_{it}_0.png",
              f"indiLgt/indiLgt_{it}_0.png", f"normal/n_{it}_0.png")]
    if it != STAGE3_STEPS or not all(found):
        raise AssertionError(f"stage-3 validate_image: iter {it}, panels "
                             f"{found}")
    env = read_exr(runner.last_envmap)
    with torch.no_grad():
        want = get_light(runner.model.material).cpu().numpy()
    if env.shape != (256, 512, 3) or not np.array_equal(env, want):
        raise AssertionError(f"the envmap EXR does not read back: "
                             f"{env.shape}")
    print(f"envmap {os.path.basename(runner.last_envmap)} reads back equal, "
          f"range {env.min():.4f} .. {env.max():.4f}")

    o, d = (spread(r) for r in ds.gen_rays_at(0, 1))
    u = s3_draws(np.random.RandomState(1), runner.cfg)
    twin = Runner(conf, mode="validate_image", case="sphere",
                  is_continue=True, device="cpu")
    outs = []
    for r, dev in ((runner, "cuda"), (twin, "cpu")):
        oo, dd = o.to(dev), d.to(dev)
        near, far = RAYS.near_far_from_sphere(oo, dd)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = R.mate_illu_render(r.model, r.cfg, oo, dd, near, far,
                                     *(v.to(dev) for v in u))
        outs.append({k: v.cpu().numpy() for k, v in out.items()
                     if k in VAL_KEYS or k == "sdf_mask"})
        print(f"stage-3 chunk of {VAL_CHUNK} rays on {dev}: "
              f"{time.perf_counter() - t0:.3f} s")
    card, cpu = outs
    if card["sdf_mask"].sum() < 0.1 * VAL_CHUNK:
        raise AssertionError("the stage-3 chunk hardly sees the surface")
    same = card["sdf_mask"] == cpu["sdf_mask"]
    err = np.max([np.abs(card[k] - cpu[k]).reshape(VAL_CHUNK, -1).max(-1)
                  for k in VAL_KEYS], 0)[same]
    tight = int((err <= S3_CHUNK_TOL).sum())
    print(f"stage-3 validation chunk, card against the CPU twins: "
          f"{int(card['sdf_mask'].sum())} of {VAL_CHUNK} rays hit, "
          f"{VAL_CHUNK - int(same.sum())} sdf_mask flips (at most "
          f"{S3_FLIP_SHARE:.1%}); of the others {tight} within "
          f"{S3_CHUNK_TOL:g} abs in all {len(VAL_KEYS)} maps (need "
          f"{S3_CHUNK_SHARE:.0%}), max |err| {err.max():.3e}")
    if (VAL_CHUNK - same.sum() > S3_FLIP_SHARE * VAL_CHUNK
            or tight < S3_CHUNK_SHARE * same.sum()
            or not all(np.isfinite(card[k]).all() for k in VAL_KEYS)):
        raise AssertionError("the card's stage-3 render disagrees with the "
                             "CPU twins'")


def synthetic_train(conf: str, stage: int, type: str, per_step, card: str):
    """TRAIN_STEPS full-width steps of ``stage`` through the port's CLI on
    the Blender scene as ``type``, counters at 0 just before: the
    kernels of ``per_step`` that many times a step and nothing else,
    finite losses.  Returns (runner, launches)."""
    import torch
    from factored_neus_tpu_torch import exp_runner, lvis, mateIllu

    cli = {1: exp_runner, 2: lvis, 3: mateIllu}[stage]
    kernels = zero_counters()
    t0 = time.perf_counter()
    runner = cli.main(["--mode", "train", "--conf", conf, "--case",
                       SYN_CASE, "--type", type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    check_stage2_launches(f"synthetic stage {stage} ({type}), "
                          f"{TRAIN_STEPS} steps", launches, TRAIN_STEPS,
                          per_step)
    check_graph_run(f"synthetic stage {stage}", runner, TRAIN_STEPS)
    if (runner.iter_step != TRAIN_STEPS or runner.tcfg.batch_size != 512
            or not all(math.isfinite(m["loss"]) for m in runner.history)):
        raise AssertionError(f"synthetic stage {stage}: steps or losses "
                             f"{runner.history}")
    print(f"synthetic stage {stage} ({type}, {SYN_H}x{SYN_W}): losses "
          f"{[round(m['loss'], 5) for m in runner.history]}, rays/s at "
          f"iter {runner.history[-1]['iter']} "
          f"{runner.history[-1]['rays_per_sec']:.0f}, {wall:.3f} s with "
          f"the runner's start and the scene's load, on {card}")
    return runner, launches


def check_finite(label: str, maps) -> None:
    import numpy as np
    bad = [k for k, v in maps.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{label}: non-finite {bad}")


def check_synthetic_stage3(conf: str, card: str) -> None:
    """The stage-3 synthetic modes on the 30-step stage-3 checkpoint:
    validate_synthetic_img (level SYN_LEVEL) in linear space,
    cal_synthetic_psnr (level 1: three finite PSNRs, psnr/albedo.txt read
    back), relgt_synthetic_img under two SG envmaps (the run's lgtSGs and
    a copy turned 90 degrees about the scene's up axis, z: two different
    images, lgtSGs restored) and validate_synthetic_video (level
    SYN_VIDEO_LEVEL: five videos)."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.train.runner3 import Runner

    r = Runner(conf, mode="validate_synthetic_img", case=SYN_CASE,
               is_continue=True, type="synthetic")
    if r.cfg.material.tonemap != "none" or r.iter_step != TRAIN_STEPS:
        raise AssertionError("the synthetic stage-3 runner is not linear "
                             "or did not load its checkpoint")
    t0 = time.perf_counter()
    maps = r.validate_synthetic_img(idx=0, resolution_level=SYN_LEVEL)
    torch.cuda.synchronize()
    it = r.iter_step
    found = [os.path.exists(os.path.join(r.base_exp_dir, p)) for p in (
        f"rgb/rgb_{it}_0.png", f"diffuse/d_{it}_0.png",
        f"specular/s_{it}_0.png", f"roughness/r_{it}_0.png",
        f"lvis_mean/lvis_{it}_0.png", f"indi_light/indiLgt_{it}_0.png")]
    check_finite("stage-3 validate_synthetic_img", maps)
    if not all(found):
        raise AssertionError(f"stage-3 synthetic panels missing: {found}")
    print(f"stage-3 validate_synthetic_img level {SYN_LEVEL}: "
          f"{time.perf_counter() - t0:.3f} s on {card}")

    t0 = time.perf_counter()
    psnrs = r.cal_synthetic_psnr(idx=1, resolution_level=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(r.base_exp_dir, "psnr", "albedo.txt")) as f:
        back = [float(line.split(":")[1]) for line in f.read().split()]
    print(f"stage-3 cal_synthetic_psnr, test view 1 at level 1 "
          f"({SYN_H}x{SYN_W}): albedo {psnrs[0]:.4f} rgb {psnrs[1]:.4f} "
          f"rough {psnrs[2]:.4f} dB, {wall:.3f} s on {card}")
    if not all(math.isfinite(p) for p in psnrs) or back != list(psnrs):
        raise AssertionError("cal_synthetic_psnr: non-finite or not read "
                             "back")

    lgt = r.model.material.lgtSGs
    learned = lgt.detach().cpu().numpy()
    turned = learned.copy()
    rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    turned[:, :3] = learned[:, :3] @ rz.T
    paths = []
    for name, sgs in (("learned", learned), ("turned", turned)):
        path = os.path.join(r.base_exp_dir, "envmaps", name)
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "sg_128.npy"), sgs)
        paths.append(path)
    t0 = time.perf_counter()
    relit = r.relgt_synthetic_img(idx=0, resolution_level=SYN_LEVEL,
                                  envmap_paths=paths)
    wall = time.perf_counter() - t0
    delta = float(np.abs(relit[0] - relit[1]).max())
    same = np.array_equal(lgt.detach().cpu().numpy(), learned)
    print(f"relgt_synthetic_img level {SYN_LEVEL}, 2 envmaps: max |learned "
          f"- turned| {delta:.4f}, lgtSGs restored {same}, {wall:.3f} s on "
          f"{card}")
    if not (delta > 1e-3 and same) or not all(
            np.isfinite(x).all() for x in relit):
        raise AssertionError("relighting: the envmaps gave one image, or "
                             "lgtSGs were not restored")
    t0 = time.perf_counter()
    videos = r.validate_synthetic_video(resolution_level=SYN_VIDEO_LEVEL)
    print(f"validate_synthetic_video level {SYN_VIDEO_LEVEL}, {SYN_TEST} "
          f"test views: {[os.path.basename(v) for v in videos]}, "
          f"{time.perf_counter() - t0:.3f} s on {card}")
    if len(videos) != 5 or not all(os.path.exists(v) for v in videos):
        raise AssertionError("validate_synthetic_video")


def check_shiny_mesh(conf: str, card: str) -> None:
    """validate_mesh_shiny of a stage-1 runner of type shiny_refneus on the
    30-step checkpoint, its iter_step set to 10000: the 64^3 mesh, the
    512^3 grid fill on K2 (counters at 0 just before: K2 only), the mesh
    through scale_mat and the Shiny evaluation against dense_pcd.ply with
    test_info.json (finite d2s and s2d, result.txt written)."""
    import torch
    from factored_neus_tpu_torch.train.runner1 import (SHINY_EVAL_EVERY,
                                                       Runner)

    r = Runner(conf, mode="validate_mesh_shiny", case=SYN_CASE,
               is_continue=True, type="shiny_refneus")
    r.iter_step = SHINY_EVAL_EVERY
    kernels = zero_counters()
    t0 = time.perf_counter()
    out = r.validate_mesh_shiny()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    d2s, s2d, overall = r.shiny_scores
    t = r.mesh_times
    with open(os.path.join(r.base_exp_dir, "result.txt")) as f:
        last = f.read().splitlines()[-1]
    print(f"validate_mesh_shiny at iter {r.iter_step}: 512^3 fill "
          f"{t['fill_s']:.3f} s, marching {t['march_s']:.3f} s, Shiny "
          f"evaluation {t['eval_s']:.3f} s, {wall:.3f} s in all (with the "
          f"64^3 mesh) on {card}; launches {launches}; d2s {d2s:.6f} s2d "
          f"{s2d:.6f} overall {overall:.6f} (Blender units)")
    if (set(launches) != {"sdf_fwd"} or not out.endswith("_eval.ply")
            or not (math.isfinite(d2s) and math.isfinite(s2d))
            or not last.startswith(f"{SHINY_EVAL_EVERY}: ")):
        raise AssertionError("validate_mesh_shiny: launches, mesh, scores "
                             "or result.txt")


def check_w2c_and_roi(tmp: str) -> None:
    """A glossy-synthetic (w2c) scene and an Sk3d scene loaded on the card
    and on the CPU: rays at injected pixels and the level-2 ray grid within
    W2C_TOL; an Sk3d draw at roi_prob = 1 on the card (on images coding
    each pixel's x and y) inside the box dilated by 10 px, every pixel,
    and the constant 255/256 mask."""
    import numpy as np
    import torch
    from factored_neus_tpu_torch.data import fake_scene as FS
    from factored_neus_tpu_torch.data import rays as RAYS
    from factored_neus_tpu_torch.data.datasets import make_dataset

    glossy = FS.write_glossy_synthetic_scene(os.path.join(tmp, "glossy"),
                                             n_views=6, H=400, W=400)
    sk3d = FS.write_sk3d_scene(os.path.join(tmp, "sk3d"), n_views=4,
                               H=300, W=400)
    rng = np.random.RandomState(2)
    for typ, data in (("glossy_synthetic", glossy), ("sk3d", sk3d)):
        conf = {"data_dir": data, "sample_roi_prob": 1.0}
        card, cpu = (make_dataset(typ, conf, torch.device(d))
                     for d in ("cuda", "cpu"))
        px = torch.from_numpy(rng.randint(0, cpu.W, 4096))
        py = torch.from_numpy(rng.randint(0, cpu.H, 4096))
        errs = []
        for ds, dev in ((card, "cuda"), (cpu, "cpu")):
            errs.append([v.cpu() for v in RAYS.rays_from_pixels(
                px.to(dev), py.to(dev), ds.images, ds.masks,
                ds.intrinsics_all_inv, ds.pose_all, 1, ds.convention,
                ds.mask_ones)] + [v.cpu() for v in ds.gen_rays_at(2, 2)])
        err = max(float((a - b).abs().max()) for a, b in zip(*errs))
        print(f"{typ} ({card.convention}, mask_ones {card.mask_ones}) "
              f"{card.H}x{card.W}: rays at 4096 injected pixels and the "
              f"level-2 grid, card against the CPU: max |err| {err:.3e} "
              f"(tolerance {W2C_TOL:g})")
        if not err <= W2C_TOL:
            raise AssertionError(f"{typ}: the card's rays disagree")
    ys, xs = torch.meshgrid(torch.arange(card.H, device="cuda"),
                            torch.arange(card.W, device="cuda"),
                            indexing="ij")
    coded = torch.stack([xs, ys, xs * 0], -1).float().expand(
        card.n_images, -1, -1, -1).contiguous()
    data = dict(card.train_data(), images=coded)
    if data["roi_prob"] != 1.0 or data["roi_boxes"] is None:
        raise AssertionError("sk3d: the ROI sampler is not on")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, d, color, mask = RAYS.sample_batch(gen, data, 3, 65536)
    left, right, top, bottom = RAYS.roi_bounds(card.roi_boxes[3], card.H,
                                               card.W)
    x, y = color[:, 0], color[:, 1]
    inside = bool(((x >= left) & (x < right) & (y >= top)
                   & (y < bottom)).all())
    print(f"sk3d roi_prob 1 on the card, 65536 pixels of view 3: x "
          f"{int(x.min())}..{int(x.max())} in [{left}, {right}), y "
          f"{int(y.min())}..{int(y.max())} in [{top}, {bottom}); all "
          f"inside {inside}")
    if (not inside or not bool((mask == 255.0 / 256.0).all())
            or not bool(torch.isfinite(d).all())):
        raise AssertionError("sk3d: the ROI draw left its box")


def synthetic_phase(card: str):
    """Item 11: the Blender-layout scene (SYN_H x SYN_W, SYN_TRAIN +
    SYN_TEST views) through the three stages' CLIs at full width and
    their synthetic modes; the Shiny mesh evaluation; the w2c and ROI
    draws.  Returns {stage: launches of its training run}."""
    import torch
    from factored_neus_tpu_torch import exp_runner, lvis
    from factored_neus_tpu_torch.data.fake_scene import write_blender_scene
    from factored_neus_tpu_torch.data.images import imread_bgr_u8

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        conf = write_conf(tmp)
        write_blender_scene(os.path.join(tmp, "data", SYN_CASE), SYN_TRAIN,
                            SYN_TEST, SYN_H, SYN_W)
        print(f"Blender-layout scene {SYN_H}x{SYN_W}, {SYN_TRAIN} train + "
              f"{SYN_TEST} test views, written in "
              f"{time.perf_counter() - t0:.3f} s (host)")
        base = ["--conf", conf, "--case", SYN_CASE]
        for stage, typ, per_step in SYN_STAGES:
            _, out[f"stage{stage}"] = synthetic_train(conf, stage, typ,
                                                      per_step, card)
            t0 = time.perf_counter()
            if stage == 1:
                # the CLI's synthetic route: view 57, wrapped to 57 % 16
                r = exp_runner.main(["--mode", "validate_image",
                                     "--is_continue", "--type", typ, *base])
                panel = os.path.join(r.base_exp_dir, "validations_fine",
                                     f"v_{TRAIN_STEPS}_{57 % SYN_TRAIN}.png")
                shape = imread_bgr_u8(panel).shape
                level, want = 1, (2 * SYN_H, SYN_W, 3)
            elif stage == 2:
                r = lvis.Runner(conf, mode="validate_synthetic_img",
                                case=SYN_CASE, is_continue=True, type=typ)
                check_finite("stage-2 validate_synthetic_img",
                             r.validate_synthetic_img(
                                 idx=0, resolution_level=SYN_LEVEL))
                panel = os.path.join(
                    r.base_exp_dir, "trace_radiance", str(TRAIN_STEPS),
                    f"trace_radiance_mean_{TRAIN_STEPS}_0.png")
                shape = imread_bgr_u8(panel).shape
                level = SYN_LEVEL
                want = (2 * SYN_H // level, SYN_W // level, 3)
            else:
                check_stage3_step_against_cpu(conf, SYN_CASE, typ)
                check_synthetic_stage3(conf, card)
                continue
            torch.cuda.synchronize()
            print(f"stage-{stage} validate_synthetic_img level {level}: "
                  f"{os.path.basename(panel)} {shape}, "
                  f"{time.perf_counter() - t0:.3f} s on {card}")
            if shape != want:
                raise AssertionError(f"stage {stage}: panel {shape}")
        t0 = time.perf_counter()
        check_shiny_mesh(conf, card)
        check_w2c_and_roi(tmp)
        print(f"Shiny mesh, w2c and ROI checks: "
              f"{time.perf_counter() - t0:.3f} s on {card}")
    return out


def subprocess_run(flag: str, env: dict, label: str) -> dict:
    """Runs this script with ``flag`` in a child process (the switches are
    read at import); returns its last line's JSON."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag], cwd=HERE,
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=600)
    print(child.stdout, end="")
    if child.returncode != 0:
        raise AssertionError(f"the {label} run failed ({child.returncode}):"
                             f"\n{child.stderr[-4000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def stash_run() -> int:
    """The second training run, in its own process so that the switch is
    read at import: STASH_STEPS steps with FNEUS_PG_HBM_STASH=1.  Its last
    line is {"launches": {...}, "rays_per_sec": ...}."""
    sys.path.insert(0, HERE)
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    if not GK.STASH_BWD:
        raise AssertionError("FNEUS_PG_HBM_STASH=1 did not switch the "
                             "stash pair on")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_pack_calls()
    with tempfile.TemporaryDirectory() as tmp:
        _, runner, launches = train_run(tmp, STASH_STEPS)
    check_launched("stash run", launches, STASH_SET)
    print(json.dumps({"launches": launches,
                      "rays_per_sec": runner.history[-1]["rays_per_sec"],
                      "rev_pack_calls": PACK_CALLS[0],
                      "mma_sync_packs": mma_sync_packs_left()}))
    return 0


def split_run() -> int:
    """The womask training run with the split backward, in its own
    process so that the switch is read at import: SPLIT_STEPS steps of
    confs/womask.conf with FNEUS_PG_STACKED=0, K1-bwd-split once a step
    and K1-bwd never.  Its last line is {"launches": {...},
    "rays_per_sec": ...}."""
    sys.path.insert(0, HERE)
    import torch
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    if GK.STACKED_BWD or GK.STASH_BWD:
        raise AssertionError("FNEUS_PG_STACKED=0 did not switch K1-bwd-split "
                             "on, or the stash switch is on")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_pack_calls()
    with tempfile.TemporaryDirectory() as tmp:
        _, runner, launches = train_run(tmp, SPLIT_STEPS, "womask.conf")
    if runner.cfg.n_outside != 32:
        raise AssertionError("the womask run has no background NeRF")
    check_launched("split run", launches, SPLIT_SET)
    if launches["geometry_bwd_split"] != SPLIT_STEPS:
        raise AssertionError("split run: K1-bwd-split did not launch once a "
                             "step")
    print(json.dumps({"launches": launches,
                      "rays_per_sec": runner.history[-1]["rays_per_sec"],
                      "rev_pack_calls": PACK_CALLS[0],
                      "mma_sync_packs": mma_sync_packs_left()}))
    return 0


def bf16_run() -> int:
    """The render core's bf16 mode through the CLI, in its own process so
    that the switch is read at import (FNEUS_CORE_ACT_BF16=1): BF16_STEPS
    wmask steps (K1-fwd-bf16, K1-bwd-bf16, K3-fwd-bf16 and K3-bwd-bf16 once
    a step and no f32 K1 or K3, counters at 0 just before),
    BF16_VARIANT_STEPS with the stash switch and as many with the split
    backward (their bf16 kernels once a step), then a stage-1 run with
    --gpu 0 --profile DIR, whose trace must name K1's and K3's bf16
    kernels, and one with --debug_nans.  No mma.sync pack exists
    (count_pack_calls), and K1's reverse bf16 slab pack
    (tc_pack.pack_rev_bf16, which every bf16 K1 kernel reads, the stash
    pair too) is built once a step or more in each of the three runs.  Its
    last line is {"launches": {"main": ..., "stash": ..., "split": ...},
    "rev16_pack_calls": {...}, "rays_per_sec": ...}."""
    sys.path.insert(0, HERE)
    import torch
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.models.renderer import RendererConfig
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    if not RendererConfig().core_act_bf16 or GK.STASH_BWD or \
            not GK.STACKED_BWD:
        raise AssertionError("FNEUS_CORE_ACT_BF16=1 did not switch the "
                             "core's bf16 mode on, or another switch is on")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_pack_calls()
    launches, packs16 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        _, runner, launches["main"] = train_run(tmp, BF16_STEPS)
    packs16["main"] = PACK16_CALLS[0]
    check_launched("bf16 run", launches["main"], BF16_SET)
    per_step = {**STAGE1_PER_STEP, "geometry_fwd": 0, "geometry_bwd": 0,
                "radiance_fwd": 0, "radiance_bwd": 0,
                "geometry_fwd_bf16": 1, "geometry_bwd_bf16": 1,
                "radiance_fwd_bf16": 1, "radiance_bwd_bf16": 1}
    if any(launches["main"][k] != c * BF16_STEPS
           for k, c in per_step.items()):
        raise AssertionError(f"bf16 run: expected {per_step} launches a "
                             f"step over {BF16_STEPS} steps, got "
                             f"{launches['main']}")
    rays = runner.history[-1]["rays_per_sec"]
    for label, stash, stacked, want in (
            ("stash", True, True, BF16_STASH_SET),
            ("split", False, False, BF16_SPLIT_SET)):
        GK.STASH_BWD, GK.STACKED_BWD = stash, stacked
        before = PACK16_CALLS[0]
        with tempfile.TemporaryDirectory() as tmp:
            _, _, launches[label] = train_run(tmp, BF16_VARIANT_STEPS)
        packs16[label] = PACK16_CALLS[0] - before
        check_launched(f"bf16 {label} run", launches[label], want)
        for k in want - BF16_SHARED:
            if launches[label][k] != BF16_VARIANT_STEPS:
                raise AssertionError(f"bf16 {label} run: {k} did not launch "
                                     f"once a step")
    GK.STASH_BWD, GK.STACKED_BWD = False, True
    print(f"no mma.sync pack exists; tc_pack.pack_rev_bf16 calls: {packs16} "
          f"({BF16_STEPS} steps of the bf16 run, {BF16_VARIANT_STEPS} of the "
          f"stash and split runs)")
    if packs16["main"] < BF16_STEPS or any(
            packs16[k] < BF16_VARIANT_STEPS for k in ("stash", "split")):
        raise AssertionError("a bf16 run ran a step without K1's bf16 slab "
                             "packs")
    with tempfile.TemporaryDirectory() as tmp:
        conf = write_conf(tmp, BF16_VARIANT_STEPS)
        base = ["--mode", "train", "--conf", conf, "--case", "sphere",
                "--type", "dtu"]
        trace_dir = os.path.join(tmp, "trace")
        exp_runner.main([*base, "--gpu", "0", "--profile", trace_dir])
        traces = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, traces[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        k13 = sorted({n for n in names if "geometry_" in n
                      or "radiance_" in n})
        print(f"--profile: {traces[0]} names {len(names)} kernels, K1's "
              f"and K3's: {k13}")
        if not all(any(k in n for n in k13) for k in (
                "geometry_fwd_bf16_sweep", "geometry_bwd_wg_sweep",
                "geometry_bwd_wg_wgrad", "radiance_fwd_bf16_sweep",
                "radiance_bwd_wg_sweep", "radiance_bwd_wg_wgrad")):
            raise AssertionError("the --profile trace does not name K1 and "
                                 "K3 in bf16")
        shutil.rmtree(os.path.join(tmp, "exp"))
        r = exp_runner.main([*base, "--debug_nans"])
        if r.iter_step != BF16_VARIANT_STEPS:
            raise AssertionError("the --debug_nans run stopped early")
        print(f"--debug_nans: {r.iter_step} steps, finite, no stop")
    print(json.dumps({"launches": launches, "rev16_pack_calls": packs16,
                      "rays_per_sec": rays}))
    return 0


def sampling_run() -> int:
    """Item 13's use_pallas_sampling run, in its own process so that the
    switch is read at import (FNEUS_PALLAS_SAMPLING=1): SAMPLING_STEPS
    wmask steps through the CLI, counters at 0 just before: K2-bf16 four
    times a step (the ladder's sweeps) and no f32 K2, each other kernel
    of the main run once.  Its last line is {"launches": {...},
    "rays_per_sec": ...}."""
    sys.path.insert(0, HERE)
    import torch
    from factored_neus_tpu_torch.models.renderer import RendererConfig
    cfg = RendererConfig()
    if not cfg.use_pallas_sampling or cfg.core_act_bf16:
        raise AssertionError("FNEUS_PALLAS_SAMPLING=1 did not switch the "
                             "sampling sweeps to K2-bf16, or the core's "
                             "bf16 mode is on")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        _, runner, launches = train_run(tmp, SAMPLING_STEPS)
    check_launched("use_pallas_sampling run", launches, SAMPLING_SET)
    per_step = {**STAGE1_PER_STEP, "sdf_fwd": 0,
                "sdf_fwd_bf16": UP_SAMPLE_STEPS}
    if any(launches[k] != c * SAMPLING_STEPS for k, c in per_step.items()):
        raise AssertionError(f"use_pallas_sampling run: expected {per_step} "
                             f"launches a step, got {launches}")
    print(json.dumps({"launches": launches,
                      "rays_per_sec": runner.history[-1]["rays_per_sec"]}))
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "factored_neus_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == [STASH_RUN]:
        return stash_run()
    if sys.argv[1:] == [SPLIT_RUN]:
        return split_run()
    if sys.argv[1:] == [BF16_RUN]:
        return bf16_run()
    if sys.argv[1:] == [SAMPLING_RUN]:
        return sampling_run()
    # the f32 phases run with the core's bf16 mode off, whatever the
    # default, and the sweeps at the JAX package's defaults (stage 2's
    # coarse sweep on K2-bf16, the sampling sweeps on K2); the switches are
    # read at import, and the bf16 phases turn them on explicitly
    os.environ["FNEUS_CORE_ACT_BF16"] = "0"
    os.environ["FNEUS_SWEEP_ACT_BF16"] = "1"
    os.environ["FNEUS_PALLAS_SAMPLING"] = "0"
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from factored_neus_tpu_torch.ops import _cuda
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    if GK.STASH_BWD or not GK.STACKED_BWD:
        raise AssertionError("run without FNEUS_PG_HBM_STASH and "
                             "FNEUS_PG_STACKED: the main path is the stash "
                             "switch off and the stacked backward")

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    secs = _cuda.build_all()
    print(f"kernel build: {secs:.1f} s")
    for src, log in sorted(_cuda.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    no_hmma_anywhere()
    device = torch.device("cuda")
    kernels = check_kernels(device)
    check_validation_shapes(device, kernels)
    bf16_kernels = check_bf16_kernels(device)
    sweep_kernels = check_bf16_sweep_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        check_step_against_cpu(tmp, bf16=True)
    with tempfile.TemporaryDirectory() as tmp:
        check_step_against_cpu(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        check_step_against_cpu(tmp, "womask.conf", 3e-4, 2e-3)
    t0 = time.perf_counter()
    check_block_graph(card)
    print(f"block graph phase: {time.perf_counter() - t0:.1f} s on {card}")
    count_pack_calls()
    packs = {}
    with tempfile.TemporaryDirectory() as tmp:
        conf, runner, launches = pack_calls_during(
            f"{TRAIN_STEPS}-step wmask run", packs, train_run, tmp,
            TRAIN_STEPS)
        check_launched("main run", launches, MAIN_SET)
        per_step = STAGE1_PER_STEP
        if any(launches[k] != c * TRAIN_STEPS for k, c in per_step.items()):
            raise AssertionError(f"main run: expected {per_step} launches a "
                                 f"step over {TRAIN_STEPS} steps, got "
                                 f"{launches}")
        print(f"rays/s at iter {runner.history[-1]['iter']}: "
              f"{runner.history[-1]['rays_per_sec']:.0f} on {card}")
        mesh = pack_calls_during(f"{MESH_RES}^3 mesh", packs, check_mesh,
                                 conf)
        pack_calls_during("validation image", packs, check_validation, conf)
        check_dtu_size_validation(tmp, conf, runner.last_checkpoint, card)
        check_other_modes(conf, mesh)
        check_eval(mesh)
        runner2, launches2 = pack_calls_during(
            f"{STAGE2_STEPS}-step stage-2 run", packs, stage2_run, conf, card)
        check_stage2_shapes(device, kernels, runner2.model)
        del runner2
        check_stage2_step_against_cpu(conf)
        check_stage2_step_against_cpu(conf, sweep_bf16=True)
        check_stage2_validation(conf)
        runner3, launches3 = pack_calls_during(
            f"{STAGE3_STEPS}-step stage-3 run", packs, stage3_run, conf, card)
        check_outer_sweep(device, runner3.model, card)
        del runner3
        check_stage3_step_against_cpu(conf)
        check_stage3_validation(conf)
    print(f"no mma.sync pack exists; K1's reverse slab pack "
          f"(tc_pack.pack_rev_f32) built on the default path: {packs}")
    if packs[f"{TRAIN_STEPS}-step wmask run"] != TRAIN_STEPS or \
            packs[f"{MESH_RES}^3 mesh"]:
        raise AssertionError("K1's slab packs must be built once a training "
                             "step and never for a mesh (K2 alone)")
    t0 = time.perf_counter()
    synthetic = synthetic_phase(card)
    print(f"synthetic families phase: {time.perf_counter() - t0:.1f} s on "
          f"{card}")

    stash = subprocess_run(STASH_RUN, {"FNEUS_PG_HBM_STASH": "1"}, "stash")
    print(f"stash run rays/s over steps 1-{STASH_STEPS} (a new process: "
          f"the first steps warm up): {stash['rays_per_sec']:.0f} on {card}")
    split = subprocess_run(SPLIT_RUN, {"FNEUS_PG_STACKED": "0"}, "split")
    print(f"womask split run rays/s over steps 11-{SPLIT_STEPS}: "
          f"{split['rays_per_sec']:.0f} on {card}")
    print(f"under the switches no mma.sync pack exists (stash run: "
          f"{stash['mma_sync_packs']}, split run: {split['mma_sync_packs']});"
          f" tc_pack.pack_rev_f32 calls: stash run "
          f"{stash['rev_pack_calls']} ({STASH_STEPS} steps), split run "
          f"{split['rev_pack_calls']} ({SPLIT_STEPS} steps)")
    if stash["rev_pack_calls"] != STASH_STEPS or stash["mma_sync_packs"] or \
            split["rev_pack_calls"] != SPLIT_STEPS or split["mma_sync_packs"]:
        raise AssertionError("K1's slab packs must be built once a step "
                             "by kernel_weights in the stash and split runs, "
                             "and no mma.sync pack may exist")
    bf16 = subprocess_run(BF16_RUN, {"FNEUS_CORE_ACT_BF16": "1"}, "bf16")
    print(f"bf16 wmask run rays/s over steps 21-{BF16_STEPS}: "
          f"{bf16['rays_per_sec']:.0f} on {card}; tc_pack.pack_rev_bf16 "
          f"calls {bf16['rev16_pack_calls']}")
    sampling = subprocess_run(SAMPLING_RUN, {"FNEUS_PALLAS_SAMPLING": "1"},
                              "use_pallas_sampling")
    print(f"use_pallas_sampling wmask run rays/s over steps "
          f"1-{SAMPLING_STEPS} (a new process: the first steps warm up): "
          f"{sampling['rays_per_sec']:.0f} on {card}")
    for k in bf16_kernels + sweep_kernels:
        if k["name"] == "sdf_fwd_bf16":
            # the default stage-2 path's coarse sweep (item 9), and the
            # use_pallas_sampling run's ladder
            k["launches"] = launches2[k["name"]]
            k["sampling_launches"] = sampling["launches"][k["name"]]
            k["synthetic_launches"] = {stage: launches[k["name"]]
                                       for stage, launches in
                                       synthetic.items()}
        else:
            k["launches"] = bf16["launches"][BF16_KERNEL_RUN[k["name"]]][
                k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched")
    for k in kernels:
        k["launches"] = (stash["launches"] if k["name"] in STASH_PAIR else
                         split["launches"] if k["name"] == "geometry_bwd_split"
                         else launches)[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched")
        k["stage2_launches"] = launches2[k["name"]]
        k["stage3_launches"] = launches3[k["name"]]
        k["synthetic_launches"] = {stage: launches[k["name"]]
                                   for stage, launches in synthetic.items()}
    print(json.dumps({"kernels": kernels + bf16_kernels + sweep_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
