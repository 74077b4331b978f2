#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (factored_neus_tpu_torch).

    python3 chip_smoke.py                 # the whole check, one CUDA device

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of factored_neus_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch twin at full width (f32,
   TF32 off) and times both with CUDA events;
4. writes the analytic-sphere DTU scene (6 views, 128 x 160) with the
   port's PNG writer and trains 30 steps of confs/wmask.conf on it through
   the port's CLI, with every launch counter set to 0 just before;
5. checks finite losses, that every kernel launched during training, and
   that the checkpoint loads back;
6. prints {"kernels": [...]}, the card line, and as its last line
   {"ok": true, "device": {...}}.
Any failure raises; the script then exits non-zero without the last line.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12      # H100 SXM device memory bytes/s
N_CORE = 512 * 128      # render-core points of one wmask step
N_SWEEP = 512 * 64      # points of the ladder's first (largest) sweep
TRAIN_STEPS = 30


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


def check_kernels(device):
    """Each kernel against its plain twin at the wmask step's shapes."""
    import torch
    from factored_neus_tpu_torch.models.fields import SDFConfig, SDFNetwork
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK

    cfg = SDFConfig()                                   # 8 x 256, skip 4
    net = SDFNetwork(cfg, torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        ws, bs = net.effective_weights()
    ins = [w.shape[1] for w in ws]
    outs = [w.shape[0] for w in ws]
    S = sum(i * o for i, o in zip(ins, outs))
    s_last = ins[-1] * outs[-1]
    wbytes = 4 * sum(i * o + o for i, o in zip(ins, outs))
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(N_CORE, 3, device=device, generator=gen) * 0.5
    results, gflop = [], {}

    def entry(name, source, replaces, err, ms, plain_ms, flops, nbytes):
        t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
        gflop[name] = flops / 1e9
        results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})

    # K1-fwd: f32 dots of width <= 257 summed in another order than cuBLAS
    out_k, grad_k = GK.launch_forward(cfg, x, ws, bs)
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

    def plain_fwd():
        with torch.no_grad():
            GK.geometry_plain(ws, bs, x, cfg)
    entry("geometry_fwd", "factored_neus_tpu_torch/csrc/geometry_fwd.cu",
          "factored_neus_tpu/ops/pallas_geometry.py:729",
          max(e_out, e_g),
          cuda_ms(lambda: GK.launch_forward(cfg, x, ws, bs), 10),
          cuda_ms(lambda: plain_fwd(), 5),
          N_CORE * fwd_flops,
          N_CORE * (12 + 4 * outs[-1] + 12) + wbytes)

    # K1-bwd: adds weight-gradient sums over 131,072 stacked rows.  The
    # reference is the plain twin in float64: in float32 the twin's own
    # summation error (cuBLAS's order over 131,072 rows) is as large as the
    # kernel's, so the f64 twin measures the kernel's error alone.
    ct_out = torch.randn(out_p.shape, device=device, generator=gen)
    ct_g = torch.randn(N_CORE, 3, device=device, generator=gen)
    ct_x, dws, dbs = GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g)
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
    errs = [worst_scaled(a, b, 1e-4, 1e-5)
            for a, b in zip([ct_x, *dws, *dbs], ref64)]
    e_b = max(e for e, _ in errs)
    r_b, at = max((r, n) for (_, r), n in zip(errs, names))
    own = [worst_scaled(a, b, 1e-4, 1e-5) for a, b in zip(ref32, ref64)]
    print(f"K1-bwd  N={N_CORE}: max|err| {e_b:.3e} over ct_x, dW, db against "
          f"the f64 twin; worst ratio to (1e-4 + 1e-5 max|ref|) {r_b:.3f} "
          f"in {at} (max|ref| "
          f"{float(ref64[names.index(at)].abs().max()):.3e}); the f32 "
          f"twin's own: max|err| {max(e for e, _ in own):.3e}, worst ratio "
          f"{max(r for _, r in own):.3f}")
    if r_b > 1.0:
        raise AssertionError("K1-bwd disagrees with its plain twin")
    del ref32, ref64
    # primal and tangent forward (last layer not needed), the primal's
    # weight gradient and input cotangent, and the tangent's: its seed is
    # e0 / scale, so its last layer is a column of dW and a row of W
    bwd_flops = (4 * (S - s_last) + 2 * S + 2 * S
                 + 2 * (S - s_last) + 2 * ins[-1] + 2 * (S - s_last))
    entry("geometry_bwd", "factored_neus_tpu_torch/csrc/geometry_bwd.cu",
          "factored_neus_tpu/ops/pallas_geometry.py:846", e_b,
          cuda_ms(lambda: GK.launch_backward(cfg, x, ws, bs, ct_out, ct_g),
                  5),
          cuda_ms(plain32, 3),
          N_CORE * bwd_flops,
          N_CORE * (12 + 4 * outs[-1] + 12 + 12) + 2 * wbytes)
    del plain32

    # K2: the ladder's narrowed no-grad sweep (last layer = sdf column)
    xs = x[:N_SWEEP].contiguous()
    wn, bn = list(ws[:-1]) + [ws[-1][:1]], list(bs[:-1]) + [bs[-1][:1]]
    s_k = SK.sdf_forward(wn, bn, cfg, xs)
    with torch.no_grad():
        s_p = SK.sdf_forward_plain(wn, bn, cfg, xs)
    torch.cuda.synchronize()
    e_s, r_s = worst(s_k, s_p, 1e-5, 0.0)
    print(f"K2      N={N_SWEEP}: max|sdf err| {e_s:.3e} (tolerance 1e-5 "
          f"abs: reordered f32 sums of <= 256 terms)")
    if r_s > 1.0:
        raise AssertionError("K2 disagrees with its plain twin")
    S_n = S - s_last + ins[-1]

    def plain_sweep():
        with torch.no_grad():
            SK.sdf_forward_plain(wn, bn, cfg, xs)
    entry("sdf_fwd", "factored_neus_tpu_torch/csrc/sdf_fwd.cu",
          "factored_neus_tpu/ops/pallas_sdf.py:221", e_s,
          cuda_ms(lambda: SK.sdf_forward(wn, bn, cfg, xs), 10),
          cuda_ms(plain_sweep, 10), N_SWEEP * 2 * S_n,
          N_SWEEP * (12 + 4) + 4 * sum(
              w.numel() + b.numel() for w, b in zip(wn, bn)))
    for r in results:
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} "
              f"ms) for {gflop[r['name']]:.1f} GFLOP, bound "
              f"{r['bound_ms']:.3f} ms by {r['bound_by']}")
    return results


def write_sphere_scene(out_dir: str, n_views: int = 6, H: int = 128,
                       W: int = 160, radius: float = 3.0) -> None:
    """The analytic-sphere DTU scene of tests/make_fake_dtu.py (grey sphere
    r = 0.5, camera ring at height 0.4), written with the port's PNG
    writer."""
    import numpy as np
    from factored_neus_tpu_torch.data.images import imwrite
    focal = 1.1 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    cameras = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        c = np.array([radius * np.sin(ang), 0.4, -radius * np.cos(ang)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        pose = np.eye(4)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = \
            right, np.cross(fwd, right), fwd, c
        P = np.eye(4)
        P[:3, :4] = K @ np.linalg.inv(pose)[:3, :4]
        cameras[f"world_mat_{i}"] = P.astype(np.float32)
        cameras[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        ys, xs = np.mgrid[0:H, 0:W]
        p = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
        cam = p @ np.linalg.inv(K).T
        cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
        d = cam @ pose[:3, :3].T
        b = 2 * (d @ c)
        disc = b * b - 4 * ((c @ c) - 0.25)
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
        n = c[None, None] + t[..., None] * d
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        shade = np.clip(n[..., 1] * 0.5 + 0.5, 0, 1)
        img = np.where(hit[..., None], 0.25 + 0.55 * shade[..., None], 0.05)
        imwrite(os.path.join(out_dir, "image", f"{i:06d}.png"),
                (img * 255).astype(np.uint8).repeat(3, -1))
        imwrite(os.path.join(out_dir, "mask", f"{i:06d}.png"),
                (hit[..., None] * np.ones(3)).astype(np.uint8) * 255)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cameras)


def write_conf(tmp: str) -> str:
    """confs/wmask.conf with the scene, experiment directory and a
    TRAIN_STEPS-step schedule pointed into tmp; writes the scene too."""
    write_sphere_scene(os.path.join(tmp, "data", "sphere"))
    with open(os.path.join(HERE, "confs", "wmask.conf")) as f:
        text = f.read()
    subs = {r"base_exp_dir_geo = \S+": f"base_exp_dir_geo = {tmp}/exp/"
            "CASE_NAME/geometry",
            r"data_dir = \S+": f"data_dir = {tmp}/data/CASE_NAME/",
            r"end_iter = 300000": f"end_iter = {TRAIN_STEPS}",
            r"save_freq = \d+": f"save_freq = {TRAIN_STEPS}",
            r"val_freq = \d+": "val_freq = 100000",
            r"val_mesh_freq = \d+": "val_mesh_freq = 100000",
            r"report_freq = \d+": "report_freq = 10"}
    for pat, rep in subs.items():
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise AssertionError(f"conf edit {pat!r} matched {n} times")
    conf = os.path.join(tmp, "wmask.conf")
    with open(conf, "w") as f:
        f.write(text)
    return conf


def train_wmask(tmp: str):
    """Trains TRAIN_STEPS steps of full-width wmask.conf through the CLI;
    returns (runner, launches per kernel during training)."""
    import torch
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.ops import geometry_kernel as GK
    from factored_neus_tpu_torch.ops import sdf_kernel as SK
    from factored_neus_tpu_torch.utils import checkpoints as CK

    conf = write_conf(tmp)
    kernels = {"geometry_fwd": GK.K1_FWD, "geometry_bwd": GK.K1_BWD,
               "sdf_fwd": SK.SDF_FWD}
    for k in kernels.values():
        k.launches = 0
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
    if runner.iter_step != TRAIN_STEPS or len(runner.history) != 3:
        raise AssertionError("training did not run its steps")
    print(f"launches during {TRAIN_STEPS} training steps: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in training")
    ckpt = CK.load_checkpoint(runner.last_checkpoint)
    if int(ckpt["iter_step"]) != TRAIN_STEPS:
        raise AssertionError("checkpoint iter_step")
    for k, v in runner.model.sdf.state_dict().items():
        if not torch.equal(torch.from_numpy(ckpt["sdf_network_fine"][k]),
                           v.cpu()):
            raise AssertionError(f"checkpoint does not load back: {k}")
    print(f"checkpoint {os.path.basename(runner.last_checkpoint)} loads back")
    return runner, launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "factored_neus_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from factored_neus_tpu_torch.ops import _cuda

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    secs = _cuda.build_all()
    print(f"kernel build: {secs:.1f} s")
    for src, log in sorted(_cuda.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    device = torch.device("cuda")
    kernels = check_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        runner, launches = train_wmask(tmp)
    print(f"rays/s at iter {runner.history[-1]['iter']}: "
          f"{runner.history[-1]['rays_per_sec']:.0f} on {card}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
