"""The bf16 sweeps and the bf16 radiance MLP of the PyTorch port: K2-bf16
(stage 2's default coarse sweep, sweep_act_bf16, and every sampling sweep
under use_pallas_sampling) and K3-fwd-bf16 / K3-bwd-bf16 (the radiance MLP
of the render core under core_act_bf16).  Their plain twins are held
against the JAX package's bf16 Pallas bodies in interpret mode
(sdf_forward_pallas(bf16_matmul=True), rendering_apply_pallas(bf16=True))
and against the XLA paths they stand for (sdf_value_sweep and
rendering_apply with act_dtype=bfloat16); then a stage-1 step, a stage-2
step and a use_pallas_sampling ladder against the JAX package with the
same switches.  Each comparison asks the port to be within the JAX
package's own bf16 tolerance AND closer to JAX's rounded result than
JAX's f32 result is (max and rms), which an f32 port would not be.  The
CUDA kernels are held against these twins on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import SDF_ATOL, TWIN_RTOL
from test_torch_kernels import CASES, _setup
from test_torch_radiance import _setup as _rad_setup
from test_torch_render import build_pair, make_rays
from test_torch_secondary import jax_draws, pair2
from test_torch_stage1 import GROUPS, _batch, _jax_loss_and_grads
from util_packs import ROW_MAJOR

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import fields as F
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.ops import pallas_radiance as PR
from factored_neus_tpu.ops import sampling as JS
from factored_neus_tpu.ops.pallas_sdf import sdf_forward_pallas
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.data import rays as TRAYS
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.models import secondary as TSEC
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import sampling as TS
from factored_neus_tpu_torch.ops import sdf_kernel as SK
from factored_neus_tpu_torch.ops import tc_pack as TP
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import losses as TL
from factored_neus_tpu_torch.train import stage1 as TS1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t = torch.from_numpy
BF16 = jnp.bfloat16
# the JAX package's own bf16 tolerances (tests/test_pallas_geometry.py):
# values within SDF_ATOL (3e-2) abs of the f32 ones, and gradients within
# GRAD_REL (5%) relative L2 of them (test_bf16_backward_gradients_close)
GRAD_REL = 0.05


def _dist(a, b):
    """(max, rms) of |a - b|."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(np.sqrt((d ** 2).mean()))


def _closer(port, j16, j32, atol, name):
    """Within atol of JAX-bf16 (max), and closer to it than JAX-f32 is, in
    max and in rms.  Returns the port's (max, rms) distance over JAX-f32's."""
    (pm, pr), (fm, fr) = _dist(port, j16), _dist(j32, j16)
    assert pm <= atol, (name, pm, atol)
    assert pm < fm and pr < fr, (name, (pm, pr), (fm, fr))
    return pm / fm, pr / fr


# -- the packs and the kernels' arguments ------------------------------------

def test_bf16_packs_serve_k2_narrowed_and_k3():
    """K3-fwd-bf16 takes the bf16 slab pack (make_fwd_pack(bf16=True),
    K3-bwd-bf16's forward pack) and refuses a row-major layout and the
    f32 slab pack; K2-bf16 takes the full network's slab pack
    (tc_pack.sweep_layout) for its narrowed last layer and refuses the
    f32 slab layout and a row-major one (and K2 a row-major and the bf16
    slab layout); the
    kernels' shared memory at full width (K2-bf16's ring
    six slabs of 32 KB, 231,808 B, five of 33 KB for the full output;
    K3-fwd-bf16 on wgmma six slabs of 32 KB, 216,320 B with one consumer
    and 229,632 B with two; K3-fwd on wgmma 226,336 B) and their
    counters."""
    rcfg = TF.RenderingConfig()
    rng = np.random.RandomState(0)
    rws = [t(rng.randn(o, i).astype(np.float32))
           for i, o in zip(rcfg.dims[:-1], rcfg.dims[1:])]
    assert [w.shape[1] for w in rws] == [289, 256, 256, 256, 256]
    slab16 = RK.make_fwd_pack(rcfg, rws, bf16=True)
    assert torch.equal(slab16[0], RK.make_bwd_slabs(rcfg, rws)[0][0])
    for n, sms, nc in ((64, 132, 1), (65536, 132, 2)):
        plan = RK.fwd_wg16_plan(rcfg, rws, n, slab16[1], sms)
        assert plan["nc"] == nc
        assert plan["sweep_smem"] == (216320 if nc == 1 else 229632)
        assert plan["sweep_smem"] <= TP.SMEM_MAX
    with pytest.raises(ValueError, match="takes the bf16 slab pack"):
        RK.fwd_wg16_plan(rcfg, rws, 64, ROW_MAJOR[1], 132)
    with pytest.raises(ValueError, match="takes the bf16 slab pack"):
        RK.fwd_wg16_plan(rcfg, rws, 64, RK.make_fwd_pack(rcfg, rws)[1], 132)
    with pytest.raises(ValueError, match="takes the f32 slab"):
        RK.fwd_wg_plan(rcfg, rws, 64, slab16[1], 132)
    assert RK.WGF_FWD_SMEM == 226336 <= TP.SMEM_MAX

    cfg = TF.SDFConfig()
    ws = [torch.zeros(o, i) for i, o in zip(cfg.dims[:-1], (
        256, 256, 256, 217, 256, 256, 256, 256, 257))]
    wn = ws[:-1] + [ws[-1][:1]]
    ins, outs, _ = SK.layer_dims(cfg, wn)
    sweep = TP.sweep_layout([w.shape[1] for w in ws],
                            [w.shape[0] for w in ws], (4,), cfg.d_embed)
    assert sweep.nslab == [1, 4, 4, 4, 5, 4, 4, 4, 4]
    assert sweep.enc == [1, 0, 0, 0, 1, 0, 0, 0, 0]
    assert sweep.cols == [256] * 8 + [264]
    # 1,048,576 rows: two consumer warpgroups, a block an SM; 8,192: one
    iargs, grid = SK.sweep_iargs(cfg, wn, 1 << 20, sweep, 132)
    assert grid == 132 and iargs[4:7] == [2, 132, 8192]
    iargs, grid = SK.sweep_iargs(cfg, wn, 8192, sweep, 132)
    assert grid == 128 and iargs[4:7] == [1, 128, 128]
    assert SK.sweep_smem(len(wn), 2, 256 * 128) == (6, 231808)
    assert SK.sweep_smem(len(wn), 2, 264 * 128) == (5, 204144)
    with pytest.raises(ValueError, match="wgmma: it takes the f32"):
        SK.sweep_wg_plan(cfg, wn, 64, ROW_MAJOR[1], 132)
    with pytest.raises(ValueError, match="wgmma: it takes the f32"):
        SK.sweep_wg_plan(cfg, wn, 64, sweep, 132)
    with pytest.raises(ValueError, match="wgmma: it takes no wgmma-f32"):
        SK.sweep_iargs(cfg, wn, 64, TP.sweep_layout_f32(
            ins, outs, (4,), cfg.d_embed), 132)
    with pytest.raises(ValueError, match="wgmma: it takes no row-major"):
        SK.sweep_iargs(cfg, wn, 64, ROW_MAJOR[1], 132)
    with pytest.raises(ValueError, match="slab layout"):
        SK.sweep_iargs(cfg, ws, 64, TP.sweep_layout(ins, outs, (4,), 39),
                       132)
    assert {SK.KERNELS[True].name, RK.KERNELS["fwd", True].name,
            RK.KERNELS["bwd", True].name} == {
        "sdf_fwd_bf16", "radiance_fwd_bf16", "radiance_bwd_bf16"}


# -- K2-bf16 ------------------------------------------------------------------

@pytest.mark.parametrize("scale,skip", CASES)
def test_k2_bf16_twin_matches_jax(scale, skip):
    """value_sweep(bf16=True) (K2-bf16's twin, the last layer narrowed) on
    150 ragged rows against sdf_forward_pallas(bf16_matmul=True) in
    interpret mode (the same roundings: within TWIN_RTOL of max|sdf|) and
    against sdf_value_sweep(act_dtype=bfloat16) (the XLA path, which
    rounds a skip layer's input twice: within the JAX package's bf16
    tolerance, 3e-2); each closer than JAX's f32 sweep is, in max and
    rms."""
    jcfg, params, net, x = _setup(scale, skip)
    with torch.no_grad():
        got = net.value_sweep(t(x), bf16=True).numpy()
        f32 = net.value_sweep(t(x)).numpy()
    xj = jnp.asarray(x)
    j32 = np.asarray(F.sdf_value_sweep(params, jcfg, xj))
    pallas = np.asarray(sdf_forward_pallas(params, jcfg, xj,
                                           bf16_matmul=True, block_rows=64))
    xla = np.asarray(F.sdf_value_sweep(params, jcfg, xj, act_dtype=BF16))
    np.testing.assert_allclose(f32, j32, atol=1e-5)
    _closer(got, pallas, j32, TWIN_RTOL * (1 + np.abs(pallas).max()),
            "pallas")
    _closer(got, xla, j32, SDF_ATOL, "xla")


# -- K3-fwd-bf16 and K3-bwd-bf16 ----------------------------------------------

def _rad_loss_jax(fn, jcfg):
    def loss(p, pts, normals, dirs, feat):
        rgb = fn(p, jcfg, pts, normals, dirs, feat)
        return jnp.mean(rgb ** 2) + jnp.sum(rgb[:, 0] * pts[:, 0]) * 1e-3
    return loss


RAD_REFS = {
    "pallas": lambda bf16: lambda p, c, *a: PR.rendering_apply_pallas(
        p, c, *a, bf16=bf16, block_rows=64),
    "xla": lambda bf16: lambda p, c, *a: F.rendering_apply(
        p, c, *a, act_dtype=BF16 if bf16 else None)}


@functools.lru_cache(maxsize=None)
def _rad_jax(ref):
    """JAX's rgb and its gradients (params, then pts, normals, dirs, feat)
    through ``ref`` in bf16 and in f32."""
    jcfg, params, _, inputs = _rad_setup()
    out = {}
    for bf16 in (True, False):
        fn = RAD_REFS[ref](bf16)
        loss = _rad_loss_jax(fn, jcfg)
        g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(params, *inputs)
        out[bf16] = (np.asarray(fn(params, jcfg, *inputs)),
                     [np.asarray(a) for a in jax.tree_util.tree_leaves(g)])
    return out


@pytest.mark.parametrize("ref", sorted(RAD_REFS))
def test_k3_bf16_twins_match_jax(ref):
    """RenderingNetwork(bf16=True) on 150 ragged rows (the twins: the
    forward, and through RadianceFn the explicit backward) against
    rendering_apply_pallas(bf16=True) in interpret mode and against
    rendering_apply(act_dtype=bfloat16).  Against Pallas, whose roundings
    the twins repeat: rgb and each gradient (every v, g and b, and the
    cotangents of pts, normals, dirs and feat) within TWIN_RTOL of its
    largest entry and closer to JAX-bf16 than JAX-f32 is, in max and rms,
    per tensor.  Against XLA: rgb within 3e-2 (the JAX package's bf16
    tolerance) and closer per tensor; each gradient within 5% relative L2
    (GRAD_REL), and all of them, each scaled by its largest entry, closer
    than JAX-f32's in max and rms.  Not per tensor: the XLA path casts each
    weight to bf16 before its product, so its weight cotangents come out
    rounded to bf16, which Pallas and the port do not do; in the last
    layer's three-wide tensors that rounding alone is as large as the f32
    path's distance."""
    jcfg, params, net, inputs = _rad_setup()
    leaves = [t(a).requires_grad_(True) for a in inputs]
    rgb = net(*leaves, bf16=True)
    lt = torch.mean(rgb ** 2) + torch.sum(rgb[:, 0] * leaves[0][:, 0]) * 1e-3
    lt.backward()
    tree = bridge.jax_tree_layers(net, grads=True)
    port = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)] + [
        v.grad.numpy() for v in leaves]
    (r16, g16), (r32, g32) = _rad_jax(ref)[True], _rad_jax(ref)[False]
    assert len(port) == len(g16) == len(g32)
    pallas = ref == "pallas"
    _closer(rgb.detach().numpy(), r16, r32,
            TWIN_RTOL if pallas else SDF_ATOL, "rgb")
    for i, (a, b, c) in enumerate(zip(port, g16, g32)):
        if pallas:
            _closer(a, b, c, TWIN_RTOL * np.abs(b).max() + 1e-7, f"grad[{i}]")
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < GRAD_REL, (i, rel)
    scaled = lambda gs: np.concatenate([(g / np.abs(b).max()).ravel()
                                        for g, b in zip(gs, g16)])
    ratios = _closer(scaled(port), scaled(g16), scaled(g32), np.inf,
                     "gradients")
    print(f"K3 bf16 twins against JAX {ref}: gradients, each scaled by its "
          f"largest entry, port to JAX-bf16 over JAX-f32 to JAX-bf16 "
          f"(max, rms) {ratios[0]:.3f}, {ratios[1]:.3f}")


# -- the stage-1 step with the render core in bf16 ----------------------------

def _group_dist(tree, want):
    """Per gradient group that the step reaches, the largest per-leaf
    max |a - b| / max |b|."""
    out = {}
    for g in GROUPS:
        leaves = jax.tree_util.tree_leaves(tree[g])
        ref = [np.asarray(b) for b in jax.tree_util.tree_leaves(want[g])]
        if not any(np.abs(b).max() > 0 for b in ref):
            continue
        out[g] = max(float(np.abs(np.asarray(a) - b).max())
                     / max(float(np.abs(b).max()), 1e-12)
                     for a, b in zip(leaves, ref, strict=True))
    return out


def test_stage1_step_with_bf16_core_matches_jax(monkeypatch):
    """One stage-1 step on the same weights, batch and jitter with
    core_act_bf16 on in both packages (JAX: its Pallas geometry core in
    interpret mode and the XLA radiance MLP at act_dtype=bfloat16; the
    port: K1's and K3's bf16 twins).  Every gradient group lies at least
    as close to JAX's (per group, the largest relative max error over its
    leaves) as the same step with the radiance MLP left f32, as PR 11's
    port ran it, and the colour network's strictly closer; the loss too."""
    jcfg, jparams, cfg, model = build_pair()
    jcfg = dataclasses.replace(jcfg, use_pallas_geometry=True,
                               core_act_bf16=True)
    o, d, rgb, mask = _batch()
    step = 20
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)
    key = jax.random.PRNGKey(11)
    k1, _ = jax.random.split(key)
    t_rand = t(np.array(jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))
    (jl, jg), _ = _jax_loss_and_grads(jcfg, jparams, tcfg, o, d, rgb, mask,
                                      key, step)
    jl = float(jl)
    cfg16 = dataclasses.replace(cfg, core_act_bf16=True)

    def port_step():
        model.zero_grad(set_to_none=True)
        tl, _ = TS1.loss_on_batch(model, cfg16, tcfg, t(o), t(d), t(rgb),
                                  t(mask), step, t_rand=t_rand)
        tl.backward()
        return float(tl.detach()), bridge.jax_tree(model, grads=True)

    l_now, g_now = port_step()
    # PR 11's port: K1 in bf16, the radiance MLP in f32
    forward = TF.RenderingNetwork.forward
    monkeypatch.setattr(TF.RenderingNetwork, "forward",
                        lambda self, p, n, v, f, weights=None, bf16=False:
                        forward(self, p, n, v, f, weights))
    l_old, g_old = port_step()
    now, old = _group_dist(g_now, jg), _group_dist(g_old, jg)
    print(f"stage-1 step, core in bf16: loss port {l_now:.8f} (radiance "
          f"f32: {l_old:.8f}) JAX {jl:.8f}; per group relative max error "
          f"now {now}, with the radiance MLP in f32 {old}")
    assert abs(l_now - jl) < abs(l_old - jl), (l_now, l_old, jl)
    assert set(now) == {"sdf", "color", "variance", "ref_color"}
    assert all(now[g] <= old[g] for g in now), (now, old)
    assert now["color"] < old["color"], (now, old)


# -- stage 2 with the bf16 coarse sweep ---------------------------------------

def _stage2_step(jcfg, jparams, cfg, model, grads: bool, seed=3):
    """One stage-2 step in each package on the same rays and hemisphere
    draws: (JAX's loss, gradients (None unless ``grads``) and gt_lvis,
    then the port's)."""
    o, d, _, _ = make_rays(B=16, seed=seed)
    u_theta, u_z = jax_draws(16, seed)
    sub = {k: jparams[k] for k in ("lvis", "indirect")}
    leaves = lambda tree: [np.asarray(a) for g in ("lvis", "indirect")
                           for a in jax.tree_util.tree_leaves(tree[g])]

    def loss(p):
        near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
        out = JR.lvis_render({**jparams, **p}, jcfg, o, d, near, far,
                             jax.random.PRNGKey(seed))
        return JL.stage2_losses(out, lambda x: x)[0], out["gt_lvis"]

    if grads:
        (jl, jmap), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            sub)
        jg = leaves(jg)
    else:
        (jl, jmap), jg = jax.jit(loss)(sub), None
    model.zero_grad(set_to_none=True)
    near, far = TRAYS.near_far_from_sphere(t(o), t(d))
    out = TR.lvis_render(model, cfg, t(o), t(d), near, far, t(u_theta),
                         t(u_z))
    tl, metrics = TL.stage2_losses(out)
    assert metrics["n_hit"] >= 8
    tl.backward()
    tg = bridge.jax_tree(model, grads=True, groups=("lvis", "indirect"))
    return ((float(jl), jg, np.asarray(jmap)),
            (float(tl.detach()), leaves(tg), out["gt_lvis"].detach().numpy()))


def test_stage2_step_with_bf16_coarse_sweep_matches_jax():
    """One stage-2 step with sweep_act_bf16 on in both packages (JAX: the
    XLA coarse sweep at act_dtype=bfloat16; the port: K2-bf16's twin), on
    the same weights, rays and hemisphere draws, and JAX's step with it
    off.  The coarse sweep only places the fine samples, so what it moves
    is the occlusion target gt_lvis: within 3e-4 abs (the JAX package's
    lvis_render tolerance) of JAX-bf16's and closer to it than JAX's f32
    sweep's, in max and rms; the loss within 1e-5 relative and closer
    too; the lvis and indirect gradients (which see the target only
    through the sign of an L1 residual) within the stage-2 tolerance
    1.2e-3 + 3e-3 max|g| (tests/test_torch_stage2.py).  (The fixture's
    secondary rays hit no surface, so gt_trace_radiance is 0 in all
    three.)"""
    jcfg, jparams, cfg, model = pair2()
    (jl16, jg16, jm16), (tl16, tg16, tm16) = _stage2_step(
        dataclasses.replace(jcfg, sweep_act_bf16=True), jparams,
        dataclasses.replace(cfg, sweep_act_bf16=True), model, True)
    (jl32, _, jm32), _ = _stage2_step(
        dataclasses.replace(jcfg, sweep_act_bf16=False), jparams,
        dataclasses.replace(cfg, sweep_act_bf16=False), model, False)
    assert abs(tl16 - jl16) <= 1e-5 * abs(jl16), (tl16, jl16)
    assert abs(tl16 - jl16) < abs(jl32 - jl16), (tl16, jl16, jl32)
    for a, b in zip(tg16, jg16, strict=True):
        assert np.abs(a - b).max() <= 1.2e-3 + 3e-3 * np.abs(b).max()
    ratios = _closer(tm16, jm16, jm32, 3e-4, "gt_lvis")
    print(f"stage-2 step, bf16 coarse sweep: gt_lvis port to JAX-bf16 over "
          f"JAX-f32 to JAX-bf16 (max, rms) {ratios[0]:.3f}, "
          f"{ratios[1]:.3f}; loss port {tl16:.8f} JAX {jl16:.8f} (f32 "
          f"sweep {jl32:.8f})")


def test_coarse_sweep_alone_takes_the_bf16_sweep(monkeypatch):
    """lvis_render with sweep_act_bf16 hands cal_indi_lgt the bf16 sweep
    for the coarse sweep only (the targets' sweeps stay f32); with both
    switches off it hands it the f32 sweep, so the f32 path is the old
    one bit for bit; use_pallas_sampling puts both on K2-bf16, as the JAX
    package's _sdf_fwd_sampling does."""
    _, _, cfg, model = pair2()
    o, d, near, far = map(np.array, make_rays(B=4, seed=1))
    seen = {}
    orig = TSEC.cal_indi_lgt

    def spy(surf, normal, sdf_fwd, *a, sdf_fwd_coarse=None, **kw):
        x = torch.from_numpy(np.random.RandomState(0).randn(50, 3)
                             .astype(np.float32) * 0.4)
        seen["fwd"], seen["coarse"] = sdf_fwd(x), sdf_fwd_coarse(x)
        return orig(surf, normal, sdf_fwd, *a, sdf_fwd_coarse=sdf_fwd_coarse,
                    **kw)
    monkeypatch.setattr(TSEC, "cal_indi_lgt", spy)
    geo = model.stage1.sdf
    x = torch.from_numpy(np.random.RandomState(0).randn(50, 3)
                         .astype(np.float32) * 0.4)
    with torch.no_grad():
        s32, s16 = geo.value_sweep(x), geo.value_sweep(x, bf16=True)
    assert not torch.equal(s32, s16)
    for flags, want in (((False, True), (s32, s16)),
                        ((False, False), (s32, s32)),
                        ((True, False), (s16, s16)),
                        ((True, True), (s16, s16))):
        c = dataclasses.replace(cfg, use_pallas_sampling=flags[0],
                                sweep_act_bf16=flags[1])
        with torch.no_grad():
            TR.lvis_render(model, c, t(o), t(d), t(near), t(far),
                           *map(t, jax_draws(4)))
        assert torch.equal(seen["fwd"], want[0]), flags
        assert torch.equal(seen["coarse"], want[1]), flags
    base = TR.RendererConfig()
    assert base.sweep_act_bf16 is True and base.use_pallas_sampling is False


# -- the ladder under use_pallas_sampling -------------------------------------

def test_pallas_sampling_ladder_matches_jax():
    """The up-sampling ladder's z_vals with use_pallas_sampling on in both
    packages (JAX: _sdf_fwd_sampling's Pallas sweep, bf16_matmul, in
    interpret mode; the port: render's sweep, K2-bf16's twin) on the same
    rays: within 1e-4 abs (a z moves by its bin's share of an sdf step, a
    bf16 rounding parted by sum order moves it by ~1e-6), and closer to
    JAX's than JAX's f32 ladder is, in max and rms."""
    jcfg, jparams, cfg, model = build_pair()
    o, d, near, far = make_rays(B=12, seed=4)
    z0 = near + (far - near) * np.linspace(0, 1, cfg.n_samples)[None]
    z0 = z0.astype(np.float32)
    zj = {}
    for on in (True, False):
        c = dataclasses.replace(jcfg, use_pallas_sampling=on)
        zj[on] = np.asarray(jax.jit(lambda o, d, z: JS.hierarchical_z_vals(
            JR._sdf_fwd_sampling(jparams, c), o, d, z, c.n_importance,
            c.up_sample_steps))(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(z0)))
    c16 = dataclasses.replace(cfg, use_pallas_sampling=True)
    weights = model.kernel_weights(False, True)
    with torch.no_grad():
        zt = TS.hierarchical_z_vals(
            TR.sampling_sweep(model.sdf, c16, weights[0]), t(o), t(d),
            t(z0), c16.n_importance, c16.up_sample_steps).numpy()
    _closer(zt, zj[True], zj[False], 1e-4, "z_vals")
