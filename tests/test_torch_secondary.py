"""The PyTorch port's stage-2 pieces against the JAX package on bridged
weights (tests/util_scene.tiny_config, f32, CPU): the SG helpers, the
chunked sweeps, Lvis and IndirectLight, each secondary-ray function, and
lvis_render with the hemisphere draws reproduced from JAX's key.  Both
packages run with sweep_act_bf16 off, so their coarse sweeps are f32
(tests/test_torch_bf16_sweep.py holds the bf16 default)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import build_pair, make_rays

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.models import secondary as JSEC
from factored_neus_tpu.ops import chunk as JCH
from factored_neus_tpu.ops import sg as JSG
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.models import secondary as TSEC
from factored_neus_tpu_torch.ops import chunk as TCH
from factored_neus_tpu_torch.ops import sg as TSG

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5          # each sg and secondary function
RENDER_ATOL = 3e-4   # lvis_render's four maps (the JAX package's own)
t = torch.from_numpy


def pair2(fused: bool = True):
    """(jcfg, jparams, cfg, model): the tiny configs at f32 sweeps and a
    Stage2Model holding the same weights in every group."""
    jcfg, jparams, cfg, _ = build_pair()
    jcfg = dataclasses.replace(jcfg, sweep_act_bf16=False,
                               fused_fine_sweep=fused)
    cfg = dataclasses.replace(cfg, secondary_chunk=jcfg.secondary_chunk,
                              fused_fine_sweep=fused, sweep_act_bf16=False)
    model = TR.Stage2Model(cfg)
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    return jcfg, jparams, cfg, model


def closures(jcfg, jp, cfg, model):
    """The secondary functions' network closures: (jax, port) dicts."""
    geo, sdf_w = model.stage1, model.kernel_weights()[0]

    def vgf(p):
        return geo.sdf.value_grad_feat(p, sdf_w)
    jax_fns = {
        "sdf_fwd": lambda p: JF.sdf_value_sweep(jp["sdf"], jcfg.sdf, p),
        "sdf_apply_full": lambda p: JF.sdf_apply(jp["sdf"], jcfg.sdf, p),
        "sdf_grad": lambda p: JF.sdf_gradient(jp["sdf"], jcfg.sdf, p),
        "sdf_vgf": lambda p: JF.sdf_value_and_grad_feat(jp["sdf"], jcfg.sdf,
                                                        p),
        "color_fn": lambda p, n, d, f: JF.rendering_apply(
            jp["color"], jcfg.rendering, p, n, d, f),
        "lvis_fn": lambda p, d: JF.lvis_apply(jp["lvis"], jcfg.lvis, p, d),
        "indirect_fn": lambda p: JF.indirect_light_apply(
            jp["indirect"], jcfg.indirect, p)}
    port_fns = {
        "sdf_fwd": lambda p: geo.sdf.value_sweep(p, sdf_w),
        "sdf_apply_full": lambda p: torch.cat([vgf(p)[0][:, None],
                                               vgf(p)[1]], -1),
        "sdf_grad": lambda p: vgf(p)[2],
        "sdf_vgf": vgf,
        "color_fn": lambda p, n, d, f: geo.color(p, n, d, f),
        "lvis_fn": model.lvis,
        "indirect_fn": model.indirect}
    return jax_fns, port_fns


def _inv_s(jp):
    return float(np.exp(10.0 * np.asarray(jp["variance"]["variance"])))


def primary_rays(B=16, T=32, seed=3):
    """Rays through the unit sphere with T z values from near to far."""
    o, d, near, far = make_rays(B=B, seed=seed)
    z = near + (far - near) * np.linspace(0.0, 1.0, T, dtype=np.float32)
    return o, d, z.astype(np.float32)


def surface_points(P=12, seed=5):
    """Points and normals whose hemisphere rays see the surface: half at
    radius 0.8 facing the centre, half on radius 0.5 facing out."""
    rng = np.random.RandomState(seed)
    u = rng.randn(P, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = np.where(np.arange(P)[:, None] % 2 == 0, 0.8, 0.5)
    normal = np.where(np.arange(P)[:, None] % 2 == 0, -u, u)
    return (u * r).astype(np.float32), normal.astype(np.float32)


def jax_draws(P, seed=0):
    """cal_indi_lgt's two uniforms [P, 4] from key PRNGKey(seed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jax.random.uniform(k1, (P, TSEC.N_HEMI_DIRS))),
            np.array(jax.random.uniform(k2, (P, TSEC.N_HEMI_DIRS))))


def close(got, want, atol=ATOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=name)


# -- ops/sg.py, ops/chunk.py ---------------------------------------------

@pytest.mark.parametrize("n", [2, 64])
def test_fibonacci_sphere_matches_jax(n):
    np.testing.assert_array_equal(TSG.fibonacci_sphere(n),
                                  JSG.fibonacci_sphere(n))


@pytest.mark.parametrize("x_ref_axis", [0, 2])
def test_tangent_frame_and_sample_dirs_match_jax(x_ref_axis):
    rng = np.random.RandomState(0)
    axis = rng.randn(10, 1, 3).astype(np.float32)
    th = rng.rand(10, 4).astype(np.float32) * 6.28
    ph = rng.rand(10, 4).astype(np.float32) * 1.2
    for a, b in zip(TSG.tangent_frame(t(axis), x_ref_axis),
                    JSG.tangent_frame(jnp.asarray(axis), x_ref_axis)):
        close(a, b)
    close(TSG.sample_dirs(t(axis), t(th), t(ph), x_ref_axis),
          JSG.sample_dirs(jnp.asarray(axis), th, ph, x_ref_axis))


def test_query_sg_mixture_matches_jax():
    """IndirectLight's range: any axis, sharpness 0.1-30.1, amplitude >= 0,
    unit directions."""
    rng = np.random.RandomState(1)
    sgs = rng.randn(6, 24, 7).astype(np.float32)
    sgs[..., 3] = rng.rand(6, 24) * 30.0 + 0.1
    sgs[..., 4:] = np.abs(sgs[..., 4:])
    dirs = rng.randn(6, 4, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(TSG.query_sg_mixture(t(sgs), t(dirs)),
          JSG.query_sg_mixture(jnp.asarray(sgs), jnp.asarray(dirs)))


@pytest.mark.parametrize("n", [7, 64, 100])
def test_chunked_apply_matches_one_call_and_jax(n):
    x = np.random.RandomState(n).randn(n, 3).astype(np.float32)
    fn = lambda v: (v * v).sum(-1)
    tree = lambda v: (v[:, 0], v * 2.0)
    close(TCH.chunked_apply(fn, t(x), 16), fn(t(x)), 0.0)
    close(TCH.chunked_apply(fn, t(x), 16),
          JCH.chunked_apply(lambda v: (v * v).sum(-1), jnp.asarray(x), 16))
    for a, b in zip(TCH.chunked_apply_tree(tree, t(x), 16), tree(t(x)),
                    strict=True):
        close(a, b, 0.0)


# -- models/fields.py: Lvis, IndirectLight ---------------------------------

def test_lvis_and_indirect_light_match_jax():
    jcfg, jp, _, model = pair2()
    rng = np.random.RandomState(2)
    pts, dirs = (rng.randn(20, 3).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        close(model.lvis(t(pts), t(dirs)), jax.jit(
            lambda: JF.lvis_apply(jp["lvis"], jcfg.lvis, pts, dirs))())
        close(model.indirect(t(pts)), jax.jit(
            lambda: JF.indirect_light_apply(jp["indirect"], jcfg.indirect,
                                            pts))())
    assert [k for k in model.state_dict() if k.startswith("lvis.")][::2] == \
        [f"lvis.lvis.{i}.weight" for i in (0, 2, 4, 6, 8)]


# -- models/secondary.py ---------------------------------------------------

def test_surface_localize_matches_jax():
    rng = np.random.RandomState(4)
    B, T = 40, 16
    sdf = rng.randn(B, T).astype(np.float32)
    sdf[:5] = np.abs(sdf[:5])                     # no crossing
    sdf[5:8, :3] = 0.0                            # sign 0: ties in argmin
    mid_z = np.sort(rng.rand(B, T).astype(np.float32), -1)
    o, d = (rng.randn(B, 3).astype(np.float32) for _ in range(2))
    inside = rng.rand(B) > 0.2
    got = TSEC.surface_localize(t(mid_z), t(sdf), t(o), t(d), t(inside))
    want = JSEC.surface_localize(mid_z, sdf, o, d, inside)
    for a, b, name in zip(got, want, ("pts", "z", "mask")):
        close(a.to(torch.float32), np.asarray(b, np.float32), name=name)
    for a, b in zip(TSEC.first_crossing(t(sdf)), JSEC.first_crossing(sdf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compute_weight_and_cal_fir_hit_rgb_match_jax():
    jcfg, jp, cfg, model = pair2()
    jf, pf = closures(jcfg, jp, cfg, model)
    o, d, z = primary_rays()
    inv_s = _inv_s(jp)
    got = TSEC.compute_weight(pf["sdf_fwd"], pf["sdf_grad"], inv_s, t(o),
                              t(d), t(z), chunk=100)
    want = jax.jit(lambda: JSEC.compute_weight(
        jf["sdf_fwd"], jf["sdf_grad"], inv_s, o, d, z, chunk=100))()
    for a, b, name in zip(got, want, ("weights", "weights_inside")):
        close(a, b, name=name)
    rgb, hit = TSEC.cal_fir_hit_rgb(pf["sdf_apply_full"], pf["sdf_grad"],
                                    pf["color_fn"], t(o), t(d), t(z),
                                    chunk=100)
    jrgb, jhit = jax.jit(lambda: JSEC.cal_fir_hit_rgb(
        jf["sdf_apply_full"], jf["sdf_grad"], jf["color_fn"], o, d, z,
        chunk=100))()
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert hit.sum() >= 4
    close(rgb, jrgb, name="rgb")


def test_fine_sweep_targets_match_jax_and_the_split_path():
    jcfg, jp, cfg, model = pair2()
    jf, pf = closures(jcfg, jp, cfg, model)
    o, d, z = primary_rays()
    inv_s = _inv_s(jp)
    got = TSEC.fine_sweep_targets(pf["sdf_vgf"], pf["color_fn"], inv_s,
                                  t(o), t(d), t(z), chunk=100)
    want = jax.jit(lambda: JSEC.fine_sweep_targets(
        jf["sdf_vgf"], jf["color_fn"], inv_s, o, d, z, chunk=100))()
    names = ("rgb", "hit_mask", "weights", "weights_inside")
    for a, b, name in zip(got, want, names):
        close(a.to(torch.float32), np.asarray(b, np.float32), name=name)
    rgb, hit = TSEC.cal_fir_hit_rgb(pf["sdf_apply_full"], pf["sdf_grad"],
                                    pf["color_fn"], t(o), t(d), t(z))
    w, wi = TSEC.compute_weight(pf["sdf_fwd"], pf["sdf_grad"], inv_s, t(o),
                                t(d), t(z))
    for a, b, name in zip(got, (rgb, hit, w, wi), names):
        close(a.to(torch.float32), b.to(torch.float32), name=name)


TARGETS = ("gt_lvis", "pre_lvis", "gt_trace_radiance", "pre_trace_radiance")


@pytest.mark.parametrize("fused", [True, False])
def test_cal_indi_lgt_matches_jax(fused):
    jcfg, jp, cfg, model = pair2(fused)
    jf, pf = closures(jcfg, jp, cfg, model)
    surf, normal = surface_points()
    u_theta, u_z = jax_draws(len(surf))
    inv_s = _inv_s(jp)
    want = jax.jit(lambda: JSEC.cal_indi_lgt(
        jax.random.PRNGKey(0), surf, normal, jf["sdf_fwd"],
        jf["sdf_apply_full"], jf["sdf_grad"], inv_s, jf["color_fn"],
        jf["lvis_fn"], jf["indirect_fn"], chunk=jcfg.secondary_chunk,
        sdf_vgf=jf["sdf_vgf"] if fused else None))()
    with torch.no_grad():
        got = TSEC.cal_indi_lgt(
            t(surf), t(normal), pf["sdf_fwd"], pf["sdf_apply_full"],
            pf["sdf_grad"], inv_s, pf["color_fn"], pf["lvis_fn"],
            pf["indirect_fn"], u_theta=t(u_theta), u_z=t(u_z),
            chunk=cfg.secondary_chunk,
            sdf_vgf=pf["sdf_vgf"] if fused else None)
    for k in TARGETS:
        close(got[k], want[k], name=k)
    # the fixture sees occlusion and first hits, not only open sky
    assert got["gt_lvis"].min() < 0.5 and got["gt_trace_radiance"].max() > 0.1


def test_compute_light_visibility_matches_jax():
    jcfg, jp, cfg, model = pair2()
    jf, pf = closures(jcfg, jp, cfg, model)
    surf, normal = surface_points(P=6)
    inv_s = _inv_s(jp)
    want = jax.jit(lambda: JSEC.compute_light_visibility(
        jax.random.PRNGKey(0), surf, normal, jf["sdf_fwd"],
        jf["sdf_apply_full"], jf["sdf_grad"], inv_s, jf["color_fn"],
        jf["lvis_fn"], jf["indirect_fn"], n_lights=16,
        chunk=jcfg.secondary_chunk, sdf_vgf=jf["sdf_vgf"]))()
    with torch.no_grad():
        got = TSEC.compute_light_visibility(
            t(surf), t(normal), pf["sdf_fwd"], pf["sdf_apply_full"],
            pf["sdf_grad"], inv_s, pf["color_fn"], pf["lvis_fn"],
            pf["indirect_fn"], n_lights=16, chunk=cfg.secondary_chunk,
            sdf_vgf=pf["sdf_vgf"])
    for k in TARGETS:
        close(got[k], want[k], name=k)


# -- models/renderer.py: lvis_render -------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_lvis_render_matches_jax(fused):
    jcfg, jp, cfg, model = pair2(fused)
    o, d, near, far = (np.array(a) for a in make_rays(B=16, seed=3))
    u_theta, u_z = jax_draws(16, seed=7)
    want = jax.jit(lambda p, k: JR.lvis_render(p, jcfg, o, d, near, far, k))(
        jp, jax.random.PRNGKey(7))
    with torch.no_grad():
        got = TR.lvis_render(model, cfg, t(o), t(d), t(near), t(far),
                             u_theta=t(u_theta), u_z=t(u_z))
    np.testing.assert_array_equal(got["sdf_mask"].numpy(),
                                  np.asarray(want["sdf_mask"]))
    assert got["sdf_mask"].sum() >= 8
    for k in TARGETS:
        close(got[k], want[k], RENDER_ATOL, k)
    assert got["gt_lvis"].min() < 0.9


def test_stage2_model_rebuilds_its_packs_only_when_weights_change():
    _, jp, _, model = pair2()
    first = model.kernel_weights()
    assert model.kernel_weights() is first
    sdf = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5, jp["sdf"])
    bridge.load_jax_group(model, "sdf", sdf)
    again = model.kernel_weights()
    assert again is not first
    close(again[0][0][0], first[0][0][0] * 1.5, 1e-6)
