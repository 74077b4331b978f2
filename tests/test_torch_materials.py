"""The PyTorch port's stage-3 pieces against the JAX package on the same
numpy-seeded inputs and bridged weights (CPU, f32): the new ops/math.py
functions and the integrated directional encoding, the SG envmap and
integration functions, Lvis' factorised sweep, the Monte-Carlo visibility
queries with JAX's uniforms fed in, the SG rendering equation, the KL
sparsity loss, the envmap raster and init, EnvmapMaterial's forward and
the bridge of the material group."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_scene import tiny_config, tiny_params

from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.models import materials as JM
from factored_neus_tpu.ops import math as JU
from factored_neus_tpu.ops import sg as JSG
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import materials as TM
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.ops import math as TU
from factored_neus_tpu_torch.ops import sg as TSG

torch.backends.cuda.matmul.allow_tf32 = False
MATH_ATOL = 1e-5
SG_ATOL = 1e-4       # the JAX parity file's ATOL for the SG functions
t = torch.from_numpy


def close(got, want, atol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=name)


def unit(rng, *shape):
    v = rng.randn(*shape, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def material_config(jcfg) -> TM.EnvmapMaterialConfig:
    """The port's material config with the JAX config's fields."""
    return TM.EnvmapMaterialConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(TM.EnvmapMaterialConfig)})


@functools.lru_cache(maxsize=None)
def jax_pair(seed=0):
    """(jcfg, jparams): the tiny JAX config and its params (made once a
    process: eager JAX init takes seconds on the CPU)."""
    jcfg = tiny_config()
    return jcfg, tiny_params(jcfg, seed)


def material_pair(seed=0):
    """(jcfg, jparams, material, lvis): the tiny JAX config's material
    (16 lobes, 4 samples) and full-width Lvis, bridged into a fresh port
    model."""
    jcfg, jparams = jax_pair(seed)
    model = TR.Stage3Model(dataclasses.replace(
        TR.RendererConfig(), material=material_config(jcfg.material)))
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams),
                           groups=("lvis", "material"))
    return jcfg, jparams, model.material, model.lvis


def jax_vis_draws(key, n_rows, nsamp):
    """get_diffuse_visibility's two uniforms [n_rows, nsamp] from key."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (n_rows, nsamp))),
            np.array(jax.random.uniform(k2, (n_rows, nsamp))))


def surface(P=24, seed=5):
    """Points on radius 0.5 with outward normals, view directions towards
    a camera ring, and BRDF inputs in their ranges."""
    rng = np.random.RandomState(seed)
    n = unit(rng, P)
    pts = 0.5 * n
    cam = unit(rng, P) * 3.0
    view = cam - pts
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    return {"points": f32(pts), "normal": f32(n), "viewdirs": f32(view),
            "specular_reflectance": np.full((P, 3), 0.02, np.float32),
            "specular_albedo": f32(rng.uniform(0.05, 0.95, (P, 3))),
            "roughness": f32(rng.uniform(0.1, 0.99, (P, 1))),
            "diffuse_albedo": f32(rng.uniform(0.0, 1.0, (P, 3)))}


# -- ops/math.py -----------------------------------------------------------

def test_math_functions_match_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    x[:8] = rng.uniform(0.0, 0.04, (8, 3))             # the linear segment
    x[8, :] = [0.5, 0.5, 0.2]                          # ties at the max
    x[9, :] = [0.3, 0.7, 0.7]
    x[10, :] = 0.0                                     # v = 0
    close(TU.srgb_to_linear(t(x)), JU.srgb_to_linear(x), MATH_ATOL, "srgb")
    v = rng.randn(64, 3).astype(np.float32)
    v[0] = 0.0
    close(TU.norm_axis(t(v)), JU.norm_axis(v), MATH_ATOL, "norm_axis")
    cos = rng.uniform(-0.2, 1.0, (64, 1)).astype(np.float32)
    alpha = rng.uniform(0.01, 1.0, (64, 1)).astype(np.float32)
    close(TU.smith_g1(t(cos), t(alpha)), JU.smith_g1(cos, alpha), MATH_ATOL,
          "smith_g1")
    for name, a, b in zip("hsv", TU.rgb_to_hsv(t(x)), JU.rgb_to_hsv(x)):
        close(a, b, 1e-5 * max(1.0, float(np.abs(b).max())), name)


# at l = 16 (deg_view 5) the Legendre sums cancel from O(1e4) coefficients,
# so f32 keeps ~1e-4: the JAX function itself lies 7.1e-5 from the float64
# evaluation of the same formula on these inputs, the port 2.8e-5
IDE_ATOL = {4: MATH_ATOL, 5: 1e-4}


@pytest.mark.parametrize("deg_view", [4, 5])
def test_integrated_dir_enc_matches_jax(deg_view):
    """The port's IDE against the JAX package's (1e-5 at deg_view 4, 1e-4
    at 5) and no farther than it from the same formula in float64."""
    rng = np.random.RandomState(deg_view)
    xyz = unit(rng, 200)
    xyz[0] = [0.0, 0.0, 1.0]                           # on the pole
    kappa_inv = rng.uniform(0.0, 1.0, (200, 1)).astype(np.float32)
    fn = TU.generate_ide_fn(deg_view)
    got = fn(t(xyz), t(kappa_inv))
    want = np.asarray(JU.generate_ide_fn(deg_view)(jnp.asarray(xyz),
                                                   jnp.asarray(kappa_inv)))
    assert got.shape == want.shape
    close(got, want, IDE_ATOL[deg_view], f"ide {deg_view}")
    f64 = fn(t(xyz).double(), t(kappa_inv).double()).numpy()
    assert np.abs(got.numpy() - f64).max() <= max(
        np.abs(want - f64).max(), 1e-6)
    for a, b in zip(TU.ide_tables(deg_view), JU._ide_tables(deg_view)):
        np.testing.assert_array_equal(a, b)


# -- ops/sg.py ---------------------------------------------------------------

def _sgs(rng, M=16):
    sgs = rng.randn(M, 7).astype(np.float32)
    sgs[:, 3] = rng.uniform(-40.0, 40.0, M)            # |lambda| taken
    return sgs


def _sg_case(name, rng):
    """(port value, JAX value) of one SG function on seeded inputs."""
    sgs = _sgs(rng)
    if name == "compute_energy":
        return TSG.compute_energy(t(sgs)), JSG.compute_energy(sgs)
    if name == "render_envmap_sg":
        v = unit(rng, 5, 7)
        return TSG.render_envmap_sg(t(sgs), t(v)), JSG.render_envmap_sg(sgs,
                                                                        v)
    if name == "compute_envmap":
        return (TSG.compute_envmap(t(sgs), 16, 32, upper_hemi=True),
                JSG.compute_envmap(sgs, 16, 32, upper_hemi=True))
    P, M = 12, 16
    lobe1, lobe2 = unit(rng, P, M) * 2.0, unit(rng, P, M) * 0.5
    lam1 = rng.uniform(0.1, 30.0, (P, M, 1)).astype(np.float32)
    lam2 = rng.uniform(10.0, 900.0, (P, M, 1)).astype(np.float32)
    mu1, mu2 = (rng.uniform(0.0, 2.0, (P, M, 3)).astype(np.float32)
                for _ in range(2))
    if name == "lambda_trick":
        args = (lobe1, lam1, mu1, lobe2, lam2, mu2)
        return (torch.cat(TSG.lambda_trick(*map(t, args)), -1),
                jnp.concatenate(JSG.lambda_trick(*args), -1))
    if name == "hemisphere_int":
        cos = rng.uniform(-1.0, 1.0, (P, M, 1)).astype(np.float32)
        lam = np.concatenate([lam1, lam2], 1)
        cos = np.concatenate([cos, -cos], 1)
        return (TSG.hemisphere_int(t(lam), t(cos)),
                JSG.hemisphere_int(lam, cos))
    normal = np.broadcast_to(unit(rng, P)[:, None], (P, M, 3)).copy()
    return (TSG.integrate_rgb(t(normal), t(lobe2), t(lam2), t(mu1)),
            JSG.integrate_rgb(normal, lobe2, lam2, mu1))


@pytest.mark.parametrize("name", ["compute_energy", "render_envmap_sg",
                                  "compute_envmap", "lambda_trick",
                                  "hemisphere_int", "integrate_rgb"])
def test_sg_function_matches_jax(name):
    got, want = _sg_case(name, np.random.RandomState(7))
    assert tuple(got.shape) == tuple(want.shape)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got, want, SG_ATOL * scale, name)


def test_sg_epsilons_are_the_jax_packages():
    """render_envmap_sg normalises its lobes without TINY, lambda_trick
    with it: a lobe of length 1e-3 tells the two apart."""
    sgs = np.zeros((1, 7), np.float32)
    sgs[0, :3] = [1e-3, 0.0, 0.0]
    sgs[0, 3:] = [5.0, 1.0, 1.0, 1.0]
    v = np.array([[1.0, 0.0, 0.0]], np.float32)
    close(TSG.render_envmap_sg(t(sgs), t(v)), JSG.render_envmap_sg(sgs, v),
          1e-6)
    assert float(TSG.render_envmap_sg(t(sgs), t(v))[0, 0]) == \
        pytest.approx(1.0, abs=1e-6)
    lobe = t(sgs[:, :3])
    lam = torch.full((1, 1), 5.0)
    got = TSG.lambda_trick(lobe, lam, lam, lobe, lam, lam)[0]
    want = JSG.lambda_trick(sgs[:, :3], 5.0, 5.0, sgs[:, :3], 5.0, 5.0)[0]
    close(got, want, 1e-6)
    assert float(torch.linalg.norm(got)) < 0.9999


# -- fields.Lvis.outer --------------------------------------------------------

def test_lvis_outer_matches_jax_and_the_flat_forward():
    jcfg, jparams, _, lvis = material_pair()
    rng = np.random.RandomState(1)
    P, D = 7, 11
    pts = (rng.randn(P, 3) * 0.4).astype(np.float32)
    dirs = unit(rng, D)
    with torch.no_grad():
        got = lvis.outer(t(pts), t(dirs))
        flat = lvis(t(np.broadcast_to(pts[None], (D, P, 3)).reshape(-1, 3)),
                    t(np.broadcast_to(dirs[:, None], (D, P, 3)
                                      ).reshape(-1, 3))).reshape(D, P)
    want = JF.lvis_apply_outer(jparams["lvis"], jcfg.lvis, pts, dirs)
    assert got.shape == (D, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=2e-5,
                               atol=2e-6)


# -- the visibility queries ----------------------------------------------------

def test_diffuse_visibility_matches_jax():
    jcfg, jparams, material, lvis = material_pair()
    s = surface()
    lgt = jparams["material"]["lgtSGs"]
    lobes = np.asarray(JU.norm_axis(lgt[:, :3]))
    lam = np.abs(np.asarray(lgt[:, 3:4]))
    key = jax.random.PRNGKey(4)
    u = jax_vis_draws(key, lgt.shape[0], 4)
    want = JM.get_diffuse_visibility(key, s["points"], s["normal"],
                                     jparams["lvis"], jcfg.lvis, lobes, lam,
                                     nsamp=4)
    got = TM.get_diffuse_visibility(t(s["points"]), t(s["normal"]), lvis,
                                    t(lobes), t(lam), nsamp=4,
                                    u_theta=t(u[0]), u_phi=t(u[1]))
    assert got.shape == (16, 24) and not got.requires_grad
    close(got, want, SG_ATOL, "diffuse visibility")
    assert float(got.min()) == 0.0 and 0.3 < float(got.max()) <= 1.0


def test_specular_visibility_matches_jax_with_a_degenerate_row():
    jcfg, jparams, _, lvis = material_pair()
    s = surface(P=6)
    rng = np.random.RandomState(2)
    n, v = s["normal"], s["viewdirs"]
    ref = -v + 2.0 * np.maximum((n * v).sum(-1, keepdims=True), 0) * n
    lobes = unit(rng, 6)
    lobes[0] = -ref[0] / np.linalg.norm(ref[0])        # opposite the lobe
    lam = rng.uniform(1.0, 20.0, (6, 1)).astype(np.float32)
    lam[0], lam[1] = 50.0, 0.1       # row 0 samples within 5 deg of ref[0]
    key = jax.random.PRNGKey(6)
    u = jax_vis_draws(key, 6, 24)
    want = JM.get_specular_visibility(key, s["points"], n, v, jparams["lvis"],
                                      jcfg.lvis, lobes, lam)
    got = TM.get_specular_visibility(t(s["points"]), t(n), t(v), lvis,
                                     t(lobes), t(lam), u_theta=t(u[0]),
                                     u_phi=t(u[1]))
    close(got, want, SG_ATOL, "specular visibility")
    phi_range = np.arccos(1.0 - 1.9 * 0.1 / 50.0)
    dirs = TSG.sample_dirs(t(ref[:1, None]), t(u[0][:1]) * 2 * np.pi,
                           t(u[1][:1]) * phi_range, x_ref_axis=2)
    logw = 50.0 * (dirs @ t(lobes[0]) - 1.0)
    assert float(torch.exp(logw).sum()) <= TM.TINY    # row 0 is degenerate


# -- the SG rendering equation -------------------------------------------------

def _jax_render(fn, s, lgt, jparams, jcfg, key, **kw):
    return fn(s["points"], s["normal"], s["viewdirs"], lgt,
              s["specular_reflectance"], s["specular_albedo"],
              s["roughness"], s["diffuse_albedo"], lvis_params=jparams["lvis"],
              lvis_cfg=jcfg.lvis, key=key, vis_nsamp=4, **kw)


RENDER_INPUTS = ("lgt", "specular_albedo", "roughness", "diffuse_albedo")


@pytest.mark.parametrize("comp_vis", [True, False])
def test_render_with_sg_matches_jax(comp_vis):
    """Every output, and the gradients of their sum (a seeded cotangent)
    with respect to the light SGs and the BRDF inputs."""
    jcfg, jparams, _, lvis = material_pair()
    s = surface()
    rng = np.random.RandomState(3)
    P = s["points"].shape[0]
    lgt = np.broadcast_to(np.asarray(jparams["material"]["lgtSGs"])[None],
                          (P, 16, 7)).copy()
    lgt[:, :, 3] *= np.where(rng.rand(P, 16) < 0.3, -1.0, 1.0)  # abs(lambda)
    key = jax.random.PRNGKey(8)
    u = jax_vis_draws(key, 16, 4)
    keys = ("env_rgb", "diffuse_rgb", "specular_rgb", "lvis_mean")
    cot = {k: rng.randn(P, 3).astype(np.float32) for k in keys}

    def jfun(lgt_, sa, r, da):
        out = JM.render_with_sg(s["points"], s["normal"], s["viewdirs"], lgt_,
                                s["specular_reflectance"], sa, r, da,
                                comp_vis=comp_vis,
                                lvis_params=jparams["lvis"],
                                lvis_cfg=jcfg.lvis, key=key, vis_nsamp=4)
        return sum(jnp.sum(out[k] * cot[k]) for k in keys), out

    jin = (lgt, s["specular_albedo"], s["roughness"], s["diffuse_albedo"])
    (_, want), jg = jax.value_and_grad(jfun, argnums=(0, 1, 2, 3),
                                       has_aux=True)(*jin)
    tin = [t(a.copy()).requires_grad_() for a in jin]
    got = TM.render_with_sg(t(s["points"]), t(s["normal"]), t(s["viewdirs"]),
                            tin[0], t(s["specular_reflectance"]), *tin[1:],
                            comp_vis=comp_vis, lvis=lvis, vis_nsamp=4,
                            u_theta=t(u[0]), u_phi=t(u[1]))
    for k in keys:
        close(got[k], want[k], SG_ATOL, k)
    sum(torch.sum(got[k] * t(cot[k])) for k in keys).backward()
    for name, a, b in zip(RENDER_INPUTS, tin, jg):
        b = np.asarray(b)
        close(a.grad, b, 6e-4 + 3e-3 * np.abs(b).max(), f"d/d {name}")
    assert bool((got["lvis_mean"] > 0).any()) == comp_vis


def test_render_with_all_sg_matches_jax():
    jcfg, jparams, material, lvis = material_pair()
    s = surface()
    P = s["points"].shape[0]
    rng = np.random.RandomState(4)
    indi = np.concatenate([unit(rng, P, 24),
                           rng.uniform(0.1, 30.0, (P, 24, 1)),
                           rng.uniform(0.0, 0.5, (P, 24, 3))],
                          -1).astype(np.float32)
    lgt = np.asarray(jparams["material"]["lgtSGs"])
    key = jax.random.PRNGKey(9)
    u = jax_vis_draws(key, 16, 4)
    want = _jax_render(JM.render_with_all_sg, s, lgt, jparams, jcfg, key,
                       indir_lgt_sgs=indi)
    with torch.no_grad():
        got = TM.render_with_all_sg(
            t(s["points"]), t(s["normal"]), t(s["viewdirs"]), t(lgt),
            t(s["specular_reflectance"]), t(s["specular_albedo"]),
            t(s["roughness"]), t(s["diffuse_albedo"]), lvis=lvis,
            indir_lgt_sgs=t(indi), vis_nsamp=4, u_theta=t(u[0]),
            u_phi=t(u[1]))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], SG_ATOL, k)
    assert float(got["indir_rgb"].max()) > 0.05


@pytest.mark.parametrize("mask", ["none", "some", "zero_hit"])
def test_kl_divergence_matches_jax(mask):
    rng = np.random.RandomState(5)
    raw = (rng.randn(20, 32) * 3).astype(np.float32)
    raw[0, 0] = 40.0                                   # a saturated latent
    m = {"none": None, "some": rng.rand(20) < 0.5,
         "zero_hit": np.zeros(20, bool)}[mask]
    x = t(raw).requires_grad_()
    got = TM.kl_divergence(0.05, x, None if m is None else t(m))
    want, jg = jax.value_and_grad(
        lambda r: JM.kl_divergence(0.05, r, mask=m))(raw)
    close(got, want, MATH_ATOL * max(1.0, abs(float(want))), "kl")
    got.backward()
    close(x.grad, jg, 1e-6, "d kl")
    if mask == "zero_hit":
        assert float(got) == 0.0 and not x.grad.any()


# -- EnvmapMaterial ------------------------------------------------------------

def test_envmap_raster_and_init():
    jcfg, jparams, material, _ = material_pair()
    with torch.no_grad():
        close(TM.get_light(material, 32, 64),
              JM.get_light(jparams["material"], 32, 64), SG_ATOL, "envmap")
        assert TM.get_light(material).shape == (256, 512, 3)
    own = TM.EnvmapMaterial(TM.EnvmapMaterialConfig(),
                            torch.Generator().manual_seed(3))
    sgs = own.lgtSGs.detach()
    assert sgs.shape == (128, 7)
    np.testing.assert_array_equal(sgs[:64, :3], sgs[64:, :3])
    np.testing.assert_allclose(sgs[:64, :3].numpy(),
                               TSG.fibonacci_sphere(64), atol=1e-7)
    assert float(sgs[:, 3].min()) >= 10.0
    np.testing.assert_array_equal(sgs[:, 4], sgs[:, 5])
    np.testing.assert_array_equal(sgs[:, 4], sgs[:, 6])
    np.testing.assert_allclose(TSG.compute_energy(sgs).sum(0).numpy(),
                               [2 * np.pi * 0.8] * 3, rtol=1e-5)
    layers = [k for k in own.state_dict() if k.endswith(".weight")]
    assert layers == ([f"brdf_encoder_layer.{i}.weight"
                       for i in (0, 2, 4, 6, 8)]
                      + [f"brdf_decoder_layer.{i}.weight" for i in (0, 2, 4)]
                      + [f"net_cs.{i}.weight" for i in (0, 2, 4, 6, 8)])


def test_envmap_material_forward_matches_jax():
    """EnvmapMaterial.forward against envmap_material_apply on bridged
    weights, with hit and missed rays in the mask: every output, and every
    material gradient of a seeded cotangent."""
    jcfg, jparams, material, lvis = material_pair()
    s = surface()
    P = s["points"].shape[0]
    rng = np.random.RandomState(6)
    ray_dirs = -s["viewdirs"] * 1.7                    # normalised inside
    n = s["normal"] * 2.0
    indi = np.concatenate([unit(rng, P, 24),
                           rng.uniform(0.1, 30.0, (P, 24, 1)),
                           rng.uniform(0.0, 0.5, (P, 24, 3))],
                          -1).astype(np.float32)
    hit = rng.rand(P) < 0.6
    key = jax.random.PRNGKey(10)
    u = jax_vis_draws(key, 16, 4)
    keys = ("rgb", "env_rgb", "indir_rgb", "diffuse_rgb", "specular_rgb",
            "lvis_mean", "roughness", "diffuse_albedo", "specular_albedo")
    cot = {k: rng.randn(P, 1 if k == "roughness" else 3).astype(np.float32)
           for k in keys}

    def jloss(mp):
        out = JM.envmap_material_apply(mp, jcfg.material, key, s["points"],
                                       ray_dirs, n, None, indi,
                                       jparams["lvis"], jcfg.lvis,
                                       hit_mask=hit)
        return (sum(jnp.sum(out[k] * cot[k]) for k in keys)
                + out["encoder_loss"]), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams["material"])
    got = material(t(s["points"]), t(ray_dirs), t(n), t(indi), lvis,
                   hit_mask=t(hit), u_theta=t(u[0]), u_phi=t(u[1]))
    for k in keys + ("encoder_loss",):
        close(got[k], want[k], SG_ATOL, k)
    (sum(torch.sum(got[k] * t(cot[k])) for k in keys)
     + got["encoder_loss"]).backward()
    tg = bridge.jax_tree(material_owner(material), grads=True,
                         groups=("material",))["material"]
    for a, b in zip(jax.tree_util.tree_leaves(tg),
                    jax.tree_util.tree_leaves(jg), strict=True):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 6e-4 + 3e-3 * np.abs(b).max()


def material_owner(material):
    """A stand-in model holding only the material group (for bridge)."""
    class Owner(torch.nn.Module):
        GROUPS = ("material",)
    owner = Owner()
    owner.material = material
    return owner


def test_material_bridge_roundtrip():
    _, jparams, material, _ = material_pair(seed=2)
    got = bridge.jax_tree(material_owner(material))["material"]
    want = jparams["material"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and back: the port's values into a fresh material equal the original
    fresh = TM.EnvmapMaterial(material.cfg, torch.Generator().manual_seed(9))
    bridge.load_jax_group(material_owner(fresh), "material", got)
    for (k, a), b in zip(fresh.state_dict().items(),
                         material.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
