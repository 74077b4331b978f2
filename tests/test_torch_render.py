"""The PyTorch port's stage-1 fields and renderer against the JAX package on
bridged weights (tests/util_scene.tiny_config, f32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_scene import tiny_config, tiny_params

from factored_neus_tpu.data import rays as JRAYS
from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import renderer as TR

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def port_config(jcfg) -> TR.RendererConfig:
    """The port's RendererConfig with the JAX config's stage-1 fields."""
    sub = lambda cls, c: cls(**{f: getattr(c, f) for f in
                                cls.__dataclass_fields__})
    return TR.RendererConfig(
        n_samples=jcfg.n_samples, n_importance=jcfg.n_importance,
        n_outside=jcfg.n_outside, up_sample_steps=jcfg.up_sample_steps,
        perturb=jcfg.perturb, sdf=sub(TF.SDFConfig, jcfg.sdf),
        rendering=sub(TF.RenderingConfig, jcfg.rendering),
        refcolor=sub(TF.RefColorConfig, jcfg.refcolor))


def build_pair(seed=0):
    jcfg = tiny_config()
    jparams = tiny_params(jcfg, seed)
    cfg = port_config(jcfg)
    model = TR.Stage1Model(cfg)
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, cfg, model


def make_rays(B=24, seed=0):
    """Rays from a ring of cameras at radius 3 through the unit sphere."""
    rng = np.random.RandomState(seed)
    ang = rng.uniform(0, 2 * np.pi, B)
    o = np.stack([3 * np.sin(ang), rng.uniform(-0.3, 0.3, B),
                  -3 * np.cos(ang)], -1)
    d = -o + rng.randn(B, 3) * 0.25
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    near, far = JRAYS.near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
    return o, d, np.asarray(near), np.asarray(far)


def test_bridge_roundtrip():
    _, jparams, _, model = build_pair()
    got = bridge.jax_tree(model)
    want = {k: jparams[k] for k in ("sdf", "color", "variance", "ref_color")}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_fields_match_jax():
    jcfg, jparams, _, model = build_pair()
    rng = np.random.RandomState(1)
    n = 40
    pts, nrm, dirs = (rng.randn(n, 3).astype(np.float32) for _ in range(3))
    feat = rng.randn(n, jcfg.sdf.d_out - 1).astype(np.float32)
    t = torch.from_numpy
    with torch.no_grad():
        rgb = model.color(t(pts), t(nrm), t(dirs), t(feat))
        ref = model.ref_color(t(pts), t(feat), t(dirs), t(nrm))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(JF.rendering_apply(
        jparams["color"], jcfg.rendering, pts, nrm, dirs, feat)), atol=1e-6)
    jref = JF.refcolor_apply(jparams["ref_color"], jcfg.refcolor, pts, feat,
                             dirs, nrm)
    for k in ("rgb", "specular_rgb", "diffuse_rgb"):
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(jref[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        float(model.variance.inv_s()),
        float(JF.variance_inv_s(jparams["variance"])), rtol=1e-6)


OUT_KEYS = ("color_fine", "surface_color", "sdf_mask", "s_val", "cdf_fine",
            "weight_sum", "weight_max", "gradients", "weights",
            "gradient_error", "inside_sphere", "specular_color",
            "diffuse_color")


@pytest.mark.parametrize("jitter", [False, True])
def test_render_matches_jax(jitter):
    jcfg, jparams, cfg, model = build_pair()
    o, d, near, far = make_rays()
    kw = dict(cos_anneal_ratio=0.37)
    t_rand = None
    if jitter:
        key = jax.random.PRNGKey(5)
        k1, _ = jax.random.split(key)
        t_rand = torch.from_numpy(np.asarray(
            jax.random.uniform(k1, (o.shape[0], 1)) - 0.5))
        jout = jax.jit(lambda p: JR.render(p, jcfg, o, d, near, far,
                                           key=key, **kw))(jparams)
    else:
        jout = jax.jit(lambda p: JR.render(p, jcfg, o, d, near, far,
                                           key=None, perturb_overwrite=0.0,
                                           **kw))(jparams)
    t = torch.from_numpy
    with torch.no_grad():
        tout = TR.render(model, cfg, t(o), t(d), t(near), t(far),
                         t_rand=t_rand, **kw)
    assert bool(tout["sdf_mask"].any()) and not bool(tout["sdf_mask"].all())
    for k in OUT_KEYS:
        np.testing.assert_allclose(tout[k].detach().numpy().astype(np.float32),
                                   np.asarray(jout[k]).astype(np.float32),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def test_render_refuses_background_nerf():
    _, _, cfg, model = build_pair()
    import dataclasses
    o, d, near, far = make_rays(4)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError):
        TR.render(model, dataclasses.replace(cfg, n_outside=8), t(o), t(d),
                  t(near), t(far))
