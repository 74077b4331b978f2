"""The three JAX switches in the PyTorch port: the matmul mode
(FNEUS_MATMUL_PRECISION, ops/mlp.py), FNEUS_NERF_ACT_BF16 and
FNEUS_PALLAS_GEOMETRY (models/renderer.RendererConfig).

JAX on the CPU runs every precision as f32, so the JAX reference of a TPU's
one bf16 pass is emulated here: the JAX package's dense_apply and
wn_dense_apply are swapped (pytest's monkeypatch; its files stay as they
are) for a product that rounds both operands to bf16 and sums in f32, its
two backward products in the same mode, as XLA keeps a dot's precision in
its transposes.  lvis_apply_outer's two direct products get a reference of
their own.  Each site of the mode is held against that reference at the
JAX package's bf16 bar (tests/test_pallas_geometry.py::
test_bf16_variant_close) and must be closer to it than JAX's f32 result
is (test_torch_bf16._closer's rule)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_materials import material_config, unit
from test_torch_render import make_rays, port_config
from test_torch_stage1 import GROUPS, _batch
from util_scene import tiny_config, tiny_params

from factored_neus_tpu.data.rays import near_far_from_sphere
from factored_neus_tpu.models import fields as JF
from factored_neus_tpu.models import materials as JM
from factored_neus_tpu.models import renderer as JR
from factored_neus_tpu.ops import mlp as JMLP
from factored_neus_tpu.ops.embedder import positional_encoding as jpe
from factored_neus_tpu.train import losses as JL
from factored_neus_tpu.utils import schedule as JSCH
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.ops import geometry_kernel as GK
from factored_neus_tpu_torch.ops import mlp as M
from factored_neus_tpu_torch.ops.embedder import positional_encoding
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX package's bf16 bar (tests/test_pallas_geometry.py:105-111):
# values, gradients
VAL_ATOL, GRAD_ATOL = 3e-2, 5e-2
# PERF.md §2's stage-1 gate: 3e-4 + 2e-3 max|g|
GATE_ABS, GATE_REL = 3e-4, 2e-3
t = torch.from_numpy
# the JAX package's own weight-normed product (f32 on the CPU)
_WN_F32 = JMLP.wn_dense_apply


@pytest.fixture(autouse=True)
def _f32_mode():
    """Every test starts and ends with the matmul mode unset (f32)."""
    M.set_matmul_precision(None)
    yield
    M.set_matmul_precision(None)


# -- the JAX reference of a TPU's bf16 passes ---------------------------------

def _rnd(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _passes(a, b, mode):
    """a @ b as a TPU runs XLA's DEFAULT ('bf16': one bf16 pass) or HIGH
    ('bf16x3': hi hi + hi lo + lo hi) precision, f32 sums."""
    dot = lambda u, v: jnp.dot(u, v, precision="highest")
    ah, bh = _rnd(a), _rnd(b)
    if mode == "bf16":
        return dot(ah, bh)
    al, bl = _rnd(a - ah), _rnd(b - bh)
    return (dot(ah, bl) + dot(al, bh)) + dot(ah, bh)


@functools.lru_cache(maxsize=None)
def tpu_dot(mode):
    """The product of ``mode`` with its backward's two products in the same
    mode (differentiable again)."""
    @jax.custom_vjp
    def dot(a, b):
        return _passes(a, b, mode)

    def fwd(a, b):
        return dot(a, b), (a, b)

    def bwd(res, g):
        a, b = res
        return dot(g, b.T), dot(a.T, g)

    dot.defvjp(fwd, bwd)

    def apply(x, w):
        y = dot(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return apply


def patch_jax(monkeypatch, mode):
    """Swaps the JAX package's dense_apply and wn_dense_apply for products
    in ``mode`` (None: leaves them, f32 on the CPU)."""
    if mode is None or mode == "f32":
        return
    dot = tpu_dot(mode)

    def dense_apply(p, x):
        return dot(x, p["w"]) + p["b"]

    def wn_dense_apply(p, x):
        v, g = p["v"], p["g"]
        col_norm = jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
        w = v * (g[None, :] / jnp.maximum(col_norm, 1e-12))
        return dot(x, w) + p["b"]

    monkeypatch.setattr(JMLP, "dense_apply", dense_apply)
    monkeypatch.setattr(JMLP, "wn_dense_apply", wn_dense_apply)


def jax_lvis_outer(params, cfg, pts, dirs, mode):
    """lvis_apply_outer (models/fields.py:422-453) with its two direct
    first-layer products in ``mode``; layers 2-5 through dense_apply (the
    caller patches it)."""
    dot = (tpu_dot(mode) if mode in ("bf16", "bf16x3") else
           lambda u, v: jnp.dot(u, v, precision="highest"))
    pe_p = jpe(pts, cfg.multires_pts)
    pe_d = jpe(dirs, cfg.multires_view)
    dp = pe_p.shape[-1]
    w1, b1 = params[0]["w"], params[0]["b"]
    x = jax.nn.relu(dot(pe_d, w1[dp:])[:, None, :]
                    + dot(pe_p, w1[:dp])[None, :, :] + b1)
    x = x.reshape(-1, x.shape[-1])
    for i in range(1, len(params)):
        x = JMLP.dense_apply(params[i], x)
        if i < len(params) - 1:
            x = jax.nn.relu(x)
    return jax.nn.sigmoid(x).reshape(pe_d.shape[0], pts.shape[0])


# -- the sites ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pair():
    jcfg = tiny_config()
    return jcfg, jax.tree_util.tree_map(np.asarray, tiny_params(jcfg, 0))


def port_stage3(jcfg, jparams):
    """A Stage3Model on the tiny JAX config's weights (every group)."""
    cfg = dataclasses.replace(
        port_config(jcfg), lvis=TR.F.LvisConfig(**dataclasses.asdict(
            jcfg.lvis)),
        indirect=TR.F.IndirectLightConfig(**dataclasses.asdict(
            jcfg.indirect)),
        material=material_config(jcfg.material))
    model = TR.Stage3Model(cfg)
    bridge.load_jax_params(model, jparams)
    return cfg, model


def _inputs(name, jcfg):
    """numpy inputs of a site, from a seed."""
    rng = np.random.RandomState(11)
    n = 48
    f = lambda *s: rng.randn(*s).astype(np.float32)
    if name in ("refcolor", "radiance"):
        return (f(n, 3) * 0.4, f(n, jcfg.sdf.d_out - 1), unit(rng, n),
                unit(rng, n))
    if name == "nerf":
        p = f(n, 3)
        p /= np.linalg.norm(p, axis=-1, keepdims=True) + 1.0
        r = rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32)
        return np.concatenate([p, r], -1), unit(rng, n)
    if name == "lvis":
        return f(n, 3) * 0.4, unit(rng, n)
    if name == "lvis_outer":
        return f(9, 3) * 0.4, unit(rng, 13)
    if name == "indirect":
        return (f(n, 3) * 0.4,)
    if name == "material":
        return f(n, 3) * 0.4, unit(rng, n)
    if name == "sweep":
        return (f(n, 3) * 0.5,)
    raise KeyError(name)


# each site: (JAX params group, jax fn(params, *inputs), port fn(model,
# cfg, *inputs) under the current mode)
def _jax_material(p, cfg, pts, dirs):
    pts_enc = jpe(pts, cfg.multires_pts)
    ref_enc = jpe(dirs, cfg.multires_view)
    raw = JM._leaky_mlp(p["brdf_encoder"], pts_enc)
    brdf = jax.nn.sigmoid(JM._leaky_mlp(p["brdf_decoder"],
                                        jax.nn.sigmoid(raw)))
    spec = JM._leaky_mlp(p["net_cs"], jnp.concatenate([pts_enc, ref_enc], -1),
                         final_activation=jax.nn.sigmoid)
    return jnp.concatenate([raw, brdf, spec], -1)


def _port_material(m, cfg, pts, dirs):
    mat = m.material
    pts_enc = positional_encoding(pts, mat.cfg.multires_pts)
    ref_enc = positional_encoding(dirs, mat.cfg.multires_view)
    raw = mat.brdf_encoder_layer(pts_enc)
    brdf = torch.sigmoid(mat.brdf_decoder_layer(torch.sigmoid(raw)))
    spec = mat.net_cs(torch.cat([pts_enc, ref_enc], -1))
    return torch.cat([raw, brdf, spec], -1)


def _stack(d):
    return (jnp.concatenate if isinstance(d["rgb"], jnp.ndarray)
            else torch.cat)([d["rgb"], d["specular_rgb"], d["diffuse_rgb"]],
                            -1)


SITES = {
    "refcolor": ("ref_color",
                 lambda p, c, pts, feat, d, n: _stack(JF.refcolor_apply(
                     p, c.refcolor, pts, feat, d, n)),
                 lambda m, c, pts, feat, d, n: _stack(
                     m.stage1.ref_color(pts, feat, d, n))),
    "nerf": ("nerf",
             lambda p, c, x, d: jnp.concatenate(JF.nerf_apply(
                 p, c.nerf, x, d), -1),
             lambda m, c, x, d: torch.cat(m.stage1.nerf(x, d), -1)),
    "lvis": ("lvis", lambda p, c, x, d: JF.lvis_apply(p, c.lvis, x, d),
             lambda m, c, x, d: m.lvis(x, d)),
    "lvis_outer": ("lvis", None, lambda m, c, x, d: m.lvis.outer(x, d)),
    "indirect": ("indirect",
                 lambda p, c, x: JF.indirect_light_apply(p, c.indirect, x),
                 lambda m, c, x: m.indirect(x)),
    "material": ("material", lambda p, c, x, d: _jax_material(
                     p, c.material, x, d),
                 lambda m, c, x, d: _port_material(m, c, x, d)),
    "radiance": ("color",
                 lambda p, c, pts, feat, d, n: JF.rendering_apply(
                     p, c.rendering, pts, n, d, feat),
                 lambda m, c, pts, feat, d, n: m.stage1.color(
                     pts, n, d, feat, None, TR.color_bf16(c))),
    # the ladder's sweep: K2-bf16's twin under the mode (no gradient)
    "sweep": ("sdf", lambda p, c, x: JF.sdf_value_sweep(p, c.sdf, x),
              lambda m, c, x: TR.sampling_sweep(
                  m.stage1.sdf, c, m.stage1.sdf.kernel_weights())(x)),
}


def _jax_site(name, mode, monkeypatch):
    """(out, grads of the JAX params group) of a site with JAX's products
    in ``mode``; the loss is sum(out * r), r fixed."""
    group, jfn, _ = SITES[name]
    jcfg, jparams = _jax_pair()
    ins = _inputs(name, jcfg)
    with monkeypatch.context() as mp:
        patch_jax(mp, mode)
        if name == "lvis_outer":
            fn = lambda p, *a: jax_lvis_outer(p, jcfg.lvis, *a, mode)
        else:
            fn = lambda p, *a: jfn(p, jcfg, *a)
        if name == "sweep":
            return np.asarray(jax.jit(fn)(jparams[group], *ins)), None

        def loss(p):
            out = fn(p, *ins)
            r = np.random.RandomState(5).rand(*out.shape).astype(np.float32)
            return jnp.sum(out * r), out
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jparams[group])
    return np.asarray(out), [np.asarray(a) for a in
                             jax.tree_util.tree_leaves(g)]


def _port_site(name, mode):
    group, _, pfn = SITES[name]
    jcfg, jparams = _jax_pair()
    cfg, model = port_stage3(jcfg, jparams)
    model.requires_grad_(True)
    ins = [t(a) for a in _inputs(name, jcfg)]
    M.set_matmul_precision(mode)
    out = pfn(model, cfg, *ins)
    if name == "sweep":
        return out.detach().numpy(), None
    r = t(np.random.RandomState(5).rand(*out.shape).astype(np.float32))
    torch.sum(out * r).backward()
    g = bridge.jax_tree(model, grads=True, groups=(group,))[group]
    return out.detach().numpy(), jax.tree_util.tree_leaves(g)


def closer(port, j16, j32, atol, name):
    """Within atol of the rounded JAX result, and closer to it than JAX's
    f32 result is (max abs per tensor); where JAX's two results agree
    exactly, the port within f32 summation order of them."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    d_port = float(np.abs(port - j16).max())
    d_f32 = float(np.abs(j32 - j16).max())
    assert d_port <= atol, (name, d_port, atol)
    if d_f32 == 0.0:
        # a sum that no rounding reaches (a bias gradient): f32 order only
        assert d_port <= 1e-5 * (1.0 + np.abs(j16).max()), (name, d_port)
        return 0.0
    assert d_port < d_f32, (name, d_port, d_f32)
    return d_port / d_f32


@pytest.mark.parametrize("name", list(SITES))
def test_site_in_one_bf16_pass_matches_the_tpu_emulation(name, monkeypatch):
    """Each site of the mode under FNEUS_MATMUL_PRECISION=default: its
    output and every parameter gradient within the JAX package's bf16 bar
    of the JAX site with one bf16 pass a product, and closer to it than
    JAX's f32 site is.  The radiance MLP takes K3's bf16 operand mode,
    the ladder's sweep K2-bf16's twin."""
    o16, g16 = _jax_site(name, "bf16", monkeypatch)
    o32, g32 = _jax_site(name, None, monkeypatch)
    out, grads = _port_site(name, "default")
    ratios = [closer(out, o16, o32, VAL_ATOL, f"{name} out")]
    if grads is not None:
        assert len(grads) == len(g16) > 0
        for i, (a, b, c) in enumerate(zip(grads, g16, g32)):
            ratios.append(closer(a, b, c, GRAD_ATOL, f"{name} grad[{i}]"))
    print(f"{name}: port to JAX-bf16 / JAX-f32 to JAX-bf16, worst "
          f"{max(ratios):.3f}")


def test_high_is_three_bf16_passes(monkeypatch):
    """'high' (hi hi + hi lo + lo hi) on Lvis.outer, forward and
    gradients: within 1e-6 + 1e-5 max|ref| of the JAX emulation of a TPU's
    HIGH, and within 5e-5 max|ref| of f32, which one pass is not."""
    o3, g3 = _jax_site("lvis_outer", "bf16x3", monkeypatch)
    o32, g32 = _jax_site("lvis_outer", None, monkeypatch)
    o16, _ = _jax_site("lvis_outer", "bf16", monkeypatch)
    out, grads = _port_site("lvis_outer", "high")
    for a, b, c in zip([out] + grads, [o3] + g3, [o32] + g32):
        assert np.abs(a - b).max() <= 1e-6 + 1e-5 * np.abs(b).max()
        assert np.abs(a - c).max() <= 5e-5 * np.abs(c).max()
    assert np.abs(o16 - o32).max() > 5e-5 * np.abs(o32).max()


# -- defaults and refusals ----------------------------------------------------

def test_mode_values_and_refusals():
    for value, mode in (("highest", "f32"), ("float32", "f32"),
                        (None, "f32"), ("default", "bf16"),
                        ("bfloat16", "bf16"), ("high", "bf16x3")):
        assert M.matmul_mode_of(value) == mode
        M.set_matmul_precision(value)
        assert M.matmul_mode() == mode and M.MATMUL_PRECISION == value
        assert M.one_pass() == (mode == "bf16")
    M.set_matmul_precision("high")
    with pytest.raises(ValueError, match="bfloat16, default, float32, "
                                         "high, highest"):
        M.set_matmul_precision("bf16")
    assert M.matmul_mode() == "bf16x3"
    for value, on in ((None, True), ("auto", True), ("1", True),
                      ("0", False)):
        assert TR.pallas_geometry_switch(value) is on
    with pytest.raises(ValueError, match="FNEUS_PALLAS_GEOMETRY"):
        TR.pallas_geometry_switch("yes")
    cfg = TR.RendererConfig()
    assert cfg.use_pallas_geometry and not cfg.nerf_act_bf16
    assert not TR.ladder_bf16(cfg) and not TR.color_bf16(cfg)
    M.set_matmul_precision("default")
    assert TR.ladder_bf16(cfg) and TR.color_bf16(cfg)


def test_unset_is_highest_bit_for_bit():
    """With the mode unset the port computes what it computed before the
    mode existed (nn.functional.linear and torch.matmul), and 'highest'
    computes the same bits: a stage-1 step's loss and gradients, and
    every stage-2 and stage-3 site."""
    jcfg, jparams = _jax_pair()
    o, d, rgb, mask = _batch()
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1, anneal_end=50.0,
                          end_iter=100)
    t_rand = t(np.random.RandomState(2).rand(o.shape[0], 1).astype(
        np.float32) - 0.5)
    runs = []
    for mode in (None, "highest", "float32"):
        M.set_matmul_precision(mode)
        cfg, model = port_stage3(jcfg, jparams)
        loss, _ = TS1.loss_on_batch(model.stage1, cfg, tcfg, t(o), t(d),
                                    t(rgb), t(mask), 20, t_rand=t_rand)
        loss.backward()
        outs = [loss.detach()] + [p.grad for p in model.stage1.parameters()
                                  if p.grad is not None]
        for name in ("lvis", "lvis_outer", "indirect", "material"):
            ins = [t(a) for a in _inputs(name, jcfg)]
            outs.append(SITES[name][2](model, cfg, *ins).detach())
        runs.append(outs)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    # the f32 mode's products are the plain torch calls
    lin = TR.F._linear(5, 3, torch.Generator().manual_seed(0))
    x = torch.randn(7, 5)
    assert torch.equal(lin(x), torch.nn.functional.linear(
        x, lin.weight, lin.bias))


def test_a_mode_change_drops_the_captured_graph():
    """A captured step graph keeps the mode it was captured in: after a
    change StepTrainer drops it (the next graph step warms up and captures
    anew) and never replays the old mode; the same mode keeps it."""
    trainer = TC.StepTrainer.__new__(TC.StepTrainer)
    sentinel = object()
    for same in (True, False):
        trainer._graph, trainer._static = sentinel, ("loss", {})
        trainer._counts, trainer._warm = [lambda: None], TC.WARMUP_STEPS
        trainer._graph_mode = "f32"
        M.set_matmul_precision(None if same else "default")
        trainer._drop_stale_graph()
        if same:
            assert trainer._graph is sentinel
        else:
            assert trainer._graph is None and trainer._warm == 0
            assert trainer._counts == [] and trainer._graph_mode is None


# -- the geometry's XLA path (FNEUS_PALLAS_GEOMETRY=0) ------------------------

def test_geometry_autograd_path_second_derivative_is_finite():
    """value_grad_feat_autograd differentiates twice (the eikonal loss)
    with a finite result where beta x is large (softplus_beta's own
    backward), in f32 and under the mode with the bf16 act path, and in
    f32 it is K1's twin's function."""
    jcfg, jparams = _jax_pair()
    _, model = port_stage3(jcfg, jparams)
    net = model.stage1.sdf.requires_grad_(True)
    x = t(np.random.RandomState(3).randn(64, 3).astype(np.float32) * 2.0)
    ws, bs = net.effective_weights()
    out, grad = GK.geometry_plain(ws, bs, x, net.cfg)
    for mode, act in ((None, False), ("default", True)):
        M.set_matmul_precision(mode)
        net.zero_grad()
        s, f, g = net.value_grad_feat_autograd(x, act_bf16=act)
        eik = torch.sum((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
        (eik + s.sum()).backward()
        for p in net.parameters():
            assert torch.isfinite(p.grad).all()
        if mode is None:
            torch.testing.assert_close(s, out[:, 0], atol=1e-5, rtol=0)
            torch.testing.assert_close(f, out[:, 1:], atol=1e-5, rtol=0)
            torch.testing.assert_close(g, grad, atol=1e-5, rtol=0)
    with torch.no_grad():
        s, _, g = net.value_grad_feat_autograd(x)
    assert not s.requires_grad and not g.requires_grad


# -- stage-1 steps in both packages -------------------------------------------

def _tcfg():
    return TC.TrainConfig(igr_weight=0.1, mask_weight=0.1,
                          surface_weight=0.1, anneal_end=50.0,
                          warm_up_end=0.0, end_iter=100)


@functools.lru_cache(maxsize=None)
def _case(n_outside):
    jcfg = tiny_config(n_outside)
    jparams = jax.tree_util.tree_map(np.asarray, tiny_params(jcfg, 0))
    o, d, rgb, mask = _batch()
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    t_rand = np.asarray(jax.random.uniform(k1, (o.shape[0], 1)) - 0.5)
    t_out = (np.asarray(jax.random.uniform(k2, (o.shape[0], n_outside)))
             if n_outside else None)
    return jcfg, jparams, (o, d, rgb, mask), key, t_rand, t_out


def _jax_step(n_outside, mode, core_bf16, monkeypatch, nerf_bf16=False):
    """JAX's stage-1 loss and gradients (GROUPS' leaves) with its products
    in ``mode`` outside the geometry: the geometry is the XLA path in f32
    (or act_dtype bf16 with core_bf16), standing in for the Pallas body,
    which ignores MATMUL_PRECISION."""
    jcfg, jparams, (o, d, rgb, mask), key, _, _ = _case(n_outside)
    jcfg = dataclasses.replace(jcfg, core_act_bf16=core_bf16,
                               use_pallas_geometry=False)
    tcfg = _tcfg()
    sub = {k: jparams[k] for k in GROUPS}
    with monkeypatch.context() as mp:
        patch_jax(mp, mode)
        mp.setenv("FNEUS_NERF_ACT_BF16", "1" if nerf_bf16 else "0")
        geometry = JF.sdf_value_and_grad_feat

        def f32_geometry(*a, **k):
            with monkeypatch.context() as inner:
                inner.setattr(JMLP, "wn_dense_apply", _WN_F32)
                return geometry(*a, **k)
        mp.setattr(JF, "sdf_value_and_grad_feat", f32_geometry)

        def loss(p):
            near, far = near_far_from_sphere(jnp.asarray(o), jnp.asarray(d))
            out = JR.render({**jparams, **p}, jcfg, o, d, near, far, key=key,
                            cos_anneal_ratio=JSCH.cos_anneal_ratio(
                                20, tcfg.anneal_end))
            return JL.stage1_losses(out, rgb, mask, tcfg,
                                    reduce=lambda x: x)[0]
        jl, jg = jax.jit(jax.value_and_grad(loss))(sub)
    return float(jl), [np.asarray(a) for a in jax.tree_util.tree_leaves(jg)]


def _port_step(n_outside, mode, **cfg_fields):
    jcfg, jparams, (o, d, rgb, mask), _, t_rand, t_out = _case(n_outside)
    cfg = dataclasses.replace(port_config(jcfg), **cfg_fields)
    model = TR.Stage1Model(cfg)
    bridge.load_jax_params(model, jparams)
    M.set_matmul_precision(mode)
    loss, _ = TS1.loss_on_batch(
        model, cfg, _tcfg(), t(o), t(d), t(rgb), t(mask), 20,
        t_rand=t(t_rand), t_rand_out=None if t_out is None else t(t_out))
    loss.backward()
    tree = bridge.jax_tree(model, grads=True)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return float(loss.detach()), [(jax.tree_util.keystr(p), np.asarray(a))
                                  for p, a in leaves]


def _hold_step(port, j16, j32, closer_groups=()):
    """The loss and every gradient within JAX's own bf16-to-f32 distance
    plus the stage-1 gate; the groups in ``closer_groups`` closer to the
    rounded JAX step than JAX's f32 step is."""
    (tl, tg), (l16, g16), (l32, g32) = port, j16, j32
    assert abs(tl - l16) <= abs(l32 - l16) + 1e-5 * abs(l16), (tl, l16, l32)
    assert len(tg) == len(g16) == len(g32)
    for (name, a), b, c in zip(tg, g16, g32):
        if any(name.startswith(f"['{g}']") for g in closer_groups):
            closer(a, b, c, GRAD_ATOL, name)
        tol = np.abs(c - b).max() + GATE_ABS + GATE_REL * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)


@functools.lru_cache(maxsize=None)
def _jax_f32_step(n_outside, core_bf16):
    mp = pytest.MonkeyPatch()
    try:
        return _jax_step(n_outside, None, core_bf16, mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("core_bf16", [False, True])
def test_stage1_step_under_default_matches_the_tpu_emulation(
        core_bf16, monkeypatch):
    """One stage-1 step under FNEUS_MATMUL_PRECISION=default (and with
    FNEUS_CORE_ACT_BF16=1), both packages on the same weights, batch and
    jitter: JAX's products in one bf16 pass outside the geometry, the
    port's ladder on K2-bf16's twin, its radiance MLP in K3's bf16 mode
    and RefColor in the mode.  Without core_bf16, RefColor's and the
    radiance MLP's gradients are closer to the rounded JAX step than
    JAX's f32 step is; with it, K1 runs its bf16 twin where JAX runs its
    XLA act_dtype path, which moves every gradient by more than the mode
    does, so the step is held at JAX's own bf16-to-f32 distance plus the
    stage-1 gate."""
    j16 = _jax_step(0, "bf16", core_bf16, monkeypatch)
    j32 = _jax_f32_step(0, core_bf16)
    port = _port_step(0, "default", core_act_bf16=core_bf16)
    _hold_step(port, j16, j32, () if core_bf16 else ("ref_color", "color"))


def test_stage1_step_on_the_xla_geometry_path_meets_the_gate():
    """FNEUS_PALLAS_GEOMETRY=0: the port's geometry through autograd
    (value_grad_feat_autograd) against JAX's XLA path (use_pallas_geometry
    auto on the CPU), f32: the loss and every gradient within the stage-1
    gate."""
    tl, tg = _port_step(0, None, use_pallas_geometry=False)
    jl, jg = _jax_f32_step(0, False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for (name, a), b in zip(tg, jg):
        tol = GATE_ABS + GATE_REL * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)


def test_womask_step_with_the_nerf_in_bf16(monkeypatch):
    """womask with FNEUS_NERF_ACT_BF16=1 under FNEUS_CORE_ACT_BF16=1
    (matmul mode unset): the background NeRF on the JAX package's
    act_dtype path in both packages, the geometry on the XLA path's
    act_dtype bf16 in both (FNEUS_PALLAS_GEOMETRY=0); the NeRF's
    gradients closer to JAX's bf16 NeRF than its f32 NeRF is."""
    j16 = _jax_step(2, None, True, monkeypatch, nerf_bf16=True)
    j32 = _jax_step(2, None, True, monkeypatch, nerf_bf16=False)
    port = _port_step(2, None, core_act_bf16=True, nerf_act_bf16=True,
                      use_pallas_geometry=False)
    _hold_step(port, j16, j32, ("nerf",))


@pytest.mark.parametrize("mode,core_bf16,geometry", [
    (None, False, True), ("default", False, True), ("default", True, True),
    (None, False, False), ("default", True, False), ("high", False, True)])
def test_step_weights_build_the_packs_of_each_route(mode, core_bf16,
                                                     geometry, monkeypatch):
    """renderer.step_weights as on a card (the packs built on the CPU):
    the ladder's sweep pack follows the one-pass mode (sweep16 for
    K2-bf16, else sweep32 for K2), the radiance MLP's packs K3's bf16
    mode under it or core_act_bf16, and K1's slab packs exist only on
    K1's route (FNEUS_PALLAS_GEOMETRY unset); 'high' keeps the f32
    kernels."""
    monkeypatch.setattr(TR.F, "_on_card", lambda t: True)
    jcfg, jparams = _jax_pair()
    cfg = dataclasses.replace(port_config(jcfg), core_act_bf16=core_bf16,
                              use_pallas_geometry=geometry)
    model = TR.Stage1Model(cfg)
    M.set_matmul_precision(mode)
    sdf_w, color_w = TR.step_weights(model, cfg)
    built = lambda kw: {f for f in kw._fields[2:]
                        if getattr(kw, f) is not None}
    one_pass = mode == "default"
    ladder = {"sweep16"} if one_pass else {"sweep32"}
    k1 = ({"sweep16", "rev16"} if core_bf16 else {"sweep32", "rev32"}) \
        if geometry else set()
    assert built(sdf_w) == ladder | k1
    assert built(color_w) == ({"sweep16", "rev16"} if one_pass or core_bf16
                              else {"sweep32", "rev32"})
