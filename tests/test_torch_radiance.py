"""K3 (the fused radiance MLP) of the PyTorch port against the JAX package:
the plain twin the port runs on the CPU is held against the XLA path
(fields.rendering_apply) and against the Pallas kernel in interpret mode
(pallas_radiance.rendering_apply_pallas), at the sizes and tolerances of
tests/test_pallas_geometry.py.  The CUDA kernels themselves are held
against the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factored_neus_tpu.models import fields as F
from factored_neus_tpu.ops import pallas_radiance as PR
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.ops import radiance_kernel as RK
from factored_neus_tpu_torch.ops import tc_pack as TP

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIZES = dict(d_feature=64, d_hidden=64, n_layers=3, multires_view=4)


def _setup(n=150, seed=0, **kw):
    kw = {**SIZES, **kw}
    jcfg = F.RenderingConfig(**kw)
    params = F.rendering_init(jax.random.PRNGKey(seed), jcfg)
    net = TF.RenderingNetwork(TF.RenderingConfig(**kw))
    bridge.load_layers(net, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(seed + 1)
    pts = rng.randn(n, 3) * 0.4
    normals = rng.randn(n, 3)
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    feat = rng.randn(n, kw["d_feature"]) * 0.5
    inputs = [a.astype(np.float32) for a in (pts, normals, dirs, feat)]
    return jcfg, params, net, inputs


def _pallas(block_rows):
    return lambda p, c, *a: PR.rendering_apply_pallas(
        p, c, *a, bf16=False, block_rows=block_rows)


REFS = {"xla": lambda p, c, *a: F.rendering_apply(p, c, *a),
        "pallas32": _pallas(32), "pallas64": _pallas(64)}


@pytest.mark.parametrize("ref", sorted(REFS))
def test_k3_twin_forward_matches_jax(ref):
    jcfg, params, net, inputs = _setup()
    with torch.no_grad():
        rgb = net(*map(torch.from_numpy, inputs))
    want = REFS[ref](params, jcfg, *map(jnp.asarray, inputs))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want), atol=1e-5)


def test_twin_runs_the_other_modes_like_jax():
    jcfg, params, net, (pts, normals, dirs, feat) = _setup(
        mode="no_view_dir", d_in=6, multires_view=0)
    t = torch.from_numpy
    with torch.no_grad():
        rgb = net(t(pts), t(normals), t(dirs), t(feat))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(F.rendering_apply(
        params, jcfg, pts, normals, dirs, feat)), atol=1e-5)


@pytest.mark.parametrize("ref", sorted(REFS))
def test_k3_twin_backward_matches_jax(ref):
    """Loss, every v/g/b gradient and the cotangents of pts, normals, dirs
    and feat through the port's twin against jax.grad through the XLA path
    and through the Pallas custom VJP."""
    jcfg, params, net, inputs = _setup()
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    rgb = net(*leaves)
    lt = torch.mean(rgb ** 2) + torch.sum(rgb[:, 0] * leaves[0][:, 0]) * 1e-3
    lt.backward()
    tgrads = bridge.jax_tree_layers(net, grads=True)

    def loss(p, pts, normals, dirs, feat):
        out = REFS[ref](p, jcfg, pts, normals, dirs, feat)
        return jnp.mean(out ** 2) + jnp.sum(out[:, 0] * pts[:, 0]) * 1e-3

    jin = list(map(jnp.asarray, inputs))
    np.testing.assert_allclose(float(lt.detach()), float(loss(params, *jin)),
                               rtol=1e-5)
    gp, *gin = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(params, *jin)
    for name, a, b in zip(("pts", "normals", "dirs", "feat"), leaves, gin):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-4, err_msg=name)
    for a, b in zip(jax.tree_util.tree_leaves(tgrads),
                    jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)


def test_cpu_path_launches_no_kernel():
    _, _, net, inputs = _setup()
    before = (RK.K3_FWD.launches, RK.K3_BWD.launches)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    net(*leaves).sum().backward()
    assert (RK.K3_FWD.launches, RK.K3_BWD.launches) == before


def test_kernel_arguments_describe_the_network():
    """The integer arguments handed to both forward kernels, at full
    width: K3-fwd's (the layers, then its f32 slab pack's layer offsets)
    and K3-fwd-bf16's (the tiles' consumers and passes, squeeze_out, the
    layers, then its bf16 slab pack's layer offsets); each refuses the
    other's pack, and a hidden layer over 256 is refused."""
    net = TF.RenderingNetwork(TF.RenderingConfig())
    ws, _ = net.effective_weights()
    _, flay = RK.make_fwd_pack(net.cfg, ws)
    p = RK.fwd_wg_plan(net.cfg, ws, n=1000, lay=flay, sms=7)
    assert p["iargs"] == [5, 4, 27, 1000, 7, 16, 1,
                          289, 256, 256, 256, 256, 256, 256, 256, 256, 3,
                          *flay.off]
    _, lay = RK.make_fwd_pack(net.cfg, ws, bf16=True)
    p16 = RK.fwd_wg16_plan(net.cfg, ws, n=1000, lay=lay, sms=7)
    assert p16["iargs"] == [5, 4, 27, 1000, 2, 7, 8, 1,
                            289, 256, 256, 256, 256, 256, 256, 256, 256, 3,
                            *lay.off]
    assert (p16["grid"], p16["nc"], p16["n_pass"]) == (7, 2, 8)
    with pytest.raises(ValueError, match="bf16 slab pack"):
        RK.fwd_wg16_plan(net.cfg, ws, 1000, flay, 7)
    with pytest.raises(ValueError, match="wgmma"):
        RK.fwd_wg_plan(net.cfg, ws, 1000, lay, 7)
    wide = [torch.zeros(512, 289), torch.zeros(3, 512)]
    with pytest.raises(ValueError):
        RK.make_fwd_pack(TF.RenderingConfig(d_hidden=512), wide, bf16=True)