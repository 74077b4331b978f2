"""Primitives, sampling and config of the PyTorch port against the JAX
package, on the same numpy inputs (f32, CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factored_neus_tpu.models import secondary as JSEC
from factored_neus_tpu.ops import embedder as JE
from factored_neus_tpu.ops import math as JU
from factored_neus_tpu.ops import mlp as JM
from factored_neus_tpu.ops import sampling as JS
from factored_neus_tpu.utils import config as JCFG
from factored_neus_tpu.utils import hocon as JH
from factored_neus_tpu.utils import schedule as JSCH
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.models import secondary as TSEC
from factored_neus_tpu_torch.ops import embedder as TE
from factored_neus_tpu_torch.ops import math as TU
from factored_neus_tpu_torch.ops import mlp as TM
from factored_neus_tpu_torch.ops import sampling as TS
from factored_neus_tpu_torch.utils import config as TCFG
from factored_neus_tpu_torch.utils import hocon as TH
from factored_neus_tpu_torch.utils import schedule as TSCH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _close(t, j, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t)
                               else t, np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("multires", [0, 4, 6])
def test_positional_encoding(multires):
    x = _r(5, 7, 3)
    _close(TE.positional_encoding(torch.from_numpy(x), multires),
           JE.positional_encoding(jnp.asarray(x), multires))


def test_softplus_beta_and_its_derivatives():
    x = np.concatenate([_r(64, scale=0.05), [-10.0, 10.0, 0.0]]).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TM.softplus_beta(xt, 100.0)
    _close(y, JM.softplus_beta(jnp.asarray(x), 100.0))
    (d1,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), xt)
    f = lambda v: JM.softplus_beta(v, 100.0)
    jd1 = jax.vmap(jax.grad(f))(jnp.asarray(x))
    jd2 = jax.vmap(jax.grad(jax.grad(f)))(jnp.asarray(x))
    _close(d1, jd1)
    _close(d2, jd2, atol=1e-4)
    assert torch.isfinite(d2).all()


def test_math_primitives():
    a, b = _r(9, 3, seed=1), _r(9, 3, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(TU.l2_normalize(ta), JU.l2_normalize(jnp.asarray(a)))
    _close(TU.reflect(ta, tb), JU.reflect(jnp.asarray(a), jnp.asarray(b)))
    lin = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    _close(TU.linear_to_srgb(torch.from_numpy(lin)),
           JU.linear_to_srgb(jnp.asarray(lin)))


def test_sdf_geometric_init_pattern():
    """Same init scheme as the JAX package: zero PE columns in layer 0 and
    in the skip layer, last layer near sqrt(pi)/sqrt(fan_in), bias -0.5."""
    cfg = TF.SDFConfig(n_layers=4, d_hidden=64, d_out=65, skip_in=(2,),
                       multires=4)
    net = TF.SDFNetwork(cfg, torch.Generator().manual_seed(0))
    ws, bs = net.effective_weights()
    n_pe = cfg.d_embed - 3
    assert torch.all(ws[0][:, 3:] == 0) and torch.all(ws[2][:, -n_pe:] == 0)
    mean = np.sqrt(np.pi) / np.sqrt(64)
    assert abs(float(ws[-1].detach().mean()) - mean) < 1e-4
    assert torch.allclose(bs[-1], torch.full_like(bs[-1], -0.5))
    assert ws[1].shape == (64 - cfg.d_embed, 64)    # feeds the skip concat
    # the sphere init at full width: sdf ~ |x| - 0.5 near the origin
    full = TF.SDFNetwork(TF.SDFConfig(), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_r(256, 3, seed=3, scale=0.3))
    with torch.no_grad():
        err = torch.abs(full(x)[:, 0] - (x.norm(dim=-1) - 0.5)).mean()
    assert float(err) < 0.15


@pytest.mark.parametrize("T", [20, 200])
def test_sample_pdf(T):
    """Both JAX forms (one-hot for T <= 160, masked max above) against
    searchsorted + gather."""
    B, n = 6, 16
    bins = np.sort(_r(B, T, seed=4), axis=-1)
    w = np.abs(_r(B, T - 1, seed=5))
    w[0] = 0.0                                     # all-flat row
    _close(TS.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n),
           JS.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n), atol=1e-5)


def test_section_weights_alpha_and_weights():
    B, T = 4, 12
    z = np.sort(np.abs(_r(B, T, seed=6)) * 2, -1)
    sdf = _r(B, T, seed=7, scale=0.3)
    rad = np.abs(_r(B, T, seed=8)) * 1.2
    t = lambda a: torch.from_numpy(a)
    _close(TS.neus_section_weights(t(z), t(sdf), t(rad), 64.0),
           JS.neus_section_weights(jnp.asarray(z), jnp.asarray(sdf),
                                   jnp.asarray(rad), 64.0), atol=1e-6)
    cos, d = _r(B * T, 1, seed=9), np.abs(_r(B * T, 1, seed=10))
    for ratio in (0.0, 0.37, 1.0):
        for a, b in zip(TS.neus_alpha(t(sdf.reshape(-1, 1)), t(cos), t(d),
                                      20.0, ratio),
                        JS.neus_alpha(jnp.asarray(sdf.reshape(-1, 1)),
                                      jnp.asarray(cos), jnp.asarray(d), 20.0,
                                      ratio)):
            _close(a, b)
    alpha = np.clip(np.abs(_r(B, T, seed=11)), 0, 1)
    _close(TS.alpha_to_weights(t(alpha)),
           JS.alpha_to_weights(jnp.asarray(alpha)))


def test_hierarchical_ladder_matches_jax():
    """up_sample + cat_z_vals over 3 rounds with an analytic sphere SDF."""
    B = 8
    rng = np.random.RandomState(12)
    o = (np.array([0.0, 0.0, -3.0]) + rng.randn(B, 3) * 0.05).astype(
        np.float32)
    d = -o + rng.randn(B, 3).astype(np.float32) * 0.2
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.linspace(2.0, 4.0, 24, dtype=np.float32)[None].repeat(B, 0)
    zt = TS.hierarchical_z_vals(
        lambda p: torch.linalg.norm(p, dim=-1) - 0.5, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(z), 24, 3)
    zj = JS.hierarchical_z_vals(
        lambda p: jnp.linalg.norm(p, axis=-1) - 0.5, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(z), 24, 3)
    assert zt.shape == (B, 48)
    _close(zt, zj, atol=1e-5)


def test_first_crossing():
    sdf = np.array([[0.3, 0.1, -0.2, -0.1, 0.2],
                    [0.3, 0.2, 0.1, 0.1, 0.1],
                    [-0.1, -0.2, 0.3, -0.3, 0.0],
                    [0.2, 0.0, -0.1, 0.1, -0.2]], np.float32)
    for a, b in zip(TSEC.first_crossing(torch.from_numpy(sdf)),
                    JSEC.first_crossing(jnp.asarray(sdf))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_schedule_matches_jax():
    for warm in (0.0, 10.0):
        for step in (0, 3, 10, 57, 100):
            assert TSCH.learning_rate(step, 5e-4, warm, 100, 0.05) == \
                pytest.approx(float(JSCH.learning_rate(step, 5e-4, warm,
                                                       100, 0.05)), rel=1e-6)
    for end in (0.0, 50.0):
        assert TSCH.cos_anneal_ratio(20, end) == pytest.approx(
            float(JSCH.cos_anneal_ratio(20, end)))


@pytest.mark.parametrize("conf", ["wmask.conf", "womask.conf"])
def test_hocon_copy_and_config(conf):
    path = os.path.join(ROOT, "confs", conf)
    assert TH.parse_file(path, "scan") == JH.parse_file(path, "scan")
    tc, jc = TCFG.load(path, "scan"), JCFG.load(path, "scan")
    t, j = TCFG.renderer_config(tc), JCFG.renderer_config(jc)
    for f in ("n_samples", "n_importance", "n_outside", "up_sample_steps",
              "perturb"):
        assert getattr(t, f) == getattr(j, f)
    for sub in ("sdf", "rendering", "refcolor"):
        tj = getattr(t, sub).__dict__
        jj = getattr(j, sub).__dict__
        assert tj == {k: jj[k] for k in tj}
    assert TCFG.variance_init_val(tc) == JCFG.variance_init_val(jc)
