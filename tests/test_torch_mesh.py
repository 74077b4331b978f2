"""Mesh extraction of the PyTorch port against the JAX package: marching
tetrahedra (the port's own build of the same source), the grid fill and
extraction on the same SDF weights, PLY files, and --mode validate_mesh
through the port's CLI on a fabricated DTU scene."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf

from factored_neus_tpu import native as JN
from factored_neus_tpu.meshing import extract as JMEXT
from factored_neus_tpu.meshing import ply as JPLY
from factored_neus_tpu.models import fields as JF
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch import exp_runner
from factored_neus_tpu_torch import native as TN
from factored_neus_tpu_torch.meshing import extract as MEXT
from factored_neus_tpu_torch.meshing import ply as PLY
from factored_neus_tpu_torch.models import fields as TF
from factored_neus_tpu_torch.train import runner1

torch.backends.cuda.matmul.allow_tf32 = False


def _grids():
    r = np.linspace(-1.0, 1.0, 24, dtype=np.float32)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    sphere = 0.5 - np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    rng = np.random.RandomState(0)
    return {"sphere": sphere, "empty": np.ones((9, 10, 11), np.float32),
            "random": rng.randn(12, 13, 14).astype(np.float32)}


@pytest.mark.parametrize("name", ["sphere", "empty", "random"])
def test_marching_tetrahedra_matches_jax(name):
    """The port's library and the JAX package's, built from the same
    source, give the same triangles and vertices."""
    grid = _grids()[name]
    for iso in (0.0, 0.25):
        v, t = TN.marching_cubes(grid, iso)
        jv, jt = JN.marching_cubes(grid, iso)
        assert v.dtype == np.float32 and t.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)
        assert (len(t) == 0) == (name == "empty")


def _sdf_pair(seed=0):
    kw = dict(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,), multires=4)
    jcfg = JF.SDFConfig(**kw)
    params = JF.sdf_init(jax.random.PRNGKey(seed), jcfg)
    net = TF.SDFNetwork(TF.SDFConfig(**kw))
    bridge.load_layers(net, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, net


BOX = ([-1.01, -1.01, -1.01], [1.01, 1.01, 1.01])


def test_extraction_matches_jax_float32():
    """Resolution 40, which SLAB (32) does not divide, so the last slab
    is short: the grid at 1e-5 and the mesh's vertices at 1e-4 against
    the JAX package's extraction with a float32 wire, triangles equal."""
    jcfg, params, net = _sdf_pair()
    jq = JMEXT.make_sdf_grid_query(params, jcfg)
    q = MEXT.sdf_grid_query(net)
    assert 40 % MEXT.SLAB != 0
    grid = MEXT.extract_fields(*BOX, 40, q, "cpu")
    jgrid = JMEXT.extract_fields(*BOX, 40, jq, transfer_dtype=jnp.float32)
    assert grid.shape == (40, 40, 40) and grid.dtype == np.float32
    np.testing.assert_allclose(grid, jgrid, rtol=0, atol=1e-5)
    times = {}
    v, t = MEXT.extract_geometry(*BOX, 40, 0.0, q, "cpu", times=times)
    jv, jt = JMEXT.extract_geometry(*BOX, 40, 0.0, jq,
                                    transfer_dtype=jnp.float32)
    assert len(t) > 100 and set(times) == {"fill_s", "march_s"}
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)
    # geometric init: the surface is the sphere of radius bias = 0.5
    assert abs(np.linalg.norm(v, axis=-1).mean() - 0.5) < 0.05


def test_ply_roundtrip_and_jax_reader(tmp_path):
    """A port-written mesh reads back the same through both packages'
    readers, and the file is byte for byte the JAX package's."""
    v, t = TN.marching_cubes(_grids()["sphere"], 0.0)
    path, jpath = str(tmp_path / "m.ply"), str(tmp_path / "j.ply")
    PLY.write_ply(path, v, t)
    JPLY.write_ply(jpath, v, t)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for reader in (PLY.read_ply_mesh, JPLY.read_ply_mesh):
        rv, rt = reader(path)
        np.testing.assert_array_equal(rv, v.astype(np.float64))
        np.testing.assert_array_equal(rt, t)
    rgb = (np.arange(len(v) * 3).reshape(-1, 3) % 256).astype(np.uint8)
    PLY.write_ply(path, v, colors=rgb, normals=-v)
    back = JPLY.read_ply(path)["vertex"]
    np.testing.assert_array_equal(back["red"], rgb[:, 0])
    np.testing.assert_array_equal(back["nz"], -v[:, 2])
    assert PLY.read_ply(path)["vertex"].keys() == back.keys()


def test_cli_validate_mesh_after_training(tmp_path, monkeypatch):
    """Train a few wmask steps through the port's CLI on the CPU (the mesh
    at val_mesh_freq included), then --mode validate_mesh --is_continue:
    a closed, finite mesh (the fake scene's scale mat is the identity, so
    world space is the SDF's space) whose vertices lie on the checkpoint's
    SDF zero set, within a quarter of a grid cell.  Grids cut to 16^3 and
    32^3 for the CPU twin."""
    make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"))
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    monkeypatch.setattr(runner1.Runner, "validate_mesh", functools.partialmethod(
        runner1.Runner.validate_mesh, resolution=16))
    base = ["--conf", conf, "--case", "fake_scan", "--type", "dtu",
            "--device", "cpu"]
    trained = exp_runner.main(["--mode", "train"] + base)
    mesh = os.path.join(trained.base_exp_dir, "meshes", "00000004.ply")
    assert trained.last_mesh == mesh and os.path.exists(mesh)

    monkeypatch.undo()
    monkeypatch.setattr(runner1.Runner, "validate_mesh", functools.partialmethod(
        runner1.Runner.validate_mesh, resolution=32))
    runner = exp_runner.main(["--mode", "validate_mesh", "--is_continue",
                              "--mcube_threshold", "0.0"] + base)
    assert runner.iter_step == 4 and runner.last_mesh == mesh
    v, t = PLY.read_ply_mesh(mesh)
    assert len(v) > 100 and len(t) > 100 and np.isfinite(v).all()
    cell = 2.02 / (32 - 1)
    with torch.no_grad():
        sdf = runner.model.sdf.value_sweep(torch.from_numpy(v).float())
    assert float(sdf.abs().max()) <= 0.25 * cell
    # geometric init (bias 0.5) is a noisy sphere: 0.3-0.7 over seeds
    assert 0.25 < np.linalg.norm(v, axis=-1).mean() < 0.8
    # every edge is shared by two triangles: the surface is closed
    e = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]),
                -1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_runner_refuses_unported_modes(tmp_path):
    # a mode the JAX runner does not have, or a malformed interpolate_<i>_<j>;
    # the error lists the ported modes
    for mode in ("validate_mesh_dense", "interpolate_0", "interpolate_a_b"):
        with pytest.raises(NotImplementedError, match="validate_mesh"):
            runner1.Runner(str(tmp_path / "none.conf"), mode=mode,
                           device="cpu")
