"""The port imports nothing of JAX: every module of factored_neus_tpu_torch
imports, and its CLIs train (with the JAX CLIs' --gpu, --shard,
--debug_nans, --profile and --mcube_threshold), validate, mesh and score a
tiny scene, and train and validate stages 2 and 3 on it, and every
dataset family is
fabricated and loaded under each of its type names, in a
process where jax, jaxlib and factored_neus_tpu cannot be imported (nor
the optional cv2, imageio, PIL and TensorBoard writers, which the port
does without)."""
import os
import subprocess
import sys
import textwrap

from make_fake_dtu import write_tiny_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "factored_neus_tpu", "cv2", "imageio", "PIL",
               "tensorboardX", "torch.utils.tensorboard"}

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:                       # any import of them raises
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, Block())
    import factored_neus_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    print("imported", len(names))

    tmp, conf = sys.argv[1], sys.argv[2]
    from factored_neus_tpu_torch import exp_runner
    from factored_neus_tpu_torch.data.fake_scene import write_sphere_scene
    from factored_neus_tpu_torch.tools.quality import chamfer_vs_sphere
    write_sphere_scene(os.path.join(tmp, "data", "fake_scan"), n_views=3,
                       H=24, W=32)
    base = ["--conf", conf, "--case", "fake_scan", "--device", "cpu"]
    # the JAX CLIs' options: --gpu, --shard, --debug_nans, --profile DIR
    jax_flags = ["--gpu", "0", "--shard", "--debug_nans"]
    trace = os.path.join(tmp, "trace")
    r = exp_runner.main(["--mode", "train", *base, *jax_flags, "--profile",
                         trace])
    assert os.listdir(trace), trace
    r.validate_mesh(world_space=True, resolution=32)
    exp_runner.main(["--mode", "validate_image", "--is_continue", *base])
    r = exp_runner.main(["--mode", "interpolate_0_1", "--is_continue",
                         *base])
    assert r.last_video.endswith("_frames"), r.last_video
    from factored_neus_tpu_torch import lvis
    r2 = lvis.main(["--mode", "train", *base, *jax_flags,
                    "--mcube_threshold", "0.0"])
    assert r2.iter_step == 4 and r2.history, r2.iter_step
    lvis.main(["--mode", "validate_image", "--is_continue", *base])
    from factored_neus_tpu_torch import mateIllu
    r3 = mateIllu.main(["--mode", "train", *base, *jax_flags,
                        "--mcube_threshold", "0.0"])
    assert r3.iter_step == 4 and r3.history, r3.iter_step
    v3 = mateIllu.main(["--mode", "validate_image", "--is_continue", *base])
    assert os.path.exists(v3.last_envmap), v3.last_envmap
    from factored_neus_tpu_torch.meshing.ply import read_ply_mesh
    meshes = os.path.join(r.base_exp_dir, "meshes")
    d2s, s2d = chamfer_vs_sphere(*read_ply_mesh(
        os.path.join(meshes, sorted(os.listdir(meshes))[0])))
    import torch
    from factored_neus_tpu_torch.data import datasets as D
    from factored_neus_tpu_torch.data import fake_scene as FS
    fam = os.path.join(tmp, "families")
    size = {"n_views": 2, "H": 6, "W": 8}
    blender = FS.write_blender_scene(os.path.join(fam, "blender"), n_train=2,
                                     n_test=1, H=8, W=10)
    scenes = {"glossy_synthetic": FS.write_glossy_synthetic_scene(
                  os.path.join(fam, "glossy"), **size),
              "glossy_real": FS.write_glossy_real_scene(
                  os.path.join(fam, "real"), **size),
              "sk3d": FS.write_sk3d_scene(os.path.join(fam, "sk3d"), **size)}
    for typ in D.DATASET_TYPES:
        data_dir = scenes.get(typ, blender)
        if typ == "dtu":
            data_dir = os.path.join(tmp, "data", "fake_scan")
        ds = D.make_dataset(typ, {"data_dir": data_dir}, torch.device("cpu"))
        assert ds.n_images >= 2 and ds.images.shape[-1] == 3, typ
    test = D.SyntheticDataset({"data_dir": blender}, torch.device("cpu"),
                              split="test")
    assert test.albedo.shape == (1, 8, 10, 3)
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("ok", d2s, s2d)
""")


def test_port_runs_without_jax(tmp_path):
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    with open(conf) as f:
        text = f.read().replace("val_mesh_freq = 4", "val_mesh_freq = 1000"
                                ).replace("report_freq = 4",
                                          "report_freq = 4\n val_chunk = 64")
    with open(conf, "w") as f:
        f.write(text)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path), conf],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("imported") and int(lines[0].split()[1]) > 30
    assert lines[-1].startswith("ok")
