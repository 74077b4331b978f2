"""The port's stage CLIs take every option of the JAX package's root CLIs
(exp_runner.py, lvis.py, mateIllu.py): --gpu (ignored), --shard (a no-op
on one device, refused on more), --profile DIR (a torch.profiler trace)
and --debug_nans (a stop at the first non-finite loss or gradient, naming
the step and the tensor), and stages 2-3 --mcube_threshold (unused)."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from make_fake_dtu import write_tiny_conf

from factored_neus_tpu_torch import exp_runner, lvis, mateIllu
from factored_neus_tpu_torch.data.fake_scene import write_sphere_scene
from factored_neus_tpu_torch.train import stage1 as TS1
from factored_neus_tpu_torch.utils import cli
from factored_neus_tpu_torch.utils import logging as LOG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLIS = {"exp_runner.py": exp_runner, "lvis.py": lvis,
             "mateIllu.py": mateIllu}
# a value for each option of the JAX CLIs that takes one
VALUES = {"--conf": "x.conf", "--mode": "train", "--mcube_threshold": "0.0",
          "--gpu": "0", "--case": "c", "--type": "dtu",
          "--surface_weight": "0.1", "--idx": "0", "--profile": "d",
          "--seed": "0"}


def jax_cli_options(script: str):
    """The option strings the JAX CLI's --help lists, read in a
    subprocess."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, script, "--help"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return sorted(set(re.findall(r"(?<![\w-])(--[a-z_]+)", out)))


@pytest.mark.parametrize("script", sorted(PORT_CLIS))
def test_port_cli_accepts_every_jax_option(script):
    opts = jax_cli_options(script)
    assert {"--gpu", "--shard", "--profile", "--debug_nans"} <= set(opts)
    parser = PORT_CLIS[script].build_parser()
    missing = [o for o in opts if o not in parser._option_string_actions]
    assert not missing, (script, missing)
    argv = []
    for o in opts:
        if o != "--help":
            argv += [o, VALUES[o]] if o in VALUES else [o]
    args = parser.parse_args(argv)
    assert args.gpu == 0 and args.shard and args.debug_nans
    assert args.profile == "d"


def tiny_run(tmp_path, steps: int = 2):
    """A tiny conf with ``steps`` steps, no validation or mesh, on a
    fabricated sphere scene; the CLI arguments of a CPU training run."""
    write_sphere_scene(str(tmp_path / "data" / "fake_scan"), n_views=3,
                       H=24, W=32)
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=steps)
    with open(conf) as f:
        text = re.sub(r"val_(mesh_)?freq = \d+", "val_\\1freq = 1000000",
                      f.read())
    with open(conf, "w") as f:
        f.write(text)
    return ["--mode", "train", "--conf", conf, "--case", "fake_scan",
            "--device", "cpu"]


def test_profile_writes_a_trace(tmp_path):
    """Two tiny steps with --gpu 0 --profile DIR: a Chrome trace in DIR
    that holds the steps' operators."""
    trace_dir = tmp_path / "trace"
    runner = exp_runner.main(tiny_run(tmp_path) + ["--gpu", "0", "--profile",
                                                   str(trace_dir)])
    assert runner.iter_step == 2
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].startswith("trace_")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_debug_nans_stops_at_the_first_nan_and_names_it(tmp_path,
                                                        monkeypatch):
    """A NaN injected into one gradient at step 1: --debug_nans stops
    there, naming the step and the parameter; without it the run goes on
    (and the check does nothing outside the scope)."""
    orig = TS1.loss_on_batch

    def poisoned(model, cfg, tcfg, rays_o, rays_d, color, mask, step, **kw):
        if step == 1:
            model.sdf.lin0.bias.register_hook(
                lambda g: torch.full_like(g, float("nan")))
        return orig(model, cfg, tcfg, rays_o, rays_d, color, mask, step,
                    **kw)

    monkeypatch.setattr(TS1, "loss_on_batch", poisoned)
    argv = tiny_run(tmp_path, steps=3)
    with pytest.raises(FloatingPointError,
                       match=r"gradient of sdf\.lin0\.bias at step 1$"):
        exp_runner.main(argv + ["--debug_nans"])
    runner = exp_runner.main(argv)
    assert runner.iter_step == 3
    assert not np.isfinite(runner.model.sdf.lin0.bias.detach().numpy()).all()
    LOG.check_finite(0, torch.tensor(float("nan")), [])
    with LOG.debug_nans(True), pytest.raises(FloatingPointError,
                                             match="non-finite loss at step 7"):
        LOG.check_finite(7, torch.tensor(float("nan")), [])


@pytest.mark.parametrize("module", [exp_runner, lvis, mateIllu])
def test_shard_is_a_no_op_on_one_device_and_refused_on_more(module,
                                                            monkeypatch):
    cli.check_shard(True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cli.check_shard(False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1"):
        module.main(["--conf", "unused.conf", "--shard", "--device", "cpu"])
