"""The port's importer of reference ``.pth`` checkpoints
(factored_neus_tpu_torch/utils/torch_import.py) against the JAX
package's (factored_neus_tpu/utils/torch_import.py): a ``.pth`` saved with
torch.save from the port's models, in each weight-norm key layout, with
every group of GROUP_CONVERTERS; its CLI's npz read by the port's
``--is_continue``, and a step on the imported weights."""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import reference_pth
from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_materials import material_config
from test_torch_render import port_config
from test_torch_stage1 import _batch, no_mesh
from util_scene import tiny_config

from factored_neus_tpu.utils import torch_import as JTI
from factored_neus_tpu_torch import bridge
from factored_neus_tpu_torch.models import renderer as TR
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train import stage1 as TS1
from factored_neus_tpu_torch.train.runner1 import Runner
from factored_neus_tpu_torch.utils import checkpoints as CK
from factored_neus_tpu_torch.utils import torch_import as TI

LAYOUTS = ("legacy", "parametrizations")


def _cfg() -> TR.RendererConfig:
    """The tiny test widths with a background NeRF (stage 1), full width
    Lvis and IndirectLight, a 16-lobe material."""
    jcfg = tiny_config(2)
    return dataclasses.replace(port_config(jcfg),
                               material=material_config(jcfg.material))


def _stage3(seed=3):
    """A Stage3Model at _cfg's widths, random weights from a seed."""
    return TR.Stage3Model(_cfg(), seed=seed)


def _assert_trees_equal(a, b, path="") -> None:
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_trees_equal(u, v, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("layout", LAYOUTS)
def test_both_importers_give_equal_trees(layout, tmp_path):
    """Every group of GROUP_CONVERTERS, read by both packages' importers
    from one .pth: equal trees, equal to the port's own checkpoint trees
    (bridge.jax_tree); the optimizer is not converted."""
    model = _stage3()
    pth = str(tmp_path / f"{layout}.pth")
    torch.save(reference_pth(model, 1234, layout), pth)
    want_groups = set(TI.GROUP_CONVERTERS)
    assert set(torch.load(pth, weights_only=True)) == want_groups | {
        "iter_step", "optimizer"}
    assert sorted(TI.GROUP_CONVERTERS) == sorted(JTI.GROUP_CONVERTERS)
    assert all(TI.GROUP_CONVERTERS[k][1] == JTI.GROUP_CONVERTERS[k][1]
               for k in TI.GROUP_CONVERTERS)
    port = TI.load_torch_checkpoint(pth)
    ref = JTI.load_torch_checkpoint(pth)
    _assert_trees_equal(port, ref)
    assert set(port) == want_groups | {"iter_step"}
    assert port["iter_step"] == 1234
    tree = bridge.jax_tree(model)
    for name, (_, group) in TI.GROUP_CONVERTERS.items():
        _assert_trees_equal(port[name], tree[group], name)


def test_load_into_fills_every_stage_and_refuses_a_missing_group(tmp_path):
    """load_into puts a .pth's groups into fresh Stage1, Stage2 and Stage3
    models: their parameters equal the source model's."""
    src = _stage3(seed=3)
    pth = str(tmp_path / "src.pth")
    torch.save(reference_pth(src, 7, "parametrizations"), pth)
    groups = TI.load_torch_checkpoint(pth)
    for cls in (TR.Stage1Model, TR.Stage2Model, TR.Stage3Model):
        dst = cls(_cfg(), seed=9)
        assert not all(torch.equal(a, b) for a, b in zip(
            dst.parameters(), src.parameters()))
        assert TI.load_into(dst, groups) == 7
        want = dict((src.stage1 if cls is TR.Stage1Model
                     else src).named_parameters())
        for name, p in dst.named_parameters():
            assert torch.equal(p, want[name]), name
    del groups["lvis_network"]
    with pytest.raises(KeyError, match="lvis_network"):
        TI.load_into(TR.Stage2Model(_cfg()), groups)


def test_cli_npz_continues_and_steps_bit_for_bit(tmp_path):
    """The CLI's npz of a .pth (parametrizations layout, every group) is
    read by the stage-1 runner's --is_continue: iter_step, the stage-1
    weights, the later stages' groups passed through, a fresh optimizer;
    a step on the imported weights is the source models' step bit for bit
    (loss and every gradient)."""
    make_fake_dtu_scene(str(tmp_path / "data" / "fake_scan"))
    conf = write_tiny_conf(str(tmp_path / "tiny.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / "exp" / "CASE_NAME"), iters=4)
    no_mesh(conf)
    src = Runner(conf, case="fake_scan", device="cpu")
    later = TR.Stage3Model(src.cfg, seed=4)
    groups = reference_pth(src.model, 3, "parametrizations")
    groups.update({k: v for k, v in reference_pth(later, 3).items()
                   if k in ("lvis_network", "indiLgt_network",
                            "mateIllu_network")})
    pth = str(tmp_path / "ref.pth")
    torch.save(groups, pth)
    assert TI.main([pth, src.base_exp_dir]) == 0
    path = CK.latest_checkpoint(src.base_exp_dir)
    assert path.endswith("ckpt_000003.npz")
    got = Runner(conf, case="fake_scan", is_continue=True, device="cpu")
    assert got.iter_step == 3
    assert not got.trainer.opt.state
    assert sorted(got.passed_through) == ["indiLgt_network", "lvis_network",
                                          "mateIllu_network"]
    for (n, a), (_, b) in zip(src.model.named_parameters(),
                              got.model.named_parameters()):
        assert torch.equal(a, b), n
    o, d, rgb, mask = (torch.from_numpy(a) for a in _batch())
    t_rand = torch.from_numpy(np.random.RandomState(4).rand(
        o.shape[0], 1).astype(np.float32) - 0.5)
    tcfg = TC.TrainConfig(igr_weight=0.1, mask_weight=0.1)
    runs = []
    for model in (src.model, got.model):
        model.zero_grad()
        loss, _ = TS1.loss_on_batch(model, src.cfg, tcfg, o, d, rgb, mask,
                                    3, t_rand=t_rand)
        loss.backward()
        runs.append([loss.detach()] + [p.grad for p in model.parameters()
                                       if p.grad is not None])
    assert len(runs[0]) == len(runs[1]) > 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))
