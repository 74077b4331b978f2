"""Multi-step blocking (train.block_steps) and the background checkpoint
writer of the PyTorch port against the JAX package, on the CPU: plan_block
and boundary_metrics against JAX's, the three stages' runners with
block_steps 4 and 1 (the same parameters, Adam leaves, report and
checkpoint iterations, at the events JAX's plan_block gives), the async
writer against JAX's test of its own, the launch counts of a captured
graph and the ROI draw from its device table.  Graphs themselves need a
card: tests/test_torch_cuda.py."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_fake_dtu import make_fake_dtu_scene, write_tiny_conf
from test_torch_stage1 import no_mesh

from factored_neus_tpu.train import common as JC
from factored_neus_tpu.utils import checkpoints as JCK
from factored_neus_tpu_torch import bridge, exp_runner, lvis, mateIllu
from factored_neus_tpu_torch.data import rays as RAYS
from factored_neus_tpu_torch.models import renderer as R
from factored_neus_tpu_torch.ops import _cuda
from factored_neus_tpu_torch.train import common as TC
from factored_neus_tpu_torch.train.stage1 import Stage1Trainer
from factored_neus_tpu_torch.utils import checkpoints as CK
from factored_neus_tpu_torch.utils import config as TCFG

# (iter_step, end_iter, block, freqs, n_images)
PLANS = [(96, 1000, 8, (100, 0, 2500), 5),      # stops at an event
         (998, 1000, 8, (100,), 5),             # and at end_iter
         (0, 7, 4, (), 3),                      # rotates mid-block
         (1, 7, 8, (), 3),
         (5, 100, 1, (10,), 4),                 # block = 1
         (3, 50, 8, (0, 0, 0), 4),              # freqs of 0
         (17, 40, 6, (5, 10, 20), 3),
         (0, 30, 8, (10, 30, 100000, 100000), 6)]   # chip_smoke's run


@pytest.mark.parametrize("it,end,block,freqs,n", PLANS)
def test_plan_block_matches_jax(it, end, block, freqs, n):
    """The port's plan_block and JAX's from the same rng state: equal K,
    image indices and permutation, the rngs left in equal states, block
    after block to the end of the run."""
    ra, rb = np.random.RandomState(it), np.random.RandomState(it)
    pa, pb = ra.permutation(n), rb.permutation(n)
    while it < end:
        ka, ia, pa = TC.plan_block(it, end, block, freqs, pa, ra, n)
        kb, ib, pb = JC.plan_block(it, end, block, freqs, pb, rb, n)
        assert (ka, ia) == (kb, ib)
        np.testing.assert_array_equal(pa, pb)
        for a, b in zip(ra.get_state(), rb.get_state()):
            np.testing.assert_array_equal(a, b)
        assert 1 <= ka <= max(1, block)
        assert all((it + j) % f for f in freqs if f for j in range(1, ka))
        it += ka


def test_plan_block_follows_the_single_step_sequence():
    """Blocks draw the images that single steps draw (the permutation
    rotating mid-block with the same rng stream)."""
    rng = np.random.RandomState(3)
    perm, single = rng.permutation(3), []
    for t in range(11):
        single.append(int(perm[t % 3]))
        if (t + 1) % 3 == 0:
            perm = rng.permutation(3)
    rng = np.random.RandomState(3)
    perm, blocked, t = rng.permutation(3), [], 0
    while t < 11:
        k, idxs, perm = TC.plan_block(t, 11, 4, (), perm, rng, 3)
        blocked += idxs
        t += k
    assert blocked == single


def test_boundary_metrics_matches_jax():
    stacked = {"loss": np.array([0.5, 0.25, 0.125], np.float32),
               "psnr": np.array([10.0, 11.0, 12.0], np.float32)}
    want = JC.boundary_metrics({k: jnp.asarray(v)
                                for k, v in stacked.items()})
    assert TC.boundary_metrics({k: torch.from_numpy(v)
                                for k, v in stacked.items()}) == want
    # a graph's boundary step: its own 0-dim outputs
    assert TC.boundary_metrics({k: torch.tensor(v[-1]) for k, v in
                                stacked.items()}) == want == {
        "loss": 0.125, "psnr": 12.0}


# -- the three stages' runners, block_steps 4 against 1 ----------------------

STAGE1_ITERS, LATER_ITERS, REPORT, SAVE = 10, 6, 3, 5


def _blocked_conf(tmp_path, name: str, block: int) -> str:
    """The tiny conf with report_freq 3, save_freq 5 and block_steps
    ``block``; no validation and no mesh within the run."""
    data = tmp_path / "data" / "fake_scan"
    if not data.exists():
        make_fake_dtu_scene(str(data), n_views=3, H=24, W=32)
    conf = write_tiny_conf(str(tmp_path / f"{name}.conf"),
                           str(tmp_path / "data" / "CASE_NAME"),
                           str(tmp_path / name / "CASE_NAME"),
                           iters=STAGE1_ITERS, iters2=LATER_ITERS)
    no_mesh(conf)
    with open(conf) as f:
        text = f.read()
    text = re.sub(r"report_freq = \d+", f"report_freq = {REPORT}\n"
                  f"    block_steps = {block}", text)
    text = re.sub(r"save_freq = \d+", f"save_freq = {SAVE}", text)
    text = re.sub(r"val_freq = \d+", "val_freq = 1000000", text)
    with open(conf, "w") as f:
        f.write(text)
    return conf


def _jax_events(end: int, block: int, freqs, n: int):
    """The block boundaries JAX's plan_block gives a run from 0."""
    rng = np.random.RandomState(0)
    perm, it, ends = rng.permutation(n), 0, []
    while it < end:
        k, _, perm = JC.plan_block(it, end, block, freqs, perm, rng, n)
        it += k
        ends.append(it)
    return ends


def _checkpoint_iters(runner):
    names = os.listdir(os.path.join(runner.base_exp_dir, "checkpoints"))
    return sorted(int(m.group(1)) for m in
                  (re.match(r"ckpt_(\d+)\.npz$", f) for f in names) if m)


def _same_state(a, b, stage: int):
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values(), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    la = TC.optimizer_leaves(a.model, a.trainer.opt, stage=stage)
    lb = TC.optimizer_leaves(b.model, b.trainer.opt, stage=stage)
    for x, y in zip(la, lb, strict=True):
        np.testing.assert_array_equal(x, y)


def test_block_steps_follow_the_single_step_trajectory(tmp_path,
                                                       monkeypatch):
    """Stages 1, 2 and 3 with block_steps 4 and with 1, each stage chained
    from its own run's checkpoint: bitwise the same parameters and Adam
    leaves, reports and checkpoints at the same iterations, and the
    blocked runs' blocks end where JAX's plan_block ends them."""
    ends = []
    advance = TC.BlockStepper.advance

    def recorded(self, iter_step):
        metrics, k = advance(self, iter_step)
        ends.append((self.block, iter_step + k))
        return metrics, k
    monkeypatch.setattr(TC.BlockStepper, "advance", recorded)
    runs = {}
    for block in (4, 1):
        conf = _blocked_conf(tmp_path, f"block{block}", block)
        base = ["--mode", "train", "--conf", conf, "--case", "fake_scan",
                "--type", "dtu", "--device", "cpu"]
        runs[block] = [cli.main(base) for cli in (exp_runner, lvis,
                                                  mateIllu)]
    for stage, (a, b) in enumerate(zip(runs[4], runs[1]), 1):
        end = STAGE1_ITERS if stage == 1 else LATER_ITERS
        _same_state(a, b, stage)
        assert a.iter_step == b.iter_step == end
        assert [m["iter"] for m in a.history] == \
            [m["iter"] for m in b.history] == list(range(REPORT, end + 1,
                                                         REPORT))
        for ma, mb in zip(a.history, b.history):
            assert all(ma[k] == mb[k] for k in ma if k != "rays_per_sec")
        assert _checkpoint_iters(a) == _checkpoint_iters(b) == list(
            range(SAVE, end + 1, SAVE))
    freqs = {1: (REPORT, SAVE, 1000000, 1000000),
             2: (REPORT, SAVE, 1000000), 3: (REPORT, SAVE, 1000000)}
    got = [it for block, it in ends if block == 4]
    want = [it for stage in (1, 2, 3) for it in _jax_events(
        STAGE1_ITERS if stage == 1 else LATER_ITERS, 4, freqs[stage], 3)]
    assert got == want
    assert max(np.diff([0] + got[:5])) == 3       # blocks of more than one
    assert [it for block, it in ends if block == 1] == \
        list(range(1, STAGE1_ITERS + 1)) + 2 * list(range(1, LATER_ITERS
                                                          + 1))


def test_run_block_equals_single_steps(tmp_path):
    """StepTrainer.run_block over a block of images equals one step() per
    image, bit for bit (the slot's rows: learning rate, anneal ratio,
    image index)."""
    make_fake_dtu_scene(str(tmp_path / "fake_scan"), n_views=3, H=24, W=32)
    conf = TCFG.load(write_tiny_conf(
        str(tmp_path / "t.conf"), str(tmp_path / "CASE_NAME"),
        str(tmp_path / "exp"), iters=8), "fake_scan")
    from factored_neus_tpu_torch.data.datasets import make_dataset
    ds = make_dataset("dtu", conf["dataset"], torch.device("cpu"))
    cfg = TCFG.renderer_config(conf)
    tcfg = TC.TrainConfig.from_conf(conf)
    trainers = [Stage1Trainer(R.Stage1Model(cfg, seed=0), cfg, tcfg,
                              ds.train_data(), seed=1) for _ in range(2)]
    idxs = [2, 0, 1, 1]
    last = trainers[0].run_block(0, idxs)
    for i, idx in enumerate(idxs):
        m = trainers[1].step(idx, i)
    assert {k: float(v) for k, v in last.items()} == \
        {k: float(v) for k, v in m.items()}
    for x, y in zip(trainers[0].model.parameters(),
                    trainers[1].model.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert float(trainers[0].slot[0]) == pytest.approx(
        TC.learning_rate(tcfg, 3))
    assert float(trainers[0].slot[2]) == 1.0
    with pytest.raises(ValueError, match="CUDA"):
        trainers[0].run_block(4, [0], graph=True)


def test_load_optimizer_leaves_puts_step_on_the_parameters_device():
    cfg = R.RendererConfig()
    model = R.Stage1Model(cfg, seed=0)
    opt = TC.make_optimizer(model, TC.TrainConfig())
    for p in opt.param_groups[0]["params"][:3]:
        p.grad = torch.ones_like(p)
    opt.step()
    leaves = TC.optimizer_leaves(model, opt)
    fresh = TC.make_optimizer(model, TC.TrainConfig())
    TC.load_optimizer_leaves(model, fresh, leaves)
    assert len(fresh.state) == 3
    for p, st in fresh.state.items():
        assert st["step"].device == p.device and float(st["step"]) == 1.0
        assert st["step"].dtype == torch.float32
    for a, b in zip(TC.optimizer_leaves(model, fresh), leaves, strict=True):
        np.testing.assert_array_equal(a, b)
    # the leaves as tensors (the background writer's snapshot) hold the
    # same values
    for a, b in zip(TC.optimizer_leaves(model, opt, host=False), leaves,
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


# -- the background checkpoint writer ----------------------------------------

def test_async_checkpoint_save(tmp_path):
    """save_checkpoint_async: the file equals a sync save, an in-place
    change of the source right after the call does not reach it, the JAX
    package's reader loads it, and a writer's error surfaces at the next
    save to its directory and at the wait, never at another directory's
    save or a lookup."""
    w = torch.arange(12.0).reshape(3, 4)
    groups = {"sdf_network_fine": {"l0": {"w": w, "b": torch.ones(4)}},
              "optimizer": CK.Leaves([torch.tensor(3, dtype=torch.int32),
                                      w.T]),
              "iter_step": np.asarray(7)}
    sync = CK.save_checkpoint(str(tmp_path / "sync"), 7, groups)
    path = CK.save_checkpoint_async(str(tmp_path), 7, groups)
    w.mul_(0.0)
    CK.wait_for_async_saves()
    assert CK.latest_checkpoint(str(tmp_path)) == path
    assert path.endswith("ckpt_000007.npz")
    with np.load(path) as a, np.load(sync) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for read in (CK.load_checkpoint, JCK.load_checkpoint):
        loaded = read(path)
        np.testing.assert_array_equal(
            loaded["sdf_network_fine"]["l0"]["w"],
            np.arange(12.0).reshape(3, 4))
        assert int(loaded["iter_step"]) == 7
        assert int(loaded["optimizer"][0]) == 3

    bad = tmp_path / "file_in_the_way"
    bad.write_text("x")
    CK.save_checkpoint_async(str(bad / "sub"), 1, {"iter_step": 1})
    good = tmp_path / "recovered"
    CK.save_checkpoint_async(str(good), 2, {"iter_step": 2})
    assert CK.latest_checkpoint(str(good)).endswith("ckpt_000002.npz")
    assert CK.latest_checkpoint(str(bad / "sub")) is None
    with pytest.raises(RuntimeError, match="async checkpoint"):
        CK.save_checkpoint_async(str(bad / "sub"), 3, {"iter_step": 3})
    with pytest.raises(RuntimeError, match="async checkpoint"):
        CK.wait_for_async_saves()
    CK.wait_for_async_saves()


def test_async_writers_under_contention(tmp_path):
    """Sixteen threads (more than the cores) save 64 checkpoints into
    four directories with a short switch interval: each directory's
    files all land, each with its own contents, and nothing fails."""
    import sys
    import threading

    def saves(t):
        for i in range(4):
            it = 4 * t + i
            CK.save_checkpoint_async(str(tmp_path / f"d{t % 4}"), it, {
                "w": torch.full((64,), float(it)),
                "iter_step": np.asarray(it)})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saves, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        CK.wait_for_async_saves()
    finally:
        sys.setswitchinterval(interval)
    for d in range(4):
        names = os.listdir(tmp_path / f"d{d}" / "checkpoints")
        iters = sorted(int(n[5:11]) for n in names)
        assert iters == sorted(4 * t + i for t in range(d, 16, 4)
                               for i in range(4))
        for it in iters:
            got = CK.load_checkpoint(CK.checkpoint_path(
                str(tmp_path / f"d{d}"), it))
            assert int(got["iter_step"]) == it
            assert (got["w"] == it).all()


def test_runner_checkpoints_in_the_background_load_in_jax(tmp_path):
    """A runner's background save: the same file as its sync save, read
    by the JAX package's reader, its parameters the model's."""
    conf = _blocked_conf(tmp_path, "bg", 1)
    from factored_neus_tpu_torch.train import runner1 as TR1
    r = TR1.Runner(conf, case="fake_scan", device="cpu")
    r.trainer.step(0, 0)
    r.iter_step = 1
    bg = r.save_checkpoint(background=True)
    CK.wait_for_async_saves()
    os.rename(bg, bg + ".bg")
    sync = r.save_checkpoint()
    assert sync == bg
    with np.load(bg + ".bg") as a, np.load(sync) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    raw = JCK.load_checkpoint(sync)
    tree = bridge.jax_tree(r.model)
    np.testing.assert_array_equal(raw["sdf_network_fine"][0]["v"],
                                  tree["sdf"][0]["v"])


# -- launch counts under capture, the ROI table ------------------------------

def test_captured_launches_count_once_a_replay(monkeypatch):
    """_cuda.count: at once outside a capture; inside one, recorded for
    the replays (and raising outside recording())."""
    hits = []
    bump = lambda: hits.append(1)
    _cuda.count(bump)
    assert hits == [1]
    monkeypatch.setattr(_cuda, "capturing", lambda: True)
    with _cuda.recording() as calls:
        _cuda.count(bump)
        _cuda.count(bump)
    assert hits == [1] and calls == [bump, bump]
    with pytest.raises(RuntimeError, match="recording"):
        _cuda.count(bump)


def test_roi_draw_from_the_device_table():
    """The ROI draw reading its box from the table (the step's form)
    equals the draw on the host box, bit for bit, and stays in the
    dilated box."""
    n, H, W, B = 3, 40, 50, 2048
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    images = torch.stack([xs, ys, torch.zeros_like(xs)], -1).float().expand(
        n, H, W, 3).contiguous()
    boxes = [np.array([5, 20, 8, 30]), np.array([0, 49, 0, 39]),
             np.array([30, 45, 25, 33])]
    data = {"images": images, "masks": torch.ones(n, H, W, 3),
            "intr_inv": torch.eye(4).expand(n, 4, 4).contiguous(),
            "poses": torch.eye(4).expand(n, 4, 4).contiguous(),
            "roi_boxes": boxes, "roi_prob": 0.7}
    tables = RAYS.draw_tables(data)
    assert tables["roi_table"].tolist() == [
        list(RAYS.roi_bounds(b, H, W)) for b in boxes]
    for idx in range(n):
        a = RAYS.sample_batch(torch.Generator().manual_seed(idx), tables,
                              torch.tensor(float(idx)), B)
        b = RAYS.gen_random_rays(torch.Generator().manual_seed(idx), images,
                                 data["masks"], data["intr_inv"],
                                 data["poses"], idx, B, roi_box=boxes[idx],
                                 roi_prob=0.7)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        left, right, top, bottom = RAYS.roi_bounds(boxes[idx], H, W)
        x, y = a[2][:, 0], a[2][:, 1]
        inside = (x >= left) & (x < right) & (y >= top) & (y < bottom)
        share = float(inside.float().mean())
        box_share = (right - left) * (bottom - top) / (H * W)
        assert abs(share - (0.7 + 0.3 * box_share)) < 0.05
