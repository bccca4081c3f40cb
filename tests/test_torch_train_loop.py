"""The port's train loop and training entry points on the CPU: the
reference's system tests of training (`tests/test_system.py`) run on the
port's `train`, and the launchers.

The loss falls toward the Markov chain's entropy; a run interrupted at a
checkpoint and resumed ends at the uninterrupted run's loss; an injected
failure recovers under `run_with_restarts`; compressed gradients train;
accumulating 4 microbatches matches the large batch. `launch.train`
without ``--device cpu`` raises RuntimeError where there is no GPU and
refuses ``--mesh mini``; `launch.quickstart` and `launch.train_100m` run
with few steps; `launch.machine_smoke` prints what ``launch.gups --smoke``
prints.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpointing.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, MarkovTask
from repro_torch.launch import gups, machine_smoke, quickstart, train_100m
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 run_with_restarts)
from repro_torch.runtime.train_loop import train


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _tiny(arch="granite-3-2b"):
    return get_config(arch).reduced().replace(vocab=64, n_layers=2)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_training_reduces_loss_toward_entropy(arch):
    cfg = _tiny(arch)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, branching=2)
    rep = train(build_model(cfg), steps=30, data_cfg=data,
                opt=AdamWConfig(lr=5e-3, total_steps=30, warmup_steps=3),
                device="cpu")
    first, last = min(rep.losses), max(rep.losses)
    assert rep.losses[last] < rep.losses[first] - 0.3
    assert rep.losses[last] > MarkovTask(data).entropy()
    assert len(rep.step_s) == 30


def test_checkpoint_resume_is_exact(tmp_path):
    cfg = _tiny()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    opt = AdamWConfig(lr=1e-3, total_steps=12, warmup_steps=2)
    r1 = train(build_model(cfg), steps=12, data_cfg=data, opt=opt, seed=7,
               device="cpu")
    train(build_model(cfg), steps=6, data_cfg=data, opt=opt, seed=7,
          ckpt_dir=tmp_path, ckpt_every=6, device="cpu")
    r3 = train(build_model(cfg), steps=12, data_cfg=data, opt=opt, seed=7,
               ckpt_dir=tmp_path, ckpt_every=6, device="cpu")
    assert r3.resumed_from == 6
    last = max(r1.losses)
    np.testing.assert_allclose(r1.losses[last], r3.losses[last], rtol=1e-4)


def test_injected_failure_recovers_via_supervisor(tmp_path):
    cfg = _tiny()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    attempts = {"n": 0}

    def loop():
        attempts["n"] += 1
        fail = 5 if attempts["n"] == 1 else None  # crash only on first attempt
        train(build_model(cfg), steps=10, data_cfg=data, opt=opt,
              ckpt_dir=tmp_path, ckpt_every=2, fail_at_step=fail,
              device="cpu")

    rep = run_with_restarts(loop, restore_fn=lambda: None, max_restarts=2)
    assert rep.completed and rep.restarts == 1
    assert rep.failures == ["RuntimeError: injected failure at step 5"]
    assert latest_step(tmp_path) == 10


def test_grad_compression_trains():
    cfg = _tiny()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, branching=2)
    rep = train(build_model(cfg), steps=20, data_cfg=data,
                opt=AdamWConfig(lr=5e-3, total_steps=20, warmup_steps=2),
                compress_grads=True, device="cpu")
    first, last = min(rep.losses), max(rep.losses)
    assert rep.losses[last] < rep.losses[first]


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_grad_accumulation_matches_large_batch(arch):
    cfg = _tiny(arch).replace(dtype="float32")
    model = build_model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    opt = AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1, grad_clip=0.0)
    r_full = train(model, steps=3, data_cfg=data, opt=opt, seed=3,
                   device="cpu")
    r_acc = train(model, steps=3, data_cfg=data, opt=opt, seed=3, accum=4,
                  device="cpu")
    last = max(r_full.losses)
    np.testing.assert_allclose(r_full.losses[last], r_acc.losses[last],
                               rtol=1e-3)


def test_straggler_monitor_flags_a_slow_step():
    mon = StragglerMonitor(window=8, threshold=2.0)
    flags = [mon.record(t) for t in [1.0] * 6 + [5.0, 1.0]]
    assert flags == [False] * 6 + [True, False]
    assert mon.flagged == [(7, 5.0)]


# ----------------------------------------------------------------- launchers


def test_launch_train_needs_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                           "--steps", "1"])


def test_launch_train_on_the_mini_mesh_of_two_cpu_ranks(capsys):
    """``--mesh mini --ranks 2 --device cpu``: the (1, 2) mesh as two gloo
    ranks; rank 0's report, and its loss falls."""
    rep = launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--mesh", "mini", "--ranks", "2", "--device",
                             "cpu", "--steps", "12", "--batch", "4",
                             "--seq", "16", "--lr", "1e-2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 12 and rep.steps == 12
    assert out["loss_last"] < out["loss_first"]


def test_launch_train_on_a_2x1_mesh_prints_each_ranks_placed_bytes(capsys):
    """``--mesh 2x1``: each rank holds its block of params, mu and nu by
    the rules, about half the whole (exactly the specs' share), and one
    line a rank says so before rank 0's report."""
    from repro_torch.core import tree
    from repro_torch.models.lm import param_specs
    from repro_torch.models.params import abstract, partition_specs
    from repro_torch.sharding import Mesh, ShardingCtx, block_shape

    rep = launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--mesh", "2x1", "--device", "cpu", "--backend",
                             "gloo", "--steps", "3", "--batch", "4", "--seq",
                             "16"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()[-3:]]
    cfg = get_config("granite-moe-1b-a400m").reduced()
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (2, 1)))
    specs = param_specs(cfg)
    parts = partition_specs(specs, ctx)
    leaves = tree.leaves(abstract(specs))
    share = sum(int(np.prod(block_shape(x.shape, s, ctx))) * x.element_size()
                for x, s in zip(leaves, tree.leaves(parts)))
    whole = sum(x.numel() * x.element_size() for x in leaves)
    assert 0.45 * whole < share < 0.55 * whole
    assert [x["rank"] for x in lines[:2]] == [0, 1]
    for x in lines[:2]:
        assert x["mesh"] == [2, 1]
        assert x["held_bytes"] == {"params": share, "mu": share, "nu": share}
    assert rep.held_bytes == lines[0]["held_bytes"]
    assert lines[2]["steps"] == 3 and np.isfinite(lines[2]["loss_last"])


def test_launch_train_on_the_cpu(tmp_path, capsys):
    rep = launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--device", "cpu", "--steps", "6", "--batch",
                             "4", "--seq", "16", "--accum", "2",
                             "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 6 and np.isfinite(out["loss_last"])
    assert rep.resumed_from is None and latest_step(tmp_path) == 6


def test_quickstart_runs(capsys):
    rep, rep2, stats = quickstart.main(["--device", "cpu", "--steps", "4"])
    assert rep2.resumed_from == 4
    assert len(stats["generated"]) == 2
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "serve:" in out


def test_train_100m_runs_with_few_steps(tmp_path):
    rep = train_100m.main(["--steps", "2", "--d-model", "128", "--layers",
                           "1", "--vocab", "64", "--seq", "16", "--batch",
                           "2", "--ckpt-dir", str(tmp_path),
                           "--device", "cpu"])
    assert sorted(rep.losses) == [0, 1] and latest_step(tmp_path) == 2


def test_machine_smoke_prints_what_gups_smoke_prints(capsys):
    machine_smoke.main(["--device", "cpu"])
    ours = capsys.readouterr().out
    repro_torch.reset()
    gups.main(["--smoke", "--device", "cpu"])
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["machine"]
