"""The port's examples (``vmas_tpu_torch/examples``) stay runnable: each
``main`` at a tiny size on the CPU, ``train_ppo`` and ``train_sharded`` also
over two gloo ranks (``processes=2``), and each module's command line."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from vmas_tpu_torch.examples import run_heuristic, speed_sweep, train_ppo, train_sharded, use_vmas_tpu_env

torch.set_num_threads(1)


def test_use_vmas_tpu_env():
    rates = use_vmas_tpu_env.main("transport", num_envs=4, n_steps=3, device="cpu")
    assert set(rates) == {"per_call", "rollout"} and all(r > 0 for r in rates.values())


def test_run_heuristic():
    rew = run_heuristic.main("transport", num_envs=4, n_steps=3, device="cpu")
    assert np.isfinite(rew)


def test_speed_sweep():
    rows = speed_sweep.main(n_envs=(2,), device="cpu", n_steps=2)
    assert len(rows) == 1 and rows[0]["n_envs"] == 2
    assert all(rows[0][k] > 0 for k in ("loop_s", "rollout_s", "fused_loop_s", "fused_rollout_s", "rows_s"))


def test_train_ppo():
    model = train_ppo.main(scenario="dispersion", num_envs=8, iters=2, horizon=4, device="cpu", fused_physics=True)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert not torch.distributed.is_initialized()  # the one-rank group it made is gone


def test_train_sharded():
    params = train_sharded.main(scenario="transport", num_envs=8, iters=2, horizon=2, device="cpu")
    assert all(bool(torch.isfinite(layer[k]).all()) for layer in params for k in ("w", "b"))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("example,kw", [
    (train_ppo, dict(scenario="dispersion", horizon=4, fused_physics=True)),
    (train_sharded, dict(horizon=2)),
], ids=["train_ppo", "train_sharded"])
def test_two_ranks(example, kw, capsys):
    """``processes=2``: two ranks of 4 envs each, rank 0's log printed."""
    example.main(**kw, num_envs=8, iters=2, processes=2, device="cpu")
    out = capsys.readouterr().out
    assert "mesh: 2 ranks, 8 envs (4/rank) on cpu" in out and "2 ranks done" in out


def test_command_line():
    out = subprocess.run([sys.executable, "-m", "vmas_tpu_torch.examples.speed_sweep", "--n_envs", "2",
                          "--n_steps", "1", "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "simple_spread, 3 agents, 1 steps on cpu" in out.stdout
