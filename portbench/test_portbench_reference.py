"""The plain reference against the port on the CPU at a tiny size, and the
check's control and planted faults coming out as not correct.

Run from the repository's root: ``python -m pytest portbench -q``.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import faults
from portbench import harness as H
from portbench import run
from portbench.reference import physics as P

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["transport.ppo", "joint_passage.rollout"]
# a tiny size: 8 envs, a few steps, one small PPO update after two more
TINY = {"ppo": {"horizon": 6, "epochs": 2}, "rollout": {"horizon": 6, "warm_calls": 2}}


def tiny_cell(name):
    cell = H.load_cell(name, ROOT)
    cell.num_envs = 8
    cell.traffic.update(TINY[cell.traffic["runner"]])
    return cell


def run_cpu(cell, seed=2**31 + 17):
    return cell.runner.run(cell, seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("config", ["transport", "joint_passage"])
def test_world_table_is_the_programs(config):
    """The reference's constants, worked out from the configuration's entity
    table, are the ones the port's kernel spec holds."""
    from vmas_tpu_torch import make_env
    from vmas_tpu_torch.core import fused as F

    cfg = H.load_module(ROOT / "portbench" / "configs" / f"{config}.py", f"test_cfg_{config}")
    env = make_env(config, num_envs=2, device="cpu", seed=0, fused_physics=True)
    ks, spec = F._kernel_spec(env.world), P.Spec(cfg.WORLD)
    assert [e.name for e in env.world.entities] == cfg.ENTITY_NAMES
    for key in ("E", "J", "substeps", "sub_dt", "cm", "cf", "jf", "tcf", "x_semidim", "y_semidim", "movable",
                "rotatable", "max_f", "f_range", "inv_mass", "inv_moi", "drag_fac", "joints", "ss", "ls", "ll",
                "bs", "bl", "bb", "trig"):
        assert getattr(spec, key) == getattr(ks, key), key


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(name):
    """A whole run of the cell on the CPU at 8 envs: the program and the
    reference agree to the bit on every compared number."""
    res = run_cpu(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in the next lower precision, put in the program's
    place, fails one of the cell's numbers."""
    cell = tiny_cell(name)
    checks, ok = H.checks_of(cell.runner.control(cell, 5, "cpu"), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("kind", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, kind, capsys, monkeypatch):
    """A whole run past the harness's look for a chip, with the timed path
    broken underneath: its result line says ``correct`` false. (The
    repository's conftest has loaded JAX into this process; the look for it
    is tested in a fresh interpreter, test_portbench_imports.py.)"""
    monkeypatch.setattr(H, "forbidden_modules", lambda: [])
    cell = tiny_cell(name)
    args = run.parse(["--workload", name, "--seed", str(2**31 + 29), "--seconds", "0.3", "--trace", "0"])
    with faults.planted(kind, cell):
        assert run.run_cell(cell, args, "cpu", time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"
