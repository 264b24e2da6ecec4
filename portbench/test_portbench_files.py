"""The harness finds a cell, a configuration, a traffic mix and a metric by
name from their files alone: one added as files is picked up with no edit
of the harness. Run from the repository's root: ``python -m pytest portbench
-q``."""

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness as H
from portbench import run

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_from_its_files(name):
    cell = H.load_cell(name, ROOT)
    assert cell.num_envs > 0 and cell.limits
    # the runner reports the rate its traffic file names, and set-up
    assert {m["name"] for m in cell.e2e} == {cell.traffic["metric"], "setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        # a reader that finds nothing to read returns nothing
        assert H.read_metric(cell, m, {}) is None or m["name"] == "make_env_s"


def test_a_cell_added_as_files_is_picked_up(tmp_path, capsys, monkeypatch):
    """A new configuration, traffic mix, cell, end-to-end metric and
    per-layer metric, each a file of its own plus entries in BENCHMARK.json,
    run through the unchanged harness's entry past its look for a chip. (The
    repository's conftest has loaded JAX into this process; the look for it
    is tested in a fresh interpreter, test_portbench_imports.py.)"""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "transport_3.json").write_text(json.dumps(
        {**json.loads((pb / "configs" / "transport.json").read_text()), "kwargs": {"n_agents": 3}}))
    (pb / "configs" / "transport_3.py").write_text(
        (pb / "configs" / "transport.py").read_text().replace("N_AGENTS = 4", "N_AGENTS = 3"))
    (pb / "traffic" / "short_rollout.json").write_text(json.dumps(
        {"runner": "rollout", "metric": "env_steps_per_s.short", "horizon": 4, "warm_calls": 2, "trace_calls": 2}))
    (pb / "cells" / "transport_3.short_rollout.json").write_text(json.dumps(
        {"num_envs": 8, "limits": {"obs_gap": 0.0, "rew_gap": 0.0, "state_gap": 0.0, "done_flips": 0}}))
    (pb / "metrics" / "calls.short.py").write_text("def read(r):\n    return r.get('calls')\n")
    bench["configs"].append({"name": "transport_3", "source": "x", "file": "portbench/configs/transport_3.json",
                             "reduced": ["n_agents"], "why": "a test"})
    bench["workloads"].append({"name": "transport_3.short_rollout", "config": "transport_3",
                               "traffic": "short_rollout", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "env_steps_per_s.short", "unit": "env-steps/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["transport_3.short_rollout"]})
    bench["per_layer"].append({"name": "calls.short", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "Rollout loop",
                               "moves": "env_steps_per_s.short", "workloads": ["transport_3.short_rollout"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = H.load_cell("transport_3.short_rollout", tmp_path, bench_dir=pb)
    assert cell.num_envs == 8 and cell.traffic["horizon"] == 4
    assert cell.reference.N_AGENTS == 3 and cell.runner.__name__.endswith("rollout")
    assert {m["name"] for m in cell.e2e} == {"env_steps_per_s.short", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["calls.short"]
    assert H.read_metric(cell, cell.per_layer[0], {"calls": 7}) == 7
    monkeypatch.setattr(H, "forbidden_modules", lambda: [])
    args = run.parse(["--workload", cell.name, "--seed", "3", "--seconds", "0.2", "--trace", "0"])
    assert run.run_cell(cell, args, "cpu", time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"env_steps_per_s.short", "setup_s"}
    assert line["metrics"]["env_steps_per_s.short"]["value"] > 0


def test_benchmark_json_keeps_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").exists()
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
