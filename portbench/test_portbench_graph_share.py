"""The reader of the collection's graph share (``portbench/metrics/
graph_share.ppo.py``): 100 on a recorder with one replay a collection, the
share on others, and None where the program recorded no replay or no
collection, or in a cell of another kind. Run from the repository's root:
``python -m pytest portbench -q``."""

import json
from pathlib import Path

import pytest

from portbench import harness as H
from vmas_tpu_torch import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def recorder():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _read(kind="ppo"):
    mod = H.load_module(ROOT / "portbench" / "metrics" / "graph_share.ppo.py", "portbench_metric_graph_share")
    return mod.read({"kind": kind})


def _record(collects, replays):
    for _ in range(collects):
        profiling._recorder.add("vmas.ppo.collect", 0.01)
    for _ in range(replays):
        profiling._recorder.add("vmas.rows.replay", 0.001)


def test_it_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    m = per_layer["graph_share.ppo"]
    assert (m["source"], m["unit"], m["moves"], m["workloads"]) == (
        "program_span", "%", "ppo_env_steps_per_s", ["transport.ppo"])


@pytest.mark.parametrize("collects,replays,want", [(2, 2, 100.0), (4, 3, 75.0), (2, 0, None), (0, 2, None)])
def test_replays_over_collections(collects, replays, want):
    _record(collects, replays)
    assert _read() == want
    assert _read("rollout") is None
