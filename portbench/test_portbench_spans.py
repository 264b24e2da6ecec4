"""The ten readers of the program's spans (``portbench/spans.py``,
``portbench/metrics/``): each returns None on an empty recorder and the
span's number on a filled one. Run from the repository's root: ``python -m
pytest portbench -q``."""

import json
import statistics
from pathlib import Path

import pytest
import torch

from portbench import harness as H
from vmas_tpu_torch import make_env, profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# reader -> (its cell's kind, the span it reads, what it takes of it)
READERS = {
    "span_collect_ms.ppo": ("ppo", "vmas.ppo.collect", "device mean"),
    "span_batch_ms.ppo": ("ppo", "vmas.ppo.batch", "device mean"),
    "span_fit_ms.ppo": ("ppo", "vmas.ppo.fit", "device mean"),
    "step_host_us.ppo": ("ppo", "vmas.rows.policy_step", "host median us"),
    "launch_host_us.ppo": ("ppo", "vmas.rows.launch", "host median us"),
    "launch_host_us.rollout": ("rollout", "vmas.rows.launch", "host median us"),
    "span_actions_ms.rollout": ("rollout", "vmas.rows.actions", "host median"),
    "span_loop_ms.rollout": ("rollout", "vmas.rows.loop", "device median"),
    "span_finish_ms.rollout": ("rollout", "vmas.rows.finish", "device median"),
    "kernel_load_s": (None, "vmas.kernels.load", "host total"),
}
HOST_S = [0.003, 0.001, 0.002, 0.010]
DEVICE_MS = [4.0, 1.0, 2.0, 9.0]


class _Event:
    """A recorded CUDA event as the recorder reads it, at a set time."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture(autouse=True)
def recorder():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _read(name, kind):
    mod = H.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "portbench_metric_" + name)
    return mod.read({} if kind is None else {"kind": kind})


def test_every_span_metric_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        assert per_layer[name]["source"] == "program_span" and per_layer[name]["workloads"], name


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_on_an_empty_recorder(name):
    kind, _, _ = READERS[name]
    assert _read(name, kind) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_span_number(name):
    kind, span, what = READERS[name]
    for s, ms in zip(HOST_S, DEVICE_MS):
        profiling._recorder.add(span, s, (_Event(100.0), _Event(100.0 + ms)) if what.startswith("device") else None)
    profiling._recorder.add("vmas.other", 1.0)
    want = {
        "device mean": statistics.fmean(DEVICE_MS),
        "device median": statistics.median(DEVICE_MS),
        "host median": 1e3 * statistics.median(HOST_S),
        "host median us": 1e6 * statistics.median(HOST_S),
        "host total": sum(HOST_S),
    }[what]
    assert _read(name, kind) == pytest.approx(want, rel=1e-12)
    # a cell of the other kind reads nothing
    if kind is not None:
        assert _read(name, {"ppo": "rollout", "rollout": "ppo"}[kind]) is None


def test_host_readers_on_a_recorded_cpu_rollout():
    """The spans the program records in a rows rollout (on the CPU: the host
    clock alone) fill the rollout's host readers; its device readers stay
    empty."""
    from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

    env = make_env("transport", num_envs=8, device="cpu", seed=0, n_agents=4, fused_physics=True)
    profiling.enable()
    rows_rollout_fn(env, horizon=4)(env.state, env.steps, torch.Generator().manual_seed(0))
    s = profiling.summary()
    assert _read("launch_host_us.rollout", "rollout") == pytest.approx(
        1e3 * statistics.median(s["vmas.rows.launch"]["samples_ms"]))
    assert _read("span_actions_ms.rollout", "rollout") == pytest.approx(s["vmas.rows.actions"]["samples_ms"][0])
    assert _read("span_loop_ms.rollout", "rollout") is None
    assert _read("span_finish_ms.rollout", "rollout") is None
