"""The program's spans (``vmas_tpu_torch/profiling.py`` ``span``): what
records when, what each rows rollout and PPO update records, that a span
reaches the profiler as a host operation and never as a user annotation,
and that the spans leave the trajectories as they are.

On the CPU, with no JAX; the last test needs a CUDA GPU (``gpu`` marker)
and skips without one. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import json

import pytest
import torch
from torch.autograd import DeviceType

from vmas_tpu_torch import make_env, profiling
from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.parallel import init_actor_critic, make_ppo_update, obs_dim_of
from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

B = 8
ROWS = ("vmas.rows.call", "vmas.rows.actions", "vmas.rows.loop", "vmas.rows.finish")
PPO = ("vmas.ppo.update", "vmas.ppo.collect", "vmas.ppo.batch", "vmas.ppo.fit")


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts from an empty recorder that records only under a
    profiler session, and leaves it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _env(device="cpu"):
    return make_env("transport", num_envs=B, device=device, seed=0, n_agents=4, fused_physics=True)


def _rows_call(env, horizon, seed=1):
    gen = torch.Generator(device=env.device).manual_seed(seed)
    return rows_rollout_fn(env, horizon=horizon)(env.state, env.steps, gen)


def _ppo_update(horizon=4):
    env = make_env("transport", num_envs=B, device="cpu", seed=0, n_agents=3, fused_physics=True)
    model = init_actor_critic(obs_dim_of(env), 2, generator=torch.Generator().manual_seed(0), device="cpu")
    update, make_optimizer = make_ppo_update(env, horizon=horizon, collect="rows", epochs=2)
    return update(model, make_optimizer(model), env.state, env.steps, torch.Generator().manual_seed(2))


def test_the_profiler_hook_exists():
    """The spans enter the trace through this type: a torch without it
    fails here, and not on the card."""
    assert callable(torch._C._profiler._RecordFunctionFast)
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)


def test_off_records_nothing_and_keeps_the_trajectory_bitwise():
    env = _env()
    st_off, steps_off, tr_off = _rows_call(env, 16)
    assert profiling.summary() == {}
    profiling.enable()
    st_on, steps_on, tr_on = _rows_call(env, 16)
    assert profiling.summary()
    assert torch.equal(steps_off, steps_on)
    for k in ("rewards", "dones"):
        assert torch.equal(tr_off[k], tr_on[k]), k
    for a, b in zip(tr_off["obs"], tr_on["obs"]):
        assert torch.equal(a, b)
    for f in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        assert torch.equal(getattr(st_off, f), getattr(st_on, f)), f


def test_a_rows_call_records_its_parts_and_each_launch():
    env = _env()
    profiling.enable()
    _rows_call(env, 16)
    s = profiling.summary()
    assert {k: s[k]["count"] for k in ROWS} == dict.fromkeys(ROWS, 1)
    assert s["vmas.rows.launch"]["count"] == 16 and len(s["vmas.rows.launch"]["samples_ms"]) == 16
    # the parts lie inside the call on the host clock; the CPU has no device clock
    parts = sum(s[k]["total_s"] for k in ROWS[1:])
    assert 0 < parts <= s["vmas.rows.call"]["total_s"]
    assert all("device_ms" not in v for v in s.values())
    assert "vmas.rows.policy_step" not in s


def test_a_ppo_update_records_its_parts_and_each_policy_step():
    profiling.enable()
    _ppo_update(horizon=4)
    s = profiling.summary()
    assert {k: s[k]["count"] for k in PPO} == dict.fromkeys(PPO, 1)
    assert s["vmas.rows.policy_step"]["count"] == 4 and s["vmas.rows.launch"]["count"] == 4
    assert {k: s[k]["count"] for k in ROWS[::2]} == {"vmas.rows.call": 1, "vmas.rows.loop": 1}
    assert "vmas.rows.actions" not in s
    parts = sum(s[k]["total_s"] for k in PPO[1:])
    assert 0 < parts <= s["vmas.ppo.update"]["total_s"]


def test_spans_are_host_operations_of_a_profiler_session_only():
    env = _env()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _rows_call(env, 4)
    events = [e for e in prof.events() if e.name.startswith("vmas.")]
    assert {e.name for e in events} == set(ROWS) | {"vmas.rows.launch"}
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in events)
    s = profiling.summary()
    assert s["vmas.rows.launch"]["count"] == 4
    profiling.reset()
    _rows_call(env, 4)
    assert profiling.summary() == {}


def test_a_span_that_records_always():
    with profiling.span("vmas.test.once", always=True):
        pass
    with profiling.span("vmas.test.not"):
        pass
    s = profiling.summary()
    assert list(s) == ["vmas.test.once"] and s["vmas.test.once"]["count"] == 1
    profiling.reset()
    assert profiling.summary() == {}


def test_trace_file_holds_the_span_names(tmp_path):
    env = _env()
    with profiling.trace(str(tmp_path / "tr")):
        _rows_call(env, 4)
    names = {str(e.get("name", "")) for e in json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert set(ROWS) | {"vmas.rows.launch"} <= names


@pytest.mark.gpu
def test_spans_add_no_device_record_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rows step's kernel has no CPU mode")
    env = _env("cuda")
    _rows_call(env, 4)  # loads the kernel
    torch.cuda.synchronize()
    profiling.reset()
    launches0 = F.rows_step_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _rows_call(env, 16)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert device and not [e.name for e in device if "vmas." in e.name]
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert set(ROWS) | {"vmas.rows.launch"} <= host
    s = profiling.summary()
    assert s["vmas.rows.launch"]["count"] == F.rows_step_launches - launches0 == 16
    # the device clock of the call and its parts
    for k in ("vmas.rows.call", "vmas.rows.loop", "vmas.rows.finish"):
        assert len(s[k]["device_ms"]) == 1 and s[k]["device_ms"][0] > 0, k
