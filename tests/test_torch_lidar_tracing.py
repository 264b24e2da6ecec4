"""The Lidar's span and counters (``sensors.py``, ``profiling.count``) and
the rows rollout's state-rebuild span (``parallel/rollout.py``
``vmas.rows.states``): what a navigation rows call records, where the
spans lie, that nothing records with recording off, and that flocking's
Lidar counts its tests by the same rule. On the CPU, with no JAX; the last
two tests need a CUDA GPU (``gpu`` marker) and skip without one:

    python -m pytest --noconftest tests/test_torch_lidar_tracing.py -q
"""

import pytest
import torch

from vmas_tpu_torch import make_env, profiling
from vmas_tpu_torch.core import Agent
from vmas_tpu_torch.parallel.rollout import rows_rollout_fn

B, T, A, R = 8, 5, 4, 12
LIDAR = ("vmas.sensors.lidar.casts", "vmas.sensors.lidar.rays", "vmas.sensors.lidar.tests.sphere")


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts from an empty recorder that records only under a
    profiler session, and leaves it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _navigation_call():
    """A navigation rows call of T steps at B envs; the env (whose reset
    measures the Lidars once) is made first."""
    env = make_env("navigation", num_envs=B, device="cpu", seed=0, fused_physics=True)
    run = rows_rollout_fn(env, horizon=T)
    return lambda: run(env.state, env.steps, torch.Generator().manual_seed(1))


def test_a_navigation_rows_call_counts_its_rays_and_tests():
    call = _navigation_call()
    profiling.enable()
    call()
    n = profiling.counters()
    rays = B * T * A * R
    # each agent's rays over the call's T x B env-steps, each tested against
    # the other three agents
    assert n == {"vmas.sensors.lidar.casts": B * T * A, "vmas.sensors.lidar.rays": rays,
                 "vmas.sensors.lidar.tests.sphere": rays * (A - 1)}
    s = profiling.summary()
    # one measure per agent over the call's one chunk of steps
    assert s["vmas.sensors.lidar"]["count"] == A
    assert s["vmas.rows.states"]["count"] == 1


def test_the_state_rebuild_lies_inside_the_finish():
    call = _navigation_call()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    spans = {}
    for e in prof.events():
        if e.name.startswith("vmas."):
            spans.setdefault(e.name, []).append(e.time_range)
    (finish,), (states,) = spans["vmas.rows.finish"], spans["vmas.rows.states"]
    assert finish.start <= states.start <= states.end <= finish.end
    assert len(spans["vmas.sensors.lidar"]) == A
    assert all(states.start <= r.start <= r.end <= states.end for r in spans["vmas.sensors.lidar"])
    s = profiling.summary()
    assert s["vmas.rows.states"]["total_s"] <= s["vmas.rows.finish"]["total_s"]
    assert profiling.counters()["vmas.sensors.lidar.rays"] == B * T * A * R


def test_off_counts_and_records_nothing():
    call = _navigation_call()
    _, _, off = call()
    assert profiling.summary() == {} and profiling.counters() == {}
    profiling.enable()
    _, _, on = call()
    assert set(LIDAR) <= set(profiling.counters())
    for a, b in zip(off["obs"], on["obs"]):
        assert torch.equal(a, b)
    profiling.reset()
    assert profiling.summary() == {} and profiling.counters() == {}


def test_flockings_lidar_counts_the_obstacles_it_admits():
    """Flocking's Lidar admits the sphere obstacles, not the agents (the
    target among them): its tests are its rays times the obstacles."""
    n_obstacles = 3
    env = make_env("flocking", num_envs=B, device="cpu", seed=0, n_obstacles=n_obstacles)
    sensing = [a for a in env.world.agents if a.sensors]
    assert sensing and any(isinstance(e, Agent) and e not in sensing for e in env.world.entities)
    profiling.enable()
    for a in sensing:
        a.sensors[0].measure(env.state)
    rays = B * R * len(sensing)
    assert profiling.counters() == {"vmas.sensors.lidar.casts": B * len(sensing), "vmas.sensors.lidar.rays": rays,
                                    "vmas.sensors.lidar.tests.sphere": rays * n_obstacles}
    assert profiling.summary()["vmas.sensors.lidar"]["count"] == len(sensing)


@pytest.mark.gpu
def test_the_lidar_span_adds_no_device_record_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rows step's kernel has no CPU mode")
    env = make_env("navigation", num_envs=B, device="cuda", seed=0, fused_physics=True)
    run = rows_rollout_fn(env, horizon=T)
    run(env.state, env.steps, torch.Generator(device="cuda").manual_seed(1))  # loads the kernel
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(env.state, env.steps, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device and not [e.name for e in device if "vmas." in e.name]
    s = profiling.summary()
    assert len(s["vmas.sensors.lidar"]["device_ms"]) == A and len(s["vmas.rows.states"]["device_ms"]) == 1
    assert sum(s["vmas.sensors.lidar"]["device_ms"]) <= s["vmas.rows.states"]["device_ms"][0]
    assert profiling.counters()["vmas.sensors.lidar.tests.sphere"] == B * T * A * R * (A - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("scenario", ["navigation", "transport"])
def test_a_rows_call_waits_for_nothing_on_the_card(scenario):
    """After the first call (the kernel's load, the constants' copies), a
    random-action rows call, navigation's Lidar included, makes no
    operation that waits for the device: the host can run ahead of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rows step's kernel has no CPU mode")
    env = make_env(scenario, num_envs=B, device="cuda", seed=0, fused_physics=True)
    run = rows_rollout_fn(env, horizon=T)
    state, steps, _ = run(env.state, env.steps, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(state, steps, torch.Generator(device="cuda").manual_seed(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
