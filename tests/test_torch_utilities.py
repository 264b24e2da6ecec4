"""The port's utilities against the JAX package's: the top-level name lists
and ``Wrapper`` (fault 3.6) with simple_adversary's two reward methods,
checkpoints (``vmas_tpu_torch/checkpoint.py``), ``checked_step``
(``debug.py``) and the profiling helpers (``profiling.py``), on the CPU.

* the lists and ``Wrapper``'s members equal the JAX package's; the reward
  methods bitwise the JAX ones from one injected state;
* a checkpoint round-trips bitwise (npz, an extension-less path, dcp with
  its zero-size comm leaf), and a resumed env and a resumed rows rollout
  replay bitwise, the generator's state included; a mismatched config
  raises ``ValueError`` naming the leaf;
* ``checked_step`` gives ``env.step``'s results bitwise and raises on the
  NaN and Inf position states of tests/test_debug.py, where the JAX
  package's ``checked_step`` raises too (transport, 2 envs; one JAX
  compile for the file);
* ``StepTimer``, ``benchmark_fn`` and ``trace`` behave as
  tests/test_checkpoint.py:62-77 holds the JAX ones to.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
import vmas_tpu_torch
from vmas_tpu.debug import checked_step as jax_checked_step
from vmas_tpu_torch import make_env
from vmas_tpu_torch.checkpoint import load_env, load_state, save_env, save_state
from vmas_tpu_torch.debug import checked_step, validate_state
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
from vmas_tpu_torch.parallel import rows_rollout_fn
from vmas_tpu_torch.profiling import StepTimer, benchmark_fn, trace
from vmas_tpu_torch.testing import mpe_family_state, trees_equal

torch.set_num_threads(1)


# -- fault 3.6: the top-level lists, Wrapper, simple_adversary's rewards ------

def test_top_level_lists_match_jax():
    assert vmas_tpu_torch.scenarios == vmas_tpu.scenarios
    assert vmas_tpu_torch.debug_scenarios == vmas_tpu.debug_scenarios
    assert vmas_tpu_torch.mpe_scenarios == vmas_tpu.mpe_scenarios
    assert len(vmas_tpu_torch.scenarios) == 23 and len(vmas_tpu_torch.debug_scenarios) == 11
    assert [(m.name, m.value) for m in vmas_tpu_torch.Wrapper] == [(m.name, m.value) for m in vmas_tpu.Wrapper]
    for name in ("scenarios", "debug_scenarios", "mpe_scenarios", "make_env", "render_interactively"):
        assert name in vmas_tpu_torch.__all__


def test_simple_adversary_reward_methods_match_jax():
    """agent_reward and adversary_reward exist on both packages' scenario and
    agree bitwise from one injected state; reward dispatches to them."""
    env = make_env("simple_adversary", 8, device="cpu", seed=0)
    arrays = mpe_family_state(env, np.random.default_rng(11))
    env.state = state_from_numpy(env.world, arrays)
    jenv = vmas_tpu.make_env("simple_adversary", num_envs=8, seed=0)
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    js = jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
                            scenario={**jenv.state.scenario,
                                      **{k: jnp.asarray(v) for k, v in arrays["scenario"].items()}})
    sc, jsc = env.scenario, jenv.scenario
    for a, ja in zip(sc.world.agents, jsc.world.agents):
        method = "adversary_reward" if a.adversary else "agent_reward"
        got = getattr(sc, method)(a, env.state).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jsc, method)(ja, js)), err_msg=f"{a.name} {method}")
        np.testing.assert_array_equal(sc.reward(a, env.state).numpy(), got)
    assert {a.adversary for a in sc.world.agents} == {True, False}


# -- checkpoints ---------------------------------------------------------------

def test_env_checkpoint_roundtrip(tmp_path):
    """A resumed env replays the exact trajectory of the original, random
    actions included (the generator's state is restored)."""
    path = str(tmp_path / "ckpt.npz")
    env = make_env("transport", num_envs=3, device="cpu", seed=4)
    env.step(env.get_random_actions())
    save_env(env, path)
    ref = make_env("transport", num_envs=3, device="cpu", seed=9)
    load_env(ref, path)
    assert trees_equal(state_to_numpy(ref.state), state_to_numpy(env.state))
    assert torch.equal(ref.steps, env.steps)
    for _ in range(3):
        obs_a = env.step(env.get_random_actions())[0]
        obs_b = ref.step(ref.get_random_actions())[0]
        assert all(torch.equal(a, b) for a, b in zip(obs_a, obs_b))


def test_checkpoint_extensionless_path(tmp_path):
    path = str(tmp_path / "ckpt")  # no extension
    env = make_env("dispersion", num_envs=2, device="cpu", seed=1)
    save_env(env, path)
    assert os.path.exists(path + ".npz")
    load_env(env, path)


@pytest.mark.parametrize("name", ["transport", "football"])
def test_env_checkpoint_dcp_roundtrip(tmp_path, name):
    """The dcp backend keeps the zero-size comm leaf c[B, A, 0] at its shape
    and restores everything that moves the next steps: football's team AI
    draws from the last step's observation seed."""
    env = make_env(name, num_envs=2, device="cpu", seed=3)
    env.step(env.get_random_actions())
    save_env(env, str(tmp_path / "dcp_ck"), backend="dcp")
    other = make_env(name, num_envs=2, device="cpu", seed=9)
    load_env(other, str(tmp_path / "dcp_ck"), backend="dcp")
    assert other.state.c.shape == env.state.c.shape and other.state.c.numel() == 0
    assert trees_equal(state_to_numpy(other.state), state_to_numpy(env.state))
    for _ in range(2):
        acts = env.get_random_actions()
        other.get_random_actions()
        assert all(torch.equal(a, b) for a, b in zip(env.step(acts)[1], other.step(acts)[1]))
    assert trees_equal(state_to_numpy(other.state), state_to_numpy(env.state))


def test_state_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    env = make_env("transport", num_envs=3, device="cpu", seed=0)
    save_state(env.state, path)
    with pytest.raises(ValueError, match="leaf 'scenario/"):
        load_state(make_env("balance", num_envs=3, device="cpu", seed=0).state, path)
    with pytest.raises(ValueError, match="leaf 'pos' has shape"):
        load_state(make_env("transport", num_envs=4, device="cpu", seed=0).state, path)
    with pytest.raises(ValueError, match="backend"):
        save_env(env, path, backend="orbax")


def test_resumed_rows_rollout_replays(tmp_path):
    """10 rows steps, a checkpoint, 10 more: a fresh env that loads the
    checkpoint and runs the same call gives the second 10 bitwise, the
    env's generator carrying the random actions across."""
    env = make_env("transport", num_envs=4, device="cpu", seed=2, fused_physics=True)
    run = rows_rollout_fn(env, horizon=10)
    env.state, env.steps, _ = run(env.state, env.steps, env.generator)
    save_env(env, str(tmp_path / "rows"))
    state_a, steps_a, traj_a = run(env.state, env.steps, env.generator)
    other = make_env("transport", num_envs=4, device="cpu", seed=7, fused_physics=True)
    load_env(other, str(tmp_path / "rows"))
    state_b, steps_b, traj_b = rows_rollout_fn(other, horizon=10)(other.state, other.steps, other.generator)
    assert torch.equal(traj_a["rewards"], traj_b["rewards"]) and torch.equal(steps_a, steps_b)
    assert all(torch.equal(a, b) for a, b in zip(traj_a["obs"], traj_b["obs"]))
    assert trees_equal(state_to_numpy(state_a), state_to_numpy(state_b))
    assert torch.equal(env.generator.get_state(), other.generator.get_state())


# -- checked_step ------------------------------------------------------------------

def test_checked_step_is_env_step_bitwise():
    for kw in ({}, {"fused_physics": True}):
        env = make_env("transport", num_envs=2, device="cpu", seed=0, **kw)
        twin = make_env("transport", num_envs=2, device="cpu", seed=0, **kw)
        step = checked_step(env)
        for _ in range(3):
            acts = env.get_random_actions()
            twin.get_random_actions()
            a, b = step(acts), twin.step(acts)
            assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]))
        assert trees_equal(state_to_numpy(env.state), state_to_numpy(twin.state))
        assert torch.equal(env.generator.get_state(), twin.generator.get_state())
        validate_state(env.state)


@pytest.fixture(scope="module")
def jax_step():
    env = vmas_tpu.make_env("transport", num_envs=2, seed=0)
    return env, jax_checked_step(env)


@pytest.mark.parametrize("value", [float("nan"), float("inf")], ids=["nan", "inf"])
def test_checked_step_raises_where_jax_does(jax_step, value):
    """The NaN and Inf position states of tests/test_debug.py: both
    packages' checked_step raise, the port's with a message naming the
    violated invariants; the env keeps its pre-step state."""
    jenv, jstep = jax_step
    jenv.reset(seed=0)
    jenv.state = jenv.state.replace(pos=jenv.state.pos.at[0, 0, 0].set(value))
    with pytest.raises(Exception, match="non-finite|nan"):
        jstep(jenv.get_random_actions())

    env = make_env("transport", num_envs=2, device="cpu", seed=0)
    step = checked_step(env)
    pos = env.state.pos.clone()
    pos[0, 0, 0] = value
    env.state = env.state.replace(pos=pos)
    before = state_to_numpy(env.state)
    with pytest.raises(FloatingPointError, match="non-finite entity positions"):
        step(env.get_random_actions())
    assert trees_equal(before, state_to_numpy(env.state))
    with pytest.raises(FloatingPointError, match="non-finite"):
        validate_state(env.state)


def test_checked_step_names_the_op_that_made_a_nan():
    """A NaN made inside the step from NaN-free inputs (a scenario hook that
    takes the square root of a negative number) is named by its op."""
    env = make_env("transport", num_envs=2, device="cpu", seed=0)
    pre_step = env.scenario.pre_step
    env.scenario.pre_step = lambda state: pre_step(state.replace(torque=torch.sqrt(state.torque - 1.0)))
    with pytest.raises(FloatingPointError, match=r"nan first produced by aten\.sqrt"):
        checked_step(env)(env.get_random_actions())


# -- profiling ---------------------------------------------------------------------

def test_step_timer_and_benchmark():
    env = make_env("dispersion", num_envs=2, device="cpu", seed=0)
    timer = StepTimer()
    acts = env.get_random_actions()
    with timer.phase("step"):
        env.step(acts)
    out = []
    with timer.phase("step", sync_on=lambda: out):
        out = env.step(acts)
    s = timer.summary()
    assert s["step"]["count"] == 2 and s["step"]["total_s"] > 0 and s["step"]["mean_ms"] > 0
    timer.reset()
    assert timer.summary() == {}

    mean_s, last = benchmark_fn(lambda: env.step(acts), iters=2, warmup=1)
    assert mean_s > 0 and len(last) == 4
    # warmup=0 measures the first call; iters < 1 is rejected
    mean_s0, _ = benchmark_fn(lambda: env.step(acts), iters=1, warmup=0)
    assert mean_s0 > 0
    with pytest.raises(ValueError):
        benchmark_fn(lambda: None, iters=0)


def test_trace_writes_a_chrome_trace(tmp_path):
    env = make_env("transport", num_envs=2, device="cpu", seed=0)
    with trace(str(tmp_path / "tr")):
        env.step(env.get_random_actions())
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
