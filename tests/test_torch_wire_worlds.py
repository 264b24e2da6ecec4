"""The port's buzz_wire (its emit in the fused step: the 12 line-sphere
overlap tests of its collision penalty) and the debug world asym_joint (no
fused outputs: the fused step with no emit, its hooks around it) against
the JAX package's, from injected states, with tests/test_torch_joint_worlds.py's
helpers and tolerances:

* the plain versions of the fused step (K1) and of the rows step (K2)
  with buzz_wire's emit against the JAX package's Pallas kernel in
  interpret mode, its 15 substeps cut to 5 on both sides, from a state
  where the ball touches the wire's walls and floors moving into them (the
  line hits and the envs done required) and every joint pulls;
* one env step, on the plain path and on the fused step, against the JAX
  package's unfused step with its hooks, at the full substeps (asym_joint
  without its observation noise, whose streams differ);
* the recorded reference trajectories at the defaults (asym_joint without
  its observation noise), free-running for 10 steps and re-synced over 50,
  with tests/test_scenario_parity.py's atol table.

Then the port alone: buzz_wire's rows rollouts bitwise its env.step
rollouts, asym_joint refused by the rows paths and stepped by rollout_fn
with its noise, the kernel's emit parameters, and the resets.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_joint_worlds import (
    REQUIRED,
    check_catches_joint_error,
    check_emit_params,
    check_env_step,
    check_fused_twin,
    check_pair_buckets,
    check_rows_rollouts,
    check_rows_twin,
    golden_replay,
    jax_steps,
    make_step_states,
    make_twins,
)
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported

torch.set_num_threads(1)

TWINS = {"buzz_wire": ("buzz_wire", {})}
STEP = {**TWINS, "asym_joint": ("asym_joint", {"obs_noise": 0})}
NAMES = ("buzz_wire", "asym_joint")


@pytest.fixture(scope="module")
def twins():
    return make_twins(TWINS, 110)


@pytest.fixture(scope="module")
def step_states():
    return make_step_states(STEP, 120)


@pytest.fixture(scope="module")
def jax_stepped(step_states):
    return jax_steps(STEP, step_states)


def test_pair_buckets_and_lanes(twins):
    check_pair_buckets(*twins["buzz_wire"][:2])


def test_fused_step_twin_matches_pallas(twins):
    """The plain version of K1 with buzz_wire's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode), on a
    state where the line tests hit, the joints pull and envs are done."""
    env, jenv, jfo, arrays, _ = twins["buzz_wire"]
    ev = check_fused_twin(env, jenv, jfo, arrays)
    assert all(ev[k] > 0 for k in REQUIRED["buzz_wire"]), ev


def test_rows_step_twin_matches_pallas(twins):
    """The plain version of K2 against the JAX package's rows kernel in
    interpret mode."""
    check_rows_twin(*twins["buzz_wire"])


def test_twin_catches_a_joint_error(twins, monkeypatch):
    """Every joint force of the port 3e-4 too strong fails the K1 and K2
    twin comparisons, which pass without it."""
    check_catches_joint_error(monkeypatch, twins["buzz_wire"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(STEP))
def test_env_step_matches_jax(config, fused, step_states, jax_stepped):
    """One env step from the injected state, on the plain path or the fused
    step (asym_joint: the fused step with no emit, its hooks around it),
    against the JAX package's: state, observations, rewards, dones and the
    scratch the next step reads."""
    name, kw = STEP[config]
    check_env_step(name, kw, *step_states[config], fused, jax_stepped[config])


@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name):
    golden_replay(name)


def test_rows_rollout_equals_step_rollout():
    """buzz_wire's rows rollouts (k_steps 1 and 2, and a policy) bitwise its
    env.step rollouts, from a state with line hits."""
    check_rows_rollouts("buzz_wire", {}, 130)


def test_asym_joint_is_not_rows_eligible():
    """asym_joint has no fused outputs: with fused_physics the fused step
    runs its physics with no emit (the plain version here), its hooks (the
    observation noise and the energy term) around it, and it has no rows
    rollout; rollout_fn steps it."""
    env = torch_make_env("asym_joint", 4, device="cpu", seed=0, fused_physics=True)
    assert env.world.fused and env._fused_outputs is None and not rows_rollout_supported(env)
    with pytest.raises(AssertionError, match="not eligible"):
        rows_rollout_fn(env, horizon=2)
    _, _, traj = rollout_fn(env, horizon=2)(env.state, env.steps, torch.Generator().manual_seed(1))
    assert traj["rewards"].shape == (2, 4, 2) and bool((traj["rewards"] != 0).any())
    # the observation noise (0.2 by default) is there
    assert bool((traj["obs"][0][-1][:, :2] != env.agents[0].pos(env.state)).all())


def test_kernel_emit_params(twins):
    """buzz_wire's kernel parameters: the collidables (the agents, then the
    ball) with their radii rounded to f32 (the JAX package subtracts
    LINE_MIN_DIST and the radius one at a time, so no sum is rounded), the
    walls and floors with their half lengths, the factor and penalty, the
    scratch carry map; the by-value parameters within 4 KB."""
    env = twins["buzz_wire"][0]
    sc, agents = env.scenario, env.world.agents
    p = check_emit_params("buzz_wire", env)
    assert p.n_coll == 3 and [p.coll[k] for k in range(3)] == [a.index for a in agents] + [sc.ball.index]
    assert [p.coll_r[k] for k in range(3)] == [np.float32(0.03)] * 3
    assert [p.line[k] for k in range(4)] == [e.index for e in sc.walls + sc.floors]
    assert [p.half[k] for k in range(4)] == [np.float32(1.0)] * 2 + [np.float32(0.125)] * 2
    assert (p.factor, p.coll_pen) == (1.0, -10.0)


@pytest.mark.parametrize("name", NAMES)
def test_reset_invariants(name):
    """The port's own reset: the JAX package's ranges and layouts (the ball
    in the wire's channel and 0.25 from each agent, the goal in it; the bar
    at the origin, its ends 0.25 from it and swapped per env, the mass on
    it), each draw spread, the shapings consistent."""
    env = torch_make_env(name, 256, device="cpu", seed=3)
    st, sc = env.state, env.scenario
    agents = [a.index for a in env.world.agents]
    assert not st.vel.any()
    if name == "buzz_wire":
        ball, goal = st.pos[:, sc.ball.index], st.pos[:, sc.goal.index]
        assert bool((ball[:, 0].abs() <= 0.03 + 1e-6).all()) and bool((ball[:, 1] <= -0.03 + 1e-6).all())
        d = torch.linalg.vector_norm(st.pos[:, agents] - ball[:, None], dim=-1)
        torch.testing.assert_close(d, torch.full_like(d, 0.25), atol=1e-6, rtol=0)
        torch.testing.assert_close(st.scenario["pos_shaping"], torch.linalg.vector_norm(ball - goal, dim=-1),
                                   atol=1e-6, rtol=0)
        assert float(goal[:, 1].std()) > 0.2 and not st.scenario["collided"].any()
    if name == "asym_joint":
        assert not st.pos[:, sc.joint.landmark.index].any()
        d = torch.linalg.vector_norm(st.pos[:, agents], dim=-1)
        torch.testing.assert_close(d, torch.full_like(d, 0.25), atol=1e-6, rtol=0)
        assert set(torch.sign(st.pos[:, agents[0], 0]).tolist()) == {-1.0, 1.0}  # the ends swapped per env
        torch.testing.assert_close(st.pos[:, sc.mass.index, 0].abs(), torch.full((256,), 0.75 * 0.25), atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(st.scenario["rot_shaping_pre"], torch.full((256,), math.pi / 2), atol=1e-6,
                                   rtol=0)
