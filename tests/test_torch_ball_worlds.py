"""The port's ball worlds ball_trajectory and ball_passage (each with its
emit in the fused step) against the JAX package's, from injected states,
with tests/test_torch_joint_worlds.py's helpers and tolerances:

* the plain versions of the fused step (K1) and of the rows step (K2)
  with the scenario's emit against the JAX package's Pallas kernel in
  interpret mode: ball_trajectory with its pos and dist shapings on (the
  square root of the ball's distance to the circle) and its 15 substeps
  cut to 5 on both sides; ball_passage cut to 3 walls (9 box-sphere pairs,
  still in the JAX kernel's table form of 8 pairs or more; its 19 walls'
  57 tests compile slowly in interpret mode), with the contacts, box hits
  and done the state makes required;
* one env step, on the plain path and on the fused step, against the JAX
  package's unfused step with its hooks, at the full substeps
  (ball_trajectory without joints too);
* the recorded reference trajectories at the defaults, free-running and
  re-synced, with tests/test_scenario_parity.py's atol table and horizons.

Then the port alone: the rows rollouts bitwise their env.step rollouts,
the kernel's emit parameters with their thresholds rounded once, and the
resets.
"""

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
from vmas_tpu_torch.core.utils import LINE_MIN_DIST

torch.set_num_threads(1)

# ball_passage cut to 3 walls; ball_trajectory with every shaping on
SHAPED = ("ball_trajectory", {"pos_shaping_factor": 1, "dist_shaping_factor": 1})
CUT = ("ball_passage", {"n_passages": 17})
TWINS = {"ball_trajectory": SHAPED, "ball_passage": CUT}
STEP = {**TWINS, "ball_trajectory,no_joints": ("ball_trajectory", {"joints": False})}
NAMES = ("ball_trajectory", "ball_passage")


@pytest.fixture(scope="module")
def twins():
    return make_twins(TWINS, 140)


@pytest.fixture(scope="module")
def step_states():
    return make_step_states(STEP, 150)


@pytest.fixture(scope="module")
def jax_stepped(step_states):
    return jax_steps(STEP, step_states)


@pytest.mark.parametrize("config", sorted(TWINS))
def test_pair_buckets_and_lanes(config, twins):
    check_pair_buckets(*twins[config][:2])


@pytest.mark.parametrize("config", sorted(TWINS))
def test_fused_step_twin_matches_pallas(config, twins):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode), on a
    state where the agents touch the ball or the walls, the ball sits
    inside a wall, past it, on its goal or out of the arena."""
    env, jenv, jfo, arrays, _ = twins[config]
    ev = check_fused_twin(env, jenv, jfo, arrays)
    assert all(ev[k] > 0 for k in REQUIRED[TWINS[config][0]]), ev


@pytest.mark.parametrize("config", sorted(TWINS))
def test_rows_step_twin_matches_pallas(config, twins):
    """The plain version of K2 against the JAX package's rows kernel in
    interpret mode."""
    check_rows_twin(*twins[config])


def test_twin_catches_a_joint_error(twins, monkeypatch):
    """Every joint force of the port 3e-4 too strong fails ball_trajectory's
    K1 and K2 twin comparisons, which pass without it (ball_passage has no
    joint)."""
    check_catches_joint_error(monkeypatch, twins["ball_trajectory"])


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


@pytest.mark.parametrize("config", sorted(TWINS) + ["ball_passage,default"])
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollouts bitwise their env.step rollouts (k_steps 1 and 2,
    and a policy), from a state with contacts and events."""
    name, kw = TWINS.get(config, ("ball_passage", {}))
    check_rows_rollouts(name, kw, 160)


@pytest.mark.parametrize("config", sorted(TWINS) + ["ball_passage,default"])
def test_kernel_emit_params(config, twins):
    """Each emit's kernel parameters: ball_passage's contact distances
    (radius + LINE_MIN_DIST) and arena bounds, each a double expression the
    JAX package compares against, rounded once to f32, its walls and open
    passages in world order; ball_trajectory's circle and factors; the
    scratch carry map; the by-value parameters within 4 KB."""
    name = TWINS.get(config, CUT)[0]
    env = twins[config][0] if config in twins else torch_make_env(name, 2, device="cpu", seed=0, fused_physics=True)
    p = check_emit_params(name, env)
    sc = env.scenario
    if name == "ball_passage":
        agents = [a.index for a in env.world.agents]
        assert [p.coll[k] for k in range(p.n_coll)] == agents + [sc.ball.index]
        assert [p.coll_dmin[k] for k in range(p.n_coll)] == [np.float32(0.03333 + LINE_MIN_DIST)] * 3
        assert (p.lo, p.hi) == (np.float32(-1 + 0.03333), np.float32(1 - 0.03333))
        assert [p.wall[k] for k in range(p.n_walls)] == [q.index for q in sc.passages if q.collide]
        assert [p.open[k] for k in range(p.n_open)] == [q.index for q in sc.passages if not q.collide]
        assert (p.hw, p.hl, p.coll_pen) == (np.float32(0.1), np.float32(0.103 / 2), np.float32(-0.06))
        assert p.n_walls == (19 if config.endswith("default") else 3)
    if name == "ball_trajectory":
        assert (p.ball, p.R, p.v_des) == (sc.ball.index, 0.5, 1.0)
        assert (p.pos_f, p.speed_f, p.dist_f) == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_reset_invariants(name):
    """The port's own reset: the JAX package's ranges and layouts (the ball
    within the circle's square, the agents on its sides along x at 0.2,
    swapped per env; the ball and agents below the wall of boxes, the goal
    above it, the boxes on their slots in a per-env order), each draw
    spread, the shapings consistent."""
    env = torch_make_env(name, 256, device="cpu", seed=3)
    st, sc = env.state, env.scenario
    agents = [a.index for a in env.world.agents]
    assert not st.vel.any()
    if name == "ball_trajectory":
        ball = st.pos[:, sc.ball.index]
        assert bool((ball.abs() <= 0.5).all()) and float(ball.std()) > 0.2
        rel = st.pos[:, agents] - ball[:, None]
        torch.testing.assert_close(rel[..., 0].abs(), torch.full_like(rel[..., 0], 0.2), atol=1e-6, rtol=0)
        assert not rel[..., 1].any() and set(torch.sign(rel[:, 0, 0]).tolist()) == {-1.0, 1.0}
        torch.testing.assert_close(st.scenario["speed_shaping"], torch.ones(256), atol=0, rtol=0)
    if name == "ball_passage":
        ball, goal = st.pos[:, sc.ball.index], st.pos[:, sc.goal.index]
        assert bool((ball[:, 1] < 0).all()) and bool((goal[:, 1] > 0).all())
        assert bool((st.pos[:, agents].abs() <= 1).all())
        slots = torch.stack([st.pos[:, p.index, 0] for p in sc.passages], -1)
        k = (slots + 1 + sc.agent_radius - sc.passage_length / 2) / sc.passage_length
        assert torch.equal(k.round().sort(-1).values, torch.arange(len(sc.passages)).float().expand(256, -1))
        assert k.round().unique(dim=0).shape[0] > 200  # a permutation per env
        torch.testing.assert_close(st.scenario["pos_shaping_post"], torch.linalg.vector_norm(ball - goal, dim=-1),
                                   atol=1e-6, rtol=0)
