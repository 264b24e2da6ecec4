"""Football's rows paths: the rows step with the ball's script in it
against the JAX package's, and the rows rollouts against ``rollout_fn``.

* The plain version of K2 for both teams as policies against the JAX
  package's rows kernel in interpret mode, on ``testing.football_state``
  (impulses, x impulses zeroed in the goal mouth, goals, live agent
  shaping and line-sphere contacts counted), and the ball's impulse
  (``fused.BallScriptActRows``) against the JAX package's
  ``ball_action_script`` on balls near every wall and in the goal mouth.
* ``rows_rollout_fn`` (``k_steps`` 1 and 4) and ``rows_policy_rollout_fn``
  (a linear policy) bitwise ``rollout_fn`` on the CPU, from a state with
  the ball near the walls: the ball's script runs in the rows step, the
  red team's mirror is a decode transform, and the final state (the
  ball's u included) is ``rollout_fn``'s.
* The eligibility: the red AI's config and the hook-pipeline configs
  refuse the rows paths, as the JAX package's do; ``rollout()`` keeps
  ``rollout_fn`` for football (``rows_auto = False``); ``rows_step_supported``
  takes a kernel script only with an in-kernel ``process_act_rows``.
* ``dict_obs`` through ``rollout_fn`` (trees of observations) and its
  observation space, a Dict per agent as the JAX package's.

Tolerances: state rows atol 1e-5 rtol 1e-5; observation rows atol 2e-5
rtol 1e-5; reward and shaping rows atol 2e-3; done equal; the ball's
impulse atol 1e-7 (each op rounded once); rollouts bitwise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import fused as JF
from vmas_tpu.parallel.rollout import rows_rollout_supported as jax_rows_supported
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel import rollout_fn, rows_policy_rollout_fn, rows_rollout_fn
from vmas_tpu_torch.parallel.rollout import rows_rollout_supported
from vmas_tpu_torch.testing import football_events, football_state

torch.set_num_threads(1)

B = 16
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
TWO = {"ai_red_agents": False}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    scr = dict(jenv.state.scenario)
    for k, v in arrays["scenario"].items():
        scr[k] = jax.tree_util.tree_map(jnp.asarray, v)
    return jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]), scenario=scr)


@pytest.fixture(scope="module")
def two_teams():
    """Both teams policies: (the port's fused env, the JAX package's env,
    the state, the actions)."""
    env = torch_make_env("football", B, device="cpu", seed=0, fused_physics=True, **TWO)
    rng = np.random.default_rng(71)
    acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
    return env, vmas_tpu.make_env("football", B, seed=0, **TWO), football_state(env, rng), acts


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    np.testing.assert_allclose(t_extra[:fo.base], j_extra[:fo.base], atol=2e-5, rtol=1e-5,
                               err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[fo.base:], j_extra[fo.base:], atol=2e-3, rtol=0,
                               err_msg=f"{what}: other rows")
    np.testing.assert_array_equal(t_extra[fo.base + 3], j_extra[fo.base + 3], err_msg=f"{what}: done")


def test_rows_step_twin_matches_pallas(two_teams):
    """The plain version of K2 for both teams as policies (the action rows,
    the ball's script after them, the physics, the emit, the scratch carry)
    against the JAX package's rows kernel in interpret mode, the ball's
    impulse rows after the emit rows; impulses seen, and envs whose x
    impulse the goal mouth zeroed."""
    env, jenv, arrays, acts = two_teams
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
    slots = [a.index for a in env.agents]
    assert slots == [a.index for a in jenv.agents] and tfo.kernel_script_slots == tuple(jfo.kernel_script_slots)
    assert tfo.kernel_script_u == tuple(tuple(int(v) for v in r) for r in jfo.kernel_script_u)
    assert (tfo.n_ctrl, tfo.n_ctrl_out) == (0, 2)
    act = np.concatenate([np.stack([u[:, 0] for u in acts]), np.stack([u[:, 1] for u in acts])]).astype(np.float32)
    bp = 128
    jact = np.zeros((-(-act.shape[0] // 8) * 8, bp), np.float32)
    jact[:act.shape[0], :B] = act
    js = jax_state(jenv, arrays)
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    st = state_from_numpy(env.world, arrays)
    carry = TF.pack_carry(env.world, st, tfo)
    tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
    assert tc.shape == jc.shape and te.shape == je.shape == (tfo.n_out + 2, B)
    np.testing.assert_allclose(tc.numpy(), jc, **STATE_TOL, err_msg="carry rows")
    _compare_emit(tfo, te[:tfo.n_out], je[:tfo.n_out], "rows step")
    np.testing.assert_allclose(te[tfo.n_out:].numpy(), je[tfo.n_out:], atol=1e-7, rtol=0, err_msg="impulse rows")
    events = football_events(env, carry, te[:tfo.n_out], te[tfo.n_out:])
    assert all(v > 0 for v in events.values()), events


def test_ball_script_matches_jax(two_teams):
    """The ball's impulse (fused.BallScriptActRows, which both the ball's
    action script and the rows step compute) against the JAX package's
    ball_action_script, on a state with the ball near every wall, in the
    goal mouth, at low and high vertical speeds: each of its terms taken."""
    from vmas_tpu.scenarios.football import ball_action_script

    env = two_teams[0]
    rng = np.random.default_rng(3)
    n = 512
    sc = env.scenario
    hl, hw = sc.pitch_length / 2, sc.pitch_width / 2
    p = np.stack([rng.uniform(-hl - 0.06, hl + 0.06, n), rng.uniform(-hw, hw, n)], -1)
    edge = rng.uniform(size=n) < 0.5
    p[edge, 1] = np.where(rng.uniform(size=int(edge.sum())) < 0.5, -1, 1) * (hw - rng.uniform(0, 0.06,
                                                                                              int(edge.sum())))
    ends = rng.uniform(size=n) < 0.5
    p[ends, 0] = np.where(rng.uniform(size=int(ends.sum())) < 0.5, -1, 1) * (hl - rng.uniform(0, 0.06,
                                                                                             int(ends.sum())))
    vy = rng.uniform(-0.5, 0.5, n)
    p, vy = p.astype(np.float32), vy.astype(np.float32)
    ax, ay = sc.ball_script.impulse(torch.as_tensor(p[:, 0]), torch.as_tensor(p[:, 1]), torch.as_tensor(vy))
    jenv = vmas_tpu.make_env("football", n, seed=0, ai_red_agents=False)
    jw, ball = jenv.world, jenv.scenario.ball
    js = jenv.state
    js = ball.set_pos(js, jnp.asarray(p))
    js = ball.set_vel(js, jnp.stack([jnp.zeros(n), jnp.asarray(vy)], -1))
    want = np.asarray(ball.u(ball_action_script(ball, jw, js)))
    got = torch.stack([ax, ay], -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    mouth = np.abs(p[:, 1]) < sc.goal_size / 2
    assert (ax.numpy() != 0).any() and (ay.numpy() != 0).any() and (ax.numpy()[mouth] == 0).all()
    assert ((ay.numpy() != 0) & (np.abs(vy) >= 0.3)).sum() == 0




def _bitwise(ta, tb, sa, sb):
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    for key, val in sa.scenario.items():
        assert torch.equal(val, sb.scenario[key]), key


def _start(env):
    """The two-team state of ``testing.football_state``, the ball near the
    walls in most envs, so that its script acts from the first step."""
    return state_from_numpy(env.world, football_state(env, np.random.default_rng(72)))


@pytest.mark.parametrize("k_steps", [1, 4])
def test_rows_rollout_bitwise_rollout_fn(k_steps, two_teams):
    """rows_rollout_fn against rollout_fn (K1 each step, the ball's script
    and the red mirror in the hooks) over 8 steps: trajectories and final
    state bitwise, the ball's u from the last step's hook rows; the ball's
    script acted (a non-zero u on the ball in some env at the end)."""
    env = two_teams[0]
    s0 = _start(env)
    sa, na, ta = rollout_fn(env, horizon=8)(s0, env.steps, torch.Generator().manual_seed(5))
    sb, nb, tb = rows_rollout_fn(env, horizon=8, k_steps=k_steps)(s0, env.steps, torch.Generator().manual_seed(5))
    _bitwise(ta, tb, sa, sb)
    assert torch.equal(na, nb)
    assert bool(env.scenario.ball.u(sb).abs().sum() > 0)
    assert bool(ta["dones"].any()) and bool((ta["rewards"] != 0).all(-1).any())


def test_rows_policy_rollout_bitwise_rollout_fn(two_teams):
    """rows_policy_rollout_fn with a small linear policy against rollout_fn
    with the same policy, over 6 steps, bitwise: the policy reads the rows'
    observations, the red agents' actions are mirrored before the kernel."""
    env = two_teams[0]
    g = torch.Generator().manual_seed(3)
    W = (torch.rand((56, 2), generator=g) * 2 - 1) * 0.5

    def policy(obs, gen):
        return tuple(torch.tanh(o @ W) for o in obs)

    s0 = _start(env)
    sa, _, ta = rollout_fn(env, policy, horizon=6)(s0, env.steps, torch.Generator().manual_seed(6))
    sb, _, tb = rows_policy_rollout_fn(env, policy, horizon=6)(s0, env.steps, torch.Generator().manual_seed(6))
    _bitwise(ta, tb, sa, sb)
    red = env.scenario.red_agents[0]
    assert not torch.equal(red.u(sb)[:, 0], torch.tanh(ta["obs"][red.slot][-2] @ W)[:, 0])


CONFIGS = {
    "ai_red": {}, "two_teams": TWO, "dict_obs": {"dict_obs": True},
    "shooting": {"enable_shooting": True, "ai_red_agents": False},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_eligibility_matches_jax(config):
    """Which configs the rows paths take, as in the JAX package: both teams
    as policies only (the red AI runs in the hooks; dict observations and
    shooting run the hook pipeline)."""
    kw = CONFIGS[config]
    env = torch_make_env("football", 4, device="cpu", seed=0, fused_physics=True, **kw)
    jenv = vmas_tpu.make_env("football", 4, seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) == jax_rows_supported(jenv) == (config == "two_teams")
    if config == "ai_red":
        with pytest.raises(AssertionError, match="not eligible"):
            rows_rollout_fn(env, horizon=2)
        with pytest.raises(AssertionError, match="not eligible"):
            rows_policy_rollout_fn(env, lambda obs, g: obs, horizon=2)


def test_rollout_keeps_rollout_fn(monkeypatch):
    """football declares rows_auto = False: rollout() runs rollout_fn even
    where the rows paths are eligible (the JAX package's
    test_rollout_honors_rows_auto_optout)."""
    import sys

    from vmas_tpu_torch.parallel.rollout import rollout

    mod = sys.modules["vmas_tpu_torch.parallel.rollout"]
    env = torch_make_env("football", 8, device="cpu", seed=0, fused_physics=True, **TWO)
    assert rows_rollout_supported(env) and env._fused_outputs.rows_auto is False

    def boom(*a, **k):
        raise AssertionError("rollout() must not pick the rows paths here")

    monkeypatch.setattr(mod, "rows_rollout_fn", boom)
    monkeypatch.setattr(mod, "rows_policy_rollout_fn", boom)
    traj = rollout(env, horizon=2, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(traj["rewards"]).all())
    traj = rollout(env, lambda obs, g: tuple(o[:, :2] * 0 for o in obs), horizon=2)
    assert bool(torch.isfinite(traj["rewards"]).all())


def test_rows_step_supported_needs_the_kernel_script(two_teams):
    """A scripted agent is taken only where the outputs declare it a kernel
    script (``kernel_script_slots``) and carry the in-kernel
    ``process_act_rows`` that runs it, as in the JAX package."""
    env = two_teams[0]
    fo = env._fused_outputs
    assert TF.rows_step_supported(env.world, fo, env.agents)
    no_hook = copy.copy(fo)
    no_hook.process_act_rows = None
    assert not TF.rows_step_supported(env.world, no_hook, env.agents)
    undeclared = copy.copy(fo)
    undeclared.kernel_script_slots = ()
    assert not TF.rows_step_supported(env.world, undeclared, env.agents)


def test_dict_obs_rollout_and_spaces():
    """dict observations through rollout_fn (each agent's a dict of [T, B,
    ...] tensors) with autoreset, and the observation space, a Dict of Boxes
    per agent with the JAX package's shapes."""
    env = torch_make_env("football", 4, device="cpu", seed=0, dict_obs=True, ai_forced_objectives=True)
    jenv = vmas_tpu.make_env("football", 4, seed=0, dict_obs=True, ai_forced_objectives=True)
    st, _, traj = rollout_fn(env, horizon=3, autoreset=True)(env.state, env.steps, torch.Generator().manual_seed(1))
    o = traj["obs"][0]
    assert set(o) == {"obs", "pos", "vel", "adversaries", "teammates"}
    assert o["adversaries"].shape == (3, 4, 3, 8) and o["teammates"].shape == (3, 4, 2, 8)
    space = env.observation_space
    jspace = jenv.observation_space
    for a in range(env.n_agents):
        assert set(space[a].spaces) == set(jspace[a].spaces)
        assert all(space[a][k].shape == jspace[a][k].shape for k in jspace[a].spaces)
