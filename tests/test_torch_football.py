"""The port's football (its emit in the fused step, the ball's script, the
team AI and the hooks) against the JAX package's, from injected states.

The same state, made from a seed with numpy (``testing.football_state``:
goals scored by each team, the ball at rest far from every agent, near the
walls with a low vertical speed and in the goal mouth; agents against a
wall and touching), goes through the JAX function and its counterpart in
the port:

* the plain version of the fused step (K1, both fused configurations of
  the JAX package's tests/test_fused.py) against the JAX package's Pallas
  kernel in interpret mode, with the events counted
  (``testing.football_events``);
* one env step on the hook pipeline (and on the fused step where the
  config fuses) against the JAX package's unfused step: the red AI with
  its objectives forced, both teams policies, dict observations, shooting
  with both teams policies, five physically different blue agents;
* the AI with its candidate offsets fed in: the JAX package's own draw,
  read from its scratch after its step (``ai_Red["cbp_samples"]``), given
  to the port's AI in place of its draw;
* the recorded reference trajectories (``scenario_football.npz``, both
  teams policies, and ``scenario_football_ai.npz``, the red AI with the
  reference's objectives injected each step), free-running and re-synced,
  with tests/test_scenario_parity.py's atol table and scratch refresh.

Then the resets, the kernel's parameters and the interop of the AI's
nested scratch. The rows step (K2 with the ball's script) and the rows
paths: tests/test_torch_football_rollouts.py.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise);
observation rows atol 2e-5 rtol 1e-5; reward and shaping rows atol 2e-3;
flags and dones equal; the AI's scratch and the red agents' u atol 1e-5 rtol 1e-5 (its
Hermite sums run in another order than XLA's einsum; its choices, argmin
and argmax, equal).
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import fused as JF
from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
from vmas_tpu_torch.testing import football_events, football_state

torch.set_num_threads(1)

B = 16
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the JAX package's tests/test_fused.py configurations of football
FUSED = {"ai_red": {}, "two_teams": {"ai_red_agents": False}}
# the hook pipeline's configurations: (kwargs, whether the config fuses);
# where the red AI plays, its objectives are forced (its candidates are
# random draws, fed in by test_ai_with_fed_draws_matches_jax instead)
HOOKS = {
    "ai_red,forced": ({"ai_forced_objectives": True}, True),
    "two_teams": ({"ai_red_agents": False}, True),
    "dict_obs": ({"dict_obs": True, "ai_forced_objectives": True}, False),
    "shooting,two_teams": ({"enable_shooting": True, "ai_red_agents": False}, False),
    "physically_different": ({"physically_different": True, "n_blue_agents": 5, "ai_forced_objectives": True},
                             True),
}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    scr = dict(jenv.state.scenario)
    for k, v in arrays["scenario"].items():
        scr[k] = jax.tree_util.tree_map(jnp.asarray, v)
    return jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]), scenario=scr)


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def fused_cases():
    """Per fused config: (the port's fused env, the JAX package's env, the
    state, the policy agents' actions)."""
    out = {}
    for k, (config, kw) in enumerate(sorted(FUSED.items())):
        env = torch_make_env("football", B, device="cpu", seed=0, fused_physics=True, **kw)
        rng = np.random.default_rng(70 + k)
        acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
        out[config] = (env, vmas_tpu.make_env("football", B, seed=0, **kw), football_state(env, rng), acts)
    return out


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    np.testing.assert_allclose(t_extra[:fo.base], j_extra[:fo.base], atol=2e-5, rtol=1e-5,
                               err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[fo.base:], j_extra[fo.base:], atol=2e-3, rtol=0,
                               err_msg=f"{what}: other rows")
    np.testing.assert_array_equal(t_extra[fo.base + 3], j_extra[fo.base + 3], err_msg=f"{what}: done")


@pytest.mark.parametrize("config", sorted(FUSED))
def test_pair_buckets_and_lanes(config, fused_cases):
    """The JAX package's 19 entities, 21 sphere-sphere and 70 line-sphere
    pairs, 2 substeps; both fuse at 8 lanes per env; the rows step takes
    the two-team config (the ball's script in the kernel) and not the
    red AI's (its scripted agents run outside the kernel), as the JAX
    package's does."""
    env, jenv = fused_cases[config][:2]
    jw = jenv.world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    for key in ("ss_a", "ss_b", "ls_line", "ls_sphere", "movable", "is_agent"):
        np.testing.assert_array_equal(np.asarray(getattr(env.world.spec, key)), np.asarray(getattr(jw.spec, key)))
    assert (len(env.world.spec.ss_a), len(env.world.spec.ls_line), env.world.substeps) == (21, 70, 2)
    assert TF.supports(env.world) == JF.supports(jw) is True
    assert TF._kernel_spec(env.world).lanes == 8
    jfo = jenv.scenario.make_fused_outputs(jw)
    assert TF.rows_step_supported(env.world, env._fused_outputs, env.agents) == JF.rows_step_supported(
        jw, jfo, jenv.agents) == (config == "two_teams")


@pytest.mark.parametrize("config", sorted(FUSED))
def test_fused_step_twin_matches_pallas(config, fused_cases):
    """The plain version of K1 with football's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode):
    blue and red goals, live agent shaping and line-sphere contacts
    seen."""
    env, jenv, arrays, _ = fused_cases[config]
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
    assert (tfo.n_out, tfo.n_scratch_in, tfo.carry_extra_idx) == (jfo.n_out, jfo.n_scratch_in,
                                                                   jfo.carry_extra_idx)
    assert tfo.n_out == {"ai_red": 177, "two_teams": 350}[config]
    j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(jax_state(jenv, arrays))
    st = state_from_numpy(env.world, arrays)
    t_state, t_extra = TF.fused_physics_step(env.world, st, tfo)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    _compare_emit(tfo, t_extra, j_extra, "fused step")
    x = torch.cat([TF.state_rows(st), st.joint_fixed_rot.T, tfo.scratch_rows(st)])
    events = football_events(env, x, t_extra)
    assert all(v > 0 for v in events.values()), events


@pytest.fixture(scope="module")
def hook_cases():
    """Per hook config: (kwargs, fuses, the injected state, the actions, the
    JAX package's env.step from it: state, obs, rews, dones)."""
    out = {}
    for k, (config, (kw, fuses)) in enumerate(sorted(HOOKS.items())):
        env = torch_make_env("football", B, device="cpu", seed=0, **kw)
        rng = np.random.default_rng(90 + k)
        arrays = football_state(env, rng)
        if "ai_Red" in arrays["scenario"]:
            ai = arrays["scenario"]["ai_Red"]
            ai["forced_best_pos"] = rng.uniform(-1.0, 1.0, ai["forced_best_pos"].shape).astype(np.float32)
            ai["target_pos_rel"] = rng.uniform(-0.5, 0.5, ai["target_pos_rel"].shape).astype(np.float32)
        acts = [rng.uniform(-1.0, 1.0, (B, env.get_agent_action_size(a))).astype(np.float32) for a in env.agents]
        jenv = vmas_tpu.make_env("football", B, seed=0, **kw)
        jenv.state = jax_state(jenv, arrays)
        obs, rews, dones, _ = jenv.step([jnp.asarray(a) for a in acts])
        out[config] = (kw, fuses, arrays, acts, (jenv.state, obs, rews, dones))
    return out


def _close_tree(got, want, msg, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close_tree(got[k], want[k], f"{msg}[{k}]", **tol)
        return
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(HOOKS))
def test_env_step_matches_jax(config, fused, hook_cases):
    """One env step from the injected state, on the hook pipeline and, where
    the config fuses, on the fused step, against the JAX package's hook
    pipeline: state, observations (dicts with ``dict_obs``), rewards, dones
    and the scratch, the red AI's too."""
    kw, fuses, arrays, acts, (j_state, j_obs, j_rews, j_dones) = hook_cases[config]
    if fused and not fuses:
        env = torch_make_env("football", B, device="cpu", seed=0, fused_physics=True, **kw)
        assert env._fused_outputs is None
        return
    env = torch_make_env("football", B, device="cpu", seed=0, fused_physics=fused, **kw)
    assert (env._fused_outputs is not None) == fused
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    for field in FIELDS:
        np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    for u, ju in zip(env.state.u, j_state.u):
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **STATE_TOL, err_msg="u")
    for i in range(env.n_agents):
        _close_tree(obs[i], j_obs[i], f"obs[{i}]", atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]).reshape(B), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    want = {k: v for k, v in j_state.scenario.items() if k != "__obs_key"}
    _close_tree(env.state.scenario, want, "scratch", atol=2e-3, rtol=0)
    if "ai_Red" in want:
        _close_tree(env.state.scenario["ai_Red"], want["ai_Red"], "ai_Red", **STATE_TOL)


def test_ai_with_fed_draws_matches_jax():
    """The red AI at strength 1 with its candidates: the JAX package's
    env.step draws its offsets (``_ai_key(state, 500)``) and keeps them in
    its scratch; the port's AI is given that draw in place of its own
    (``AgentPolicy.sample_offsets``), and its scratch and the red agents' u
    match, over two steps re-synced to the JAX package's state."""
    env = torch_make_env("football", B, device="cpu", seed=0)
    jenv = vmas_tpu.make_env("football", B, seed=0)
    rng = np.random.default_rng(11)
    arrays = football_state(env, rng)
    jenv.state = jax_state(jenv, arrays)
    ctrl = env.scenario.red_controller
    red = [a.index for a in env.scenario.red_agents]
    possessions = 0
    for t in range(2):
        env.state = state_from_numpy(env.world, state_to_numpy_jax(jenv.state))
        acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
        jenv.step([jnp.asarray(a) for a in acts])
        j_ai = _np_tree(jenv.state.scenario["ai_Red"])
        ctrl.sample_offsets = lambda B_, device, s=torch.tensor(j_ai["cbp_samples"]): s
        env.step([torch.as_tensor(a) for a in acts])
        _close_tree(env.state.scenario["ai_Red"], j_ai, f"ai_Red, step {t}", **STATE_TOL)
        for e, a in zip(red, env.scenario.red_agents):
            np.testing.assert_allclose(a.u(env.state).numpy(), np.asarray(jenv.state.u[a.slot]), **STATE_TOL)
        np.testing.assert_allclose(env.state.pos.numpy(), np.asarray(jenv.state.pos), **STATE_TOL)
        possessions += int(j_ai["agent_possession"].any(-1).sum())
    assert possessions == 2 * B


def state_to_numpy_jax(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc",
                                                       "joint_fixed_rot", "rendering")}
    arrays["u"] = [np.asarray(u) for u in js.u]
    arrays["scenario"] = _np_tree(dict(js.scenario))
    return arrays


def test_interop_carries_jax_states():
    """A JAX package's football state with the red AI's nested scratch, as
    numpy arrays, into the port bitwise; the JAX package's step key
    (``__obs_key``) is left behind, and the port steps on from it."""
    jenv = vmas_tpu.make_env("football", B, seed=0)
    jenv.step([jnp.zeros((B, 2)) for _ in jenv.agents])
    arrays = state_to_numpy_jax(jenv.state)
    assert "__obs_key" in arrays["scenario"] and isinstance(arrays["scenario"]["ai_Red"], dict)
    env = torch_make_env("football", B, device="cpu", seed=0, fused_physics=True)
    st = state_from_numpy(env.world, arrays)
    back = state_to_numpy(st)
    assert set(back["scenario"]) == set(arrays["scenario"]) - {"__obs_key"}
    for k, v in back["scenario"]["ai_Red"].items():
        assert np.array_equal(v, arrays["scenario"]["ai_Red"][k]), k
    assert np.array_equal(back["pos"], arrays["pos"])
    env.state = st
    obs = env.step(env.get_random_actions())[0]
    assert all(bool(torch.isfinite(o).all()) for o in obs)


@pytest.mark.parametrize("case", ["football", "football_ai"])
def test_golden_replay(case):
    """The recorded reference trajectory (16 envs) through the port's
    env.step on the fused step's plain version, free-running and then
    re-synced to the recorded state before each step, after
    tests/test_scenario_parity.py's one-cycle scratch refresh; in
    ``football_ai`` the reference AI's recorded objectives are written to
    the red AI's ``forced_best_pos`` before each step (the JAX package's
    harness), which exercises the rest of the AI."""
    d = np.load(GOLDEN.format(case))
    nb = d["init_pos"].shape[0]
    kw = {"football": {"ai_red_agents": False}, "football_ai": {"ai_forced_objectives": True}}[case]
    env = torch_make_env("football", nb, device="cpu", seed=0, fused_physics=True, **kw)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert env._fused_outputs is not None and len(env.agents) == len(d["agent_names"])

    def inject(pos, vel, rot, ang_vel, scratch):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque), scenario=scratch)

    def close(a, ref, tol, msg):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        assert err.max(initial=0) <= tol, f"{msg}: max error {err.max():.2e} beyond {tol}"

    scratch0 = dict(env.state.scenario)
    atol = 2e-3
    for resync in (False, True):
        state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], dict(scratch0))
        env.state = env.scenario.post_rewards(env.scenario.pre_rewards(state))
        for t in range(d["actions"].shape[0]):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state.scenario)
            if case == "football_ai":
                scr = dict(env.state.scenario)
                scr["ai_Red"] = {**scr["ai_Red"], "forced_best_pos": torch.as_tensor(
                    d["extra_step_ai_best_pos"][t]).permute(1, 0, 2).contiguous()}
                env.state = env.state.replace(scenario=scr)
            acts = [torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            close(env.state.rot, d["rot"][t], 10 * atol, f"rot, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")
                close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}], {tag}")
            np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done, {tag}")


@pytest.mark.parametrize("config", ["random", "formation", "formation,randomised", "formation,both"])
def test_reset_invariants(config):
    """The port's own reset: the blue agents in their half (or their
    formation slots, the JAX package's, plus at most half the noise; with
    ``randomise_formation_indices`` each env a permutation of them), the red
    agents in theirs facing -x, the walls, goal parts and nets at the JAX
    package's poses, the ball at the centre, the shaping baselines from the
    state, and the AI's scratch with the JAX package's keys and shapes."""
    kw = {"random": {}, "formation": {"spawn_in_formation": True},
          "formation,randomised": {"spawn_in_formation": True, "randomise_formation_indices": True},
          "formation,both": {"spawn_in_formation": True, "only_blue_formation": False}}[config]
    n = 64
    env = torch_make_env("football", n, device="cpu", seed=5, **kw)
    jenv = vmas_tpu.make_env("football", n, seed=5, **kw)
    st, sc = env.state, env.scenario
    fixed = [e.index for e in env.world.landmarks]
    np.testing.assert_allclose(st.pos[:, fixed].numpy(), np.asarray(jenv.state.pos)[:, fixed], atol=0, rtol=0)
    np.testing.assert_allclose(st.rot[:, fixed].numpy(), np.asarray(jenv.state.rot)[:, fixed], atol=0, rtol=0)
    assert not st.pos[:, sc.ball.index].any() and not st.vel.any()
    blue = st.pos[:, [a.index for a in sc.blue_agents]].numpy()
    red = st.pos[:, [a.index for a in sc.red_agents]].numpy()
    noise = sc.formation_noise / 2 + 1e-6
    if "formation" in config:
        slots = sc.formation_slots(len(sc.blue_agents), True)
        d = np.abs(blue[:, :, None] - slots[None, None]).max(-1)  # [n, A, slots]
        assert (d.min(-1) <= noise).all()
        owner = d.argmin(-1)
        assert all(sorted(o) == list(range(len(slots))) for o in owner)
        if "randomised" in config:
            assert len({tuple(o) for o in owner}) > 1
        else:
            assert (owner == np.arange(len(slots))).all()
    else:
        assert (blue[..., 0] <= 0.025 + 1e-6).all() and (blue[..., 0] >= -1.5 + 0.025 - 1e-6).all()
        assert blue[..., 0].std() > 0.2
    if config == "formation,both":
        slots = sc.formation_slots(len(sc.red_agents), False)
        assert (np.abs(red[:, :, None] - slots[None, None]).max(-1).min(-1) <= noise).all()
    else:
        assert (red[..., 0] >= -0.025 - 1e-6).all() and (red[..., 0] <= 1.5 - 0.025 + 1e-6).all()
        assert torch.equal(st.rot[:, [a.index for a in sc.red_agents]],
                           torch.full((n, len(sc.red_agents)), np.float32(np.pi)))
    jscr = jenv.state.scenario
    assert set(st.scenario) == set(jscr) - {"__obs_key"}
    for k, v in jscr["ai_Red"].items():
        assert tuple(st.scenario["ai_Red"][k].shape) == v.shape and str(st.scenario["ai_Red"][k].dtype)[6:] == str(
            v.dtype), k
    ball = st.pos[:, sc.ball.index]
    np.testing.assert_allclose(st.scenario["pos_shaping_blue"].numpy(),
                               (torch.linalg.vector_norm(ball - sc.right_goal_pos, dim=-1) * 10).numpy(), atol=1e-6)


def test_kernel_params():
    """EMIT_FOOTBALL's parameters (both teams, the policy agents with their
    team, the constants rounded once to f32, the scratch carry map) and the
    ball script's (ACT_BALL, the ball's entity, the constants), built when
    the Environment is (check_fusable); the by-value parameters within 4
    KB."""
    for kw, A in (({}, 3), ({"ai_red_agents": False}, 6)):
        env = torch_make_env("football", 4, device="cpu", seed=0, fused_physics=True, **kw)
        fo, sc = env._fused_outputs, env.scenario
        assert fo._kernel_emit is not None and fo.process_act_rows._kernel_params is not None
        kind, ep = fo.kernel_emit()
        assert kind == K.EMIT_FOOTBALL == 28
        p = ep.football
        assert (p.n_agents, p.n_blue, p.n_red, p.ball) == (A, 3, 3, sc.ball.index)
        assert [p.agent[i] for i in range(A)] == [a.index for a in env.agents]
        assert [p.blue[i] for i in range(A)] == [1, 1, 1, 0, 0, 0][:A]
        assert [p.red_i[i] for i in range(3)] == [a.index for a in sc.red_agents]
        assert p.gx == np.float32(1.51) and p.y_goal == np.float32(0.175) and p.trigger == np.float32(0.4)
        assert (p.dense_blue, p.dense_red, p.obs_adv, p.obs_team) == (1, int(A == 6), 1, 1)
        assert [ep.carry_idx[k] for k in range(fo.n_scratch_in)] == list(fo.carry_extra_idx)
        ap = fo.process_act_rows.kernel_params()
        assert ap.kind == K.ACT_BALL and ap.ball.slot == sc.ball.index and ap.n_pid == 0
        assert (ap.ball.dist_thres, ap.ball.vel_thres, ap.ball.impulse) == (np.float32(0.05), np.float32(0.3),
                                                                           np.float32(0.05))
        assert (ap.ball.pw_half, ap.ball.pl_half, ap.ball.y_goal) == (0.75, 1.5, np.float32(0.175))
        assert K.act_ctrl_rows(ap) == 0 and fo.process_act_rows.n_ctrl_out == fo.n_ctrl_out == 2
    by_value = ctypes.sizeof(K.FusedSpec) + ctypes.sizeof(K.EmitParams) + ctypes.sizeof(K.ActParams)
    assert by_value + 5 * 8 + 3 * 4 <= 4096
    members = [f[1] for f in K._EmitUnion._fields_]
    assert ctypes.sizeof(K.EmitParams) == 4 * K.MAX_K + max(ctypes.sizeof(m) for m in members)
