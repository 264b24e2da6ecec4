"""The port's give_way and multi_give_way (vmas_tpu_torch/scenarios, their
velocity controllers and their rows in the fused step, with the PID inside
the rows step) against the JAX package's, from injected states.

give_way: two agents (spheres of radius 0.16) in a corridor of lines, 5
substeps, a PID velocity controller each; multi_give_way: four such agents
in a cross of corridors. The same state, made from a seed with numpy, in
which the agents touch each other and the walls and the controllers'
memory is set (``give_way_contact_state``, ``multi_give_way_contact_state``),
with actions that drive every branch of the PID (``pid_actions``), goes
through the JAX function and its counterpart in the port:

* the env step (the JAX package's XLA physics and hooks) against the port's
  env step on the plain physics and on the fused step's twin;
* the twins of the fused step (K1) and of the rows step (K2, with the PID
  hook) against the Pallas kernel in interpret mode, on the scenario's
  world with its substeps cut from 5 to 1 in both packages (one substep
  runs every line of the kernel that five do, and the JAX kernels then
  compile in some 3-6 s instead of 6-9 s each).

Then the port alone: the emit against the scenario's hooks, ``rows_rollout_fn``
against ``rollout_fn`` (give_way, multi_give_way and joint_passage with its
controller; the final state's u and controller memory included), several
env steps per rows launch against one, eligibility, reset invariants, the
noisy and delayed configs, a JAX state carried in and out, and the recorded
reference trajectories.

Tolerances: state and controller rows atol 1e-5 rtol 1e-5 (f32 reorder
noise); observation rows atol 2e-5; reward and shaping rows atol 2e-3;
flags equal; the golden replays at tests/test_scenario_parity.py's atol for
these scenarios, 2e-3 (velocities, observations and rewards 10x).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import fused as JF
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported
from vmas_tpu_torch.testing import give_way_contact_state, multi_give_way_contact_state, pid_actions, pid_counts

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
NAMES = ("give_way", "multi_give_way")
CONTACT_STATES = {"give_way": give_way_contact_state, "multi_give_way": multi_give_way_contact_state}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")


def _jnp_tree(d):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **_jnp_tree(arrays["scenario"])},
    )


def act_rows(acts):
    """Per-agent [B, 2] actions as the rows step's [2A, B] rows."""
    return np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])


@pytest.fixture(scope="module")
def cases():
    """Per scenario: (the port's env, the contact state, the PID actions)."""
    out = {}
    for k, name in enumerate(NAMES):
        env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True)
        out[name] = (env, CONTACT_STATES[name](env, np.random.default_rng(10 + k)),
                     pid_actions(env, np.random.default_rng(20 + k)))
    return out


@pytest.fixture(scope="module")
def jax_steps(cases):
    """Per scenario, the JAX package's env (XLA physics, controller on)
    stepped once from the contact state: (env, outputs)."""
    out = {}
    for name in NAMES:
        _, arrays, acts = cases[name]
        jenv = vmas_tpu.make_env(name, B, seed=0)
        jenv.state = jax_state(jenv, arrays)
        out[name] = (jenv, jenv.step([jnp.asarray(a) for a in acts]))
    return out


def _one_substep(*worlds):
    for w in worlds:
        w.substeps, w.sub_dt = 1, w.dt


@pytest.mark.parametrize("name", NAMES)
def test_pair_buckets_and_supports(name, jax_steps):
    """The same contact pairs in the same order, and the same verdict of the
    fused step's cost rule, as the JAX package."""
    jw = jax_steps[name][0].world
    tw = torch_make_env(name, 2, device="cpu", fused_physics=True).world
    for field in ("ss_a", "ss_b", "ls_line", "ls_sphere", "ll_a", "bs_box", "bl_box", "bb_a", "movable"):
        np.testing.assert_array_equal(np.asarray(getattr(tw.spec, field)), np.asarray(getattr(jw.spec, field)),
                                      err_msg=field)
    ks = TF._kernel_spec(tw)
    assert (len(ks.ss), len(ks.ls)) == {"give_way": (1, 16), "multi_give_way": (6, 48)}[name]
    assert TF.supports(tw) == JF.supports(jw) is True


@pytest.mark.parametrize("name", NAMES)
def test_contact_state_exercises_pid(name, cases):
    """The state touches both contact types, and the actions drive the
    clamp, the min_input_norm zeroing, the reset and the cutoff."""
    env, arrays, acts = cases[name]
    fo = env._fused_outputs
    x = TF.pack_carry(env.world, state_from_numpy(env.world, arrays), fo)
    counts = TF.contact_counts(env.world, x)
    assert counts["ss"] > 0 and counts["ls"] > 0, counts
    pc = pid_counts(env.world, fo, x, torch.as_tensor(act_rows(acts)))
    assert all(v > 0 for v in pc.values()), pc


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_env_step_matches_jax(name, fused, cases, jax_steps):
    """One env step with the velocity controller: the clamp, the PID memory
    (reset where |u| < 1e-3), the forces it asks for, the physics (the
    plain path, or the fused step's twin with the controller before it),
    the rewards, observations and infos."""
    _, arrays, acts = cases[name]
    jenv, (j_obs, j_rews, j_dones, j_infos) = jax_steps[name]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, infos = env.step([torch.as_tensor(a) for a in acts])
    js, ts = jenv.state, env.state
    for field in FIELDS:
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), **STATE_TOL,
                                   err_msg=field)
    for i, a in enumerate(env.agents):
        np.testing.assert_allclose(ts.u[i].numpy(), np.asarray(js.u[i]), **STATE_TOL, err_msg="u")
        for k in ("accum_errs", "prev_err"):
            np.testing.assert_allclose(ts.scenario[f"__vel_ctrl_{a.name}"][k].numpy(),
                                       np.asarray(js.scenario[f"__vel_ctrl_{a.name}"][k]), **STATE_TOL, err_msg=k)
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    assert set(infos[0]) == set(j_infos[0])
    for k in infos[0]:
        np.testing.assert_allclose(infos[0][k].numpy(), np.asarray(j_infos[0][k]), atol=2e-3, err_msg=k)


def _compare_emit(fo, t_extra, j_extra, what):
    """Emit rows of the port against the JAX package's: observations, then
    the flag rows (goal_reached / the reached latch) equal, then reward and
    shaping rows."""
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base, A = fo.base, fo.n_agents
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    flags = [fo.n_out - 1]
    np.testing.assert_array_equal(t_extra[flags], j_extra[flags], err_msg=f"{what}: flags")
    np.testing.assert_allclose(t_extra[base:fo.n_out - 1], j_extra[base:fo.n_out - 1], atol=2e-3,
                               err_msg=f"{what}: reward and shaping rows ({A} agents)")


@pytest.mark.parametrize("name", NAMES)
def test_fused_step_twin_matches_pallas(name, cases):
    """The twin of K1 against the JAX package's fused_physics_step (the
    Pallas kernel in interpret mode), at one substep: the state after the
    env's process_action, whose force rows hold the controllers' output."""
    env, arrays, acts = cases[name]
    jenv = vmas_tpu.make_env(name, B, seed=0, fused_physics=True)
    _one_substep(jenv.world, env.world)
    env.world._kernel_spec = None
    try:
        ts = state_from_numpy(env.world, arrays)
        for i, a in enumerate(env.agents):
            ts = env.scenario.env_process_action(a, env.agents[i].set_u(ts, torch.as_tensor(acts[i])))
        tfo, jfo = env._fused_outputs, jenv._fused_outputs
        js = jax_state(jenv, state_to_numpy(ts))
        j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(js)
        x = torch.cat([TF.state_rows(ts), ts.joint_fixed_rot.T,
                       torch.as_tensor(tfo.scratch_rows(ts), dtype=torch.float32)]).contiguous()
        y = TF.fused_step_plain(env.world, x, tfo)
        E = len(env.world.entities)
        np.testing.assert_allclose(y[:E].numpy(), np.asarray(j_state.pos[..., 0]).T, **STATE_TOL)
        np.testing.assert_allclose(y[2 * E:3 * E].numpy(), np.asarray(j_state.vel[..., 0]).T, **STATE_TOL)
        np.testing.assert_allclose(y[6 * E:8 * E].numpy(), np.concatenate(
            [np.asarray(j_state.force[..., 0]).T, np.asarray(j_state.force[..., 1]).T]), **STATE_TOL)
        _compare_emit(tfo, y[9 * E:], j_extra, "fused step")
    finally:
        env.world.substeps, env.world.sub_dt = 5, env.world.dt / 5
        env.world._kernel_spec = None


@pytest.mark.parametrize("name", NAMES)
def test_rows_step_twin_matches_pallas(name, cases):
    """The twin of K2 with the PID hook against the JAX package's rows
    kernel (interpret mode), at one substep: state, scratch and controller
    rows, the emit rows and the controller's output rows."""
    env, arrays, acts = cases[name]
    jenv = vmas_tpu.make_env(name, B, seed=0, fused_physics=True)
    _one_substep(jenv.world, env.world)
    env.world._kernel_spec = None
    try:
        js, ts = jax_state(jenv, arrays), state_from_numpy(env.world, arrays)
        jfo, tfo = jenv._fused_outputs, env._fused_outputs
        slots = [a.index for a in env.agents]
        act = act_rows(acts)
        bp = 128
        jact = np.zeros((act.shape[0], bp), np.float32)
        jact[:, :B] = act
        jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
        jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
        carry = TF.pack_carry(env.world, ts, tfo)
        tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
        E, A = len(env.world.entities), len(slots)
        R = TF.rows_layout(env.world, tfo)
        assert tc.shape == jc.shape == (R, B) and te.shape == je.shape == (tfo.n_out + 2 * A, B)
        assert tfo.n_ctrl == 4 * A and R == 9 * E + tfo.n_scratch_in + 4 * A
        np.testing.assert_allclose(tc[:9 * E].numpy(), jc[:9 * E], **STATE_TOL, err_msg="state rows")
        np.testing.assert_allclose(tc[R - 4 * A:].numpy(), jc[R - 4 * A:], **STATE_TOL, err_msg="controller rows")
        np.testing.assert_allclose(te[tfo.n_out:].numpy(), je[tfo.n_out:], **STATE_TOL, err_msg="controller output")
        _compare_emit(tfo, te[:tfo.n_out], je[:tfo.n_out], "rows step")
        # the scratch rows are the emit rows carry_extra_idx names; the
        # controller rows moved
        assert torch.equal(tc[9 * E:R - 4 * A], te[list(tfo.carry_extra_idx)])
        assert not torch.equal(tc[R - 4 * A:], carry[R - 4 * A:])
    finally:
        env.world.substeps, env.world.sub_dt = 5, env.world.dt / 5
        env.world._kernel_spec = None


@pytest.mark.parametrize("name", NAMES)
def test_emit_matches_scenario_hooks(name, cases):
    """The fused step's emit rows, unpacked, against pre_rewards, reward,
    observation, done and info on the plain path's post-step state."""
    _, arrays, acts = cases[name]
    envs = [torch_make_env(name, B, device="cpu", seed=0, fused_physics=f) for f in (True, False)]
    outs = []
    for env in envs:
        env.state = state_from_numpy(env.world, arrays)
        outs.append(env.step([torch.as_tensor(a) for a in acts]))
    (of, rf, df, inf_f), (op, rp, dp, inf_p) = outs
    for field in FIELDS:
        torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), **STATE_TOL)
    for i in range(len(envs[0].agents)):
        torch.testing.assert_close(of[i], op[i], atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(rf[i], rp[i], atol=2e-3, rtol=0)
    assert torch.equal(df, dp)
    for k in inf_p[0]:
        torch.testing.assert_close(inf_f[0][k], inf_p[0][k], atol=2e-3, rtol=0)
    for k, v in envs[1].state.scenario.items():
        if not k.startswith("__"):
            torch.testing.assert_close(envs[0].state.scenario[k], v, atol=2e-3, rtol=0)


CONFIGS = {
    "give_way": ("give_way", {}),
    "multi_give_way": ("multi_give_way", {}),
    "joint_passage+pid": ("joint_passage", {"use_controller": True}),
}


def _assert_same_rollout(a, b):
    """Two rollout results (state, steps, traj) bitwise equal: trajectory,
    physical state, u and every scratch value, the controllers' memory
    included."""
    (sa, ta_steps, ta), (sb, tb_steps, tb) = a, b
    assert torch.equal(ta_steps, tb_steps)
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in FIELDS + ("joint_fixed_rot",):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    assert sa.scenario.keys() == sb.scenario.keys()
    for k, v in sa.scenario.items():
        w = sb.scenario[k]
        if isinstance(v, dict):
            assert all(torch.equal(v[m], w[m]) for m in v), k
        else:
            assert torch.equal(v, w), k


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollout (the PID in the rows step) against rollout_fn
    (process_action, then the fused step) from a reset, with the final
    state's u the controllers' output and their memory carried out."""
    name, kw = CONFIGS[config]
    env = torch_make_env(name, B, device="cpu", seed=1, fused_physics=True, **kw)
    assert rows_rollout_supported(env) and env._fused_outputs.n_ctrl == 4 * env.n_agents
    s0, st0 = env.state, env.steps
    a = rollout_fn(env, horizon=4)(s0, st0, torch.Generator().manual_seed(4))
    b = rows_rollout_fn(env, horizon=4)(s0, st0, torch.Generator().manual_seed(4))
    assert b[2]["rewards"].shape == (4, B, env.n_agents)
    _assert_same_rollout(a, b)
    agent = env.agents[0]
    assert not torch.equal(b[0].u[0], agent.u(s0)) and b[0].scenario[f"__vel_ctrl_{agent.name}"]["prev_err"].any()


@pytest.mark.parametrize("k_steps", [2, 3])
@pytest.mark.parametrize("name", ["transport", "give_way"])
def test_rows_rollout_k_steps(name, k_steps):
    """k_steps env steps per rows launch replay one step per launch
    bitwise: trajectory, final state, scratch and controller memory."""
    env = torch_make_env(name, B, device="cpu", seed=2, fused_physics=True)
    s0, st0 = env.state, env.steps
    a = rows_rollout_fn(env, horizon=6)(s0, st0, torch.Generator().manual_seed(5))
    b = rows_rollout_fn(env, horizon=6, k_steps=k_steps)(s0, st0, torch.Generator().manual_seed(5))
    _assert_same_rollout(a, b)
    with pytest.raises(AssertionError, match="must divide"):
        rows_rollout_fn(env, horizon=5, k_steps=k_steps)


@pytest.mark.parametrize("name,kwargs,eligible", [
    ("give_way", {}, True),
    ("give_way", {"use_velocity_controller": False}, True),
    ("give_way", {"dt_delay": 2}, False),
    # (the case keeps its name from when the noisy config was not eligible)
    pytest.param("give_way", {"obs_noise": 0.1}, True, id="give_way-kwargs3-False"),
    ("give_way", {"agent_collision_penalty": -1}, False),
    ("multi_give_way", {}, True),
    ("multi_give_way", {"box_agents": True}, False),
])
def test_rows_rollout_supported(name, kwargs, eligible):
    """The default configs run the PID in the rows step; with the
    controller off process_action is a declared no-op; the observation
    noise rides the rows path (each step's noise streams reach unpack), and
    ``rollout()`` takes it with rollout_fn's trajectory; the action delay's
    queue stays on env.step, and a penalty (or box agents) has no fused
    outputs."""
    env = torch_make_env(name, 2, device="cpu", fused_physics=True, **kwargs)
    assert rows_rollout_supported(env) is eligible
    if "obs_noise" in kwargs:
        paths, traj, want = testing.rollout_path_and_reference(env, 3, 2)
        assert paths == ["rows_rollout_fn"] and testing.same_trajectory(traj, want)
    fo = env._fused_outputs
    assert (fo is None) == ("agent_collision_penalty" in kwargs or "box_agents" in kwargs)
    if fo is not None:
        # the controller runs in the rows step unless it is off or delayed
        in_kernel = not ({"use_velocity_controller", "dt_delay"} & set(kwargs))
        assert fo.n_ctrl == (4 * env.n_agents if in_kernel else 0)


@pytest.mark.parametrize("name", NAMES)
def test_reset_invariants(name):
    """The port's own reset: the agents at their starts (give_way's within
    its spawn noise of 0.02), the goals in place, the walls where the map
    puts them, zero controller memory and shapings of the start-goal
    distances."""
    env = torch_make_env(name, 64, device="cpu", seed=7)
    sc, st = env.scenario, env.state
    start = sc.scenario_length / 2 - sc.agent_dist_from_wall
    goal = sc.scenario_length / 2 - sc.goal_dist_from_wall
    if name == "give_way":
        starts = [(-start, 0.0), (start, 0.0)]
        goals = [(goal, 0.0), (-goal, 0.0)]
        noise = sc.spawn_pos_noise
    else:
        starts = [(-start, 0.0), (0.0, start), (start, 0.0), (0.0, -start)]
        goals = [(0.0, -goal), (-goal, 0.0), (0.0, goal), (goal, 0.0)]
        noise = 0.0
    for a, s, g in zip(sc.world.agents, starts, goals):
        off = a.pos(st) - torch.tensor(s)
        assert bool((off.abs() <= noise + 1e-6).all()), a.name
        torch.testing.assert_close(a.goal.pos(st), torch.tensor(g).expand(64, 2), atol=1e-6, rtol=0)
        for k in ("accum_errs", "prev_err"):
            assert not st.scenario[f"__vel_ctrl_{a.name}"][k].any()
    if name == "give_way":
        assert bool((sc.world.agents[0].pos(st)[:, 0] != -start).any())  # the noise is there
        torch.testing.assert_close(sc.floor.pos(st), torch.tensor([0.0, -0.2]).expand(64, 2))
    d = torch.stack([torch.linalg.norm(a.pos(st) - a.goal.pos(st), dim=-1) for a in sc.world.agents], -1)
    torch.testing.assert_close(st.scenario["shaping"], d, atol=1e-6, rtol=0)


def test_noisy_fused_step_matches_plain(cases):
    """With observation noise, give_way's unpack draws it from the streams
    observation draws it from."""
    _, arrays, acts = cases["give_way"]
    envs = [torch_make_env("give_way", B, device="cpu", seed=3, fused_physics=f, obs_noise=0.05,
                           observe_rel_pos=True) for f in (True, False)]
    outs = [env.step([torch.as_tensor(a) for a in acts]) for env in envs]
    for i in range(2):
        assert outs[0][0][i].shape == (B, 6)
        torch.testing.assert_close(outs[0][0][i], outs[1][0][i], atol=2e-5, rtol=1e-5)
    assert bool((outs[0][0][0][:, :2] != envs[0].agents[0].pos(envs[0].state)).all())


def test_dt_delay_matches_jax(cases):
    """The action delay: a JAX state with a filled [D, B, 2] queue and the
    controllers' memory goes into the port and back bitwise, and three env
    steps of both packages from it agree (the delayed action acts, the
    queue shifts)."""
    _, arrays, _ = cases["give_way"]
    jenv = vmas_tpu.make_env("give_way", B, seed=0, dt_delay=2)
    rng = np.random.default_rng(9)
    queues = {f"queue_{a.name}": jnp.asarray(rng.uniform(-0.6, 0.6, (2, B, 2)).astype(np.float32))
              for a in jenv.agents}
    jenv.state = jax_state(jenv, arrays)
    jenv.state = jenv.state.replace(scenario={**jenv.state.scenario, **queues})
    js = jenv.state
    np_state = {k: np.asarray(getattr(js, k)) for k in ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc",
                                                         "joint_fixed_rot", "rendering")}
    np_state["u"] = [np.asarray(u) for u in js.u]
    np_state["scenario"] = jax.tree_util.tree_map(np.asarray, dict(js.scenario))
    env = torch_make_env("give_way", B, device="cpu", seed=0, dt_delay=2)
    env.state = state_from_numpy(env.world, np_state)
    back = state_to_numpy(env.state)
    leaves = jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(leaves(back), leaves(np_state), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
        assert a.dtype == b.dtype or np.issubdtype(b.dtype, np.integer), pa
    assert back["scenario"]["queue_agent_0"].shape == (2, B, 2) and back["scenario"]["__vel_ctrl_agent_0"]["accum_errs"].any()

    acts = [pid_actions(env, np.random.default_rng(30 + t)) for t in range(3)]
    for t in range(3):
        jenv.step([jnp.asarray(a) for a in acts[t]])
        env.step([torch.as_tensor(a) for a in acts[t]])
        for field in FIELDS:
            np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(jenv.state, field)),
                                       **STATE_TOL, err_msg=f"{field} at step {t}")
    q = env.state.scenario["queue_agent_0"]
    assert torch.equal(q[1], torch.as_tensor(acts[2][0])) and torch.equal(q[0], torch.as_tensor(acts[1][0]))


@pytest.mark.parametrize("resync", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name, resync):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's twin: free-running, or re-synced to
    the recorded state before each step, as tests/test_scenario_parity.py
    checks the JAX package."""
    d = np.load(GOLDEN.format(name))
    nb, atol = d["init_pos"].shape[0], 2e-3
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]

    def inject(pos, vel, rot, ang_vel):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque))

    # one discarded reward cycle recomputes the shaping baselines
    env.state = env.scenario.pre_rewards(inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"]))
    close = lambda a, ref, tol, msg: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(ref, np.float64), atol=tol, rtol=0, err_msg=msg)
    for t in range(d["actions"].shape[0]):
        if resync and t > 0:
            env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1])
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)])
        close(env.state.pos, d["pos"][t], atol, f"pos at step {t}")
        close(env.state.vel, d["vel"][t], 10 * atol, f"vel at step {t}")
        for i in range(env.n_agents):
            close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}] at step {t}")
            close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}] at step {t}")
        np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done at step {t}")
