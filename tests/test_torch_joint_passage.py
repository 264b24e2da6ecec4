"""The port's joint_passage (vmas_tpu_torch/scenarios/joint_passage.py, its
velocity controller and its rows in the fused step) against the JAX
package's, from injected states.

joint_passage: two agents joined by a bar (three rigid joint constraints,
force 900, 10 substeps) carry it and an asymmetric mass through a gap in a
wall of boxes. The same state, made from a seed with numpy, in which its
four contact types touch and every joint is pulled apart
(``joint_passage_contact_state``), goes through the JAX function and its
counterpart in the port:

* the env step with the velocity controller on (the JAX package's XLA
  physics and hooks, one compile per module) against the port's env step
  on the plain physics and on the fused step's twin;
* the twin of the rows step (K2) against ``make_rows_step``, the Pallas
  kernel in interpret mode, on the scenario's world with its substeps cut
  from 10 to 2 in both packages: the 10-substep kernel takes some 45 s to
  trace and compile on the CPU, the cut one some 10 s, and one substep
  exercises every line of the kernel the ten do.

Then the port alone: ``rows_rollout_fn`` against ``rollout_fn``, its
eligibility, reset invariants, the noisy config, a JAX state carried in and
out (the controller's nested memory included), and the recorded reference
trajectory.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise), but atol
1e-4 rtol 5e-5 for the fused step against the plain path, the JAX
package's or the port's (tests/test_fused.py's for joint worlds: the two
sum a body's constraint forces in different orders; measured 1.65e-5 on an
angular velocity of -0.082); observation rows
atol 2e-5; reward and shaping rows atol 2e-3; just_passed and done equal
except in an env within 1e-5 of one of their thresholds; the golden replay
free-running for 10 steps at atol 4e-3, then re-synced to the recorded
state over all 50 (tests/test_scenario_parity.py's tolerance for this
scenario).
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
from vmas_tpu_torch.testing import joint_passage_contact_state, joint_passage_flag_margin

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
# the fused step against the plain path (the JAX package's XLA path and the
# port's plain physics): tests/test_fused.py's tolerance for joint worlds.
# The kernel adds each constraint's two sides in table order; the plain
# path adds every constraint's first side, then every second side, so the
# bar's three constraint forces sum in another order.
JOINT_PLAIN_TOL = dict(atol=1e-4, rtol=5e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
FLAG_MARGIN = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_joint_passage.npz")


def _jnp_tree(d):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **_jnp_tree(arrays["scenario"])},
    )


def _actions(seed, n=2):
    """Per agent [B, 2] actions, some of them below the controller's reset
    threshold of 1e-3."""
    a = np.random.default_rng(seed).uniform(-1, 1, (n, B, 2)).astype(np.float32)
    a[0, :2] *= 1e-4
    return list(a)


def compare_outputs(fo, t_rows, t_extra, j_extra, what):
    """Emit rows of the port against the JAX package's: observations, then
    the flags (an env within FLAG_MARGIN of a threshold is excused, with
    the reward rows its flag feeds), then reward and shaping."""
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base = fo.base
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    differ = (t_extra[base + 7:] != j_extra[base + 7:]).any(0)
    near = joint_passage_flag_margin(fo, t_rows).numpy() < FLAG_MARGIN
    assert not (differ & ~near).any(), f"{what}: flags differ off their thresholds"
    np.testing.assert_allclose(t_extra[base:base + 7, ~differ], j_extra[base:base + 7, ~differ], atol=2e-3,
                               err_msg=f"{what}: reward and shaping rows")


@pytest.fixture(scope="module")
def arrays():
    env = torch_make_env("joint_passage", B, device="cpu", seed=0, fused_physics=True)
    return joint_passage_contact_state(env, np.random.default_rng(1))


@pytest.fixture(scope="module")
def jax_controller_step(arrays):
    """The JAX package's env (velocity controller on, XLA physics) stepped
    once from the contact state: (env, outputs)."""
    jenv = vmas_tpu.make_env("joint_passage", B, seed=0, use_controller=True)
    jenv.state = jax_state(jenv, arrays)
    return jenv, jenv.step([jnp.asarray(a) for a in _actions(3)])


def test_contact_state_touches_every_type(arrays):
    env = torch_make_env("joint_passage", B, device="cpu", seed=0, fused_physics=True)
    ts = state_from_numpy(env.world, arrays)
    x = TF.pack_carry(env.world, ts, env._fused_outputs)
    counts = TF.contact_counts(env.world, x)
    assert {k for k, v in counts.items() if v > 0} == {"ss", "ls", "bs", "bl"}, counts
    assert TF.joint_counts(env.world, x) == {"force": 3 * B, "torque": 0}


@pytest.mark.parametrize("fused", [False, True])
def test_env_step_with_controller_matches_jax(fused, arrays, jax_controller_step):
    """One env step with the velocity controller on: the PID memory (reset
    where |u| < 1e-3), the forces it asks for, the physics (the plain path,
    or the fused step's twin with the controller outside the kernel), the
    rewards, observations, dones and infos."""
    jenv, (j_obs, j_rews, j_dones, j_infos) = jax_controller_step
    env = torch_make_env("joint_passage", B, device="cpu", seed=0, use_controller=True, fused_physics=fused)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, infos = env.step([torch.as_tensor(a) for a in _actions(3)])
    js, ts = jenv.state, env.state
    for name in FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   **(JOINT_PLAIN_TOL if fused else STATE_TOL), err_msg=name)
    for i, a in enumerate(env.agents):
        np.testing.assert_allclose(ts.u[i].numpy(), np.asarray(js.u[i]), **STATE_TOL, err_msg="u")
        for k in ("accum_errs", "prev_err"):
            np.testing.assert_allclose(ts.scenario[f"__vel_ctrl_{a.name}"][k].numpy(),
                                       np.asarray(js.scenario[f"__vel_ctrl_{a.name}"][k]), **STATE_TOL, err_msg=k)
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
    fo = env.scenario.make_fused_outputs(env.world)
    ok = joint_passage_flag_margin(fo, TF.state_rows(ts)).numpy() >= FLAG_MARGIN
    np.testing.assert_array_equal(dones.numpy()[ok], np.asarray(j_dones)[ok])
    np.testing.assert_allclose(rews[0].numpy()[ok], np.asarray(j_rews[0])[ok], atol=2e-3)
    assert set(infos[0]) == set(j_infos[0])
    np.testing.assert_array_equal(infos[0]["passed"].numpy()[ok], np.asarray(j_infos[0]["passed"])[ok])


def test_rows_step_twin_matches_pallas(arrays):
    """The twin of K2 against the JAX package's rows kernel (interpret
    mode) on the scenario's world, both with substeps 2."""
    jenv = vmas_tpu.make_env("joint_passage", B, seed=0, fused_physics=True)
    tenv = torch_make_env("joint_passage", B, device="cpu", seed=0, fused_physics=True)
    for w in (jenv.world, tenv.world):
        w.substeps, w.sub_dt = 2, w.dt / 2
    js, ts = jax_state(jenv, arrays), state_from_numpy(tenv.world, arrays)
    jfo, tfo = jenv._fused_outputs, tenv._fused_outputs
    slots = [a.index for a in tenv.agents]
    act = np.random.default_rng(2).uniform(-0.8, 0.8, (2 * len(slots), B)).astype(np.float32)
    bp = 128
    jact = np.zeros((2 * len(slots), bp), np.float32)
    jact[:, :B] = act
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    tc, te = TF.rows_step_plain(tenv.world, tfo, slots, TF.pack_carry(tenv.world, ts, tfo), torch.as_tensor(act))
    E, J = len(tenv.world.entities), 3
    assert tc.shape == (9 * E + J + 5, B) and te.shape == (tfo.n_out, B) == (2 * 10 + 10, B)
    np.testing.assert_allclose(tc[:9 * E].numpy(), jc[:9 * E], **STATE_TOL, err_msg="state rows")
    compare_outputs(tfo, tc[:9 * E], te, je, "rows step")
    # the fixed rotations ride the carry; the scratch rows are the emitted
    # shapings and passed
    assert torch.equal(tc[9 * E:9 * E + J], TF.pack_carry(tenv.world, ts, tfo)[9 * E:9 * E + J])
    assert torch.equal(tc[9 * E + J:], te[list(tfo.carry_extra_idx)])


def test_emit_matches_scenario_hooks(arrays):
    """The twin's emit rows, unpacked, against pre_rewards, reward,
    observation, done and info on the plain path's post-step state."""
    envs = [torch_make_env("joint_passage", B, device="cpu", seed=0, fused_physics=f) for f in (True, False)]
    outs = []
    for env in envs:
        env.state = state_from_numpy(env.world, arrays)
        outs.append(env.step([torch.as_tensor(a) for a in _actions(4)]))
    (of, rf, df, inf_f), (op, rp, dp, inf_p) = outs
    for name in FIELDS:
        torch.testing.assert_close(getattr(envs[0].state, name), getattr(envs[1].state, name), **JOINT_PLAIN_TOL)
    for i in range(2):
        torch.testing.assert_close(of[i], op[i], atol=2e-5, rtol=1e-5)
    near = joint_passage_flag_margin(envs[0]._fused_outputs, TF.state_rows(envs[1].state)) < FLAG_MARGIN
    assert torch.equal(df[~near], dp[~near])
    torch.testing.assert_close(rf[0][~near], rp[0][~near], atol=2e-3, rtol=0)
    for k in inf_p[0]:
        torch.testing.assert_close(inf_f[0][k][~near].float(), inf_p[0][k][~near].float(), atol=2e-3, rtol=0)
    for k in ("pos_shaping_pre", "pos_shaping_post", "rot_shaping_pre", "rot_shaping_post", "passed"):
        torch.testing.assert_close(envs[0].state.scenario[k], envs[1].state.scenario[k], atol=2e-3, rtol=0)


def test_rows_rollout_equals_step_rollout(arrays):
    env = torch_make_env("joint_passage", B, device="cpu", seed=0, fused_physics=True)
    assert rows_rollout_supported(env)
    s0, st0 = state_from_numpy(env.world, arrays), env.steps
    sa, _, ta = rollout_fn(env, horizon=3)(s0, st0, torch.Generator().manual_seed(4))
    sb, _, tb = rows_rollout_fn(env, horizon=3)(s0, st0, torch.Generator().manual_seed(4))
    assert tb["rewards"].shape == (3, B, 2) and all(o.shape == (3, B, 10) for o in tb["obs"])
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    for name in FIELDS + ("joint_fixed_rot",):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    for k in ("rew", "pos_rew", "rot_rew", "pos_shaping_pre", "pos_shaping_post", "rot_shaping_pre",
              "rot_shaping_post", "passed", "just_passed"):
        assert torch.equal(sa.scenario[k], sb.scenario[k]), k
    # the controller is off: its memory is the reset's, untouched
    assert all(torch.equal(sa.scenario[k]["prev_err"], sb.scenario[k]["prev_err"])
               for k in sa.scenario if k.startswith("__vel_ctrl"))


@pytest.mark.parametrize("kwargs,eligible", [
    ({}, True),
    ({"use_controller": True}, True),
    # (the noisy cases keep their names from when they were not eligible)
    pytest.param({"obs_noise": 0.1}, True, id="kwargs2-False"),
    pytest.param({"observe_joint_angle": True, "joint_angle_obs_noise": 0.1}, True, id="kwargs3-False"),
    ({"collision_reward": -1}, False),
])
def test_rows_rollout_supported(kwargs, eligible):
    """The rows rollout runs the default config, the controller config
    (its PID in the rows step) and the noisy ones (each step's noise
    streams reach unpack; ``rollout()`` takes the rows path with
    rollout_fn's trajectory); a collision reward has no fused outputs and
    runs through rollout_fn."""
    env = torch_make_env("joint_passage", 2, device="cpu", fused_physics=True, **kwargs)
    assert rows_rollout_supported(env) is eligible
    if "obs_noise" in kwargs or "joint_angle_obs_noise" in kwargs:
        paths, traj, want = testing.rollout_path_and_reference(env, 3, 2)
        assert paths == ["rows_rollout_fn"] and testing.same_trajectory(traj, want)
    assert (env._fused_outputs is None) == ("collision_reward" in kwargs)


def test_noisy_fused_step_matches_plain(arrays):
    """With observation and joint-angle noise, unpack draws the noise from
    the streams observation draws it from."""
    kw = dict(obs_noise=0.05, observe_joint_angle=True, joint_angle_obs_noise=0.1)
    envs = [torch_make_env("joint_passage", B, device="cpu", seed=3, fused_physics=f, **kw) for f in (True, False)]
    outs = [env.step([torch.as_tensor(a) for a in _actions(5)]) for env in envs]
    for i in range(2):
        assert outs[0][0][i].shape == (B, 12)
        torch.testing.assert_close(outs[0][0][i], outs[1][0][i], atol=2e-5, rtol=1e-5)
    # the noise is there: the observed position is not the agent's
    assert bool((outs[0][0][0][:, :2] != envs[0].agents[0].pos(envs[0].state)).all())


def test_jax_state_round_trip(jax_controller_step):
    """A JAX state, controller memory and fixed rotations included, into
    the port and back out: bitwise the same values."""
    jenv, _ = jax_controller_step
    js = jenv.state
    env = torch_make_env("joint_passage", B, device="cpu", seed=0)
    arrays = {k: np.asarray(getattr(js, k)) for k in ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc",
                                                       "joint_fixed_rot", "rendering")}
    arrays["u"] = [np.asarray(u) for u in js.u]
    arrays["scenario"] = jax.tree_util.tree_map(np.asarray, {k: v for k, v in js.scenario.items()})
    back = state_to_numpy(state_from_numpy(env.world, arrays))
    assert isinstance(back["scenario"]["__vel_ctrl_agent_0"], dict)
    leaves = lambda d: jax.tree_util.tree_leaves_with_path(d)
    for (pa, a), (pb, b) in zip(leaves(back), leaves(arrays), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=str(pa))
        assert a.dtype == b.dtype or np.issubdtype(b.dtype, np.integer), pa
    assert np.asarray(js.scenario["__vel_ctrl_agent_0"]["prev_err"]).any()


def test_reset_invariants():
    """The port's own reset: the agents joint_length apart, the mass at
    mass_position along the bar, the bar synced between them, the
    passages in their slots with the open one hidden, start below and goal
    above the wall, zero controller memory."""
    env = torch_make_env("joint_passage", 64, device="cpu", seed=7)
    sc, st = env.scenario, env.state
    a0, a1 = (a.pos(st) for a in sc.world.agents)
    torch.testing.assert_close(torch.linalg.norm(a1 - a0, dim=-1), torch.full((64,), 0.5), atol=1e-5, rtol=0)
    mid = (a0 + a1) / 2
    torch.testing.assert_close(sc.joint.landmark.pos(st), mid, atol=1e-6, rtol=0)
    dist_mass = torch.linalg.norm(sc.mass.pos(st) - mid, dim=-1)
    torch.testing.assert_close(dist_mass, torch.full((64,), 0.75 * 0.25), atol=1e-5, rtol=0)
    xs = lambda i: -1 - sc.agent_radius + sc.passage_length / 2 + sc.passage_length * i
    for k, p in enumerate(sc.collide_passages):
        slot = k if k < 7 else k + 1
        torch.testing.assert_close(p.pos(st)[:, 0], torch.full((64,), xs(slot)), atol=1e-6, rtol=0)
    gap = sc.non_collide_passages[0]
    assert not gap.is_rendering(st).any() and all(p.is_rendering(st).all() for p in sc.collide_passages)
    torch.testing.assert_close(gap.pos(st)[:, 0], torch.full((64,), xs(7)), atol=1e-6, rtol=0)
    lo = sc.passage_width / 2 + sc.agent_radius
    assert bool((torch.maximum(a0[:, 1], a1[:, 1]) < -lo + 1e-6).all())
    goal = sc.goal.pos(st)
    assert bool((goal[:, 1] > lo).all() and (goal.abs() < 1).all())
    assert bool((sc.goal.rot(st).abs() <= np.pi / 2).all())
    for a in sc.world.agents:
        assert not st.scenario[f"__vel_ctrl_{a.name}"]["accum_errs"].any()
    assert not st.scenario["passed"].any() and bool((st.scenario["pos_shaping_pre"] > 0).all())
    assert env.steps.eq(0).all() and st.joint_fixed_rot.shape == (64, 3)


@pytest.mark.parametrize("resync", [False, True])
def test_golden_joint_passage_replay(resync):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's twin: free-running for 10 steps,
    or re-synced to the recorded state before each of the 50, as
    tests/test_scenario_parity.py checks the JAX package."""
    d = np.load(GOLDEN)
    nb, atol = d["init_pos"].shape[0], 4e-3
    T = d["actions"].shape[0] if resync else 10
    env = torch_make_env("joint_passage", nb, device="cpu", seed=0, fused_physics=True)
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
    for t in range(T):
        if resync and t > 0:
            env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1])
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(2)])
        close(env.state.pos, d["pos"][t], atol, f"pos at step {t}")
        close(env.state.vel, d["vel"][t], 10 * atol, f"vel at step {t}")
        close(env.state.rot, d["rot"][t], 10 * atol, f"rot at step {t}")
        for i in range(2):
            close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}] at step {t}")
            close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}] at step {t}")
        np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done at step {t}")
