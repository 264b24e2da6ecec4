"""The port's joint_passage_size (its emit in the fused step, its velocity
controller in the rows step) against the JAX package's, from injected
states; the helpers of the joint worlds' tests (buzz_wire and asym_joint:
tests/test_torch_wire_worlds.py; ball_trajectory and ball_passage:
tests/test_torch_ball_worlds.py).

The same state, made from a seed with numpy (``testing.joint_worlds_state``:
every joint pulled, the agents on the passages' faces or a side wall, both
past the passages with ``passed`` 0 and the bar at rest on its goal), goes
through the JAX function and its counterpart in the port:

* the plain versions of the fused step (K1) and of the rows step (K2)
  with the scenario's emit against the JAX package's Pallas kernel in
  interpret mode, in the controller config (the PID in K2, the observed
  joint angle, the 0-180 middle angle), with the contacts, joint forces,
  ``just_passed`` and ``done`` the state makes required;
* one env step, on the plain path and on the fused step (K1's plain
  version), against the JAX package's unfused step with its hooks: the
  default (its 0-360 middle angle) and the controller config with the mass
  on the bar (``asym_package``: 10 substeps, a third joint);
* the recorded reference trajectory at the defaults, free-running and
  re-synced, with tests/test_scenario_parity.py's atol table and scratch
  refresh (the map rebuilt from the recorded passages).

Then the port alone: the rows rollouts bitwise their env.step rollouts
(the ``t`` finale, the in-kernel PID, the noisy config), eligibility, the
kernel's emit parameters, and the resets.

Tolerances: state rows atol 1e-5 rtol 1e-5, observation rows atol 2e-5
rtol 1e-5, reward rows atol 2e-3; flags, counts and dones equal; the
rollouts bitwise. One named set of elements gets an allowance on top: the
velocity and angular velocity of each entity a joint holds, wherever they
appear (state fields, carried rows, the emits' per-agent velocity rows).
There the bound adds four times the JAX package's own one-ulp spread at
that element (``with_spread``: the change of its result when every
position of the state moves by one ulp), capped at CAP (5e-5 for a
velocity, 1e-3 for an angular velocity). A light bar between two
constraints of force 400-900 turns the last bits of two large opposing
torques into its spin, so the JAX package's own bar spin moves by up to
3.8e-3 (ball_trajectory) when the positions move by one ulp; the largest
error of the port there is 6.5e-4. Every other element is held to the
stated tolerances alone, and a small error planted in the joint term
fails the comparison (``test_twin_catches_a_joint_error``). This CPU
build's ``torch.sqrt`` is not correctly rounded in some 0.6% of inputs, so
norms and ``** 0.5`` are held to the JAX package within these bounds,
never bitwise.
"""

import ctypes
import math
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
from vmas_tpu_torch import testing
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel.rollout import (
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
OBS_TOL = dict(atol=2e-5, rtol=1e-5)
REW_TOL = dict(atol=2e-3, rtol=0.0)
# the allowance of the joined entities' velocities: COND times the
# reference's own one-ulp spread there, capped per field
COND = 4
CAP = {"vel": 5e-5, "ang_vel": 1e-3}
# the relative error planted in every joint force by the mutation test
PLANTED = 3e-4
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the most substeps the kernels' twins are compared at (the stiff joint
# worlds' 15 compile for 10-15 s per kernel in interpret mode; below 5 their
# bars spin up to 100 rad/s in a step)
TWIN_SUBSTEPS = 5
# the configs held to the JAX package's kernels (TWINS) and to its env.step
# (STEP): the controller config with the observed joint angle and the 0-180
# middle angle; with the mass on the bar too
PID = ("joint_passage_size", {"use_vel_controller": True, "observe_joint_angle": True, "middle_angle_180": True})
TWINS = {"joint_passage_size,pid": PID}
STEP = {**TWINS, "joint_passage_size": ("joint_passage_size", {}),
        "joint_passage_size,pid,asym": ("joint_passage_size", {**PID[1], "asym_package": True})}
NAMES = ("joint_passage_size",)
# tests/test_scenario_parity.py's atol table, free-running horizons and
# kwargs for these recordings
GOLDEN_ATOL = {"buzz_wire": 4e-3, "joint_passage_size": 4e-3, "asym_joint": 4e-3, "ball_trajectory": 4e-3}
GOLDEN_T = {"asym_joint": 10, "ball_trajectory": 10, "buzz_wire": 10}
GOLDEN_KW = {"asym_joint": {"obs_noise": 0}}


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **_jnp_tree(arrays["scenario"])},
    )


def cut(env_or_world):
    """The world with its substeps cut to TWIN_SUBSTEPS for the twins'
    comparison."""
    w = getattr(env_or_world, "world", env_or_world)
    w.substeps = min(w.substeps, TWIN_SUBSTEPS)
    w.sub_dt = w.dt / w.substeps
    return env_or_world


def actions(env, rng):
    return [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]


def make_twins(configs, seed):
    """Per fused config: the port's fused env and the JAX package's env and
    fused outputs, both with TWIN_SUBSTEPS, a state and actions."""
    out = {}
    for k, (config, (name, kw)) in enumerate(sorted(configs.items())):
        env = cut(torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw))
        jenv = cut(vmas_tpu.make_env(name, B, seed=0, **kw))
        rng = np.random.default_rng(seed + k)
        jfo = jenv.scenario.make_fused_outputs(jenv.world)
        out[config] = (env, jenv, jfo, testing.joint_worlds_state(env, rng), actions(env, rng))
    return out


def nudged(arrays, direction):
    """The state dict with every position moved by one ulp, up
    (``direction`` 1) or down (-1)."""
    return {**arrays, "pos": np.nextafter(arrays["pos"], np.float32(direction * np.inf)).astype(np.float32)}


def with_spread(run, arrays):
    """``run(arrays)`` (a pytree of arrays) and, per element, the JAX
    package's own sensitivity at this state: the largest change of the
    output when every position moves by one ulp either way (``nudged``;
    ``run`` is compiled once, so the two reruns are cheap)."""
    base = jax.tree_util.tree_map(np.asarray, run(arrays))
    moved = [jax.tree_util.tree_map(np.asarray, run(nudged(arrays, d))) for d in (1, -1)]
    def diff(b, u, d):
        if b.dtype.kind not in "fc":  # flags and counts: compared exactly
            return np.zeros(b.shape)
        return np.maximum(np.abs(u - b), np.abs(d - b))

    spread = jax.tree_util.tree_map(diff, base, *moved)
    return base, spread


def close(got, want, tol, what, spread=0.0, caps=0.0):
    """``got`` within ``tol`` (atol, rtol) of ``want``, element by element;
    where ``caps`` is positive (the joined entities' velocities), plus COND
    times the reference's own one-ulp ``spread`` there, at most ``caps``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    allowance = np.minimum(COND * np.asarray(spread, np.float64), caps)
    bound = tol["atol"] + tol["rtol"] * np.abs(want) + allowance
    bad = err > bound
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} beyond the bound, max abs err "
                           f"{err[bad].max():.3e} where the allowance is {np.broadcast_to(allowance, bad.shape)[bad].max():.3e}")


def joined(world):
    """The entities a joint holds."""
    return sorted(set(map(int, world.spec.joint_idx_a)) | set(map(int, world.spec.joint_idx_b)))


def field_caps(world, field, shape):
    """The allowance's caps on a state field [B, E, ...]: CAP[field] at the
    joined entities of a velocity field, else 0."""
    caps = np.zeros(shape)
    if field in CAP:
        caps[:, joined(world)] = CAP[field]
    return caps


def row_caps(world, n_rows):
    """The allowance's caps on carried rows [n_rows, B] (9E state rows
    first: px, py, vx, vy, rot, w, ...): the joined entities' velocity and
    angular velocity rows."""
    E = len(world.entities)
    caps = np.zeros((n_rows, 1))
    for e in joined(world):
        caps[[2 * E + e, 3 * E + e]] = CAP["vel"]
        caps[5 * E + e] = CAP["ang_vel"]
    return caps


def obs_caps(world, fo):
    """The allowance's caps on an emit's observation rows: each opens per
    agent with [pos, vel]; the velocity rows of the joined agents."""
    agents = [a.index for a in world.agents]
    per = fo.base // len(agents)
    assert per * len(agents) == fo.base
    caps = np.zeros((fo.base, 1))
    for i, a in enumerate(agents):
        if a in joined(world):
            caps[i * per + 2:i * per + 4] = CAP["vel"]
    return caps


def compare_emit(world, fo, t_extra, j_extra, spread, what):
    base = fo.base
    close(t_extra[:base], j_extra[:base], OBS_TOL, f"{what}: obs rows", spread[:base], obs_caps(world, fo))
    close(t_extra[base:], j_extra[base:], REW_TOL, f"{what}: other rows")


# the events a twin comparison must see, per world
REQUIRED = {
    "buzz_wire": ("ls", "joints", "line_hits", "line_band", "done"),
    "joint_passage_size": ("ls", "bs", "joints", "just_passed", "done"),
    "ball_trajectory": ("ss", "joints"),
    "ball_passage": ("ss", "bs", "box_hits", "done"),
}


def events(env, x, extra, y):
    """The contacts per type and joint forces on the input rows ``x``, and
    the step's events (testing.joint_worlds_events) on its emit rows
    ``extra`` and output state rows ``y``."""
    out = dict(TF.contact_counts(env.world, x))
    out["joints"] = TF.joint_counts(env.world, x)["force"]
    out.update(testing.joint_worlds_events(env, torch.as_tensor(np.asarray(extra)), y))
    return out


def jax_ref(form, jenv, run, arrays):
    """The JAX package's kernel ``form`` on a twin's state with its spread,
    kept on the twin's JAX env: each compiles once per file (10-15 s in
    interpret mode)."""
    refs = jenv.__dict__.setdefault("_twin_refs", {})
    if form not in refs:
        refs[form] = with_spread(run, arrays)
    return refs[form]


def check_fused_twin(env, jenv, jfo, arrays):
    """K1's plain version with the emit against the JAX package's
    fused_physics_step; returns the events of the step."""
    tfo = env._fused_outputs
    assert tfo.n_out == jfo.n_out and tfo.n_scratch_in == jfo.n_scratch_in
    step = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))

    def run(a):
        j_state, j_extra = step(jax_state(jenv, a))
        return {f: getattr(j_state, f) for f in FIELDS}, j_extra

    (j_state, j_extra), (s_state, s_extra) = jax_ref("fused", jenv, run, arrays)
    st = state_from_numpy(env.world, arrays)
    t_state, t_extra = TF.fused_physics_step(env.world, st, tfo)
    for field in FIELDS:
        close(getattr(t_state, field).numpy(), j_state[field], STATE_TOL, field, s_state[field],
              field_caps(env.world, field, j_state[field].shape))
    compare_emit(env.world, tfo, t_extra.numpy(), j_extra, s_extra, "fused step")
    x = torch.cat([TF.state_rows(st), st.joint_fixed_rot.T])
    return events(env, x, t_extra, TF.state_rows(t_state))


def check_rows_twin(env, jenv, jfo, arrays, acts):
    """K2's plain version (the action rows, the in-kernel controller where
    the config runs one, the physics, the emit, the scratch carry) against
    the JAX package's rows kernel."""
    tfo = env._fused_outputs
    slots = [a.index for a in env.agents]
    act = np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])
    bp = 128
    jact = np.zeros((-(-act.shape[0] // 8) * 8, bp), np.float32)
    jact[:act.shape[0], :B] = act
    step = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))

    def run(a):
        jc, je = step(JF.pack_carry(jenv.world, jax_state(jenv, a), jfo, bp), jact)
        return jc[:, :B], je[:, :B]

    (jc, je), (sc_, se) = jax_ref("rows", jenv, run, arrays)
    carry = TF.pack_carry(env.world, state_from_numpy(env.world, arrays), tfo)
    tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
    tc, te = tc.numpy(), te.numpy()
    n_tot = tfo.n_out + tfo.n_ctrl_out
    assert tc.shape == jc.shape and te.shape == je.shape == (n_tot, B)
    close(tc, jc, STATE_TOL, "carry rows", sc_, row_caps(env.world, tc.shape[0]))
    compare_emit(env.world, tfo, te[:tfo.n_out], je[:tfo.n_out], se[:tfo.n_out], "rows step")
    if tfo.n_ctrl_out:
        close(te[tfo.n_out:], je[tfo.n_out:], STATE_TOL, "controller rows")


def check_catches_joint_error(monkeypatch, twin):
    """With every joint force of the port PLANTED too strong (relative),
    both twin comparisons fail: the allowance on the joined entities'
    velocities does not hide an error of the joint term."""
    real = TF._joint_forces

    def planted(*args):
        for a, b, fx, fy, ta, tb in real(*args):
            yield a, b, fx * (1 + PLANTED), fy * (1 + PLANTED), ta, tb

    env, jenv, jfo, arrays, acts = twin
    check_fused_twin(env, jenv, jfo, arrays)
    check_rows_twin(env, jenv, jfo, arrays, acts)
    monkeypatch.setattr(TF, "_joint_forces", planted)
    with pytest.raises(AssertionError, match="beyond the bound"):
        check_fused_twin(env, jenv, jfo, arrays)
    with pytest.raises(AssertionError, match="beyond the bound"):
        check_rows_twin(env, jenv, jfo, arrays, acts)


def check_env_step(name, kw, arrays, acts, fused, jax_out):
    """One env.step of the port from the injected state against the JAX
    package's (``jax_out``: its state, obs, rewards, dones and their
    one-ulp spreads, ``jax_steps``)."""
    (j_state, j_obs, j_rews, j_dones), spread = jax_out
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused, **kw)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    assert (env._fused_outputs is not None) == (fused and name != "asym_joint")
    for field in FIELDS:
        close(getattr(env.state, field).numpy(), j_state[field], STATE_TOL, field, spread[0][field],
              field_caps(env.world, field, j_state[field].shape))
    for i in range(env.n_agents):
        close(obs[i].numpy(), j_obs[i], OBS_TOL, "obs")
        close(rews[i].numpy(), np.reshape(j_rews[i], B), REW_TOL, "reward")
    np.testing.assert_array_equal(dones.numpy(), j_dones)
    for key, val in env.state.scenario.items():
        want = j_state["scenario"][key]
        if isinstance(val, dict):
            for k2, v2 in val.items():
                close(v2.numpy(), want[k2], STATE_TOL, f"{key}.{k2}")
        elif val.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
        else:
            close(val.numpy(), want, REW_TOL, key)


def jax_steps(configs, states):
    """Per config: the JAX package's env.step (hooks) from the injected
    state, ``((state fields and scratch, obs, rews, dones), spread)``."""
    out = {}
    for config, (name, kw) in configs.items():
        arrays, acts = states[config]
        jenv = vmas_tpu.make_env(name, B, seed=0, **kw)

        def run(a, jenv=jenv, acts=acts):
            jenv.state = jax_state(jenv, a)
            obs, rews, dones, _ = jenv.step([jnp.asarray(x) for x in acts])
            st = {f: getattr(jenv.state, f) for f in FIELDS}
            st["scenario"] = dict(jenv.state.scenario)
            return st, tuple(obs), tuple(rews), dones

        base, spread = with_spread(run, arrays)
        out[config] = (base, spread)
    return out


def rebuild_joint_passage_size(env, state):
    """joint_passage_size keeps its map in scratch; rebuild it from the
    injected open passages (big, big + 1, small), as
    tests/test_scenario_parity.py does for the JAX package."""
    nc = env.scenario.non_collide_passages
    big = (state.pos[:, nc[0].index] + state.pos[:, nc[1].index]) / 2
    small = state.pos[:, nc[2].index]
    lr = torch.where(small[:, 0] > big[:, 0], 4, -3).to(torch.int32)
    scr = dict(state.scenario)
    scr.update(big_passage_pos=big, small_passage_pos=small, pass_center=(big + small) / 2, small_left_or_right=lr,
               middle_angle=torch.where(lr > 0, math.pi, 0.0).to(torch.float32))
    return state.replace(scenario=scr)


def golden_replay(name, golden_t=GOLDEN_T):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's plain version, free-running
    (``golden_t`` steps where given, as tests/test_scenario_parity.py) with
    no env allowed to fork, and then re-synced to the recorded state before
    each step, one env a step allowed to fork on a knife-edge term (a
    wire touch's -10), as the JAX package's re-synced replay allows; both
    after the same one-cycle scratch refresh."""
    d = np.load(GOLDEN.format(name))
    nb, atol = d["init_pos"].shape[0], GOLDEN_ATOL.get(name, 2e-3)
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True, **GOLDEN_KW.get(name, {}))
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert (env._fused_outputs is not None) == (name != "asym_joint")

    def inject(pos, vel, rot, ang_vel, scratch):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque), scenario=scratch)

    def close(a, ref, tol, msg, cap=1.0):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)
        assert per_env.max() <= cap, f"{msg}: max error {per_env.max():.4f} beyond the cap"
        assert int((per_env > tol).sum()) <= n_chaotic, f"{msg}: envs {np.flatnonzero(per_env > tol)} beyond {tol}"

    scratch0 = dict(env.state.scenario)
    for resync in (False, True):
        n_chaotic = 1 if resync else 0
        state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], dict(scratch0))
        if name == "joint_passage_size":
            state = rebuild_joint_passage_size(env, state)
        env.state = env.scenario.post_rewards(env.scenario.pre_rewards(state))
        T = d["actions"].shape[0] if resync else golden_t.get(name, d["actions"].shape[0])
        for t in range(T):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state.scenario)
            acts = [torch.as_tensor(d["actions"][t, i, :, :2]) for i in range(env.n_agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            close(env.state.rot, d["rot"][t], 10 * atol, f"rot, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")
                close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}], {tag}", cap=25.0)
            assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"done, {tag}"


def rollouts_equal(sa, ta, sb, tb):
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rot", "ang_vel", "force", "joint_fixed_rot", "rendering"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    assert sa.scenario.keys() == sb.scenario.keys()
    for k, v in sa.scenario.items():
        if isinstance(v, dict):
            assert all(torch.equal(v[k2], sb.scenario[k][k2]) for k2 in v), k
        else:
            assert torch.equal(v, sb.scenario[k]), k


def check_rows_rollouts(name, kw, seed):
    """The rows rollout (k_steps 1 and 2) and a rows policy rollout against
    their env.step rollouts from a state with events, bitwise: rewards,
    dones, observations, the final state with its u, rendering and scratch
    (step counters and controller memory included)."""
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env)
    s0 = state_from_numpy(env.world, testing.joint_worlds_state(env, np.random.default_rng(seed)))
    st0 = env.steps
    env.scenario.obs_seed = 5
    sa, ta_steps, ta = rollout_fn(env, horizon=4)(s0, st0, torch.Generator().manual_seed(7))
    for k in (1, 2):
        env.scenario.obs_seed = 5
        sb, tb_steps, tb = rows_rollout_fn(env, horizon=4, k_steps=k)(s0, st0, torch.Generator().manual_seed(7))
        assert tb["rewards"].shape == (4, 16, env.n_agents) and torch.equal(ta_steps, tb_steps)
        rollouts_equal(sa, ta, sb, tb)
    assert not torch.equal(sb.pos, s0.pos)
    W = [torch.as_tensor(np.random.default_rng(seed).normal(0, 0.3, (o.shape[-1], 2)), dtype=torch.float32)
         for o in env._observations(s0)]

    def policy(obs, generator):
        return tuple(torch.tanh(o @ w) for o, w in zip(obs, W))

    env.scenario.obs_seed = 6
    sa, _, ta = rollout_fn(env, policy, 3)(s0, st0, torch.Generator().manual_seed(8))
    env.scenario.obs_seed = 6
    sb, _, tb = rows_policy_rollout_fn(env, policy, 3)(s0, st0, torch.Generator().manual_seed(8))
    rollouts_equal(sa, ta, sb, tb)
    return env, s0, sb


def make_step_states(configs, seed):
    """Per config: a state and actions for the env.step comparison."""
    out = {}
    for k, (config, (name, kw)) in enumerate(sorted(configs.items())):
        env = torch_make_env(name, B, device="cpu", seed=0, **kw)
        rng = np.random.default_rng(seed + k)
        build = testing.asym_joint_state if name == "asym_joint" else testing.joint_worlds_state
        out[config] = (build(env, rng), actions(env, rng))
    return out


def check_emit_params(name, env):
    """The emit's kernel parameters common to every world: its kind, its
    member of the union with the agents, the scratch carry map; the
    by-value parameters within 4 KB. Returns the member."""
    fo = env._fused_outputs
    kind, ep = fo.kernel_emit()
    assert kind == getattr(K, "EMIT_" + name.upper())
    p = getattr(ep, name)
    agents = env.world.agents
    assert p.n_agents == len(agents) and [p.agent[i] for i in range(len(agents))] == [a.index for a in agents]
    carry = [ep.carry_idx[k] for k in range(fo.n_scratch_in)]
    assert carry == [-1 if ei is None else ei for ei in fo.carry_extra_idx]
    members = [f[1] for f in K._EmitUnion._fields_]
    assert ctypes.sizeof(K.EmitParams) == 4 * K.MAX_K + max(ctypes.sizeof(m) for m in members)
    by_value = ctypes.sizeof(K.FusedSpec) + ctypes.sizeof(K.EmitParams) + ctypes.sizeof(K.ActParams)
    assert by_value + 5 * 8 + 3 * 4 <= 4096
    return p


@pytest.fixture(scope="module")
def twins():
    return make_twins(TWINS, 110)


@pytest.fixture(scope="module")
def step_states():
    return make_step_states(STEP, 120)


@pytest.fixture(scope="module")
def jax_stepped(step_states):
    return jax_steps(STEP, step_states)


def check_pair_buckets(env, jenv):
    """The same entities, joints and contact pairs as the JAX package, both
    fuse, the lane rule (8 lanes per env: each of these worlds has more
    than 3 items of a type) and rows eligibility."""
    jw = jenv.world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    for key in ("ss_a", "ss_b", "ls_line", "ls_sphere", "bs_box", "bs_sphere", "joint_idx_a", "joint_idx_b"):
        np.testing.assert_array_equal(np.asarray(getattr(env.world.spec, key)), np.asarray(getattr(jw.spec, key)),
                                      err_msg=key)
    assert TF.supports(env.world) == JF.supports(jw) is True
    ks = TF._kernel_spec(env.world)
    assert ks.lanes == 8 and max(len(getattr(ks, t)) for t in TF.ITEM_TYPES) > TF.FEW_ITEMS
    assert TF.rows_step_supported(env.world, env._fused_outputs, env.agents)


@pytest.mark.parametrize("config", sorted(TWINS))
def test_pair_buckets_and_lanes(config, twins):
    check_pair_buckets(*twins[config][:2])


@pytest.mark.parametrize("config", sorted(TWINS))
def test_fused_step_twin_matches_pallas(config, twins):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode), on a
    state where the joints pull, the passages' faces and the walls touch,
    just_passed flips and envs are done."""
    env, jenv, jfo, arrays, _ = twins[config]
    ev = check_fused_twin(env, jenv, jfo, arrays)
    assert all(ev[k] > 0 for k in REQUIRED[TWINS[config][0]]), ev


@pytest.mark.parametrize("config", sorted(TWINS))
def test_rows_step_twin_matches_pallas(config, twins):
    """The plain version of K2 (the controller config: its PID in the
    kernel) against the JAX package's rows kernel in interpret mode."""
    check_rows_twin(*twins[config])


@pytest.mark.parametrize("config", sorted(TWINS))
def test_twin_catches_a_joint_error(config, twins, monkeypatch):
    """Every joint force of the port 3e-4 too strong fails the K1 and K2
    twin comparisons, which pass without it."""
    check_catches_joint_error(monkeypatch, twins[config])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(STEP))
def test_env_step_matches_jax(config, fused, step_states, jax_stepped):
    """One env step from the injected state, on the plain path or the fused
    step, against the JAX package's: state, observations, rewards, dones
    and the scratch the next step reads."""
    name, kw = STEP[config]
    check_env_step(name, kw, *step_states[config], fused, jax_stepped[config])


@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name):
    golden_replay(name)


ROLLOUTS = {**STEP, "joint_passage_size,noise": ("joint_passage_size", {
    "observe_joint_angle": True, "joint_angle_obs_noise": 0.2, "obs_noise": 0.1})}


@pytest.mark.parametrize("config", sorted(ROLLOUTS))
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollouts bitwise their env.step rollouts; the ``t`` clock set
    to its start value plus the horizon, the PID in the kernel, the noisy
    config's noise drawn in unpack per step."""
    name, kw = ROLLOUTS[config]
    env, s0, sb = check_rows_rollouts(name, kw, 130)
    assert torch.equal(sb.scenario["t"], s0.scenario["t"] + 3)
    if kw.get("use_vel_controller"):
        assert bool(sb.scenario["__vel_ctrl_agent_0"]["prev_err"].any())
        assert not torch.equal(sb.u[0], s0.u[0])


@pytest.mark.parametrize("name,kw,eligible", [
    ("joint_passage_size", {}, True),
    ("joint_passage_size", {"use_vel_controller": True}, True),
    ("joint_passage_size", {"obs_noise": 0.1}, True),
    ("joint_passage_size", {"collision_reward": -1}, False),
    ("joint_passage_size", {"energy_reward_coeff": 0.1}, False),
])
def test_rows_rollout_supported(name, kw, eligible):
    """The fused configs with a scratch carry are rows-eligible (the PID
    config with its controller in the kernel, the noisy one with its noise
    streams); a collision or an energy reward has no fused outputs: the
    hooks run around the fused step with no emit."""
    env = torch_make_env(name, 4, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) is eligible
    assert (env._fused_outputs is None) == (not eligible) and env.world.fused
    if not eligible:
        with pytest.raises(AssertionError, match="not eligible"):
            rows_rollout_fn(env, horizon=2)


@pytest.mark.parametrize("config", sorted(TWINS))
def test_kernel_emit_params(config, twins):
    """The emit's kernel parameters: its kind, its member of the union
    filled, the threshold, the scratch carry map (the map rows carried
    unchanged, ``t`` a step counter); the by-value parameters within 4
    KB."""
    env = twins[config][0]
    fo, sc = env._fused_outputs, env.scenario
    p = check_emit_params("joint_passage_size", env)
    assert (p.jl, p.goal) == (sc.joint.landmark.index, sc.goal.index)
    assert p.pw_half == np.float32(0.1) and (bool(p.mid_180), bool(p.obs_joint)) == (fo.mid_180, fo.obs_joint)
    assert fo.carry_extra_idx[4:] == (None,) * 7 and fo.step_count_keys == ("t",)


@pytest.mark.parametrize("name", NAMES + ("joint_passage_size,asym",))
def test_reset_invariants(name):
    """The port's own reset: the JAX package's map (its big and small
    openings and the pass centre between them, the middle angle from the
    small opening's side, the passages on their slots, different per env),
    the bar below the wall at its length, the scratch zeroed."""
    world_name, kw = (name, {}) if "," not in name else ("joint_passage_size", {"asym_package": True})
    env = torch_make_env(world_name, 256, device="cpu", seed=3, **kw)
    st, sc = env.state, env.scenario
    agents = [a.index for a in env.world.agents]
    assert not st.vel.any()
    if world_name == "joint_passage_size":
        s = st.scenario
        open_x = torch.stack([st.pos[:, p.index, 0] for p in sc.non_collide_passages], -1)
        torch.testing.assert_close(s["big_passage_pos"][:, 0], open_x[:, :2].mean(-1), atol=1e-6, rtol=0)
        torch.testing.assert_close(s["small_passage_pos"][:, 0], open_x[:, 2], atol=1e-6, rtol=0)
        lr = s["small_left_or_right"]
        assert set(lr.tolist()) == {-3, 4}
        torch.testing.assert_close(s["middle_angle"], torch.where(lr > 0, math.pi, 0.0), atol=0, rtol=0)
        slots = torch.stack([st.pos[:, p.index, 0] for p in sc.passages], -1)
        k = (slots + 1 + sc.agent_radius - sc.passage_length / 2) / sc.passage_length
        torch.testing.assert_close(k, k.round(), atol=1e-4, rtol=0)
        assert k.round().unique(dim=0).shape[0] > 1  # the maps differ between envs
        jl = st.pos[:, sc.joint.landmark.index]
        assert bool((jl[:, 1] < 0).all()) and not s["passed"].any() and not s["t"].any()
        d = torch.linalg.vector_norm(st.pos[:, agents[0]] - st.pos[:, agents[1]], dim=-1)
        torch.testing.assert_close(d, torch.full_like(d, sc.joint_length), atol=1e-5, rtol=0)
    assert float(st.pos[:, agents].std()) > 0.05
