"""The rest of the port's MPE family (simple_push, simple_adversary,
simple_tag, simple_reference, simple_speaker_listener, simple_world_comm,
their emits in the fused step, and simple_crypto on the hook pipeline)
against the JAX package's, from injected states, and the rows rollouts on
comm worlds.

The same state, made from a seed with numpy (``testing.mpe_family_state``:
in every other env good agents within reach of an adversary's catch,
landmarks within reach of an agent's contact, and in a comm world comm
state and comm actions set for every agent), goes through the JAX function
and its counterpart in the port:

* the plain versions of the fused step (K1) and of the rows step (K2) with
  the scenario's emit against the JAX package's Pallas kernel in interpret
  mode (simple_tag with its 10 substeps cut to 2 on both sides, so that the
  JAX kernel compiles in seconds);
* one env step, on the plain path and on the fused step (K1's plain
  version), against the JAX package's unfused step, for the defaults
  and for simple_adversary's 4/2, simple_tag's every-flag and
  simple_world_comm's 3/2/1/3 configs;
* the recorded reference trajectories, free-running and re-synced, with
  the goal and key scratch rebuilt from the recording as
  tests/test_scenario_parity.py does.

Then the port alone: the emit against the scenario's hooks, the env.step
rollout against the rows rollout and the rows policy rollout with comm
(bitwise), rows-rollout eligibility, the kernel's emit parameters with the
union's layout, simple_tag's respawn on the hook pipeline, and the resets.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise);
observation rows atol 2e-5 rtol 1e-5; reward rows atol 2e-3 (simple_tag's
team sums are a torch sum against an XLA reduction); the two rollouts of
the port bitwise; the golden replays at tests/test_scenario_parity.py's
atol for these scenarios, 2e-3 (velocities, observations and rewards 10x).
"""

import ctypes
import os
import sys

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
    rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)
from vmas_tpu_torch.scenarios.mpe.simple import hit_distance, radius_classes
from vmas_tpu_torch.testing import mpe_actions, mpe_family_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
FUSED = ("simple_push", "simple_adversary", "simple_tag", "simple_reference", "simple_speaker_listener",
         "simple_world_comm")
NAMES = FUSED + ("simple_crypto",)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the configs whose emit is checked: every default, and the JAX package's
# other cases (tests/test_fused.py)
CONFIGS = {
    **{n: (n, {}) for n in NAMES},
    "simple_adversary,4/2": ("simple_adversary", {"n_agents": 4, "n_adversaries": 2}),
    "simple_tag,flags": ("simple_tag", {"shape_agent_rew": True, "shape_adversary_rew": True,
                                        "agents_share_rew": True, "adversaries_share_rew": False,
                                        "observe_same_team": False, "observe_pos": False}),
    "simple_world_comm,3/2/1/3": ("simple_world_comm", {"num_good_agents": 3, "num_adversaries": 2,
                                                        "num_forests": 1, "num_food": 3}),
}
# the substeps the kernels' twins are compared at (simple_tag's 10 cut to 2)
TWIN_SUBSTEPS = {"simple_tag": 2}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **{k: jnp.asarray(v) for k, v in arrays["scenario"].items()}},
    )


def _cut(env_or_world, name):
    """The world with its substeps cut for the twins' comparison."""
    w = getattr(env_or_world, "world", env_or_world)
    if name in TWIN_SUBSTEPS:
        w.substeps = TWIN_SUBSTEPS[name]
        w.sub_dt = w.dt / w.substeps
    return env_or_world


@pytest.fixture(scope="module")
def cases():
    """Per config: (the port's fused env, the state, per-agent actions)."""
    out = {}
    for k, (config, (name, kw)) in enumerate(sorted(CONFIGS.items())):
        env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
        rng = np.random.default_rng(60 + k)
        out[config] = (env, mpe_family_state(env, rng), mpe_actions(env, rng))
    return out


@pytest.fixture(scope="module")
def jenvs():
    """Per config: the JAX package's env (hook pipeline), built once."""
    return {config: vmas_tpu.make_env(name, B, seed=0, **kw) for config, (name, kw) in CONFIGS.items()}


@pytest.fixture(scope="module")
def twins(jenvs):
    """Per fused world: the port's fused env and the JAX package's world and
    fused outputs, with the twins' substeps (a world of its own where they
    are cut), a state and actions."""
    out = {}
    for k, name in enumerate(FUSED):
        env = _cut(torch_make_env(name, B, device="cpu", seed=0, fused_physics=True), name)
        jenv = _cut(vmas_tpu.make_env(name, B, seed=0), name) if name in TWIN_SUBSTEPS else jenvs[name]
        rng = np.random.default_rng(90 + k)
        jfo = jenv.scenario.make_fused_outputs(jenv.world)
        out[name] = (env, jenv, jfo, mpe_family_state(env, rng), mpe_actions(env, rng))
    return out


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base = fo.base
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[base:], j_extra[base:], atol=2e-3, rtol=0, err_msg=f"{what}: reward rows")


@pytest.mark.parametrize("name", FUSED)
def test_pair_buckets_and_lanes(name, cases, jenvs):
    """The same entities and contact pairs as the JAX package, both fuse,
    and the lane rule: simple_tag (14 sphere-sphere pairs) and
    simple_world_comm (21) take 8 lanes per env, the others (at most one
    pair) one thread."""
    env = cases[name][0]
    jw = jenvs[name].world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    np.testing.assert_array_equal(np.asarray(env.world.spec.ss_a), np.asarray(jw.spec.ss_a))
    np.testing.assert_array_equal(np.asarray(env.world.spec.ss_b), np.asarray(jw.spec.ss_b))
    assert TF.supports(env.world) == JF.supports(jw) is True
    ks = TF._kernel_spec(env.world)
    n_ss = {"simple_push": 1, "simple_tag": 14, "simple_world_comm": 21}.get(name, 0)
    assert len(ks.ss) == n_ss and not (ks.ls or ks.ll or ks.bs or ks.bl or ks.bb or ks.joints)
    assert ks.lanes == (8 if n_ss > TF.FEW_ITEMS else 1)


@pytest.mark.parametrize("name", FUSED)
def test_fused_step_twin_matches_pallas(name, twins):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode).
    (Its state rows against the JAX package's unfused physics step, at the
    full substeps: test_env_step_matches_jax with fused=True.)"""
    env, jenv, jfo, arrays, _ = twins[name]
    tfo = env._fused_outputs
    assert tfo.n_out == jfo.n_out and tfo.n_scratch_in == jfo.n_scratch_in
    js = jax_state(jenv, arrays)
    j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(js)
    t_state, t_extra = TF.fused_physics_step(env.world, state_from_numpy(env.world, arrays), tfo)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    _compare_emit(tfo, t_extra, j_extra, "fused step")


@pytest.mark.parametrize("name", FUSED)
def test_rows_step_twin_matches_pallas(name, twins):
    """The plain version of K2 (the action rows, the physics, the emit)
    against the JAX package's rows kernel in interpret mode."""
    env, jenv, jfo, arrays, acts = twins[name]
    tfo = env._fused_outputs
    slots = [a.index for a in env.agents]
    act = np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])
    bp = 128
    jact = np.zeros((-(-act.shape[0] // 8) * 8, bp), np.float32)
    jact[:act.shape[0], :B] = act
    js = jax_state(jenv, arrays)
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    carry = TF.pack_carry(env.world, state_from_numpy(env.world, arrays), tfo)
    tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
    assert tc.shape == jc.shape and te.shape == je.shape == (tfo.n_out, B)
    np.testing.assert_allclose(tc.numpy(), jc, **STATE_TOL, err_msg="carry rows")
    _compare_emit(tfo, te, je, "rows step")


@pytest.fixture(scope="module")
def jax_steps(cases, jenvs):
    """Per config: the JAX package's env.step (hooks) from the injected
    state: (state, obs, rews, dones)."""
    out = {}
    for config in CONFIGS:
        _, arrays, acts = cases[config]
        jenv = jenvs[config]
        jenv.state = jax_state(jenv, arrays)
        obs, rews, dones, _ = jenv.step([jnp.asarray(a) for a in acts])
        out[config] = (jenv.state, obs, rews, dones)
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_env_step_matches_jax(config, fused, cases, jax_steps):
    """One env step from the injected state, on the plain path or the
    fused step, against the JAX package's: state (with the comm state),
    observations, rewards and dones."""
    name, kw = CONFIGS[config]
    _, arrays, acts = cases[config]
    j_state, j_obs, j_rews, j_dones = jax_steps[config]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused, **kw)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    assert (env._fused_outputs is not None) == (fused and name != "simple_crypto")
    for field in FIELDS + ("c", "uc"):
        np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    for i in range(env.n_agents):
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, rtol=0, err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))


@pytest.mark.parametrize("config", sorted(c for c in CONFIGS if not c.startswith("simple_crypto")))
def test_emit_matches_scenario_hooks(config, cases):
    """The fused step's emit rows, unpacked, against the scenario's hooks on
    the plain path's post-step state: observations, rewards and (for
    simple_tag) the reward scratch; the catches, contacts and food terms
    act in some env."""
    name, kw = CONFIGS[config]
    _, arrays, acts = cases[config]
    envs = [torch_make_env(name, B, device="cpu", seed=0, fused_physics=f, **kw) for f in (True, False)]
    outs = []
    for env in envs:
        env.state = state_from_numpy(env.world, arrays)
        outs.append(env.step([torch.as_tensor(a) for a in acts]))
    (of, rf, df), (op, rp, dp) = (o[:3] for o in outs)
    for field in FIELDS + ("c",):
        torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), **STATE_TOL)
    for i in range(envs[0].n_agents):
        torch.testing.assert_close(of[i], op[i], atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(rf[i], rp[i], atol=2e-3, rtol=0)
    assert torch.equal(df, dp)
    if name == "simple_tag":
        for k in ("per_agent_rew", "agents_rew", "adversary_rew"):
            torch.testing.assert_close(envs[0].state.scenario[k], envs[1].state.scenario[k], atol=2e-3, rtol=0)
        assert bool((envs[1].state.scenario["per_agent_rew"].abs() > 5).any()), "no catch"
    if name == "simple_world_comm":
        # a good agent's food term (+2 per item) shows in its reward
        good = [i for i, a in enumerate(envs[1].agents) if not a.adversary]
        assert any(bool((rp[i] > 1).any()) for i in good), "no food eaten"
        assert any(bool((rp[i] != 0).any()) for i, a in enumerate(envs[1].agents) if a.adversary), "no catch"


@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step (on the fused step's plain version where the world has
    fused outputs), free-running and then re-synced to the recorded state
    before each step, as tests/test_scenario_parity.py checks the JAX
    package; the reference's batch-wide goal and its key and secret are
    put into the per-env scratch."""
    d = np.load(GOLDEN.format(name))
    nb, atol = d["init_pos"].shape[0], 2e-3
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert (env._fused_outputs is not None) == (name != "simple_crypto")

    def inject(pos, vel, rot, ang_vel, scratch):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque), scenario=scratch)

    scratch = dict(env.state.scenario)
    for key in ("goal_idx", "goal_b_0", "goal_b_1"):
        if f"extra_{key}" in d:
            scratch[key] = torch.full_like(scratch[key], int(d[f"extra_{key}"]))
    for key in ("key", "secret"):
        if f"extra_{key}" in d:
            scratch[key] = torch.as_tensor(d[f"extra_{key}"], dtype=torch.float32)
    close = lambda a, ref, tol, msg: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(ref, np.float64), atol=tol, rtol=0, err_msg=msg)
    for resync in (False, True):
        env.state = env.scenario.pre_rewards(inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"],
                                                    scratch))
        for t in range(d["actions"].shape[0]):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state.scenario)
            acts = [torch.as_tensor(d["actions"][t, i, :, :env.get_agent_action_size(a)])
                    for i, a in enumerate(env.agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")
                close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}], {tag}")
            np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done, {tag}")


@pytest.mark.parametrize("config", sorted(c for c in CONFIGS if not c.startswith("simple_crypto")))
def test_kernel_emit_params(config, cases):
    """Each emit's kernel parameters: its kind, its member of the union
    filled (the agents' and landmarks' runs, the roles, the collision
    distances by radius class, rounded once from the double sum), the
    goal scratch carried unchanged; the union keeps EmitParams small
    enough that the kernel's by-value parameters fit in 4 KB."""
    name, kw = CONFIGS[config]
    env = cases[config][0]
    fo = env._fused_outputs
    kind, ep = fo.kernel_emit()
    member = {"simple_speaker_listener": "speaker_listener"}.get(name, name)
    assert kind == getattr(K, "EMIT_" + member.upper())
    p = getattr(ep, member)
    agents, lms = env.world.agents, env.world.landmarks
    if name == "simple_speaker_listener":
        assert (p.n_agents, p.listener, p.l0, p.n_lm) == (2, agents[1].index, lms[0].index, 3)
    else:
        assert (p.a0, p.n_agents, p.l0, p.n_lm) == (agents[0].index, len(agents), lms[0].index, len(lms))
    if name in ("simple_push", "simple_adversary", "simple_tag", "simple_world_comm"):
        assert [p.adversary[i] for i in range(len(agents))] == [int(a.adversary) for a in agents]
    if name in ("simple_tag", "simple_world_comm"):
        rcls, radii = radius_classes([a.shape.radius for a in agents])
        assert [p.rcls[i] for i in range(len(agents))] == rcls and len(radii) == 2
        for i, a in enumerate(agents):
            for j, b in enumerate(agents):
                got = p.hit_r[rcls[i] * K.MAX_RC + rcls[j]]
                assert got == hit_distance(a.shape.radius, b.shape.radius) == np.float32(
                    float(a.shape.radius) + float(b.shape.radius))
    if name == "simple_world_comm":
        food = env.scenario.food
        assert (p.f0, p.n_food) == (food[0].index, len(food))
        assert [p.leader[i] for i in range(len(agents))] == [int(i == 0) for i in range(len(agents))]
        assert p.food_r[0] == np.float32(0.075 + 0.03) and p.food_r[1] == np.float32(0.045 + 0.03)
    if name == "simple_tag":
        flags = (p.shape_agent, p.shape_adv, p.same_team, p.obs_pos, p.obs_vel)
        assert flags == tuple(int(x) for x in (fo.shape_agent, fo.shape_adv, fo.same_team, fo.obs_pos, fo.obs_vel))
    assert [ep.carry_idx[k] for k in range(fo.n_scratch_in)] == [-1] * fo.n_scratch_in
    # the union: one member's room, not the sum of all
    members = [f[1] for f in K._EmitUnion._fields_]
    assert ctypes.sizeof(K.EmitParams) == 4 * K.MAX_K + max(ctypes.sizeof(m) for m in members)
    by_value = ctypes.sizeof(K.FusedSpec) + ctypes.sizeof(K.EmitParams) + ctypes.sizeof(K.ActParams)
    assert by_value + 5 * 8 + 3 * 4 <= 4096


ROLLOUT_CONFIGS = {
    **{n: (n, {}) for n in FUSED},
    "simple_tag,discrete": ("simple_tag", {"continuous_actions": False}),
    "simple_reference,discrete": ("simple_reference", {"continuous_actions": False}),
    "simple_speaker_listener,multidiscrete": ("simple_speaker_listener",
                                              {"continuous_actions": False, "multidiscrete_actions": True}),
    "simple_world_comm,discrete": ("simple_world_comm", {"continuous_actions": False}),
}


@pytest.mark.parametrize("config", sorted(ROLLOUT_CONFIGS))
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollout against rollout_fn (the env's own step on the fused
    step) from a reset, bitwise, as tests/test_rows_rollout.py holds the
    JAX package's: rewards, dones, observations (the comm state in them
    substituted per step), the final state with its u, uc, c and scratch;
    continuous comm, and the one-hot of a discrete comm index."""
    name, kw = ROLLOUT_CONFIGS[config]
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env)
    s0, st0 = env.state, env.steps
    sa, ta_steps, ta = rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    sb, tb_steps, tb = rows_rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    assert tb["rewards"].shape == (5, 16, env.n_agents) and torch.equal(ta_steps, tb_steps)
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "force", "c", "uc"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    assert sa.scenario.keys() == sb.scenario.keys()
    assert all(torch.equal(sa.scenario[k], sb.scenario[k]) for k in sa.scenario)
    assert not torch.equal(sb.pos, s0.pos)
    if env.world.dim_c:
        assert not torch.equal(sb.c, s0.c)


def test_rows_policy_rollout_comm():
    """The rows policy rollout on simple_reference, whose observations hold
    the other agent's comm state, against the env.step policy rollout,
    bitwise: a fixed linear policy with continuous comm (JAX
    tests/test_rows_rollout.py's protocol)."""
    env = torch_make_env("simple_reference", 8, device="cpu", seed=0, fused_physics=True)
    act_w = env.get_agent_action_size(env.agents[0])
    obs_w = int(env._observations(env.state)[0].shape[-1])
    rng = np.random.default_rng(3)
    Ws = [torch.tensor(rng.normal(size=(obs_w, act_w)) * 0.2, dtype=torch.float32) for _ in env.agents]

    def policy(obs, generator):
        return tuple(torch.cat([torch.tanh((o @ W)[:, :2]), torch.sigmoid((o @ W)[:, 2:])], -1)
                     for o, W in zip(obs, Ws))

    s0, st0 = env.state, env.steps
    sa, _, ta = rollout_fn(env, policy, horizon=4)(s0, st0, torch.Generator().manual_seed(23))
    sb, _, tb = rows_policy_rollout_fn(env, policy, horizon=4)(s0, st0, torch.Generator().manual_seed(23))
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    for field in ("pos", "vel", "uc", "c"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u))
    # the observed comm is the previous step's, which moved
    assert not torch.equal(ta["obs"][0][1, :, -10:], ta["obs"][0][0, :, -10:])


@pytest.mark.parametrize("name,kw,eligible", [
    ("simple_reference", {}, True),
    ("simple_speaker_listener", {"continuous_actions": False}, True),
    ("simple_world_comm", {}, True),
    ("simple_tag", {}, True),
    ("simple_tag", {"respawn_at_catch": True}, False),
    ("simple_crypto", {}, False),
])
def test_rows_rollout_supported(name, kw, eligible, monkeypatch):
    """Comm worlds are rows-eligible, and so are a noisy comm channel
    (c_noise > 0) and noisy actions (the rows paths draw the steps' noise
    streams as env.step does), but not simple_tag's respawn config (no
    fused outputs) or simple_crypto (unfused); ``rollout()`` takes the rows
    path where eligible, noisy or not, and ``rollout_fn`` elsewhere, with
    the same trajectory."""
    env = torch_make_env(name, 8, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) is eligible
    if eligible:
        quiet = env.agents[-1].u_noise_array
        for a in env.agents if env.world.dim_c else ():
            if not a.silent:
                a.c_noise = 0.1
        env.agents[-1].u_noise_array = np.full_like(quiet, 0.1)
        assert rows_rollout_supported(env)
        paths, traj, want = testing.rollout_path_and_reference(env, 3, 2)
        assert paths == ["rows_rollout_fn"] and testing.same_trajectory(traj, want)
        for a in env.agents:
            a.c_noise = 0.0
        env.agents[-1].u_noise_array = quiet
        assert rows_rollout_supported(env)
    R = sys.modules[rollout_fn.__module__]
    calls = []
    for fn in ("rollout_fn", "rows_rollout_fn"):
        orig = getattr(R, fn)
        monkeypatch.setattr(R, fn, lambda *a, _o=orig, _n=fn, **k: calls.append(_n) or _o(*a, **k))
    s0, st0 = env.state, env.steps
    traj = rollout(env, horizon=3, generator=torch.Generator().manual_seed(2))
    monkeypatch.undo()
    assert calls == ["rows_rollout_fn" if eligible else "rollout_fn"]
    _, _, want = rollout_fn(env, horizon=3)(s0, st0, torch.Generator().manual_seed(2))
    assert torch.equal(traj["rewards"], want["rewards"])


def test_tag_respawn_at_catch():
    """simple_tag with respawn_at_catch keeps the hook pipeline: the
    rewards are the JAX package's (computed before the respawn), and a
    caught good agent is moved inside the arena and stopped, the others
    step as in the JAX package."""
    env = torch_make_env("simple_tag", B, device="cpu", seed=0, fused_physics=True, respawn_at_catch=True)
    assert env._fused_outputs is None
    rng = np.random.default_rng(7)
    arrays, acts = mpe_family_state(env, rng), mpe_actions(env, rng)
    jenv = vmas_tpu.make_env("simple_tag", B, seed=0, respawn_at_catch=True)
    jenv.state = jax_state(jenv, arrays)
    _, j_rews, _, _ = jenv.step([jnp.asarray(a) for a in acts])
    env.state = state_from_numpy(env.world, arrays)
    _, rews, _, _ = env.step([torch.as_tensor(a) for a in acts])
    for i in range(env.n_agents):
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, rtol=0)
    good = env.agents[-1]
    caught = env.state.scenario["per_agent_rew"][:, good.slot] <= -10
    assert bool(caught.any()) and not bool(caught.all())
    pos, vel = env.state.pos[:, good.index], env.state.vel[:, good.index]
    assert bool((pos[caught].abs() <= 1).all()) and not bool(vel[caught].any())
    j_pos = torch.as_tensor(np.asarray(jenv.state.pos)[:, good.index])
    torch.testing.assert_close(pos[~caught], j_pos[~caught], **STATE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_reset_invariants(name):
    """The port's own reset: entities in their ranges and at rest, the goal
    indices in range, the key and secret binary, every draw spread."""
    env = torch_make_env(name, 512, device="cpu", seed=3)
    st = env.state
    assert bool((st.pos.abs() <= 1).all()) and not st.vel.any() and float(st.pos.std()) > 0.3
    sc = st.scenario
    for key in ("goal_idx", "goal_b_0", "goal_b_1"):
        if key in sc:
            assert sorted(torch.unique(sc[key]).tolist()) == list(range(len(env.world.landmarks)))
    if name == "simple_crypto":
        for key in ("key", "secret"):
            assert sc[key].shape == (512, 4) and sorted(torch.unique(sc[key]).tolist()) == [0.0, 1.0]
    if name == "simple_tag":
        lm = st.pos[:, [e.index for e in env.world.landmarks]]
        assert bool((lm.abs() <= 0.9).all()) and not sc["per_agent_rew"].any()
