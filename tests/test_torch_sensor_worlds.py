"""The port's sensor worlds (navigation, flocking and discovery, each with
its emit in the fused step) against the JAX package's, from injected
states (the debug world pollock: tests/test_torch_sensors.py).

The same state, made from a seed with numpy (``testing.sensor_state``: in
every other env agents just clear of each other, flocking's target beside
an agent and an agent near an obstacle, discovery's target 0 covered by two
agents; in every fourth env navigation's agents at rest on their goals),
goes through the JAX function and its counterpart in the port:

* the plain versions of the fused step (K1) and of the rows step (K2, with
  flocking's target on the action rows) with the scenario's emit against
  the JAX package's Pallas kernel in interpret mode, with the events
  counted (``testing.sensor_events``);
* one env step, on the plain path and on the fused step, against the JAX
  package's unfused step with its hooks, the configurations of the JAX
  package's tests/test_fused.py; discovery's respawned targets are drawn
  from other streams in the two packages, so their positions, and the
  Lidar of the envs where one respawned, are left out, and held instead to
  the respawn's rules;
* the recorded reference trajectories, free-running and re-synced, with
  tests/test_scenario_parity.py's atol table and scratch refresh.

Then discovery's Lidar after the respawn on both paths, the emits' kernel
parameters, the heuristic policies against the JAX package's on the same
observations, and the resets.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise); emit and
observation rows atol 2e-5 rtol 1e-5; reward and shaping rows atol 2e-3;
flags, counts and dones equal; the heuristic actions atol 1e-5 (60
bisection steps of the same residual: atol 1e-4 for navigation's).
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
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.testing import sensor_events, sensor_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the JAX package's tests/test_fused.py configurations of these worlds
CONFIGS = {
    "navigation": ("navigation", {}),
    "navigation,all_goals": ("navigation", {"shared_rew": False, "observe_all_goals": True}),
    "flocking": ("flocking", {}),
    "discovery": ("discovery", {}),
    "discovery,penalty": ("discovery", {"shared_reward": True, "agent_collision_penalty": -1.0,
                                        "targets_respawn": False}),
}
ROWS = ("navigation", "navigation,all_goals", "flocking")


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **{k: jnp.asarray(v) for k, v in arrays["scenario"].items()}},
    )


@pytest.fixture(scope="module")
def cases():
    """Per config: (the port's fused env, the JAX package's env, the state,
    per-agent actions)."""
    out = {}
    for k, (config, (name, kw)) in enumerate(sorted(CONFIGS.items())):
        env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
        rng = np.random.default_rng(60 + k)
        acts = [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]
        out[config] = (env, vmas_tpu.make_env(name, B, seed=0, **kw), sensor_state(env, rng), acts)
    return out


def _obs_rows(fo):
    """The number of emit rows that are observations."""
    return 4 * fo.n_agents if type(fo).__name__ == "DiscoveryOutputs" else fo.base


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base = _obs_rows(fo)
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[base:], j_extra[base:], atol=2e-3, rtol=0, err_msg=f"{what}: other rows")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pair_buckets_and_lanes(config, cases):
    """The same entities and contact pairs as the JAX package, both fuse,
    8 lanes per env (more than 3 sphere-sphere pairs), and the rows step
    takes navigation and flocking (its target's script declared) and not
    discovery (no scratch carry)."""
    env, jenv = cases[config][:2]
    jw = jenv.world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    for key in ("ss_a", "ss_b", "movable", "is_agent"):
        np.testing.assert_array_equal(np.asarray(getattr(env.world.spec, key)), np.asarray(getattr(jw.spec, key)))
    assert TF.supports(env.world) == JF.supports(jw) is True
    assert TF._kernel_spec(env.world).lanes == 8
    jfo = jenv.scenario.make_fused_outputs(jw)
    assert TF.rows_step_supported(env.world, env._fused_outputs, env.agents) == JF.rows_step_supported(
        jw, jfo, jenv.agents) == (config in ROWS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_step_twin_matches_pallas(config, cases):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode), on
    a state with the world's events."""
    env, jenv, arrays, _ = cases[config]
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
    assert tfo.n_out == jfo.n_out and tfo.n_scratch_in == jfo.n_scratch_in
    j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(jax_state(jenv, arrays))
    t_state, t_extra = TF.fused_physics_step(env.world, state_from_numpy(env.world, arrays), tfo)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    _compare_emit(tfo, t_extra, j_extra, "fused step")
    events = sensor_events(env, TF.state_rows(t_state), t_extra)
    assert all(v > 0 for v in events.values()), events


@pytest.mark.parametrize("config", ROWS)
def test_rows_step_twin_matches_pallas(config, cases):
    """The plain version of K2 (the action rows, flocking's target's too,
    the physics, the emit, the scratch carry) against the JAX package's
    rows kernel in interpret mode."""
    env, jenv, arrays, acts = cases[config]
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
    slots = [a.index for a in env.agents] + list(getattr(tfo, "script_slots", ()))
    assert slots == [a.index for a in jenv.agents] + list(getattr(jfo, "script_slots", ()))
    js = jax_state(jenv, arrays)
    us = list(acts)
    if hasattr(tfo, "script_us"):
        # the target's u at this step, against the JAX package's script
        us += [u[0].numpy() for u in tfo.script_us(state_from_numpy(env.world, arrays), 1)]
        np.testing.assert_allclose(us[-1], np.asarray(jfo.script_us(js, 1)[0][0]), atol=1e-6, rtol=0)
    act = np.concatenate([np.stack([u[:, 0] for u in us]), np.stack([u[:, 1] for u in us])]).astype(np.float32)
    bp = 128
    jact = np.zeros((-(-act.shape[0] // 8) * 8, bp), np.float32)
    jact[:act.shape[0], :B] = act
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    carry = TF.pack_carry(env.world, state_from_numpy(env.world, arrays), tfo)
    tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
    assert tc.shape == jc.shape and te.shape == je.shape == (tfo.n_out, B)
    np.testing.assert_allclose(tc.numpy(), jc, **STATE_TOL, err_msg="carry rows")
    _compare_emit(tfo, te, je, "rows step")


@pytest.fixture(scope="module")
def jax_steps(cases):
    """Per config: the JAX package's env.step (hooks) from the injected
    state: (state, obs, rews, dones)."""
    out = {}
    for config in CONFIGS:
        _, jenv, arrays, acts = cases[config]
        jenv.state = jax_state(jenv, arrays)
        obs, rews, dones, _ = jenv.step([jnp.asarray(a) for a in acts])
        out[config] = (jenv.state, obs, rews, dones)
    return out


def _respawned(env, state):
    """discovery's covered targets, [B, T] bool, and the envs where one
    respawned."""
    covered = state.scenario["covered_targets"].numpy()
    return covered, covered.any(-1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_env_step_matches_jax(config, fused, cases, jax_steps):
    """One env step from the injected state, on the plain path or the fused
    step, against the JAX package's: state, observations, rewards, dones
    and the scratch. In discovery the covered targets' new positions (and
    the Lidar where one moved) are the respawn's draws: held to its rules
    instead (clear of every agent and other target, within the arena; far
    outside it with ``targets_respawn=False``)."""
    name, kw = CONFIGS[config]
    _, _, arrays, acts = cases[config]
    j_state, j_obs, j_rews, j_dones = jax_steps[config]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused, **kw)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    assert (env._fused_outputs is not None) == fused
    keep = np.ones((B, len(env.world.entities)), bool)
    same_env = np.ones(B, bool)
    if name == "discovery":
        covered, moved = _respawned(env, env.state)
        assert covered.any() and np.array_equal(covered, np.asarray(j_state.scenario["covered_targets"]))
        targets = [t.index for t in env.scenario._targets]
        keep[:, targets] = ~covered
        same_env = ~moved
        pos = env.state.pos.numpy()
        if kw.get("targets_respawn", True):
            for k, ti in enumerate(targets):
                m = covered[:, k]
                assert bool((np.abs(pos[m, ti]) <= 1).all())
        else:
            assert bool((pos[:, targets][covered] <= -10).all())
    for field in FIELDS:
        got, want = getattr(env.state, field).numpy(), np.asarray(getattr(j_state, field))
        np.testing.assert_allclose(got[keep], want[keep], **STATE_TOL, err_msg=field)
    for i in range(env.n_agents):
        o, jo = obs[i].numpy(), np.asarray(j_obs[i])
        np.testing.assert_allclose(o[same_env], jo[same_env], atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(o[:, :4], jo[:, :4], atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]).reshape(B), atol=2e-3, rtol=0,
                                   err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    assert set(env.state.scenario) == set(j_state.scenario) - {"rng", "__obs_key"}
    for key, val in env.state.scenario.items():
        want = np.asarray(j_state.scenario[key])
        if val.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
        else:
            np.testing.assert_allclose(val.numpy(), want, atol=2e-3, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["navigation", "flocking", "discovery"])
def test_interop_carries_jax_states(name, cases):
    """A JAX package's state, as numpy arrays, into the port
    (``interop.state_from_numpy``): every field and the scratch dict
    carried bitwise, but discovery's PRNG key (``rng``: the port draws its
    respawn from the env's generator), and the port steps on from it."""
    from vmas_tpu_torch.interop import state_to_numpy

    js = cases[name][1].state
    arrays = {f: np.asarray(getattr(js, f)) for f in ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "uc",
                                                       "joint_fixed_rot", "rendering")}
    arrays["u"] = [np.asarray(u) for u in js.u]
    arrays["scenario"] = {k: np.asarray(v) for k, v in js.scenario.items()}
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True)
    st = state_from_numpy(env.world, arrays)
    back = state_to_numpy(st)
    for f in ("pos", "vel", "rot", "force", "rendering"):
        assert np.array_equal(back[f], arrays[f]), f
    assert set(back["scenario"]) == set(arrays["scenario"]) - {"rng"}
    assert ("rng" in arrays["scenario"]) == (name == "discovery")
    for k, v in back["scenario"].items():
        assert np.array_equal(v, arrays["scenario"][k]), k
    env.state = st
    obs = env.step(env.get_random_actions())[0]
    assert all(bool(torch.isfinite(o).all()) for o in obs)


GOLDEN_CASES = {
    "navigation": {},
    "flocking": {},
    "discovery": {},
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_replay(name):
    """The recorded reference trajectory (16 envs) through the port's
    env.step, on the fused step's plain version, free-running and then
    re-synced to the recorded state before each step, after
    tests/test_scenario_parity.py's one-cycle scratch refresh (flocking's
    clock kept at 0). discovery's covered targets respawn from other draws
    than the reference's: an env where one did is left out of the
    comparison from then on (and for its step in the re-synced replay)."""
    d = np.load(GOLDEN.format(name))
    nb = d["init_pos"].shape[0]
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True, **GOLDEN_CASES[name])
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert env._fused_outputs is not None

    def inject(pos, vel, rot, ang_vel, scratch):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque), scenario=scratch)

    def close(a, ref, tol, msg, cap=1.0):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)[live]
        assert per_env.max(initial=0) <= cap, f"{msg}: max error {per_env.max():.4f} beyond the cap"
        assert int((per_env > tol).sum()) <= n_chaotic, f"{msg}: {int((per_env > tol).sum())} envs beyond {tol}"

    scratch0 = dict(env.state.scenario)
    atol = 2e-3
    respawns = 0
    for resync in (False, True):
        n_chaotic = 0
        state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], dict(scratch0))
        keep = {k: state.scenario[k] for k in ("t",) if k in state.scenario}
        state = env.scenario.post_rewards(env.scenario.pre_rewards(state))
        env.state = state.replace(scenario={**state.scenario, **keep})
        T = d["actions"].shape[0]
        live = np.ones(nb, bool)
        for t in range(T):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state.scenario)
                live = np.ones(nb, bool)
            acts = [torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)]
            obs, rews, dones, _ = env.step(acts)
            if name == "discovery":
                moved = env.state.scenario["covered_targets"].numpy().any(-1)
                respawns += int(moved.sum())
                live &= ~moved
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            close(env.state.rot, d["rot"][t], 10 * atol, f"rot, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")
                close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}], {tag}", cap=25.0)
            assert int((dones.numpy() != d["done"][t])[live].sum()) <= n_chaotic, f"done, {tag}"
    assert name != "discovery" or respawns < nb


def test_discovery_obs_after_respawn():
    """Covered targets respawn in post_rewards, and the Lidar part of the
    observation sees the world after the respawn on the fused path as on
    the hook pipeline (the JAX package's
    test_fused_discovery_obs_after_respawn): every agent parked on target
    0 (here around it, 0.15 from its centre, where their Lidar sees it), the
    respawn drawn from the same step stream on both paths."""
    kw = dict(n_agents=4, n_targets=2)
    env_x = torch_make_env("discovery", 3, device="cpu", seed=0, **kw)
    env_f = torch_make_env("discovery", 3, device="cpu", seed=0, fused_physics=True, **kw)
    assert env_f._fused_outputs is not None
    t0 = env_x.scenario._targets[0]
    for env in (env_x, env_f):
        pos = env.state.pos.clone()
        for k, a in enumerate(env.agents):
            pos[:, a.index] = pos[:, t0.index] + 0.15 * torch.tensor([np.cos(k * np.pi / 2), np.sin(k * np.pi / 2)])
        env.state = env.state.replace(pos=pos)
    before = env_f.state.pos[:, t0.index].clone()
    acts = [torch.zeros((3, 2)) for _ in env_x.agents]
    obs_x, rews_x = env_x.step(acts)[:2]
    obs_f, rews_f = env_f.step(acts)[:2]
    assert bool(env_x.state.scenario["covered_targets"][:, 0].all())
    assert not bool((env_f.state.pos[:, t0.index] == before).any())
    torch.testing.assert_close(env_f.state.pos, env_x.state.pos, atol=1e-5, rtol=0)
    for i in range(len(obs_x)):
        np.testing.assert_allclose(obs_f[i].numpy(), obs_x[i].numpy(), atol=2e-5, err_msg=f"obs[{i}]")
        np.testing.assert_allclose(rews_f[i].numpy(), rews_x[i].numpy(), atol=2e-3)
    # the Lidar reads the respawned target: on the state before the
    # respawn it would read another world
    fo = env_f._fused_outputs
    pos = env_f.state.pos.clone()
    pos[:, t0.index] = before
    stale = fo.finish_obs(tuple(o[:, :4] for o in obs_f), env_f.state.replace(pos=pos))
    assert not torch.equal(stale[0], obs_f[0])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_kernel_emit_params(config, cases):
    """Each emit's kernel parameters: its kind, its member of the union
    filled (the thresholds rounded once to f32), the scratch carry map and
    the by-value parameters within 4 KB."""
    name = CONFIGS[config][0]
    env = cases[config][0]
    fo, sc = env._fused_outputs, env.scenario
    kind, ep = fo.kernel_emit()
    assert kind == getattr(K, "EMIT_" + name.upper())
    p = getattr(ep, name)
    A = fo.n_agents
    assert p.n_agents == A
    if name == "navigation":
        agents = env.world.agents
        assert [p.agent[i] for i in range(A)] == [a.index for a in agents]
        assert [p.goal[i] for i in range(A)] == [a.goal.index for a in agents]
        assert [p.done_r[i] for i in range(A)] == [np.float32(0.1)] * A
        assert [p.pair_mask[i] for i in range(A)] == [(1 << i) - 1 for i in range(A)]
        assert p.min_coll == np.float32(0.005) and p.all_goals == fo.all_goals
    if name == "flocking":
        assert p.n_all == A + 1 and p.target == sc._target.index
        assert [p.slot[k] for k in range(A + 1)] == [-1] + list(range(A))
        assert p.desired == np.float32(0.1) and p.coll_rew == np.float32(-0.1)
    if name == "discovery":
        assert p.n_targets == len(sc._targets) and [p.target[k] for k in range(p.n_targets)] == fo.target_i
        assert p.cover_r == np.float32(0.25) and p.per_target == 2.0 and p.with_coll == (fo.coll_pen != 0)
    carry = [ep.carry_idx[k] for k in range(fo.n_scratch_in)]
    assert carry == list(getattr(fo, "carry_extra_idx", ()))
    members = [f[1] for f in K._EmitUnion._fields_]
    assert ctypes.sizeof(K.EmitParams) == 4 * K.MAX_K + max(ctypes.sizeof(m) for m in members)
    by_value = ctypes.sizeof(K.FusedSpec) + ctypes.sizeof(K.EmitParams) + ctypes.sizeof(K.ActParams)
    assert by_value + 5 * 8 + 3 * 4 <= 4096


HEURISTICS = {"navigation": 18, "flocking": 18, "discovery": 19, "discovery,agent_lidar": 31}


@pytest.mark.parametrize("case", sorted(HEURISTICS))
def test_heuristic_policy_matches_jax(case):
    """The scenario's HeuristicPolicy against the JAX package's on the same
    observations (random at the scenario's observation width, the Lidar
    columns in its range so that some rays see something), at two
    u_ranges."""
    import importlib

    name, obs_w = case.split(",")[0], HEURISTICS[case]
    rng = np.random.default_rng(obs_w)
    obs = rng.uniform(-1.0, 1.0, (256, obs_w)).astype(np.float32)
    lo = {"navigation": 18, "flocking": 6, "discovery": 4}[name]
    obs[:, lo:] = rng.uniform(0.0, 0.4, (256, obs_w - lo))
    mine = importlib.import_module(f"vmas_tpu_torch.scenarios.{name}").HeuristicPolicy
    ref = importlib.import_module(f"vmas_tpu.scenarios.{name}").HeuristicPolicy
    for u_range in (1.0, 0.5):
        got = mine(True).compute_action(torch.as_tensor(obs), u_range)
        want = ref(True).compute_action(jnp.asarray(obs), u_range)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4 if name == "navigation" else 1e-5,
                                   rtol=0)
        assert bool((got != 0).any()) and bool((got.abs() < u_range).any())


@pytest.mark.parametrize("name", ["navigation", "flocking", "discovery"])
def test_reset_invariants(name):
    """The port's own reset: the JAX package's ranges and layouts (the
    entities within the spawning square and at least the spawn distance
    apart, flocking's target at (0, -1)), each draw spread, the scratch at
    its start values."""
    env = torch_make_env(name, 128, device="cpu", seed=3)
    st, sc = env.state, env.scenario
    assert bool((st.pos.abs() <= 1 + 1e-6).all()) and not st.vel.any()
    ents = env.world.agents if name != "discovery" else env.world.agents + sc._targets
    P = st.pos[:, [e.index for e in ents]]
    d = torch.linalg.vector_norm(P[:, :, None] - P[:, None], dim=-1) + torch.eye(len(ents)) * 9
    min_d = {"navigation": 0.25, "flocking": 0.15, "discovery": 0.2}[name]
    assert float(d.min()) >= min_d - 1e-5 or name == "flocking"
    assert float(P.std()) > 0.3
    if name == "navigation":
        G = st.pos[:, [a.goal.index for a in env.world.agents]]
        assert float(G.std()) > 0.3 and not st.scenario["collision_rew"].any()
    if name == "flocking":
        assert torch.equal(st.pos[:, sc._target.index], torch.tensor([0.0, -1.0]).expand(128, 2))
        assert not st.scenario["t"].any() and bool((st.scenario["distance_shaping"] > 0).all())
    if name == "discovery":
        assert not st.scenario["covered_targets"].any() and "rng" not in st.scenario
