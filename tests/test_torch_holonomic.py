"""The port's other holonomic worlds (reverse_transport, wheel, passage,
dispersion, dropout and the debug world het_mass, each with its emit in the
fused step), the rows rollouts' post_rewards and ``"u"`` escapes, and the
heuristic policies of transport, balance and wheel, against the JAX
package's, from injected states.

The same state, made from a seed with numpy (``testing.holonomic_state``:
in every other env the agents in contact with the hollow package's inner
walls, the wheel's line or the passage's walls and each other, on food or
on the goal), goes through the JAX function and its counterpart in the
port:

* the plain versions of the fused step (K1) and of the rows step (K2)
  with the scenario's emit against the JAX package's Pallas kernel in
  interpret mode, and one env step, on the plain path and on the fused
  step (K1's plain version), against the JAX package's unfused step with
  its hooks; each world cut on both sides where its JAX kernels compile
  slowly (reverse_transport to 2 agents, wheel to 3, passage to 18 open
  passages: 2 walls and 10 box-sphere pairs), and dispersion's shared,
  time-penalised config too;
* the recorded reference trajectories at the defaults, free-running and
  re-synced, with tests/test_scenario_parity.py's atol table and scratch
  refresh.

Then the port alone: the rows rollouts bitwise their env.step rollouts
(dispersion's post_rewards finale, dropout's per-step u), eligibility
(het_mass refused), the kernel's emit parameters with their thresholds
rounded once, the heuristic policies' actions against the JAX package's on
the same observations and driving the rows policy rollout, and the resets.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise);
observation rows atol 2e-5 rtol 1e-5; reward rows atol 2e-3 (shaping
factor 100); flags, counts and dones equal; the heuristic actions atol 1e-5
(a cos and a sin of XLA's against torch's); the rollouts bitwise.
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
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core.utils import LINE_MIN_DIST
from vmas_tpu_torch.heuristic_policy import RandomPolicy, rollout_policy
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel.rollout import (
    rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)
from vmas_tpu_torch import testing
from vmas_tpu_torch.testing import holonomic_events, holonomic_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
NAMES = ("reverse_transport", "wheel", "passage", "dispersion", "dropout", "het_mass")
ROWS = ("reverse_transport", "wheel", "passage", "dispersion", "dropout")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the configs held to the JAX package, each world cut where its JAX kernels
# compile slowly in interpret mode (reverse_transport to 2 agents, wheel to
# the JAX package's 3-agent case, passage to 2 walls: 10 box-sphere pairs,
# still in the table form of 8 pairs or more of the default's 95); and
# dispersion's shared, time-penalised case (env.step only). The defaults
# are held to the reference recordings (test_golden_replay) and, on the
# card, the kernels to their plain versions.
CONFIGS = {
    **{n: (n, {}) for n in NAMES},
    "reverse_transport": ("reverse_transport", {"n_agents": 2}),
    "wheel": ("wheel", {"n_agents": 3}),
    "passage": ("passage", {"n_passages": 18}),
    "dispersion,shared": ("dispersion", {"share_reward": True, "penalise_by_time": True}),
}
# tests/test_scenario_parity.py's tolerance, free-running horizon, scratch
# refresh and kwargs for these recordings
GOLDEN_ATOL = {"dispersion": 1e-4}
GOLDEN_T = {"passage": 10}
NO_REFRESH = ("dispersion",)
GOLDEN_KW = {"het_mass": {"mass_noise": 0}}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **{k: jnp.asarray(v) for k, v in arrays["scenario"].items()}},
    )


def _actions(env, rng):
    return [rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) for _ in env.agents]


@pytest.fixture(scope="module")
def cases():
    """Per config: (the port's fused env, the JAX package's env, the state,
    per-agent actions)."""
    out = {}
    for k, (config, (name, kw)) in enumerate(sorted(CONFIGS.items())):
        env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
        rng = np.random.default_rng(40 + k)
        out[config] = (env, vmas_tpu.make_env(name, B, seed=0, **kw), holonomic_state(env, rng), _actions(env, rng))
    return out


def _obs_rows(fo):
    """The number of emit rows that are observations (the rest: rewards,
    shapings, flags and counts)."""
    kind = type(fo).__name__
    if kind == "DispersionOutputs":
        return fo.o_just
    if kind == "HetMassOutputs":
        return 4 * fo.n_agents
    if kind == "WheelOutputs":
        return fo.n_agents * fo.obs_w
    return fo.base


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base = _obs_rows(fo)
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[base:], j_extra[base:], atol=2e-3, rtol=0, err_msg=f"{what}: other rows")


@pytest.mark.parametrize("name", NAMES)
def test_pair_buckets_and_lanes(name, cases):
    """The same entities and contact pairs as the JAX package, both fuse, and
    the lane rule: 8 lanes per env where a type has more than 3 items
    (wheel's 3 agents' 3 sphere-sphere and line-sphere pairs: one thread;
    passage's 10 and its box-sphere pairs: 8), else one thread."""
    env, jenv = cases[name][:2]
    jw = jenv.world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    for key in ("ss_a", "ss_b", "ls_line", "ls_sphere", "bs_box", "bs_sphere", "bs_not_hollow"):
        np.testing.assert_array_equal(np.asarray(getattr(env.world.spec, key)), np.asarray(getattr(jw.spec, key)))
    assert TF.supports(env.world) == JF.supports(jw) is True
    ks = TF._kernel_spec(env.world)
    items = max(len(getattr(ks, t)) for t in TF.ITEM_TYPES)
    assert ks.lanes == (8 if items > TF.FEW_ITEMS else 1)
    assert (name in ROWS) == TF.rows_step_supported(env.world, env._fused_outputs, env.agents)


@pytest.mark.parametrize("name", NAMES)
def test_fused_step_twin_matches_pallas(name, cases):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode), on a
    state with its contacts and events."""
    env, jenv, arrays, _ = cases[name]
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
    assert tfo.n_out == jfo.n_out and tfo.n_scratch_in == jfo.n_scratch_in
    j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(jax_state(jenv, arrays))
    st = state_from_numpy(env.world, arrays)
    t_state, t_extra = TF.fused_physics_step(env.world, st, tfo)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    _compare_emit(tfo, t_extra, j_extra, "fused step")
    events = holonomic_events(env, TF.state_rows(t_state), t_extra)
    assert all(v > 0 for v in events.values()), events


@pytest.mark.parametrize("name", ROWS)
def test_rows_step_twin_matches_pallas(name, cases):
    """The plain version of K2 (the action rows, the physics, the emit, the
    scratch carry) against the JAX package's rows kernel in interpret
    mode."""
    env, jenv, arrays, acts = cases[name]
    tfo, jfo = env._fused_outputs, jenv.scenario.make_fused_outputs(jenv.world)
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


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_env_step_matches_jax(config, fused, cases, jax_steps):
    """One env step from the injected state, on the plain path or the fused
    step, against the JAX package's: state, observations, rewards, dones
    and the scratch the next step reads."""
    name, kw = CONFIGS[config]
    _, _, arrays, acts = cases[config]
    j_state, j_obs, j_rews, j_dones = jax_steps[config]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused, **kw)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    assert (env._fused_outputs is not None) == fused
    for field in FIELDS:
        np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    np.testing.assert_array_equal(env.state.rendering.numpy(), np.asarray(j_state.rendering))
    for i in range(env.n_agents):
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]).reshape(B), atol=2e-3, rtol=0,
                                   err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    for key, val in env.state.scenario.items():
        want = np.asarray(j_state.scenario[key])
        if val.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
        else:
            np.testing.assert_allclose(val.numpy(), want, atol=2e-3, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's plain version, free-running (10
    steps for passage, as tests/test_scenario_parity.py) and then re-synced
    to the recorded state before each step, after the same one-cycle
    scratch refresh; passage's re-synced replay allows one env a step to
    fork on a knife-edge contact term, as the JAX package's does."""
    d = np.load(GOLDEN.format(name))
    nb, atol = d["init_pos"].shape[0], GOLDEN_ATOL.get(name, 2e-3)
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True, **GOLDEN_KW.get(name, {}))
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert env._fused_outputs is not None

    def inject(pos, vel, rot, ang_vel, scratch):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque), scenario=scratch)

    def close(a, ref, tol, msg, cap=1.0):
        # as tests/test_scenario_parity.py: in the re-synced replay of the
        # stiff-contact set (passage) one env a step may fork on a
        # knife-edge contact term, within a cap
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)
        assert per_env.max() <= cap, f"{msg}: max error {per_env.max():.4f} beyond the cap"
        assert int((per_env > tol).sum()) <= n_chaotic, f"{msg}: envs {np.flatnonzero(per_env > tol)} beyond {tol}"

    scratch0 = dict(env.state.scenario)
    for resync in (False, True):
        n_chaotic = 1 if resync and name in GOLDEN_T else 0
        state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], dict(scratch0))
        if name not in NO_REFRESH:
            state = env.scenario.post_rewards(env.scenario.pre_rewards(state))
        env.state = state
        T = d["actions"].shape[0] if resync else GOLDEN_T.get(name, d["actions"].shape[0])
        for t in range(T):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state.scenario)
            acts = [torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            close(env.state.rot, d["rot"][t], 10 * atol, f"rot, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")
                close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}], {tag}", cap=25.0)
            assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"done, {tag}"


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_kernel_emit_params(config, cases):
    """Each emit's kernel parameters: its kind, its member of the union
    filled, each threshold the JAX package compares against a double
    expression of, rounded once to f32, and the scratch carry map; the
    by-value parameters within 4 KB."""
    name = CONFIGS[config][0]
    env = cases[config][0]
    fo, sc = env._fused_outputs, env.scenario
    kind, ep = fo.kernel_emit()
    assert kind == getattr(K, "EMIT_" + name.upper())
    p = getattr(ep, name)
    agents = env.world.agents
    assert p.n_agents == len(agents) and [p.agent[i] for i in range(len(agents))] == [a.index for a in agents]
    if name == "reverse_transport":
        assert p.og_dmin == np.float32(0.09 + LINE_MIN_DIST) and p.hw == p.hl == np.float32(0.3)
    if name == "passage":
        assert p.two_r == np.float32(2 * 0.03333) and p.wall_dmin == np.float32(0.03333 + LINE_MIN_DIST)
        assert p.half_r == np.float32(0.03333 / 2)
        assert [p.wall[k] for k in range(p.n_walls)] == [q.index for q in sc.passages if q.collide]
        assert [p.open[k] for k in range(p.n_open)] == [q.index for q in sc.passages if not q.collide]
    if name == "dispersion":
        assert [p.eat_r[i] for i in range(len(agents))] == [np.float32(0.035 + 0.05)] * len(agents)
        assert (p.share, p.by_time) == (fo.share, fo.by_time)
    if name == "dropout":
        assert [p.eat_r[i] for i in range(len(agents))] == [np.float32(0.05 + 0.03)] * len(agents)
    carry = [ep.carry_idx[k] for k in range(fo.n_scratch_in)]
    assert carry == [-1 if ei is None else ei for ei in getattr(fo, "carry_extra_idx", ())][:fo.n_scratch_in]
    members = [f[1] for f in K._EmitUnion._fields_]
    assert ctypes.sizeof(K.EmitParams) == 4 * K.MAX_K + max(ctypes.sizeof(m) for m in members)
    by_value = ctypes.sizeof(K.FusedSpec) + ctypes.sizeof(K.EmitParams) + ctypes.sizeof(K.ActParams)
    assert by_value + 5 * 8 + 3 * 4 <= 4096


ROLLOUT_CONFIGS = {
    **{n: (n, {}) for n in ROWS},
    "passage,shared": ("passage", {"n_passages": 2, "shared_reward": True}),
    "dispersion,shared": ("dispersion", {"share_reward": True, "penalise_by_time": True}),
    "dropout,discrete": ("dropout", {"continuous_actions": False}),
}


def _rollouts_equal(sa, ta, sb, tb):
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rot", "ang_vel", "force", "rendering"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    assert sa.scenario.keys() == sb.scenario.keys()
    assert all(torch.equal(sa.scenario[k], sb.scenario[k]) for k in sa.scenario)


@pytest.mark.parametrize("config", sorted(ROLLOUT_CONFIGS))
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollout against rollout_fn (the env's own step on the fused
    step) from a state with events, bitwise: rewards, dones, observations,
    the final state with its u, rendering and scratch. dispersion's
    post_rewards runs once, on the final state (the eaten merge, just_eaten
    zeroed, the food's rendering); dropout's unpack reads each step's
    decoded u (its energy term)."""
    name, kw = ROLLOUT_CONFIGS[config]
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env)
    s0 = state_from_numpy(env.world, holonomic_state(env, np.random.default_rng(9)))
    st0 = env.steps
    sa, ta_steps, ta = rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    sb, tb_steps, tb = rows_rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    assert tb["rewards"].shape == (5, 16, env.n_agents) and torch.equal(ta_steps, tb_steps)
    _rollouts_equal(sa, ta, sb, tb)
    assert not torch.equal(sb.pos, s0.pos)
    if name == "dispersion":
        assert bool(sb.scenario["eaten"].any()) and not bool(sb.scenario["just_eaten"].any())
        foods = [f.index for f in env.world.landmarks]
        assert torch.equal(sb.rendering[:, foods], ~sb.scenario["eaten"])
    if name == "dropout":
        # the energy term moves with the actions, step by step
        assert bool((tb["rewards"][1:] != tb["rewards"][:-1]).any())
        assert torch.equal(sb.rendering[:, env.scenario.goal.index], ~sb.scenario["eaten"])


@pytest.mark.parametrize("name,kw,eligible", [
    ("reverse_transport", {}, True),
    ("wheel", {}, True),
    ("passage", {}, True),
    ("dispersion", {}, True),
    ("dropout", {}, True),
    ("het_mass", {}, False),
])
def test_rows_rollout_supported(name, kw, eligible, monkeypatch):
    """The five worlds with a scratch carry are rows-eligible (dispersion's
    and dropout's post_rewards declared safe, dropout's u read); het_mass is
    not (its process_action runs outside the kernel); noisy actions are
    eligible too (the rows paths draw the steps' noise streams as env.step
    does); ``rollout()`` takes the rows path where eligible, with noisy
    actions, and ``rollout_fn`` elsewhere, with the same trajectory."""
    env = torch_make_env(name, 8, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) is eligible
    if eligible:
        env.agents[-1].u_noise_array = np.full_like(env.agents[-1].u_noise_array, 0.1)
        assert rows_rollout_supported(env)
        paths, traj, want = testing.rollout_path_and_reference(env, 3, 2)
        assert paths == ["rows_rollout_fn"] and testing.same_trajectory(traj, want)
    else:
        with pytest.raises(AssertionError, match="post_rewards_rollout_safe"):
            rows_rollout_fn(env, horizon=2)
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


HEURISTICS = {"transport": (11, {"n_agents": 3}), "balance": (16, {}), "wheel": (13, {})}


@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_heuristic_policy_matches_jax(name):
    """The scenario's HeuristicPolicy against the JAX package's on the same
    observations (random, at the scenario's observation width), with each
    u_range the JAX package's tests drive it with; balance's discrete form
    too."""
    import importlib

    obs_w = HEURISTICS[name][0]
    obs = np.random.default_rng(5).uniform(-1.0, 1.0, (64, obs_w)).astype(np.float32)
    mine = importlib.import_module(f"vmas_tpu_torch.scenarios.{name}").HeuristicPolicy
    ref = importlib.import_module(f"vmas_tpu.scenarios.{name}").HeuristicPolicy
    for u_range in (1.0, 0.5):
        got = mine(True).compute_action(torch.as_tensor(obs), u_range)
        want = ref(True).compute_action(jnp.asarray(obs), u_range)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert bool((got != 0).any())
    if name == "balance":
        np.testing.assert_array_equal(mine(False).compute_action(torch.as_tensor(obs), 1.0).numpy(),
                                      np.asarray(ref(False).compute_action(jnp.asarray(obs), 1.0)))


@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_heuristic_policy_drives_rows_rollout(name):
    """Each heuristic policy drives rows_policy_rollout_fn (one K2 step per
    env step), bitwise the env.step policy rollout; the RandomPolicy's draws
    lie in the u_range."""
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **HEURISTICS[name][1])
    mod = sys.modules[type(env.scenario).__module__]
    policy = rollout_policy(env, mod.HeuristicPolicy(True))
    s0, st0 = env.state, env.steps
    sa, _, ta = rollout_fn(env, policy, horizon=5)(s0, st0, torch.Generator().manual_seed(3))
    sb, _, tb = rows_policy_rollout_fn(env, policy, horizon=5)(s0, st0, torch.Generator().manual_seed(3))
    _rollouts_equal(sa, ta, sb, tb)
    assert not torch.equal(sb.pos, s0.pos)
    u = RandomPolicy(True).compute_action(ta["obs"][0][0], 0.7)
    assert u.shape == (16, 2) and bool((u.abs() <= 0.7).all()) and float(u.std()) > 0.1


@pytest.mark.parametrize("name", NAMES)
def test_reset_invariants(name):
    """The port's own reset: the JAX package's ranges and layouts (agents
    inside the hollow package, the cross of 5 and the wall of boxes at y =
    0, agents at the origin and food in the arena, entities at least the
    spawn distance apart), each draw spread, the scratch zeroed."""
    env = torch_make_env(name, 256, device="cpu", seed=3)
    st, sc = env.state, env.scenario
    # the hollow package reaches 0.3 beyond the arena it is placed in
    assert bool((st.pos.abs() <= (1.3 if name == "reverse_transport" else 1.0) + 1e-6).all())
    assert not st.vel.any()
    agents = [a.index for a in env.world.agents]
    if name == "reverse_transport":
        rel = st.pos[:, agents] - st.pos[:, sc.package.index][:, None]
        assert bool((rel.abs() <= 0.3 - 0.03 + 1e-6).all())
    if name == "wheel":
        rot = st.rot[:, sc.line.index]
        assert bool((rot.abs() <= np.pi / 2).all()) and float(rot.std()) > 0.5
    if name == "passage":
        walls = [p.index for p in sc.passages]
        assert not st.pos[:, walls, 1].any() and float(st.pos[:, walls, 0].std()) > 0.3
        assert bool((st.pos[:, agents, 1] < 0).all())
        assert bool((st.pos[:, [a.goal.index for a in env.world.agents], 1] > 0).all())
    if name == "dispersion":
        assert not st.pos[:, agents].any()
        assert not st.scenario["eaten"].any() and bool(st.rendering.all())
    if name == "dropout":
        d = torch.linalg.vector_norm(st.pos[:, agents] - st.pos[:, [sc.goal.index]], dim=-1)
        assert bool((d >= 0.09 - 1e-6).all()) and not st.scenario["eaten"].any()
    if name == "het_mass":
        rng = np.random.RandomState(0)
        assert [a.mass for a in env.world.agents] == [float(4 + rng.uniform(-1, 1)), float(2 + rng.uniform(-1, 1))]
    assert float(st.pos[:, agents].std()) > 0.2 or name == "dispersion"
