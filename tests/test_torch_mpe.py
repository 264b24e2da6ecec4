"""The port's MPE simple and simple_spread (vmas_tpu_torch/scenarios/mpe and
their emits in the fused step) against the JAX package's, from injected
states.

simple: one agent, one landmark, no contact pair (the fused step's empty
pair table); simple_spread: 3 agents of radius 0.15 and 3 landmarks, 3
sphere-sphere pairs, one shared reward, the original VMAS paper's speed
protocol with discrete actions. The same state, made from a seed with numpy
(``testing.mpe_state``: agents 0 and 1 overlapping in every other env),
goes through the JAX function and its counterpart in the port:

* the plain versions of the fused step (K1) and of the rows step (K2) with
  the scenario's emit against the JAX package's Pallas kernel in interpret
  mode;
* one env step, on the plain path and on the fused step;
* the recorded reference trajectories, free-running and re-synced.

Then the port alone: the emit against the scenario's hooks, the env.step
rollout against the rows rollout with continuous, discrete and
multidiscrete actions (tests/test_rows_rollout.py's protocol), rows-rollout
eligibility, the kernel's emit parameters and the reset.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise);
observation rows atol 2e-5; reward rows atol 2e-3; the two rollouts of the
port bitwise; the golden replays at tests/test_scenario_parity.py's atol
for these scenarios, 2e-3 (velocities, observations and rewards 10x).
"""

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
from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported
from vmas_tpu_torch.scenarios.mpe.simple import index_run
from vmas_tpu_torch.testing import mpe_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
NAMES = ("simple", "simple_spread")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **{k: jnp.asarray(v) for k, v in arrays["scenario"].items()}},
    )


@pytest.fixture(scope="module")
def cases():
    """Per scenario: (the port's fused env, the state, per-agent actions)."""
    out = {}
    for k, name in enumerate(NAMES):
        env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True)
        rng = np.random.default_rng(40 + k)
        out[name] = (env, mpe_state(env, rng), [rng.uniform(-1, 1, (B, 2)).astype(np.float32) for _ in env.agents])
    return out


def _compare_emit(fo, t_extra, j_extra, what):
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    np.testing.assert_allclose(t_extra[:fo.base], j_extra[:fo.base], atol=2e-5, rtol=1e-5,
                               err_msg=f"{what}: obs rows")
    np.testing.assert_allclose(t_extra[fo.base:], j_extra[fo.base:], atol=2e-3, rtol=0,
                               err_msg=f"{what}: reward rows")


@pytest.mark.parametrize("name", NAMES)
def test_pair_buckets_and_supports(name, cases):
    """The same entities and contact pairs as the JAX package: simple none
    (the kernel's table holds no pair record, only the lane lists, 8 words
    per entity and no entry, and the per-entity constants, 16 words per
    entity), simple_spread three sphere-sphere pairs (each agent's list
    holds its two); both fuse, as in the JAX package."""
    env = cases[name][0]
    jw = vmas_tpu.make_env(name, 2, seed=0).world
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    ks = TF._kernel_spec(env.world)
    n_ss = {"simple": 0, "simple_spread": 3}[name]
    assert len(ks.ss) == n_ss and not (ks.ls or ks.ll or ks.bs or ks.bl or ks.bb or ks.joints)
    np.testing.assert_array_equal(np.asarray(env.world.spec.ss_a), np.asarray(jw.spec.ss_a))
    assert TF.supports(env.world) == JF.supports(jw) is True
    table = ks.pair_table("cpu")
    n_entries = {"simple": 0, "simple_spread": 6}[name]
    assert ks.table_offsets[-1] == 3 * n_ss
    assert ks.ent_offset == 3 * n_ss + 8 * ks.E + n_entries
    assert table.numel() == 3 * n_ss + 8 * ks.E + n_entries + 16 * ks.E and table.dtype == torch.int32


@pytest.mark.parametrize("name", NAMES)
def test_fused_step_twin_matches_pallas(name, cases):
    """The plain version of K1 with the scenario's emit against the JAX
    package's fused_physics_step (the Pallas kernel in interpret mode)."""
    env, arrays, _ = cases[name]
    jenv = vmas_tpu.make_env(name, B, seed=0, fused_physics=True)
    jfo, tfo = jenv._fused_outputs, env._fused_outputs
    assert (tfo.n_out, tfo.base) == (jfo.n_out, tfo.n_agents * tfo.obs_w)
    j_state, j_extra = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s, jfo))(jax_state(jenv, arrays))
    ts = state_from_numpy(env.world, arrays)
    t_state, t_extra = TF.fused_physics_step(env.world, ts, tfo)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field)),
                                   **STATE_TOL, err_msg=field)
    _compare_emit(tfo, t_extra, j_extra, "fused step")


@pytest.mark.parametrize("name", NAMES)
def test_rows_step_twin_matches_pallas(name, cases):
    """The plain version of K2 (the action rows, the physics, the emit)
    against the JAX package's rows kernel in interpret mode."""
    env, arrays, acts = cases[name]
    jenv = vmas_tpu.make_env(name, B, seed=0, fused_physics=True)
    jfo, tfo = jenv._fused_outputs, env._fused_outputs
    slots = [a.index for a in env.agents]
    act = np.concatenate([np.stack([a[:, 0] for a in acts]), np.stack([a[:, 1] for a in acts])])
    bp = 128
    jact = np.zeros((act.shape[0], bp), np.float32)
    jact[:, :B] = act
    js = jax_state(jenv, arrays)
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    carry = TF.pack_carry(env.world, state_from_numpy(env.world, arrays), tfo)
    tc, te = TF.rows_step_plain(env.world, tfo, slots, carry, torch.as_tensor(act))
    E = len(env.world.entities)
    assert tc.shape == jc.shape == (9 * E, B) and te.shape == je.shape == (tfo.n_out, B)
    np.testing.assert_allclose(tc.numpy(), jc, **STATE_TOL, err_msg="state rows")
    _compare_emit(tfo, te, je, "rows step")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_env_step_matches_jax(name, fused, cases):
    """One env step from the injected state, on the plain path or the
    fused step: state, observations, rewards and dones."""
    _, arrays, acts = cases[name]
    jenv = vmas_tpu.make_env(name, B, seed=0)
    jenv.state = jax_state(jenv, arrays)
    j_obs, j_rews, j_dones, _ = jenv.step([jnp.asarray(a) for a in acts])
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, _ = env.step([torch.as_tensor(a) for a in acts])
    for field in FIELDS:
        np.testing.assert_allclose(getattr(env.state, field).numpy(), np.asarray(getattr(jenv.state, field)),
                                   **STATE_TOL, err_msg=field)
    for i in range(env.n_agents):
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, rtol=0, err_msg="reward")
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))


@pytest.mark.parametrize("name", NAMES)
def test_emit_matches_scenario_hooks(name, cases):
    """The fused step's emit rows, unpacked, against pre_rewards, reward
    and observation on the plain path's post-step state; simple_spread's
    collision penalty acts in the overlapping envs."""
    _, arrays, acts = cases[name]
    envs = [torch_make_env(name, B, device="cpu", seed=0, fused_physics=f) for f in (True, False)]
    outs = []
    for env in envs:
        env.state = state_from_numpy(env.world, arrays)
        outs.append(env.step([torch.as_tensor(a) for a in acts]))
    (of, rf, df), (op, rp, dp) = (o[:3] for o in outs)
    for field in FIELDS:
        torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), **STATE_TOL)
    for i in range(envs[0].n_agents):
        torch.testing.assert_close(of[i], op[i], atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(rf[i], rp[i], atol=2e-3, rtol=0)
    assert torch.equal(df, dp)
    if name == "simple_spread":
        torch.testing.assert_close(envs[0].state.scenario["rew"], envs[1].state.scenario["rew"], atol=2e-3, rtol=0)
        # the penalty, one per overlapping ordered pair, is a whole number
        # below the distance term, and acts in some env
        env = envs[1]
        st = env.state
        a_pos = st.pos[:, [a.index for a in env.world.agents]]
        l_pos = st.pos[:, [lm.index for lm in env.world.landmarks]]
        dist = torch.linalg.norm(a_pos[:, :, None] - l_pos[:, None], dim=-1)
        penalty = -rp[0] - dist.min(1).values.sum(-1) * 3
        assert bool((penalty.round() - penalty).abs().max() < 1e-4) and bool((penalty.round() >= 2).any())


ROLLOUT_CONFIGS = {
    "simple": ("simple", {}),
    "simple_spread": ("simple_spread", {}),
    "simple_spread,discrete": ("simple_spread", {"continuous_actions": False}),
    "simple_spread,multidiscrete": ("simple_spread", {"continuous_actions": False, "multidiscrete_actions": True}),
}


@pytest.mark.parametrize("config", sorted(ROLLOUT_CONFIGS))
def test_rows_rollout_equals_step_rollout(config):
    """The rows rollout against rollout_fn (the env's own step on the fused
    step) from a reset, bitwise, as tests/test_rows_rollout.py holds the
    JAX package's: simple_spread at 16 envs and 3 agents with continuous,
    discrete and multidiscrete actions, simple with continuous ones."""
    name, kw = ROLLOUT_CONFIGS[config]
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env)
    s0, st0 = env.state, env.steps
    sa, ta_steps, ta = rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    sb, tb_steps, tb = rows_rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(7))
    assert tb["rewards"].shape == (5, 16, env.n_agents) and torch.equal(ta_steps, tb_steps)
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    if name == "simple_spread":
        assert torch.equal(sa.scenario["rew"], sb.scenario["rew"])
    assert not torch.equal(sb.pos, s0.pos)


@pytest.mark.parametrize("multidiscrete", [False, True])
def test_discrete_random_actions_need_no_gymnasium(multidiscrete, monkeypatch):
    """Random discrete and multidiscrete actions, per env.step and for a
    whole rollout, come from the agents' action sizes, without gymnasium
    (which a machine with a card need not have): the same draws as from the
    gymnasium spaces."""
    import sys

    kw = dict(continuous_actions=False, multidiscrete_actions=multidiscrete, fused_physics=True)
    env = torch_make_env("simple_spread", 16, device="cpu", seed=0, **kw)
    space = env.get_agent_action_space(env.agents[0])
    assert env.discrete_action_nvec(env.agents[0]) == [3, 3]
    assert list(space.nvec) == [3, 3] if multidiscrete else space.n == 9
    g0, gen = env.generator.get_state(), env.generator
    if multidiscrete:
        want = [torch.stack([torch.randint(0, int(n), (16,), generator=gen) for n in space.nvec], dim=-1)
                for _ in env.agents]
    else:
        want = [torch.randint(0, int(space.n), (16,), generator=gen) for _ in env.agents]
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    env.generator.set_state(g0)
    got = [env.get_random_action(a) for a in env.agents]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    env.step(got)
    _, _, traj = rows_rollout_fn(env, horizon=2)(env.state, env.steps, torch.Generator().manual_seed(1))
    assert traj["rewards"].shape == (2, 16, 3)
    with pytest.raises(ImportError):
        env.get_agent_action_space(env.agents[0])


@pytest.mark.parametrize("name", NAMES)
def test_kernel_emit_params(name, cases):
    """The emit's kernel parameters: the agents' and landmarks' runs of
    entity indices (landmarks first in the entity order), the radii; a
    gap in a run raises."""
    env = cases[name][0]
    kind, ep = env._fused_outputs.kernel_emit()
    L = len(env.world.landmarks)
    if name == "simple":
        p = ep.simple
        assert kind == K.EMIT_SIMPLE and (p.a0, p.n_agents, p.l0, p.n_lm) == (1, 1, 0, 1)
    else:
        p = ep.simple_spread
        assert kind == K.EMIT_SIMPLE_SPREAD and (p.a0, p.n_agents, p.l0, p.n_lm, p.obs_others) == (L, 3, 0, 3, 1)
        assert [p.radius[i] for i in range(3)] == [np.float32(0.15)] * 3
    assert index_run([4, 5, 6], "agents") == (4, 3)
    with pytest.raises(NotImplementedError, match="consecutive"):
        index_run([1, 3], "agents")


def test_reset_invariants():
    """The port's own reset: every entity uniform in [-1, 1)^2, at rest,
    simple_spread's reward scratch zero."""
    for name in NAMES:
        env = torch_make_env(name, 512, device="cpu", seed=3)
        st = env.state
        assert bool((st.pos >= -1).all()) and bool((st.pos < 1).all()) and not st.vel.any()
        assert float(st.pos.std()) > 0.5
        if name == "simple_spread":
            assert not st.scenario["rew"].any()


@pytest.mark.parametrize("resync", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_golden_replay(name, resync):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's plain version, free-running or
    re-synced to the recorded state before each step, as
    tests/test_scenario_parity.py checks the JAX package."""
    d = np.load(GOLDEN.format(name))
    nb, atol = d["init_pos"].shape[0], 2e-3
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]

    def inject(pos, vel, rot, ang_vel):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque))

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
