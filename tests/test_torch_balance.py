"""The port's balance (vmas_tpu_torch/scenarios/balance.py) against the JAX
package's, from injected states.

Balance drives four contact pair types (sphere-sphere, line-sphere,
box-sphere, box-line) and static world gravity. The same state, made from a
seed with numpy, in which all four types touch, goes through the JAX
function and its counterpart in the port: the plain physics against
``physics_step``, the plain twin of the fused step against
``fused_physics_step`` and the twin of the rows step against
``make_rows_step`` (the Pallas kernel in interpret mode on the CPU, one
module-scoped JAX env so that each kernel compiles once). Then the port
alone: ``env.step`` fused against plain, ``rows_rollout_fn`` against
``rollout_fn``, and the recorded reference trajectory.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise, as
tests/test_fused.py); observation rows atol 2e-5; reward and shaping rows
atol 2e-3 (the shaping factor of 100 amplifies position noise); the
on_ground and done flags equal except in an env within 1e-5 of one of
their thresholds; the golden replay atol 2e-3, re-synced to the recorded
state each step (tests/test_scenario_parity.py's resync test).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import fused as JF
from vmas_tpu.core import physics as JP
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core import physics as TP
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported
from vmas_tpu_torch.testing import balance_contact_state, balance_flag_margin

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
FLAG_MARGIN = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_balance.npz")


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw,
        u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={k: jnp.asarray(v) for k, v in arrays["scenario"].items()},
    )


def compare_outputs(fo, t_state_rows, t_extra, j_extra, what):
    """Emit rows of the port against the JAX package's: observations,
    then reward and shaping, then the flags (an env within FLAG_MARGIN of a
    threshold is excused, with the reward rows its flag feeds)."""
    t_extra, j_extra = np.asarray(t_extra), np.asarray(j_extra)
    base = fo.base
    np.testing.assert_allclose(t_extra[:base], j_extra[:base], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    differ = (t_extra[base + 2:base + 4] != j_extra[base + 2:base + 4]).any(0)
    near = balance_flag_margin(fo, t_state_rows).numpy() < FLAG_MARGIN
    assert not (differ & ~near).any(), f"{what}: flags differ off their thresholds"
    ok = ~differ
    np.testing.assert_allclose(t_extra[base:base + 2, ok], j_extra[base:base + 2, ok], atol=2e-3,
                               err_msg=f"{what}: reward rows")
    np.testing.assert_allclose(t_extra[base + 4], j_extra[base + 4], atol=2e-3, err_msg=f"{what}: shaping row")


@pytest.fixture(scope="module")
def envs():
    jenv = vmas_tpu.make_env("balance", B, seed=0, fused_physics=True)
    tenv = torch_make_env("balance", B, device="cpu", seed=0, fused_physics=True)
    arrays = balance_contact_state(tenv, np.random.default_rng(1))
    return jenv, tenv, arrays


def test_contact_state_touches_every_type(envs):
    _, tenv, arrays = envs
    ts = state_from_numpy(tenv.world, arrays)
    counts = TF.contact_counts(tenv.world, TF.state_rows(ts))
    assert {k for k, v in counts.items() if v > 0} == {"ss", "ls", "bs", "bl"}, counts
    assert [e.name for e in tenv.world.entities] == [e.name for e in envs[0].world.entities]


def test_physics_step_matches_jax(envs):
    jenv, tenv, arrays = envs
    js, ts = jax_state(jenv, arrays), state_from_numpy(tenv.world, arrays)
    j_state = jax.jit(lambda s: JP.physics_step(jenv.world, s))(js)
    t_state = TP.physics_step(tenv.world, ts)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
                                   **STATE_TOL, err_msg=name)


def test_fused_step_twin_matches_pallas(envs):
    jenv, tenv, arrays = envs
    js, ts = jax_state(jenv, arrays), state_from_numpy(tenv.world, arrays)
    jfo, tfo = jenv._fused_outputs, tenv._fused_outputs
    j_state, j_extra = jax.jit(lambda s: jenv.world.step_with_outputs(s, jfo))(js)
    t_state, t_extra = tenv.world.step_with_outputs(ts, tfo)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
                                   **STATE_TOL, err_msg=name)
    compare_outputs(tfo, TF.state_rows(t_state), t_extra, j_extra, "fused step")


def test_rows_step_twin_matches_pallas(envs):
    jenv, tenv, arrays = envs
    js, ts = jax_state(jenv, arrays), state_from_numpy(tenv.world, arrays)
    jfo, tfo = jenv._fused_outputs, tenv._fused_outputs
    slots = [a.index for a in tenv.agents]
    act = np.random.default_rng(2).uniform(-0.7, 0.7, (2 * len(slots), B)).astype(np.float32)
    bp = 128
    jact = np.zeros((2 * len(slots), bp), np.float32)
    jact[:, :B] = act
    jc, je = jax.jit(JF.make_rows_step(jenv.world, jfo, slots, bp))(JF.pack_carry(jenv.world, js, jfo, bp), jact)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    tc, te = TF.rows_step_plain(tenv.world, tfo, slots, TF.pack_carry(tenv.world, ts, tfo), torch.as_tensor(act))
    E = len(tenv.world.entities)
    assert tc.shape == (9 * E + 1, B) and te.shape == (tfo.n_out, B) == (3 * 8 + 8 + 5, B)
    np.testing.assert_allclose(tc[:9 * E].numpy(), jc[:9 * E], **STATE_TOL, err_msg="state rows")
    compare_outputs(tfo, tc[:9 * E], te, je, "rows step")
    # the carried scratch row is this step's shaping row
    assert torch.equal(tc[9 * E], te[tfo.carry_extra_idx[0]])


def _step_pair(arrays, n_steps, seed):
    """Port envs with the fused step and with the plain physics, from the
    same state, given the same actions."""
    fused, plain = (torch_make_env("balance", B, device="cpu", seed=0, fused_physics=f) for f in (True, False))
    for env in (fused, plain):
        env.state = state_from_numpy(env.world, arrays)
    rng = np.random.default_rng(seed)
    for t in range(n_steps):
        acts = [torch.as_tensor(a) for a in rng.uniform(-1, 1, (3, B, 2)).astype(np.float32)]
        yield t, fused, plain, fused.step(acts), plain.step(acts)


def test_env_step_fused_matches_plain(envs):
    _, tenv, arrays = envs
    fo = tenv._fused_outputs
    for t, fused, plain, (of, rf, df, inf_f), (op, rp, dp, inf_p) in _step_pair(arrays, 4, seed=3):
        for name in FIELDS:
            torch.testing.assert_close(getattr(fused.state, name), getattr(plain.state, name), **STATE_TOL)
        for i in range(3):
            torch.testing.assert_close(of[i], op[i], atol=2e-5, rtol=1e-5)
        near = balance_flag_margin(fo, TF.state_rows(plain.state)) < FLAG_MARGIN
        assert torch.equal(df[~near], dp[~near]), f"dones at step {t}"
        ok = df == dp
        torch.testing.assert_close(rf[0][ok], rp[0][ok], atol=2e-3, rtol=0)
        assert set(inf_f[0]) == set(inf_p[0]) == {"pos_rew", "ground_rew"}
        torch.testing.assert_close(inf_f[0]["pos_rew"], inf_p[0]["pos_rew"], atol=2e-3, rtol=0)
        if t == 0:
            assert bool(df.any()) and not bool(df.all()), "the state should end some episodes, not all"


def test_rows_rollout_equals_step_rollout(envs):
    _, tenv, arrays = envs
    env = torch_make_env("balance", B, device="cpu", seed=0, fused_physics=True)
    assert rows_rollout_supported(env)
    s0, st0 = state_from_numpy(env.world, arrays), env.steps
    sa, sta, ta = rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(4))
    sb, stb, tb = rows_rollout_fn(env, horizon=5)(s0, st0, torch.Generator().manual_seed(4))
    assert tb["rewards"].shape == (5, B, 3) and tb["dones"].shape == (5, B)
    assert len(tb["obs"]) == 3 and all(o.shape == (5, B, 16) for o in tb["obs"])
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(a, b) for a, b in zip(ta["obs"], tb["obs"]))
    for name in FIELDS:
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    for k in sa.scenario:
        assert torch.equal(sa.scenario[k], sb.scenario[k]), k
    # the agents' decoded u carries balance's u_multiplier of 0.7
    assert all(torch.equal(ua, ub) for ua, ub in zip(sa.u, sb.u))
    assert float(sb.u[0].abs().max()) <= 0.7


def test_make_env_steps_on_the_cpu():
    env = torch_make_env("balance", B, device="cpu", fused_physics=True)
    obs, rews, dones, infos = env.step(env.get_random_actions())
    assert len(obs) == 3 and all(o.shape == (B, 16) and bool(torch.isfinite(o).all()) for o in obs)
    assert all(r.shape == (B,) for r in rews) and dones.shape == (B,) and len(infos) == 3
    sc, pos = env.scenario, env.state.pos
    # reset: the line 6 cm above the floor's top, agents under it, the
    # package on it
    assert torch.allclose(pos[:, sc.floor.index], torch.tensor([0.0, -1.53]))
    assert bool((env.state.scenario["global_shaping"] > 0).all())


@pytest.mark.parametrize("fused", [False, True])
def test_golden_balance_replay_resync(fused):
    """The recorded reference trajectory (16 envs, 50 steps), re-synced to
    the recorded state before each step, as tests/test_scenario_parity.py
    checks the JAX package, through the port's plain physics and its fused
    step."""
    d = np.load(GOLDEN)
    nb, T, atol = d["init_pos"].shape[0], d["actions"].shape[0], 2e-3
    env = torch_make_env("balance", nb, device="cpu", seed=0, fused_physics=fused)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]

    def inject(pos, vel, rot, ang_vel):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque))

    # one discarded reward cycle recomputes the shaping baseline
    env.state = env.scenario.pre_rewards(inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"]))
    close = lambda a, ref, tol, msg: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(ref, np.float64), atol=tol, rtol=0, err_msg=msg)
    for t in range(T):
        if t > 0:
            env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1])
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(3)])
        close(env.state.pos, d["pos"][t], atol, f"pos at step {t}")
        close(env.state.vel, d["vel"][t], 10 * atol, f"vel at step {t}")
        close(env.state.rot, d["rot"][t], 10 * atol, f"rot at step {t}")
        for i in range(3):
            close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}] at step {t}")
            close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}] at step {t}")
        np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done at step {t}")
