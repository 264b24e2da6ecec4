"""The port's wind_flocking and dynamic gravity in the fused step
(vmas_tpu_torch/scenarios/wind_flocking.py, core/fused.py) against the JAX
package's, from injected states.

wind_flocking: a big and a small agent (spheres of radius 0.05 and 0.03)
with a PID velocity controller each, against a wind that is each agent's
per-env dynamic gravity; ``pre_rewards`` weakens the big agent's wind the
better the pair covers it. The same state, made from a seed with numpy
(``testing.wind_flocking_state``: the big agent's wind a random share of
the full wind, the agents touching in every 4th env), goes through the JAX
function and its counterpart in the port:

* the fused step's plain version with the dynamic-gravity rows against the
  JAX package's ``fused_physics_step`` (the Pallas kernel in interpret mode)
  and against the port's plain physics, two steps;
* one env step (process_action, the physics on the plain path or the fused
  step, the shapings, rewards, observations and infos);
* ``Entity.set_gravity`` with and without an env mask;
* the recorded reference trajectory, free-running and re-synced.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise, as
tests/test_fused.py); observations atol 2e-5; the dynamic gravity after
``pre_rewards`` atol 1e-5 (its atan2, cos and sin may differ by an ulp
between XLA and PyTorch); reward, shaping and info values atol 2e-3; the
golden replay at tests/test_scenario_parity.py's atol for this scenario,
2e-3 (velocities, observations and rewards 10x).
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
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core import physics as TP
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
from vmas_tpu_torch.parallel.rollout import rows_rollout_supported
from vmas_tpu_torch.testing import wind_flocking_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_wind_flocking.npz")


def _jnp_tree(d):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}


def jax_state(jenv, arrays):
    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
        scenario={**jenv.state.scenario, **_jnp_tree(arrays["scenario"])},
    )


@pytest.fixture(scope="module")
def case():
    """The port's fused env, the injected state and per-agent actions."""
    env = torch_make_env("wind_flocking", B, device="cpu", seed=0, fused_physics=True)
    arrays = wind_flocking_state(env, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    acts = [rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32) for _ in env.agents]
    return env, arrays, acts


def test_world_fuses_but_not_in_rows(case):
    """The world has dynamic gravity and one sphere-sphere pair; it fuses
    (the same verdict as the JAX package), and the rows form refuses it as
    the JAX package's does."""
    env = case[0]
    jw = vmas_tpu.make_env("wind_flocking", 2, seed=0).world
    ks = TF._kernel_spec(env.world)
    assert env.world.fused and ks.dyn_gravity and len(ks.ss) == 1 and env._fused_outputs is None
    assert [e.name for e in env.world.entities] == [e.name for e in jw.entities]
    assert TF.supports(env.world) == JF.supports(jw) is True
    assert ks.gravity == [None, None] and all(g is not None for g in ks.dyn_g)
    assert not rows_rollout_supported(env)

    class NoRows(TF.FusedOutputs):
        n_out, carry_extra_idx = 0, ()

    fo, slots = NoRows(), [a.index for a in env.agents]
    assert not TF.rows_step_supported(env.world, fo, env.agents)
    with pytest.raises(NotImplementedError, match="dynamic gravity"):
        TF.make_rows_step(env.world, fo, slots)
    with pytest.raises(NotImplementedError, match="dynamic gravity"):
        TF.rows_step_plain(env.world, fo, slots, None, None)


def test_fused_step_twin_matches_pallas_and_plain_physics(case):
    """Two fused steps of the plain version (dynamic-gravity rows after the
    state rows) against the JAX package's fused_physics_step in interpret
    mode and against the port's plain physics, from the injected state."""
    env, arrays, _ = case
    jenv = vmas_tpu.make_env("wind_flocking", B, seed=0)
    js = jax_state(jenv, arrays)
    ts = state_from_numpy(env.world, arrays)
    assert torch.equal(ts.dyn_gravity, torch.as_tensor(arrays["dyn_gravity"]))
    ps, s0 = ts, ts
    jstep = jax.jit(lambda s: JF.fused_physics_step(jenv.world, s))
    for t in range(2):
        js = jstep(js)
        ts = TF.fused_physics_step(env.world, ts)
        ps = TP.physics_step(env.world, ps)
        for field in FIELDS:
            np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), **STATE_TOL,
                                       err_msg=f"{field} vs Pallas at step {t}")
            torch.testing.assert_close(getattr(ts, field), getattr(ps, field), **STATE_TOL)
    # the dynamic-gravity rows are read: without the wind the step differs
    calm = TF.fused_physics_step(env.world, s0.replace(dyn_gravity=torch.zeros_like(s0.dyn_gravity)))
    assert not torch.equal(calm.vel, TF.fused_physics_step(env.world, s0).vel)


def test_dynamic_gravity_replaces_static_gravity():
    """With dynamic gravity a movable entity takes m * (dg + eg), eg the
    world's plus its own static gravity, in place of m * eg: the kernel's
    spec holds the unscaled eg and the mass, and a zero dg gives the static
    world's step bitwise."""
    from vmas_tpu_torch.core import Agent, Sphere, World

    def world(dyn):
        w = World(4, "cpu", gravity=(0.0, -1.5))
        w.add_agent(Agent(name="a", shape=Sphere(0.05), mass=2.0, gravity=(0.25, 0.0)))
        w.dynamic_gravity = dyn
        return w.finalize()

    ws, wd = world(False), world(True)
    ks, kd = TF._kernel_spec(ws), TF._kernel_spec(wd)
    assert ks.gravity == [(2.0 * 0.25, 2.0 * -1.5)] and kd.dyn_g == [(2.0, 0.25, -1.5)]
    cs, cd = ks.to_ctypes(0), kd.to_ctypes(0)
    # the per-entity constants, in the table the kernel reads (one block of
    # E words per field)
    from vmas_tpu_torch import _kernels as K

    ent = lambda f: float(kd.table[kd.ent_offset + K.ENT_FIELDS.index(f) * kd.E:][:1].view(np.float32)[0])
    assert (cs.dyn_g, cd.dyn_g) == (0, 1) and (ent("gsx"), ent("gsy"), ent("mass")) == (0.25, -1.5, 2.0)
    rng = np.random.default_rng(0)
    st = ws.spawn_state().replace(vel=torch.as_tensor(rng.normal(0, 1, (4, 1, 2)), dtype=torch.float32))
    dg = torch.as_tensor(rng.normal(0, 1, (4, 1, 2)), dtype=torch.float32)
    ys = TF.fused_physics_step(ws, st)
    y0 = TF.fused_physics_step(wd, st.replace(dyn_gravity=torch.zeros_like(dg)))
    y1 = TF.fused_physics_step(wd, st.replace(dyn_gravity=dg))
    assert torch.equal(ys.vel, y0.vel)
    sub_dt = float(wd.sub_dt)
    torch.testing.assert_close(y1.vel - ys.vel, dg * 2.0 * 0.5 * sub_dt, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_env_step_matches_jax(fused, case):
    """One env step from the injected state: the controllers' forces, the
    physics (plain, or the fused step with the dynamic-gravity rows), the
    rescaled wind, shapings, rewards, observations and infos."""
    _, arrays, acts = case
    jenv = vmas_tpu.make_env("wind_flocking", B, seed=0)
    jenv.state = jax_state(jenv, arrays)
    j_obs, j_rews, j_dones, j_infos = jenv.step([jnp.asarray(a) for a in acts])
    env = torch_make_env("wind_flocking", B, device="cpu", seed=0, fused_physics=fused)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, infos = env.step([torch.as_tensor(a) for a in acts])
    js, ts = jenv.state, env.state
    for field in FIELDS:
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), **STATE_TOL,
                                   err_msg=field)
    np.testing.assert_allclose(ts.dyn_gravity.numpy(), np.asarray(js.dyn_gravity), atol=1e-5, rtol=0)
    big = ts.dyn_gravity[:, env.scenario.big_agent.index, 1].abs()
    assert bool(((big > 0) & (big < 2)).any()), "no env with the big agent's wind weakened"
    for i in range(2):
        np.testing.assert_allclose(obs[i].numpy(), np.asarray(j_obs[i]), atol=2e-5, rtol=1e-5, err_msg="obs")
        np.testing.assert_allclose(rews[i].numpy(), np.asarray(j_rews[i]), atol=2e-3, err_msg="reward")
        assert set(infos[i]) == set(j_infos[i])
        for k in infos[i]:
            np.testing.assert_allclose(infos[i][k].numpy(), np.asarray(j_infos[i][k]), atol=2e-3, err_msg=k)
    np.testing.assert_array_equal(dones.numpy(), np.asarray(j_dones))
    back = state_to_numpy(ts)["scenario"]
    for k, v in back.items():
        want = jax.tree_util.tree_map(np.asarray, js.scenario[k])
        for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_allclose(a, b, atol=2e-3, rtol=0, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_set_gravity(masked, case):
    """Entity.set_gravity, for all envs or under an env mask, against the
    JAX package's, on both agents; a world without dynamic gravity refuses
    it."""
    env, arrays, _ = case
    jenv = vmas_tpu.make_env("wind_flocking", B, seed=0)
    js, ts = jax_state(jenv, arrays), state_from_numpy(env.world, arrays)
    rng = np.random.default_rng(5)
    mask = rng.random(B) < 0.5 if masked else None
    for k, (ja, ta) in enumerate(zip(jenv.world.agents, env.world.agents)):
        value = rng.normal(0, 1, (B, 2)).astype(np.float32) if k == 0 else np.float32([0.5, -3.0])
        js = ja.set_gravity(js, jnp.asarray(value), env_mask=None if mask is None else jnp.asarray(mask))
        ts = ta.set_gravity(ts, torch.as_tensor(value), env_mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(ts.dyn_gravity.numpy(), np.asarray(js.dyn_gravity))
    if masked:
        keep = ~mask
        np.testing.assert_array_equal(ts.dyn_gravity.numpy()[keep], arrays["dyn_gravity"][keep])
    other = torch_make_env("transport", 2, device="cpu", n_agents=2)
    with pytest.raises(AssertionError, match="dynamic_gravity"):
        other.world.agents[0].set_gravity(other.state, (0.0, 1.0))


def test_reset_invariants():
    """The port's own reset: the pair 1 m apart through the origin within
    pi/8 of the x axis, either way round, both winds the full wind, zero
    controller memory, the clock at 0 and the shapings of the reset state."""
    env = torch_make_env("wind_flocking", 256, device="cpu", seed=7)
    sc, st = env.scenario, env.state
    pb, ps = sc.big_agent.pos(st), sc.small_agent.pos(st)
    torch.testing.assert_close(pb, -ps)
    torch.testing.assert_close(torch.linalg.norm(pb - ps, dim=-1), torch.ones(256), atol=1e-6, rtol=0)
    ang = torch.atan2(ps[:, 1], ps[:, 0]).abs()
    assert bool(((ang <= np.pi / 8 + 1e-6) | (ang >= 7 * np.pi / 8 - 1e-6)).all())
    assert bool((ps[:, 0] > 0).any()) and bool((ps[:, 0] < 0).any())
    assert torch.equal(st.dyn_gravity, torch.tensor([0.0, -2.0]).expand(256, 2, 2))
    assert not st.scenario["t"].any() and st.scenario["t"].dtype == torch.int32
    for a in env.world.agents:
        assert not st.scenario[f"__vel_ctrl_{a.name}"]["accum_errs"].any()
    torch.testing.assert_close(st.scenario["wind_shaping"], torch.full((256, 2), 2.0))
    torch.testing.assert_close(st.scenario["distance_shaping"], torch.zeros(256), atol=1e-6, rtol=0)


@pytest.mark.parametrize("resync", [False, True])
def test_golden_replay(resync):
    """The recorded reference trajectory (16 envs, 50 steps) through the
    port's env.step on the fused step's plain version, free-running or
    re-synced to the recorded state before each step. As
    tests/test_scenario_parity.py does, one discarded reward cycle
    recomputes the shapings, keeping the clock ``t``, the wind shaping and
    the reset-time wind (the reference's first step runs with it)."""
    d = np.load(GOLDEN)
    nb, atol = d["init_pos"].shape[0], 2e-3
    env = torch_make_env("wind_flocking", nb, device="cpu", seed=0, fused_physics=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]

    def inject(pos, vel, rot, ang_vel):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque))

    state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"])
    keep = {k: state.scenario[k] for k in ("t", "wind_shaping")}
    refreshed = env.scenario.pre_rewards(state)
    env.state = refreshed.replace(scenario={**refreshed.scenario, **keep}, dyn_gravity=state.dyn_gravity)
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
