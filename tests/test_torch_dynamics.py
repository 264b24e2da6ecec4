"""The port's dynamics models, their grouped ``[B, A]`` forms, the
environment's process_action plan, ``canonical_u``, ``get_from_scenario``,
``to`` and the hidden dynamics state through interop, against the JAX
package's.

* Each model's ``process_action`` (holonomic, holonomic_with_rot, forward,
  rotation, static, diff_drive, kinematic_bicycle, drone; Euler and RK4
  where the model has both) on one small world of every model, from the
  same injected state and actions: force, torque and the drone's hidden
  state at atol 1e-6 rtol 1e-5.
* The grouped forms against the per-agent loop: ``process_action_batch``
  of a group of each model against its agents one by one, and the rollouts
  of tests/test_dynamics_batch.py's cases (5 steps) with grouping on
  (``VMAS_TPU_BATCH_DYNAMICS=1``) against grouping off (``0``): the exact
  models bitwise, the others (``sin``/``cos``/``tan`` on the stacked
  shape) at that file's ATOL 1e-5; the default grouping bitwise off.
* The plan (``Environment._plan_process_action``) against the JAX
  package's on the same worlds for each knob value, and its rules.
* ``canonical_u``, ``get_from_scenario`` and ``to`` against the JAX
  package's behaviour; the drone's hidden state through interop bitwise,
  and a world without hidden state unchanged.
"""

import numpy as np
import pytest
import torch

import vmas_tpu
import vmas_tpu.core as jcore
import vmas_tpu.dynamics as jdyn
from vmas_tpu.environment.environment import Environment as JEnvironment
from vmas_tpu.scenarios import load as jload
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
import vmas_tpu_torch.core as tcore
import vmas_tpu_torch.dynamics as tdyn
from vmas_tpu_torch.dynamics.common import scatter_force, scatter_torque
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy
from vmas_tpu_torch.scenarios import load as tload
from test_torch_debug_worlds import jax_state

torch.set_num_threads(1)

B = 8
MODEL_TOL = dict(atol=1e-6, rtol=1e-5)
# tests/test_dynamics_batch.py's bound on the models that compute sin, cos
# or tan on the stacked shape: about 1 ulp a step on O(1) values over 5
# steps, with room for the contact chain
ATOL = 1e-5
# tests/test_dynamics_batch.py's cases: (name, kwargs, exact)
CASES = [
    ("road_traffic", dict(n_agents=4, is_add_noise=False), False),
    ("transport", dict(n_agents=3), True),
    ("football", dict(n_blue_agents=2, n_red_agents=2, ai_red_agents=False, dense_reward=True), True),
    ("simple_speaker_listener", {}, True),
]


def model_world(core, dyn, integration, n=1):
    """A world with ``n`` agents of each dynamics model (different masses
    and shapes, so their moments of inertia differ)."""
    w = core.World(B, "cpu", dt=0.1, substeps=2)
    models = [
        ("holo", lambda: dyn.Holonomic(), core.Sphere(0.05)),
        ("holo_rot", lambda: dyn.HolonomicWithRotation(), core.Box(length=0.2, width=0.1)),
        ("fwd", lambda: dyn.Forward(), core.Sphere(0.07)),
        ("rot", lambda: dyn.Rotation(), core.Box(length=0.3, width=0.1)),
        ("static", lambda: dyn.Static(), core.Sphere(0.05)),
        ("dd", lambda: dyn.DiffDrive(w, integration=integration), core.Sphere(0.08)),
        ("bike", lambda: dyn.KinematicBicycle(w, width=0.1, l_f=0.1, l_r=0.12, max_steering_angle=0.5,
                                              integration=integration), core.Box(length=0.22, width=0.1)),
        ("drone", lambda: dyn.Drone(w, integration=integration), core.Sphere(0.05)),
    ]
    for name, make, shape in models:
        for k in range(n):
            w.add_agent(core.Agent(f"{name}_{k}", shape=shape, mass=1.0 + 0.25 * len(w.agents), dynamics=make()))
    return w.finalize()


def model_inputs(world, rng):
    """A numpy state (random poses, velocities, spins; the drones' hidden
    state random) and per agent a random u of its dynamics' width."""
    E = len(world.entities)
    arrays = {
        "pos": rng.uniform(-1, 1, (B, E, 2)), "vel": rng.normal(0, 0.5, (B, E, 2)),
        "rot": rng.uniform(-np.pi, np.pi, (B, E)), "ang_vel": rng.normal(0, 0.5, (B, E)),
    }
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    arrays["u"] = [np.asarray(rng.uniform(-1, 1, (B, a.dynamics.needed_action_size)), np.float32)
                   for a in world.agents]
    arrays["dyn"] = [np.asarray(rng.normal(0, 0.3, (B, 12)), np.float32) if isinstance(a.dynamics, tdyn.Drone)
                     else () for a in world.agents]
    return arrays


def jax_world_state(jworld, arrays):
    import jax.numpy as jnp

    st = jworld.spawn_state()
    kw = {k: jnp.asarray(arrays[k]) for k in ("pos", "vel", "rot", "ang_vel")}
    return st.replace(**kw, u=tuple(jnp.asarray(u) for u in arrays["u"]),
                      dyn=tuple(() if isinstance(d, tuple) else jnp.asarray(d) for d in arrays["dyn"]))


@pytest.fixture(scope="module")
def models():
    """Per integration: the port's and the JAX package's model worlds, the
    injected state, and each agent's process_action from it in both."""
    out = {}
    for k, integration in enumerate(("euler", "rk4")):
        tw, jw = model_world(tcore, tdyn, integration), model_world(jcore, jdyn, integration)
        arrays = model_inputs(tw, np.random.default_rng(40 + k))
        ts, js = state_from_numpy(tw, arrays), jax_world_state(jw, arrays)
        pairs = [(ta.dynamics.process_action(tw, ts), ja.dynamics.process_action(jw, js))
                 for ta, ja in zip(tw.agents, jw.agents)]
        out[integration] = (tw, pairs)
    return out


@pytest.mark.parametrize("integration", ["euler", "rk4"])
@pytest.mark.parametrize("model", ["holo", "holo_rot", "fwd", "rot", "static", "dd", "bike", "drone"])
def test_process_action_matches_jax(models, integration, model):
    tw, pairs = models[integration]
    i = next(i for i, a in enumerate(tw.agents) if a.name == f"{model}_0")
    a = tw.agents[i]
    t_out, j_out = pairs[i]
    for f in ("force", "torque"):
        np.testing.assert_allclose(getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f)), err_msg=f,
                                   **MODEL_TOL)
    if model == "drone":
        np.testing.assert_allclose(t_out.dyn[a.slot].numpy(), np.asarray(j_out.dyn[a.slot]), **MODEL_TOL)
        assert float(t_out.torque[:, a.index].abs().max()) > 0
    if model == "static":
        assert float(t_out.force.abs().max()) == 0.0 and float(t_out.torque.abs().max()) == 0.0


@pytest.mark.parametrize("integration", ["euler", "rk4"])
def test_group_form_against_loop(integration):
    """``process_action_batch`` of a group of three agents of each model
    against the three one by one: the exact models bitwise, the others at
    ATOL; the drone does not group."""
    w = model_world(tcore, tdyn, integration, n=3)
    arrays = model_inputs(w, np.random.default_rng(50))
    st = state_from_numpy(w, arrays)
    for name in ("holo", "holo_rot", "fwd", "rot", "static", "dd", "bike"):
        group = tuple(a for a in w.agents if a.name.rsplit("_", 1)[0] == name)
        dyn = group[0].dynamics
        assert dyn.batch_spec() is not None and len({a.dynamics.batch_spec() for a in group}) == 1
        grouped = dyn.process_action_batch(w, st, group)
        loop = st
        for a in group:
            loop = a.dynamics.process_action(w, loop)
        for f in ("force", "torque"):
            g, lp = getattr(grouped, f), getattr(loop, f)
            if dyn.batch_exact():
                assert torch.equal(g, lp), (name, f)
            else:
                torch.testing.assert_close(g, lp, atol=ATOL, rtol=0, msg=f"{name} {f}")
    assert all(a.dynamics.batch_spec() is None for a in w.agents if a.name.startswith("drone"))
    assert {a.name.rsplit("_", 1)[0] for a in w.agents if a.dynamics.batch_exact()} == {"holo", "holo_rot", "rot",
                                                                                          "static"}


def _rollout(monkeypatch, flag, name, kwargs, steps=5):
    if flag is None:
        monkeypatch.delenv("VMAS_TPU_BATCH_DYNAMICS", raising=False)
    else:
        monkeypatch.setenv("VMAS_TPU_BATCH_DYNAMICS", flag)
    env = torch_make_env(name, num_envs=4, device="cpu", seed=7, **kwargs)
    out = []
    for _ in range(steps):
        obs, rews, dones, _ = env.step(env.get_random_actions())
        out.append((obs, rews, dones))
    st = env.state
    leaves = [st.pos, st.vel, st.rot, st.ang_vel, st.force, st.torque, *st.u]
    for obs, rews, dones in out:
        leaves += [*obs, *rews, dones]
    return env, leaves


@pytest.mark.parametrize("name,kwargs,exact", CASES)
def test_batched_dynamics_matches_loop(monkeypatch, name, kwargs, exact):
    _, ref = _rollout(monkeypatch, "0", name, kwargs)
    env, bat = _rollout(monkeypatch, "1", name, kwargs)
    _, default = _rollout(monkeypatch, None, name, kwargs)
    assert len(ref) == len(bat) == len(default)
    for a, b, c in zip(ref, bat, default):
        assert torch.equal(a, c)  # the default groups the exact models only
        if exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, atol=ATOL, rtol=0)
    if name == "road_traffic":
        assert len(env._pa_groups) == 1 and len(env._pa_groups[0]) == 4


def jax_plan(name, kwargs, flag, monkeypatch):
    """The JAX package's plan for the world ``name``, as agent names: its
    ``_plan_process_action`` on the world alone (no compiled step)."""
    if flag is None:
        monkeypatch.delenv("VMAS_TPU_BATCH_DYNAMICS", raising=False)
    else:
        monkeypatch.setenv("VMAS_TPU_BATCH_DYNAMICS", flag)
    env = JEnvironment.__new__(JEnvironment)
    env.scenario = jload(name).Scenario()
    env.world = env.scenario.env_make_world(2, None, **kwargs)
    singles, groups = env._plan_process_action()
    return [a.name for a in singles], [[a.name for a in g] for g in groups]


PLAN_WORLDS = [
    ("transport", dict(n_agents=3)),
    ("road_traffic", dict(n_agents=4, is_add_noise=False)),
    ("give_way", {}),
    ("simple_speaker_listener", {}),
    ("flocking", {}),
    ("diff_drive", dict(n_agents=3)),
    ("kinematic_bicycle", dict(n_agents=3)),
    ("drone", {}),
    ("football", dict(n_blue_agents=2, n_red_agents=2, ai_red_agents=False)),
]


@pytest.mark.parametrize("flag", [None, "0", "1", "exact"])
@pytest.mark.parametrize("name,kwargs", PLAN_WORLDS, ids=[w[0] for w in PLAN_WORLDS])
def test_plan_matches_jax(monkeypatch, name, kwargs, flag):
    want = jax_plan(name, kwargs, flag, monkeypatch)
    env = torch_make_env(name, num_envs=2, device="cpu", seed=0, **kwargs)
    got = ([a.name for a in env._pa_singles], [[a.name for a in g] for g in env._pa_groups])
    assert got == want


def test_plan_rules(monkeypatch):
    monkeypatch.delenv("VMAS_TPU_BATCH_DYNAMICS", raising=False)
    env = torch_make_env("transport", num_envs=2, device="cpu", seed=0, n_agents=3)
    assert env._pa_singles == [] and len(env._pa_groups) == 1 and len(env._pa_groups[0]) == 3
    # scripted agents and a scenario's process_action keep the per-agent path
    env = torch_make_env("flocking", num_envs=2, device="cpu", seed=0)
    scripted = [a for a in env.world.agents if a.action_script is not None]
    assert scripted and all(a in env._pa_singles for a in scripted)
    env = torch_make_env("give_way", num_envs=2, device="cpu", seed=0)
    assert env._pa_groups == [] and env._pa_singles == env.world.agents
    # singles in agent order; diff_drive groups only under 1
    env = torch_make_env("diff_drive", num_envs=2, device="cpu", seed=0, n_agents=4)
    assert env._pa_singles[0].name == "diff_drive_0" and [len(g) for g in env._pa_groups] == [3]
    monkeypatch.setenv("VMAS_TPU_BATCH_DYNAMICS", "off")
    env = torch_make_env("transport", num_envs=2, device="cpu", seed=0, n_agents=3)
    assert env._pa_groups == [] and env._pa_singles == env.world.agents


def test_canonical_u_on_the_drone():
    """The drone's process_action widens u to [B, 4] for the step's hooks;
    the state that leaves env.step keeps [B, 3], its first three columns
    (the thrust and two torques), as the JAX package's does; rollout_fn
    and rollout() carry the spawn-time shape."""
    import jax.numpy as jnp

    from vmas_tpu_torch.parallel.rollout import rollout, rollout_fn

    env = torch_make_env("drone", B, device="cpu", seed=0)
    rng = np.random.default_rng(60)
    arrays = testing.debug_world_state(env, rng)
    acts = testing.debug_world_actions(env, rng)
    jenv = vmas_tpu.make_env("drone", B, seed=0)
    jenv.state = jax_state(jenv, arrays)
    jenv.step([jnp.asarray(a) for a in acts])
    env.state = state_from_numpy(env.world, arrays)
    seen = []
    reward = env.scenario.reward
    env.scenario.reward = lambda agent, state: seen.append(tuple(agent.u(state).shape)) or reward(agent, state)
    env.step([torch.as_tensor(a) for a in acts])
    assert seen == [(B, 4)] * 2
    for a, ju in zip(env.state.u, jenv.state.u):
        assert a.shape == (B, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(ju), atol=1e-6, rtol=1e-6)
    state, _, traj = rollout_fn(env, horizon=3)(env.state, env.steps, torch.Generator().manual_seed(1))
    assert all(u.shape == (B, 3) for u in state.u) and traj["rewards"].shape == (3, B, 2)
    traj = rollout(env, horizon=3)
    assert all(u.shape == (B, 3) for u in env.state.u) and traj["rewards"].shape == (3, B, 2)
    # a narrower u is padded with zeros back to the spawn width
    narrow = env.state.replace(u=tuple(u[:, :1] for u in env.state.u))
    padded = env._canonical_u(narrow)
    assert all(u.shape == (B, 3) and bool((u[:, 1:] == 0).all()) for u in padded.u)
    assert env._canonical_u(env.state) is env.state


def test_dyn_through_interop():
    """The drone's hidden state round-trips bitwise; a world without one
    has no ``dyn`` entry, and its state comes back unchanged."""
    env = torch_make_env("drone", B, device="cpu", seed=0)
    arrays = testing.debug_world_state(env, np.random.default_rng(61))
    st = state_from_numpy(env.world, arrays)
    assert all(d.dtype == torch.float32 and d.shape == (B, 12) for d in st.dyn)
    back = state_to_numpy(st)
    for a, b in zip(back["dyn"], arrays["dyn"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(back["dyn"][0], np.zeros_like(back["dyn"][0]))
    # the JAX package's state carries the same arrays
    jenv = vmas_tpu.make_env("drone", B, seed=0)
    for a, b in zip(jax_state(jenv, back).dyn, arrays["dyn"], strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a model with no hidden state next to one with it: () both ways
    w = model_world(tcore, tdyn, "rk4")
    arrays = model_inputs(w, np.random.default_rng(62))
    back = state_to_numpy(state_from_numpy(w, arrays))
    assert [isinstance(d, tuple) for d in back["dyn"]] == [not isinstance(a.dynamics, tdyn.Drone) for a in w.agents]
    np.testing.assert_array_equal(back["dyn"][-1], arrays["dyn"][-1])
    # no hidden state: no dyn entry, the same state
    env = torch_make_env("transport", B, device="cpu", seed=0, n_agents=3)
    back = state_to_numpy(env.state)
    assert "dyn" not in back
    again = state_from_numpy(env.world, back)
    assert again.dyn == env.state.dyn == ((),) * 3
    assert state_to_numpy(again).keys() == back.keys()


def test_set_dyn_state():
    env = torch_make_env("drone", 2, device="cpu", seed=0)
    a0, a1 = env.world.agents
    v = torch.ones((2, 12))
    st = a1.set_dyn_state(env.state, v)
    assert a1.dyn_state(st) is v and a0.dyn_state(st) is env.state.dyn[0]
    assert st is not env.state and env.state.dyn[1] is not v


def test_get_from_scenario_matches_jax():
    """goal's reward hooks update scratch: the reward hooks run (and their
    scratch stays) only where rewards are asked for, observations see the
    state after them, and the outputs come in the JAX package's order."""
    env = torch_make_env("goal", B, device="cpu", seed=0)
    arrays = testing.debug_world_state(env, np.random.default_rng(63))
    jenv = vmas_tpu.make_env("goal", B, seed=0)
    jenv.state = jax_state(jenv, arrays)
    env.state = state_from_numpy(env.world, arrays)
    assert env.get_from_scenario(False, False, False, False) is None
    obs_only = env.get_from_scenario(True, False, False, False)
    assert torch.equal(env.state.scenario["pos_shaping"], torch.as_tensor(arrays["scenario"]["pos_shaping"]))
    got = env.get_from_scenario(True, True, True, True)
    want = jenv.get_from_scenario(True, True, True, True)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][0]), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][0]), atol=2e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for k in ("pos_rew", "time_rew"):
        np.testing.assert_allclose(got[3][0][k].numpy(), np.asarray(want[3][0][k]), atol=2e-3)
    np.testing.assert_allclose(env.state.scenario["pos_shaping"].numpy(),
                               np.asarray(jenv.state.scenario["pos_shaping"]), atol=1e-5)
    assert torch.equal(obs_only[0][0], got[0][0])
    named = env.get_from_scenario(True, False, True, False, dict_agent_names=True)
    assert list(named[0]) == ["agent 0"] and list(named[1]) == ["agent 0"]
    env.max_steps, env.terminated_truncated = 3, True
    assert len(env.get_from_scenario(False, False, False, True)) == 2


def test_to():
    env = torch_make_env("goal", 2, device="cpu", seed=0)
    assert env.to("cpu") is env and env.to(torch.device("cpu")) is env and env.to("cpu:0") is env
    with pytest.raises(ValueError, match="cannot move"):
        env.to("meta")


def test_scatter_helpers_write_only_the_group():
    w = model_world(tcore, tdyn, "rk4", n=2)
    st = state_from_numpy(w, model_inputs(w, np.random.default_rng(64)))
    group = [a for a in w.agents if a.name.startswith("holo_rot")]
    idx = [a.index for a in group]
    out = scatter_torque(scatter_force(st, group, torch.ones((B, 2, 2))), group, torch.full((B, 2), 2.0))
    assert bool((out.force[:, idx] == 1).all()) and bool((out.torque[:, idx] == 2).all())
    rest = [e for e in range(len(w.entities)) if e not in idx]
    assert torch.equal(out.force[:, rest], st.force[:, rest]) and torch.equal(out.torque[:, rest], st.torque[:, rest])


def test_scenario_registry_names():
    for name in testing.DEBUG_WORLDS:
        assert tload(name).__name__ == f"vmas_tpu_torch.scenarios.debug.{name}"
        jload(name)
