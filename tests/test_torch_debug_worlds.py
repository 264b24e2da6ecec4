"""The port's dynamics and controller debug worlds (diff_drive,
kinematic_bicycle, drone, goal, vel_control, circle_trajectory,
line_trajectory) against the JAX package's, and against the recorded
reference trajectories.

None of them has fused outputs: with ``fused_physics=True`` the fused step
(K1) runs with no emit and the hooks run around it, as in the JAX package.

* One env step from an injected state (``testing.debug_world_state``: the
  first two agents in contact, the drone tilted past 30 degrees in every
  other env, the controllers' memory set; ``testing.debug_world_actions``:
  commands beyond the controllers' clamp), on the plain physics and on the
  fused step's plain version, against the JAX package's env.step (its
  plain physics): state atol 1e-5 rtol 1e-5 (the drone's hidden state
  and the controllers' memory too), observations atol 2e-5 rtol 1e-5,
  rewards and reward scratch atol 2e-3, dones equal, u at its spawn width.
* The states' events on the rows the fused step takes (contacts, torques,
  forces beyond ``f_range``), which the card's comparison requires.
* The recorded reference trajectory (16 envs, 50 steps) through env.step
  on the fused step's plain version, free-running and then re-synced to
  the recorded state before each step, with tests/test_scenario_parity.py's
  tolerance table, free-running horizon, forked envs and scratch refresh
  (kinematic_bicycle: 10 free steps, one env may fork; its 50 re-synced
  steps on the plain physics, since K1's plain version walks its box-box
  pair in Python, some 0.26 s a step at 16 envs on a CPU).
* The drone's ``needs_reset``/``done`` on states past 30 degrees, and the
  resets.
"""

import os

import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy

torch.set_num_threads(1)

B = 8
WORLDS = testing.DEBUG_WORLDS
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
OBS_TOL = dict(atol=2e-5, rtol=1e-5)
REW_TOL = dict(atol=2e-3, rtol=0.0)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# tests/test_scenario_parity.py's table for these recordings: atol (default
# 2e-3), free-running horizon, envs that may fork
GOLDEN_T = {"kinematic_bicycle": 10}
CHAOTIC = {"kinematic_bicycle": 1}
# the re-synced replays on the plain physics
RESYNC_PLAIN = ("kinematic_bicycle",)
# the events the injected state must show on the fused step's input rows
REQUIRED = {
    "diff_drive": ("ss", "torque"), "kinematic_bicycle": ("bb", "torque"), "drone": ("ss", "torque"),
    "goal": ("clamped",), "vel_control": ("clamped",), "circle_trajectory": ("clamped",),
    "line_trajectory": ("clamped",),
}


def inputs(name):
    env = torch_make_env(name, B, device="cpu", seed=0)
    rng = np.random.default_rng(70 + WORLDS.index(name))
    return testing.debug_world_state(env, rng), testing.debug_world_actions(env, rng)


def jax_state(jenv, arrays):
    import jax
    import jax.numpy as jnp

    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario", "dyn")}
    st = jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
                            scenario={**jenv.state.scenario, **jax.tree_util.tree_map(jnp.asarray,
                                                                                      arrays["scenario"])})
    if "dyn" in arrays:
        st = st.replace(dyn=tuple(jnp.asarray(d) for d in arrays["dyn"]))
    return st


@pytest.fixture(scope="module")
def jax_stepped():
    """Per world: the injected state and actions, and the JAX package's
    env.step from them (state fields, dyn, u, scratch, obs, rewards,
    dones), each compiled once per file."""
    import jax
    import jax.numpy as jnp

    out = {}
    for name in WORLDS:
        arrays, acts = inputs(name)
        jenv = vmas_tpu.make_env(name, B, seed=0)
        jenv.state = jax_state(jenv, arrays)
        obs, rews, dones, infos = jenv.step([jnp.asarray(a) for a in acts])
        js = jenv.state
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        ref = {f: np.asarray(getattr(js, f)) for f in FIELDS}
        ref.update(dyn=[np.asarray(d) for d in js.dyn if not isinstance(d, tuple)], u=to_np(list(js.u)),
                   scenario=to_np({k: v for k, v in js.scenario.items() if not k.startswith("__obs")}),
                   obs=to_np(list(obs)), rews=to_np(list(rews)), dones=np.asarray(dones), infos=to_np(list(infos)))
        out[name] = (arrays, acts, ref)
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", WORLDS)
def test_env_step_matches_jax(name, fused, jax_stepped):
    arrays, acts, ref = jax_stepped[name]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=fused)
    assert env._fused_outputs is None and env.world.fused == fused and TF.supports(env.world)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, infos = env.step([torch.as_tensor(a) for a in acts])
    st = env.state
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), ref[f], err_msg=f, **STATE_TOL)
    got_dyn = [d.numpy() for d in st.dyn if isinstance(d, torch.Tensor)]
    assert len(got_dyn) == len(ref["dyn"]) == (2 if name == "drone" else 0)
    for d, r in zip(got_dyn, ref["dyn"]):
        np.testing.assert_allclose(d, r, err_msg="dyn", **STATE_TOL)
    for a, u, r in zip(env.world.agents, st.u, ref["u"]):
        assert u.shape == (B, a.action_size) == r.shape
        np.testing.assert_allclose(u.numpy(), r, err_msg="u", **STATE_TOL)
    assert set(st.scenario) == set(ref["scenario"])
    for key, val in st.scenario.items():
        if isinstance(val, dict):  # a controller's memory
            for k2, v2 in val.items():
                np.testing.assert_allclose(v2.numpy(), ref["scenario"][key][k2], err_msg=f"{key}.{k2}", **STATE_TOL)
        else:
            np.testing.assert_allclose(val.numpy(), ref["scenario"][key], err_msg=key, **REW_TOL)
    for i in range(env.n_agents):
        np.testing.assert_allclose(obs[i].numpy(), ref["obs"][i], err_msg="obs", **OBS_TOL)
        np.testing.assert_allclose(rews[i].numpy(), ref["rews"][i], err_msg="reward", **REW_TOL)
        assert set(infos[i]) == set(ref["infos"][i])
        for k, v in infos[i].items():
            np.testing.assert_allclose(v.numpy(), ref["infos"][i][k], err_msg=k, **REW_TOL)
    np.testing.assert_array_equal(dones.numpy(), ref["dones"])
    if name == "drone":
        assert 0 < int(dones.sum()) < B


@pytest.mark.parametrize("name", WORLDS)
def test_state_shows_the_events(name):
    """The fused step's input rows of a step from the injected state (the
    hooks' forces and torques in them) show the events the card's
    comparison requires, and K1's plain version steps them as the plain
    physics does, within STATE_TOL."""
    arrays, acts = inputs(name)
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True)
    st = env._act(state_from_numpy(env.world, arrays), [torch.as_tensor(a) for a in acts],
                  [(None, None)] * env.n_agents)
    x = torch.cat([TF.state_rows(st), st.joint_fixed_rot.T])
    events = testing.debug_world_events(env, x)
    assert all(events[k] > 0 for k in REQUIRED[name]), events
    y = TF.fused_step_plain(env.world, x)
    env.world.fused = False
    ref = TF.state_rows(env.world.step(st))
    torch.testing.assert_close(y[:ref.shape[0]], ref, **STATE_TOL)


def test_drone_done_past_30_degrees():
    """needs_reset is the ±30 degree roll or pitch test on the hidden state,
    against the JAX package's on the same states, and done is its any()
    over the drones."""
    import jax.numpy as jnp

    env = torch_make_env("drone", B, device="cpu", seed=0)
    jenv = vmas_tpu.make_env("drone", B, seed=0)
    deg = np.pi / 180
    angles = np.array([0, 29.9, 30.1, -30.1, 45, -10, 0, 31], np.float64) * deg
    for axis in (0, 1):
        ds = np.zeros((B, 12), np.float32)
        ds[:, axis] = angles
        other = np.zeros((B, 12), np.float32)
        other[::4, 1 - axis] = 0.6  # the second drone tilted in envs 0 and 4
        st = env.state.replace(dyn=(torch.as_tensor(ds), torch.as_tensor(other)))
        js = jenv.state.replace(dyn=(jnp.asarray(ds), jnp.asarray(other)))
        a0, a1 = env.world.agents
        want0 = np.abs(ds[:, axis]) > np.float32(30 * deg)
        np.testing.assert_array_equal(a0.dynamics.needs_reset(st).numpy(), want0)
        np.testing.assert_array_equal(a0.dynamics.needs_reset(st).numpy(),
                                      np.asarray(jenv.world.agents[0].dynamics.needs_reset(js)))
        done = env.scenario.done(st).numpy()
        np.testing.assert_array_equal(done, want0 | (np.arange(B) % 4 == 0))
        np.testing.assert_array_equal(done, np.asarray(jenv.scenario.done(js)))


def refresh(env, state):
    """tests/test_scenario_parity.py's scratch refresh: one discarded reward
    cycle on the injected state."""
    sc = env.scenario
    state = sc.pre_rewards(state)
    for a in env.agents:
        sc.reward(a, state)
    return sc.post_rewards(state)


@pytest.mark.parametrize("name", WORLDS)
def test_golden_replay(name):
    d = np.load(GOLDEN.format(name))
    nb, T_all = d["init_pos"].shape[0], d["actions"].shape[0]
    atol = 2e-3
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert env._fused_outputs is None and env.world.fused
    base = env.state

    def inject(pos, vel, rot, ang_vel, state):
        z = torch.zeros_like
        return state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                             ang_vel=torch.as_tensor(ang_vel), force=z(state.force), torque=z(state.torque))

    def close(a, ref, tol, msg, forked):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)
        assert per_env.max() <= 1.0, f"{msg}: max error {per_env.max():.4f} beyond the cap"
        bad = np.flatnonzero(per_env > tol)
        assert len(bad) <= n_chaotic, f"{msg}: envs {bad} beyond {tol} (max {per_env.max():.2e})"
        forked.update(map(int, bad))

    for resync in (False, True):
        # the re-synced replay lets one env a step fork, as the JAX package's does
        n_chaotic = max(CHAOTIC.get(name, 0), 1) if resync else CHAOTIC.get(name, 0)
        env.world.fused = not (resync and name in RESYNC_PLAIN)
        env.state = refresh(env, inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], base))
        forked = set()
        for t in range(T_all if resync else min(T_all, GOLDEN_T.get(name, T_all))):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state)
            acts = [torch.as_tensor(d["actions"][t, i, :, :env.get_agent_action_size(a)])
                    for i, a in enumerate(env.agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{name} ({'re-synced' if resync else 'free'}) step {t}"
            close(env.state.pos.numpy(), d["pos"][t], atol, f"{tag}: pos", forked)
            close(env.state.vel.numpy(), d["vel"][t], 10 * atol, f"{tag}: vel", forked)
            close(env.state.rot.numpy(), d["rot"][t], 10 * atol, f"{tag}: rot", forked)
            for i in range(env.n_agents):
                close(obs[i].numpy(), d[f"obs_{i}"][t], 10 * atol, f"{tag}: obs {i}", forked)
                close(rews[i].numpy().reshape(nb, -1), d["rewards"][t, i].reshape(nb, -1), 10 * atol,
                      f"{tag}: reward {i}", forked)
            assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"{tag}: done"
        if not resync:
            assert len(forked) <= CHAOTIC.get(name, 0)


@pytest.mark.parametrize("name", WORLDS)
def test_reset_invariants(name):
    env = torch_make_env(name, 64, device="cpu", seed=3)
    st = env.state
    idx = [a.index for a in env.world.agents]
    pos = st.pos[:, idx]
    assert bool(torch.isfinite(st.pos).all()) and float(st.vel.abs().max()) == 0.0
    if name in ("diff_drive", "kinematic_bicycle", "drone"):
        assert float(pos.abs().max()) <= 1.0
        d = (pos[:, 0] - pos[:, 1]).norm(dim=-1)
        assert float(d.min()) >= 0.1 - 1e-6  # spawned apart
    if name == "drone":
        assert all(bool((dd == 0).all()) and dd.shape == (64, 12) for dd in st.dyn)
        assert not bool(env.scenario.done(st).any())
    if name == "vel_control":
        assert bool((pos == torch.tensor([-1.0, 0.0])).all())
    if name == "line_trajectory":
        assert bool((pos[..., 0].abs() <= 1).all() and (pos[..., 1] <= 0).all() and (pos[..., 1] >= -1).all())
    for key, val in st.scenario.items():
        if key.startswith("__vel_ctrl"):
            assert all(float(v.abs().max()) == 0.0 for v in val.values())
    # a partial reset touches only its env
    env.step(env.get_random_actions())
    before = env.state
    env.reset_at(5)
    keep = torch.arange(64) != 5
    assert torch.equal(env.state.pos[keep], before.pos[keep]) and torch.equal(env.state.vel[5], torch.zeros_like(
        before.vel[5]))
