"""The port's painting, construction and sampling (with dots_core) against
the JAX package's, and against the recorded reference trajectories.

None of them has fused outputs: with ``fused_physics=True`` the fused step
(K1) runs with no emit and the hooks run around it, as in the JAX package.

* One env step from an injected state (``testing.dots_world_state``: an
  agent pressed into a wall or the bound, two agents into each other,
  painting's knowledge matched and on goal, sampling's field and visited
  cells; ``testing.dots_world_actions``) for painting (nav, and
  ``task_type="full"`` with its comm), construction and sampling, on the
  plain physics and on the fused step's plain version, against the JAX
  package's env.step: state atol 1e-5 rtol 1e-5 (comm state and
  knowledge too), observations atol 2e-5 rtol 1e-5, rewards, infos and
  reward scratch atol 2e-3, dones and sampling's visited cells equal.
* The states' contacts on the fused step's input rows, which the card's
  comparison requires.
* The recorded reference trajectories (16 envs, 50 steps) through env.step
  on the fused step's plain version, free-running and then re-synced, with
  tests/test_scenario_parity.py's tolerance table (2e-3), forked envs (none)
  and scratch rebuilds (knowledge and expected knowledge injected;
  sampling's field injected and rebuilt, no refresh).
* Reset invariants where the random streams differ: painting's colours,
  knowledge ranges and spacing; sampling's field and spawn; partial
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
from vmas_tpu_torch.scenarios.painting import SET2

torch.set_num_threads(1)

B = 8
WORLDS = tuple(testing.DOTS_WORLDS)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
OBS_TOL = dict(atol=2e-5, rtol=1e-5)
REW_TOL = dict(atol=2e-3, rtol=0.0)
FIELDS = ("pos", "vel", "rot", "ang_vel", "c")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_{}.npz")
# the pair types each state must show on the fused step's input rows
REQUIRED = {"painting": ("ss", "bs"), "painting_full": ("ss", "bs"), "construction": ("ss", "bs"),
            "sampling": ("ss", "beyond_bound")}


def make(key, n=B, **kw):
    name, config = testing.DOTS_WORLDS[key]
    return torch_make_env(name, n, device="cpu", seed=0, **config, **kw)


def inputs(key):
    env = make(key)
    rng = np.random.default_rng(40 + WORLDS.index(key))
    return testing.dots_world_state(env, rng), testing.dots_world_actions(env, rng)


def jax_state(jenv, arrays):
    import jax
    import jax.numpy as jnp

    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario", "dyn")}
    return jenv.state.replace(**kw, u=tuple(jnp.asarray(x) for x in arrays["u"]),
                              scenario={**jenv.state.scenario,
                                        **jax.tree_util.tree_map(jnp.asarray, arrays["scenario"])})


@pytest.fixture(scope="module")
def jax_stepped():
    """Per world: the injected state and actions, and the JAX package's
    env.step from them, each compiled once per file."""
    import jax
    import jax.numpy as jnp

    out = {}
    for key in WORLDS:
        arrays, acts = inputs(key)
        name, config = testing.DOTS_WORLDS[key]
        jenv = vmas_tpu.make_env(name, B, seed=0, **config)
        jenv.state = jax_state(jenv, arrays)
        obs, rews, dones, infos = jenv.step([jnp.asarray(a) for a in acts])
        js = jenv.state
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        ref = {f: np.asarray(getattr(js, f)) for f in FIELDS}
        ref.update(scenario=to_np({k: v for k, v in js.scenario.items() if not k.startswith("__obs")}),
                   obs=to_np(list(obs)), rews=to_np(list(rews)), dones=np.asarray(dones), infos=to_np(list(infos)))
        out[key] = (arrays, acts, ref)
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("key", WORLDS)
def test_env_step_matches_jax(key, fused, jax_stepped):
    arrays, acts, ref = jax_stepped[key]
    env = make(key, fused_physics=fused)
    assert env._fused_outputs is None and env.world.fused == fused and TF.supports(env.world)
    env.state = state_from_numpy(env.world, arrays)
    obs, rews, dones, infos = env.step([torch.as_tensor(a) for a in acts])
    st = env.state
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), ref[f], err_msg=f, **STATE_TOL)
    assert set(st.scenario) == set(ref["scenario"])
    for k, v in st.scenario.items():
        tol = STATE_TOL if k.startswith("__dots") else REW_TOL
        if v.dtype == torch.bool:
            np.testing.assert_array_equal(v.numpy(), ref["scenario"][k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), ref["scenario"][k], err_msg=k, **tol)
    for i in range(env.n_agents):
        np.testing.assert_allclose(obs[i].numpy(), ref["obs"][i], err_msg=f"obs {i}", **OBS_TOL)
        np.testing.assert_allclose(rews[i].numpy(), ref["rews"][i], err_msg=f"reward {i}", **REW_TOL)
        assert set(infos[i]) == set(ref["infos"][i])
        for k, v in infos[i].items():
            np.testing.assert_allclose(v.numpy(), ref["infos"][i][k], err_msg=k, **REW_TOL)
    np.testing.assert_array_equal(dones.numpy(), ref["dones"])
    if key == "painting_full":
        # the mixing ran: some mixed colours moved
        moved = [not np.allclose(st.scenario[a._kkey()].numpy()[:, 1], arrays["scenario"][a._kkey()][:, 1])
                 for a in env.scenario.agent_list]
        assert any(moved)


@pytest.mark.parametrize("key", WORLDS)
def test_state_shows_the_contacts(key):
    """The fused step's input rows of a step from the injected state show
    the contacts the card's comparison requires, and K1's plain version
    steps them as the plain physics does, within STATE_TOL."""
    arrays, acts = inputs(key)
    env = make(key, fused_physics=True)
    st = env._act(state_from_numpy(env.world, arrays), [torch.as_tensor(a) for a in acts],
                  [(None, None)] * env.n_agents)
    x = torch.cat([TF.state_rows(st), st.joint_fixed_rot.T])
    events = testing.dots_world_events(env, x)
    assert all(events[k] > 0 for k in REQUIRED[key]), events
    y = TF.fused_step_plain(env.world, x)
    env.world.fused = False
    ref = TF.state_rows(env.world.step(st))
    torch.testing.assert_close(y[:ref.shape[0]], ref, **STATE_TOL)


def test_painting_process_action_runs_per_agent_in_order():
    """painting overrides process_action (the knowledge mixing), so its
    agents run one by one in agent order, never grouped."""
    env = make("painting_full")
    singles, groups = env._plan_process_action()
    assert groups == [] and [a.index for a in singles] == [a.index for a in env.world.agents]


# -- golden replays -------------------------------------------------------------

def rebuild(env, state, d, key):
    """tests/test_scenario_parity.py's scratch rebuilds: the recorded
    knowledge (painting), the recorded Gaussian centres with max_pdf, the
    visited cells and the reset-time samples rebuilt (sampling)."""
    sc = env.scenario
    if "extra_agent_knowledge" in d:
        for i, a in enumerate(sc.agent_list):
            state = a.set_knowledge(state, torch.as_tensor(d["extra_agent_knowledge"][:, i], dtype=torch.float32))
    if "extra_goal_knowledge" in d:
        for j, g in enumerate(sc.goals):
            state = g.set_expected_knowledge(state, torch.as_tensor(d["extra_goal_knowledge"][:, j],
                                                                    dtype=torch.float32))
    if key == "sampling":
        scr = dict(state.scenario)
        locs = torch.as_tensor(d["extra_locs"])
        scr["locs"] = locs
        scr["sampled"] = torch.zeros_like(scr["sampled"])
        scr["max_pdf"] = sc._max_pdf(locs)
        scr["agent_samples"] = torch.stack([sc._sample(scr, a.pos(state), norm=sc.norm)[0]
                                            for a in sc.world.agents], dim=-1)
        scr["sampling_rew"] = torch.zeros_like(scr["sampling_rew"])
        state = state.replace(scenario=scr)
    return state


def refresh(env, state, key):
    """One discarded reward cycle (sampling: none, NO_REFRESH)."""
    if key == "sampling":
        return state
    sc = env.scenario
    state = sc.pre_rewards(state)
    for a in env.agents:
        sc.reward(a, state)
    return sc.post_rewards(state)


@pytest.mark.parametrize("key", WORLDS)
def test_golden_replay(key):
    d = np.load(GOLDEN.format(key))
    nb, T = d["init_pos"].shape[0], d["actions"].shape[0]
    atol = 2e-3
    name, config = testing.DOTS_WORLDS[key]
    config = dict(config, n_agents=3, n_goals=3) if key == "painting_full" else config
    env = torch_make_env(name, nb, device="cpu", seed=0, fused_physics=True, **config)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    assert env._fused_outputs is None and env.world.fused
    base = env.state

    def inject(pos, vel, rot, ang_vel, state):
        z = torch.zeros_like
        return state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                             ang_vel=torch.as_tensor(ang_vel), force=z(state.force), torque=z(state.torque))

    def close(a, ref, tol, msg):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)
        assert per_env.max() <= 1.0, f"{msg}: max error {per_env.max():.4f} beyond the cap"
        bad = np.flatnonzero(per_env > tol)
        assert len(bad) <= n_chaotic, f"{msg}: envs {bad} beyond {tol} (max {per_env.max():.2e})"

    for resync in (False, True):
        # the re-synced replay lets one env a step fork, as the JAX package's does
        n_chaotic = 1 if resync else 0
        state = rebuild(env, inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"], base), d, key)
        env.state = refresh(env, state, key)
        for t in range(T):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1],
                                   env.state)
            acts = [torch.as_tensor(d["actions"][t, i, :, :env.get_agent_action_size(a)])
                    for i, a in enumerate(env.agents)]
            obs, rews, dones, _ = env.step(acts)
            tag = f"{key} ({'re-synced' if resync else 'free'}) step {t}"
            close(env.state.pos.numpy(), d["pos"][t], atol, f"{tag}: pos")
            close(env.state.vel.numpy(), d["vel"][t], 10 * atol, f"{tag}: vel")
            close(env.state.rot.numpy(), d["rot"][t], 10 * atol, f"{tag}: rot")
            for i in range(env.n_agents):
                close(obs[i].numpy(), d[f"obs_{i}"][t], 10 * atol, f"{tag}: obs {i}")
                close(rews[i].numpy().reshape(nb, -1), d["rewards"][t, i].reshape(nb, -1), 10 * atol,
                      f"{tag}: reward {i}")
            assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"{tag}: done"


# -- resets ---------------------------------------------------------------------

@pytest.mark.parametrize("key", ["painting", "painting_full", "construction"])
def test_dots_reset_invariants(key):
    env = make(key, 64)
    sc, st = env.scenario, env.state
    B_ = 64
    spawned = sc.agent_list + sc.goals if key != "construction" else env.world.agents + sc.col_points + sc.blueprints
    pos = st.pos[:, [e.index for e in spawned]]
    assert bool((pos.abs() <= 2).all())  # int(-2.5), int(2.5)
    d = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None], dim=-1) + torch.eye(len(spawned)) * 10
    assert float(d.min()) >= 1.0 - 1e-6
    walls = st.pos[:, [w.index for w in env.world.walls]]
    assert torch.equal(walls[0], torch.tensor([[-2.5, 0.0], [2.5, 0.0], [0.0, -2.5], [0.0, 2.5]]))
    assert float(st.vel.abs().max()) == 0.0
    if key == "construction":
        assert [e.name for e in sc.blueprints] == ["blueprint"] * sc.n_blueprints
        assert len({e.index for e in sc.blueprints}) == sc.n_blueprints
        return
    know = torch.stack([a.knowledge(st) for a in sc.agent_list], 1)  # [B, A, 2, 3]
    assert torch.equal(know[:, :, 0], know[:, :, 1])
    expected = torch.stack([g.expected_knowledge(st) for g in sc.goals], 1)  # [B, G, 3]
    if key == "painting":
        palette = torch.tensor(SET2)
        # each env's n distinct Set2 colours, shared by agents and goals
        assert torch.equal(know[:, :, 0], expected)
        idx = (know[:, :, 0, None] == palette).all(-1).float().argmax(-1)  # [B, A]
        assert bool((know[:, :, 0] == palette[idx]).all())
        assert all(len(set(row)) == sc.n_agents for row in idx.tolist())
        assert len({tuple(row) for row in idx.tolist()}) > 1  # the draw differs between envs
    else:
        assert bool((expected >= 0.01).all()) and bool((expected < 1).all())
        assert torch.equal(know[0, :, 0], know[-1, :, 0])  # the ramp
    assert not any(bool(a.seeking_goal(st).any()) for a in sc.agent_list)
    np.testing.assert_allclose(st.scenario["shaping"].numpy(), st.scenario["pos_shape_norm"].numpy())
    assert st.scenario["shaping"].shape == (B_, len(sc.agent_list), sc.n_goals)
    env.step(env.get_random_actions())
    before = env.state
    env.reset_at(5)
    keep = torch.arange(B_) != 5
    assert torch.equal(env.state.pos[keep], before.pos[keep])
    k0 = sc.agent_list[0]
    assert torch.equal(k0.knowledge(env.state)[keep], k0.knowledge(before)[keep])


def test_sampling_reset_and_grid():
    """The field's centres in [-xdim, xdim) x [-ydim, ydim), agents spawned
    in the arena, max_pdf the densest cell, a visited cell scores 0 the
    second time, and the grid's cells are numpy's float32 arange."""
    env = make("sampling", 64)
    sc, st = env.scenario, env.state
    s = st.scenario
    assert s["sampled"].shape == (64, 40, 40) and not bool(s["sampled"].any())
    assert bool((s["locs"].abs() <= 1).all()) and s["locs"].shape == (64, 3, 2)
    pos = st.pos[:, [a.index for a in env.world.agents]]
    assert bool((pos.abs() <= 1).all())
    xs = np.arange(-1, 1, 0.05, dtype=np.float32)
    np.testing.assert_array_equal(sc._grid[:40, 1].numpy(), np.clip(xs, -sc.y_semidim, sc.y_semidim))
    at_loc = sc._pdf(s["locs"], s["locs"][:, 0])
    assert bool((at_loc <= s["max_pdf"] * 1.2).all())
    p = pos[:, 0]
    v1, scr = sc._sample(s, p, update_sampled_flag=True)
    v2, _ = sc._sample(scr, p)
    assert bool((v1 > 0).all()) and bool((v2 == 0).all())
    assert int(scr["sampled"].sum()) == 64
