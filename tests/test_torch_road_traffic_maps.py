"""The port's road_traffic maps 2 and 3 and testing mode against the JAX
package's, and against the recorded reference trajectories.

The JAX side runs its scenario's hooks (jitted one by one, on its plain
path: ``pallas_sweeps``/``pallas_obs`` off) on states the port makes, so
that each hook's output is held to the port's from the same input; the
port runs its defaults (the kernels' plain versions here). Tolerances:

* map 2: the history ring (``hist``, ``hist_ptr``, ``hist_valid``) and the
  ISB (``isb_buffer`` below its trash row, ``isb_size``) equal to the JAX
  package's after each of several steps with collisions forced in four
  envs and ``probability_record=1.0`` (the ring and the ISB wrap, and more
  envs record in a step than the ISB holds); the ISB's replay at reset with
  ``probability_use_recording=1.0`` and one entry, equal; the counterparts
  of tests/test_scenarios/test_road_traffic.py:41-111 (the lead-up
  recorded, not the collision state; one-slot rings; ``n_steps_stored``
  ago);
* map 3 and testing mode, from ``testing.rt_events_state`` (agents
  colliding in the even envs, at their exits or entries, or across their
  lane, in the odd ones): ``done_flags`` and the agents
  reset equal to the JAX package's; the agents not reset and their ids
  equal (unchanged); the distances refreshed after the resets atol 1e-5 in
  the envs where no agent was reset; the reset agents by invariants (their
  ``scenario_id`` kept, ``path_id`` inside their sub-map's section,
  ``point_id`` in its range, on their path, ``prev_pos`` at the new
  position); the sweep runs twice a step;
* ``rollout_fn`` bitwise ``env.step`` on all three configurations;
* the golden replays of maps 2 and 3 with tests/test_scenario_parity.py's
  ``KWARGS``, ``CHAOTIC_ENVS`` (map 3: one env) and
  ``_rebuild_road_traffic`` (map 3's path ids shifted by
  ``section_offsets``), atol 2e-3.
"""

import os

import numpy as np
import pytest
import torch

from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
from vmas_tpu_torch.interop import FIELDS, state_to_numpy
from vmas_tpu_torch.parallel.rollout import _fork, _random_actions_for_horizon, _u_ranges, rollout_fn
from vmas_tpu_torch.scenarios import road_traffic as trt
from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk

torch.set_num_threads(1)

B, A = 8, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "data", "scenario_{}.npz")
MAP2 = dict(map_type="2", n_agents=A, is_add_noise=False, probability_record=1.0, n_steps_stored=2,
            n_steps_before_recording=3, buffer_size=2)
MAP3 = dict(map_type="3", n_agents=A, is_add_noise=False, scenario_probabilities=[0.4, 0.3, 0.3])
TESTING = dict(is_testing_mode=True, n_agents=A, is_add_noise=False)
CONFIGS = {"map3": MAP3, "testing": TESTING}


def jax_scenario(kw, n=B):
    """The JAX package's scenario on its plain path, with its world built
    (no environment, so nothing is compiled until a hook is jitted)."""
    from vmas_tpu.scenarios import road_traffic as jrt

    sc = jrt.Scenario()
    sc.env_make_world(n, None, pallas_sweeps=False, pallas_obs=False, **kw)
    return sc


def to_jax(jsc, state):
    """The port's state as the JAX package's, with a PRNG key for its
    per-step draws."""
    import jax
    import jax.numpy as jnp

    arr = state_to_numpy(state)
    scratch = jax.tree_util.tree_map(jnp.asarray, arr["scenario"])
    scratch["rng"] = jax.random.PRNGKey(0)
    return jsc.world.spawn_state().replace(**{f: jnp.asarray(arr[f]) for f in FIELDS},
                                            u=tuple(jnp.asarray(u) for u in arr["u"]), scenario=scratch)


def before_post_rewards(env, acts, obs_seed=7):
    """The state a step hands to post_rewards: actions, physics, post_step,
    pre_rewards."""
    st = env._act(env.state, [torch.as_tensor(a) for a in acts], [(None, None)] * env.n_agents)
    st = env.scenario.post_step(env.world.step(st))
    env.scenario.obs_seed = obs_seed
    return env.scenario.pre_rewards(st)


def slow_actions(rng, n=B):
    return [np.stack([rng.uniform(0.0, 0.2, n), rng.uniform(-0.2, 0.2, n)], -1).astype(np.float32) for _ in range(A)]


# -- map 2 --------------------------------------------------------------------

def test_map2_history_and_isb_match_jax():
    import jax

    env = torch_make_env("road_traffic", B, device="cpu", seed=0, **MAP2)
    sc, jsc = env.scenario, jax_scenario(MAP2)
    post = jax.jit(jsc.post_rewards)
    env.state = testing.rt_events_state(env)  # collisions in the even envs
    rng = np.random.default_rng(1)
    cap = sc.isb_capacity
    for t in range(6):
        s = before_post_rewards(env, slow_actions(rng))
        got = sc.post_rewards(s).scenario
        want = post(to_jax(jsc, s)).scenario
        for k in ("hist", "hist_ptr", "hist_valid", "isb_size", "prev_pos"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{k} at step {t}")
        for k in ("steering_cur", "steering_prev"):  # XLA divides by the constant as a product
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=f"{k} at step {t}")
        np.testing.assert_array_equal(got["isb_buffer"][:cap].numpy(), np.asarray(want["isb_buffer"])[:cap],
                                      err_msg=f"isb_buffer at step {t}")
        env.state = s.replace(scenario=got)
    # the four colliding envs recorded each step, more than the ISB's two slots
    assert int(got["isb_size"]) >= 4 * 6 and int(got["hist_valid"].min()) == 3


def test_map2_isb_replay_at_reset_matches_jax():
    import jax
    import jax.numpy as jnp

    kw = dict(MAP2, probability_use_recording=1.0)
    env = torch_make_env("road_traffic", B, device="cpu", seed=0, **kw)
    sc, jsc = env.scenario, jax_scenario(kw)
    for _ in range(2):
        env.step(env.get_random_actions())
    entry = sc._hist_entry(env.state, env.state.scenario)[3]  # env 3's state, [A, 8]
    scr = dict(env.state.scenario)
    buf = torch.zeros_like(scr["isb_buffer"])
    buf[0] = entry
    scr.update(isb_buffer=buf, isb_size=torch.tensor(1))
    state = env.state.replace(scenario=scr)
    got = sc._reset_agents_states(env.world.zeroed(state), torch.Generator().manual_seed(3))
    jstate = to_jax(jsc, state)
    want = jax.jit(jsc._reset_agents_states)(jsc.world.zeroed(jstate), jax.random.PRNGKey(5))
    for f in ("pos", "rot", "vel"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for k in ("scenario_id", "path_id", "point_id"):
        np.testing.assert_array_equal(got.scenario[k].numpy(), np.asarray(want.scenario[k]), err_msg=k)
    # every env took the entry
    pos, rot, vel = sc._agent_arrays(got)
    assert torch.equal(pos, entry[None, :, 0:2].expand(B, -1, -1)) and torch.equal(rot, entry[None, :, 2].expand(B, -1))
    # through env.reset too, the buffer carried over
    env.state = state
    env.reset()
    assert torch.equal(sc._agent_arrays(env.state)[0], entry[None, :, 0:2].expand(B, -1, -1))
    assert int(env.state.scenario["isb_size"]) == 1 and torch.equal(env.state.scenario["isb_buffer"][0], entry)


def _force_record(env):
    """Every collision flag set, the ISB recorder run on the current state:
    (buffer, size)."""
    sc = env.scenario
    s = dict(env.state.scenario)
    s["coll_agents"] = torch.ones_like(s["coll_agents"])
    st = sc._isb_record(env.state.replace(scenario=s), torch.Generator().manual_seed(0))
    return st.scenario["isb_buffer"].numpy(), int(st.scenario["isb_size"])


@pytest.fixture()
def map2_env():
    return torch_make_env("road_traffic", 2, device="cpu", seed=0, map_type="2", n_agents=4, probability_record=1.0,
                          is_add_noise=False)


def test_isb_records_leadup_not_collision_state(map2_env):
    env = map2_env
    sc = env.scenario
    seed_entry = env.state.scenario["hist"][:, 0].numpy().copy()
    entries = []
    for _ in range(3):
        env.step(env.get_random_actions())
        entries.append(sc._hist_entry(env.state, env.state.scenario).numpy())
    assert int(env.state.scenario["hist_valid"][0]) == 4  # the seed and 3 pushes
    size0, cap = int(env.state.scenario["isb_size"]), sc.isb_capacity
    buf, size = _force_record(env)
    assert size == size0 + 2
    # fewer than n_steps_stored steps since the reset: the lead-up is the seed
    np.testing.assert_array_equal(buf[size0 % cap], seed_entry[0])
    np.testing.assert_array_equal(buf[(size0 + 1) % cap], seed_entry[1])
    assert not np.array_equal(buf[size0 % cap], entries[-1][0])


def test_isb_edge_ring_sizes():
    """A one-slot history ring wraps its pointer and holds the latest state;
    a one-entry ISB keeps the last recording env's entry."""
    env = torch_make_env("road_traffic", 2, device="cpu", seed=0, map_type="2", n_agents=4, probability_record=1.0,
                         is_add_noise=False, n_steps_before_recording=1, buffer_size=1)
    sc = env.scenario
    for _ in range(2):
        env.step(env.get_random_actions())
    assert int(env.state.scenario["hist_ptr"][0]) == 0
    latest = sc._hist_entry(env.state, env.state.scenario).numpy()
    buf, _ = _force_record(env)
    np.testing.assert_array_equal(buf[0], latest[1])


def test_isb_records_n_steps_stored_ago(map2_env):
    env = map2_env
    sc = env.scenario
    n = sc.n_steps_stored
    env.reset(seed=1)
    entries = []
    for _ in range(n + 2):
        env.step(env.get_random_actions())
        entries.append(sc._hist_entry(env.state, env.state.scenario).numpy())
    assert int(env.state.scenario["hist_valid"][0]) == sc.n_steps_before_recording
    size0, cap = int(env.state.scenario["isb_size"]), sc.isb_capacity
    buf, size = _force_record(env)
    assert size == size0 + 2
    np.testing.assert_array_equal(buf[size0 % cap], entries[-n][0])
    np.testing.assert_array_equal(buf[(size0 + 1) % cap], entries[-n][1])


# -- map 3 and testing mode ---------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_in_step_resets_match_jax(config):
    import jax

    kw = CONFIGS[config]
    env = torch_make_env("road_traffic", B, device="cpu", seed=0, **kw)
    sc, jsc = env.scenario, jax_scenario(kw)
    env.state = testing.rt_events_state(env)
    s = before_post_rewards(env, slow_actions(np.random.default_rng(2)))
    got = sc.post_rewards(s)
    want = jax.jit(jsc.post_rewards)(to_jax(jsc, s))
    f = s.scenario
    is_done = f["coll_agents"].reshape(B, -1).any(-1) | f["coll_lanelets"].any(-1)
    mask = f["coll_entry"] | f["coll_exit"]
    if config == "testing":
        mask = mask | f["coll_agents"].any(-1) | f["coll_lanelets"]
        is_done = torch.zeros_like(is_done)
    else:
        mask = mask & ~is_done[:, None]
    np.testing.assert_array_equal(got.scenario["done_flags"].numpy(), np.asarray(want.scenario["done_flags"]))
    np.testing.assert_array_equal(got.scenario["done_flags"].numpy(), is_done.numpy())
    pos0, rot0, vel0 = sc._agent_arrays(s)
    pos1, rot1, vel1 = sc._agent_arrays(got)
    jpos = torch.tensor(np.asarray(want.pos))[:, [a.index for a in env.world.agents]]
    moved = (pos1 != pos0).any(-1)
    jmoved = (jpos != pos0).any(-1)
    assert torch.equal(moved, mask) and torch.equal(jmoved, mask), (moved, jmoved, mask)
    if config == "testing":  # the colliding agents and the one over a boundary
        assert bool(mask[0, :2].all()) and bool(mask[2, :2].all()) and bool(mask[1, 2])
    else:  # the agents at exit and entry, and none in the envs that collided
        assert bool(mask[1, 2]) and bool(mask[3, 3]) and bool(is_done[0]) and not bool(mask[0].any())
    # the agents not reset: unchanged, as in the JAX package
    keep = ~mask
    for k in ("scenario_id", "path_id", "point_id"):
        assert torch.equal(got.scenario[k][keep], s.scenario[k][keep])
        np.testing.assert_array_equal(got.scenario[k][keep].numpy(), np.asarray(want.scenario[k])[keep.numpy()])
    assert torch.equal(pos1[keep], pos0[keep]) and torch.equal(rot1[keep], rot0[keep]) and torch.equal(
        vel1[keep], vel0[keep])
    np.testing.assert_allclose(got.scenario["prev_pos"][keep].numpy(),
                               np.asarray(want.scenario["prev_pos"])[keep.numpy()], atol=1e-6)
    # the refreshed distances in the envs where nothing was reset
    calm = ~mask.any(-1)
    for k in ("d_ref", "d_left", "d_right", "short_term"):
        np.testing.assert_allclose(got.scenario[k][calm].numpy(), np.asarray(want.scenario[k])[calm.numpy()],
                                   atol=1e-5, err_msg=k)
    for k in ("idx_ref", "coll_agents", "coll_lanelets", "coll_entry", "coll_exit"):
        np.testing.assert_array_equal(got.scenario[k][calm].numpy(), np.asarray(want.scenario[k])[calm.numpy()],
                                      err_msg=k)
    # the reset agents by invariants
    sid, pid, ptid = (got.scenario[k][mask] for k in ("scenario_id", "path_id", "point_id"))
    assert torch.equal(sid, s.scenario["scenario_id"][mask])
    offs = sc._offsets
    if config == "map3":
        assert bool((pid >= offs[sid - 1]).all()) and bool((pid < offs[sid]).all())
    n = sc.P["n_points"][pid]
    assert bool((ptid >= 3).all()) and bool((ptid < n - 5).all()) if config == "map3" else bool(
        (ptid >= 6).all()) and bool((ptid < torch.div(n, 2, rounding_mode="trunc")).all())
    assert torch.equal(pos1[mask], sc.P["center"][pid, ptid]) and torch.equal(rot1[mask], sc.P["yaw"][pid, ptid])
    assert torch.equal(got.scenario["prev_pos"][mask], pos1[mask])
    # the verdict of env.done is the reward phase's
    assert torch.equal(sc.done(got), got.scenario["done_flags"])


@pytest.mark.parametrize("kw", [dict(n_agents=A), MAP2, MAP3, TESTING], ids=["map1", "map2", "map3", "testing"])
def test_sweeps_per_step(kw, monkeypatch):
    """The path sweep (K3 on the card) runs once a step, and twice in map 3
    and testing mode, whose per-agent resets refresh the distances."""
    env = torch_make_env("road_traffic", 4, device="cpu", seed=0, **kw)
    calls = []
    orig = rtk.sweep_all
    monkeypatch.setattr(rtk, "sweep_all", lambda *a, **k: calls.append(1) or orig(*a, **k))
    for _ in range(3):
        env.step(env.get_random_actions())
    assert len(calls) == 3 * (2 if kw.get("map_type") == "3" or kw.get("is_testing_mode") else 1)


@pytest.mark.parametrize("kw", [MAP2, dict(MAP3, n_agents=A), TESTING], ids=["map2", "map3", "testing"])
def test_rollout_fn_reproduces_env_step(kw):
    """The per-step draws (in-step resets, the ISB's record gate) come from
    the generator the step is given, so rollout_fn and env.step from one
    state and one generator seed agree bitwise, resets included."""
    env = torch_make_env("road_traffic", B, device="cpu", seed=0, **kw)
    env.state = testing.rt_events_state(env)
    s0, st0 = env.state, env.steps
    T = 4
    state, steps, traj = rollout_fn(env, horizon=T)(s0, st0, torch.Generator().manual_seed(11))
    g_pol, g_step = _fork(torch.Generator().manual_seed(11), 2)
    acts = _random_actions_for_horizon(env, g_pol, T, _u_ranges(env))
    env.generator = g_step
    rews = []
    for t in range(T):
        rews.append(torch.stack(env.step([a[t] for a in acts])[1], -1))
    assert torch.equal(torch.stack(rews), traj["rewards"])
    assert torch.equal(env.state.pos, state.pos) and torch.equal(env.steps, steps)
    for k, v in state.scenario.items():
        assert torch.equal(env.state.scenario[k], v), k
    if kw.get("map_type") == "2":
        assert int(state.scenario["isb_size"]) > 0
    else:
        assert not torch.equal(state.scenario["path_id"], s0.scenario["path_id"])  # resets ran


# -- golden replays -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["road_traffic_map2", "road_traffic_map3"])
def test_golden_replay(case):
    """tests/test_scenario_parity.py's replay of the recorded reference
    trajectory (16 envs, 50 steps), free-running, with its
    _rebuild_road_traffic (no refresh)."""
    d = np.load(GOLDEN.format(case))
    kw = dict(is_add_noise=False, map_type="2") if case.endswith("2") else dict(
        is_add_noise=False, map_type="3", n_agents=4, scenario_probabilities=[0.4, 0.3, 0.3])
    n_chaotic = 1 if case.endswith("3") else 0
    nb, T, atol = d["init_pos"].shape[0], d["actions"].shape[0], 2e-3
    env = torch_make_env("road_traffic", nb, device="cpu", seed=0, **kw)
    sc = env.scenario
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    z = torch.zeros_like
    state = env.state.replace(
        pos=torch.as_tensor(d["init_pos"]), vel=torch.as_tensor(d["init_vel"]),
        rot=torch.as_tensor(d["init_rot"]), ang_vel=torch.as_tensor(d["init_ang_vel"]),
        force=z(env.state.force), torque=z(env.state.torque),
    )
    scr = dict(state.scenario)
    sid = torch.as_tensor(d["extra_scenario_id"], dtype=torch.int64)
    scr["scenario_id"] = sid
    scr["path_id"] = torch.as_tensor(d["extra_path_id"], dtype=torch.int64)
    if sc.map_type == "3":
        # the recording's path ids index the current sub-map's list
        scr["path_id"] = scr["path_id"] + sc._offsets[sid - 1]
    scr["point_id"] = torch.as_tensor(d["extra_point_id"], dtype=torch.int64)
    scr = sc._update_distances(state, scr)
    scr["short_term"] = z(scr["short_term"])
    scr = sc._refresh_short_term(scr)
    pos, _, _ = sc._agent_arrays(state)
    scr.update(prev_pos=pos, steering_cur=z(scr["steering_cur"]), steering_prev=z(scr["steering_prev"]),
               rew_all=z(scr["rew_all"]))
    env.state = state.replace(scenario=scr)

    def close(arr, ref, tol, msg):
        err = np.abs(np.asarray(arr, np.float64) - np.asarray(ref, np.float64))
        per_env = err.reshape(err.shape[0], -1).max(1)
        assert (per_env <= 1.0).all(), f"{msg}: beyond the cap ({per_env.max():.4f})"
        bad = np.flatnonzero(per_env > tol)
        assert len(bad) <= n_chaotic, f"{msg}: envs {bad} beyond atol={tol} (max {per_env.max():.4f})"

    for t in range(T):
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)])
        close(env.state.pos, d["pos"][t], atol, f"{case} pos at step {t}")
        close(env.state.vel, d["vel"][t], 10 * atol, f"{case} vel at step {t}")
        close(env.state.rot, d["rot"][t], 10 * atol, f"{case} rot at step {t}")
        for i in range(env.n_agents):
            close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"{case} obs[{i}] at step {t}")
            close(rews[i].reshape(nb, -1), d["rewards"][t, i].reshape(nb, -1), 10 * atol,
                  f"{case} reward[{i}] at step {t}")
        assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"{case} dones at step {t}"


def test_map3_rejects_too_many_agents():
    with pytest.raises(ValueError, match="maximum of 5"):
        torch_make_env("road_traffic", 2, device="cpu", map_type="3", n_agents=6,
                       scenario_probabilities=[0.4, 0.3, 0.3])
    with pytest.raises(ValueError, match="maximum of 10"):
        torch_make_env("road_traffic", 2, device="cpu", map_type="3", n_agents=11)
    sc = torch_make_env("road_traffic", 2, device="cpu", map_type="3", n_agents=10).scenario
    # the three sub-maps' 32 paths one after the other
    assert sc.section_offsets[0] == 0 and sc.section_offsets[-1] == sc.P["center"].shape[0] == 32
    assert trt.STEP_STREAM >= sc.n_agents  # the step's draws have a stream of their own
