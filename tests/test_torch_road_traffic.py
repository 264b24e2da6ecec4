"""The port's road_traffic (vmas_tpu_torch, on ``device="cpu"``) against
the JAX package's.

On the CPU the port's kernel wrappers run their plain versions
(road_traffic_kernel.sweep_all_plain / obs_all_plain); the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Inputs are made from
a seed with numpy and handed to both. Tolerances:

* map tables equal, the map XML byte-identical;
* kinematic bicycle: pose deltas atol 1e-6; forces and torques, which divide
  the delta by dt^2 = 2.5e-3, atol 1e-6 rtol 1e-5;
* path sweeps: segment indices, straddle flags and short-term points equal,
  distances atol 1e-5;
* observations: plain kernel against the JAX kernel atol 1e-5 with the same
  neighbours chosen; against the per-agent hook 5e-5 (the hook's polar
  ``to_local`` is about 1 ulp from the kernel's rotation form), the JAX
  package's own tolerance (tests/test_scenarios/test_road_traffic.py);
* env steps from an injected state: observations and rewards atol 5e-5,
  dones and scratch indices equal;
* the golden replay uses the JAX package's own 2e-3, with its one chaotic
  env (tests/test_scenario_parity.py).
"""

import filecmp
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.dynamics.kinematic_bicycle import KinematicBicycle as JaxBicycle
from vmas_tpu.scenarios import road_traffic as jrt
from vmas_tpu.scenarios import road_traffic_kernel as jrtk
from vmas_tpu.scenarios import road_traffic_map as jrtm
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.dynamics import KinematicBicycle
from vmas_tpu_torch.interop import FIELDS, state_from_numpy
from vmas_tpu_torch.scenarios import road_traffic as trt
from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk
from vmas_tpu_torch.scenarios import road_traffic_map as rtm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "data", "scenario_road_traffic.npz")
SMALL = dict(n_agents=4, is_add_noise=False)
SWEEP_KW = dict(lh=0.08, wh=0.04, S=3, interval=2, shift=1)


def _paths():
    return rtm.pad_paths(rtm.build_reference_paths(rtm.parse_map())[0], 6)


# -- (a) the map -------------------------------------------------------------

def test_map_xml_is_a_byte_identical_copy():
    assert filecmp.cmp(jrtm.DEFAULT_MAP_PATH, rtm.DEFAULT_MAP_PATH, shallow=False)
    assert jrtm.DEFAULT_MAP_PATH != rtm.DEFAULT_MAP_PATH


@pytest.mark.parametrize("section", [0, 1, 2, 3], ids=["loops", "intersection", "merge_in", "merge_out"])
def test_padded_paths_match_jax(section):
    mine = rtm.pad_paths(rtm.build_reference_paths(rtm.parse_map())[section], 6)
    ref = jrtm.pad_paths(jrtm.build_reference_paths(jrtm.parse_map())[section], 6)
    assert set(vars(mine)) == set(vars(ref))
    for k, v in vars(ref).items():
        np.testing.assert_array_equal(np.asarray(getattr(mine, k)), np.asarray(v), err_msg=k)
    assert rtm.parse_map()["mean_lane_width"] == jrtm.parse_map()["mean_lane_width"]


# -- (b) kinematic bicycle ---------------------------------------------------

@pytest.mark.parametrize("integration", ["euler", "rk4"])
def test_bicycle_delta_matches_jax(integration):
    rng = np.random.default_rng(0)
    n = 512
    state = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    steer = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    v = rng.uniform(-1, 1, n).astype(np.float32)
    world = SimpleNamespace(dt=0.05)
    kw = dict(width=0.08, l_f=0.08, l_r=0.08, max_steering_angle=0.61, integration=integration)
    mine, ref = KinematicBicycle(world, **kw), JaxBicycle(world, **kw)
    step = "euler" if integration == "euler" else "runge_kutta"
    got = getattr(mine, step)(torch.as_tensor(state), torch.as_tensor(steer), torch.as_tensor(v))
    want = getattr(ref, step)(jnp.asarray(state), jnp.asarray(steer), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("integration", ["euler", "rk4"])
def test_bicycle_process_action_matches_jax(jax_pair, integration):
    """Force and torque of every agent from random poses, velocities and
    actions (steering beyond the limit included, to exercise the clamp)."""
    jenv, tenv = jax_pair(False)
    rng = np.random.default_rng(1)
    B, E = tenv.num_envs, len(tenv.world.entities)
    arrays = {
        "pos": rng.uniform(-2, 2, (B, E, 2)), "vel": rng.uniform(-1, 1, (B, E, 2)),
        "rot": rng.uniform(-3, 3, (B, E)), "ang_vel": rng.uniform(-2, 2, (B, E)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    us = [np.stack([rng.uniform(-1, 1, B), rng.uniform(-0.8, 0.8, B)], -1).astype(np.float32) for _ in range(4)]
    js = jenv.state.replace(**{k: jnp.asarray(v) for k, v in arrays.items()}, u=tuple(jnp.asarray(u) for u in us))
    ts = tenv.state.replace(**{k: torch.as_tensor(v) for k, v in arrays.items()}, u=tuple(torch.as_tensor(u) for u in us))
    for ja, ta in zip(jenv.world.agents, tenv.world.agents):
        ja.dynamics.integration = ta.dynamics.integration = integration
        js = ja.dynamics.process_action(jenv.world, js)
        ts = ta.dynamics.process_action(tenv.world, ts)
        ja.dynamics.integration = ta.dynamics.integration = "rk4"
    np.testing.assert_allclose(ts.force.numpy(), np.asarray(js.force), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ts.torque.numpy(), np.asarray(js.torque), atol=1e-6, rtol=1e-5)


# -- (c) path sweeps ---------------------------------------------------------

def _sweep_inputs(seed=0, B=16, A=20):
    """Lanes on centre-line vertices (vertex ties; padded tails included),
    on left-boundary vertices, and scattered around the paths."""
    p = _paths()
    rng = np.random.default_rng(seed)
    NP, Mc, Mb = p.center.shape[0], p.center.shape[1], p.left_b.shape[1]
    pid = rng.integers(0, NP, (B, A))
    kind = rng.integers(0, 3, (B, A))
    on_c = p.center[pid, rng.integers(0, Mc, (B, A))]
    on_l = p.left_b[pid, rng.integers(0, Mb, (B, A))]
    near = p.center[pid, rng.integers(0, Mc, (B, A))] + rng.normal(0, 0.06, (B, A, 2))
    pos = np.where((kind == 0)[..., None], on_c, np.where((kind == 1)[..., None], on_l, near))
    rot = np.where(kind == 0, p.yaw[pid, rng.integers(0, Mc, (B, A))], rng.uniform(-np.pi, np.pi, (B, A)))
    return p, pid, pos.astype(np.float32), rot.astype(np.float32)


def _jax_sweep_xla(p, pid, pos, rot, S=3):
    """The JAX scenario's XLA-path arithmetic (road_traffic.py helpers)."""
    P = jrt.SimpleNamespaceJnp(p)
    pid, pos, rot = jnp.asarray(pid), jnp.asarray(pos), jnp.asarray(rot)
    verts = jrt.rectangle_vertices(pos, rot, 0.08, 0.16)
    pts = jnp.concatenate([pos[:, :, None, :], verts[:, :, :4]], axis=2)
    n_l, n_r = P.n_left[pid], P.n_right[pid]
    d_ref, idx_ref = jrt.perpendicular_distances(pos, P.center[pid], P.n_points[pid])
    dl5, il = jrt.perpendicular_distances(pts, P.left_b[pid][:, :, None], jnp.broadcast_to(n_l[..., None], n_l.shape + (5,)))
    dr5, ir = jrt.perpendicular_distances(pts, P.right_b[pid][:, :, None], jnp.broadcast_to(n_r[..., None], n_r.shape + (5,)))
    st, _ = jrt.short_term_path(P.center[pid], idx_ref, S, P.is_loop[pid], P.n_points[pid], 2, 1)
    return dict(
        d_ref=d_ref, idx_ref=idx_ref, dl5=dl5, dr5=dr5, idx_l=il[..., 0], idx_r=ir[..., 0],
        coll_l=jrt.interX_any(verts, P.left_b[pid]), coll_r=jrt.interX_any(verts, P.right_b[pid]),
        short_term=st,
    )


def _assert_sweep_equal(got, want, tag):
    for k in ("idx_ref", "idx_l", "idx_r", "coll_l", "coll_r", "short_term"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{tag}: {k}")
    for k in ("d_ref", "dl5", "dr5"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_jax_kernel_and_helpers(seed):
    p, pid, pos, rot = _sweep_inputs(seed)
    tables = rtk.build_tables(p, "cpu")
    got = rtk.sweep_all_plain(tables, torch.as_tensor(pid), torch.as_tensor(pos), torch.as_tensor(rot), **SWEEP_KW)
    ref_k = jrtk.sweep_all(
        jrtk.build_tables(p), jnp.asarray(pid, jnp.int32), jnp.asarray(pos), jnp.asarray(rot),
        Mc=p.center.shape[1], Mb=p.left_b.shape[1], **SWEEP_KW,
    )
    xla = _jax_sweep_xla(p, pid, pos, rot)
    _assert_sweep_equal(got, xla, "vs JAX XLA helpers")
    # The JAX package's two paths can disagree with each other on a vertex
    # tie: in interpret mode on XLA:CPU the Pallas kernel's distance to the
    # segment ending on the vertex may round to 0 where the helpers (and
    # IEEE per-op rounding) give 2.4e-7 (seeds 0-3: 1 to 4 lanes of 320 per
    # index). The port equals the Pallas kernel on every lane where JAX
    # agrees with itself, index by index; the short-term points follow
    # idx_ref.
    for k, by in (("idx_ref",) * 2, ("idx_l",) * 2, ("idx_r",) * 2, ("coll_l",) * 2, ("coll_r",) * 2,
                  ("short_term", "idx_ref")):
        agree = np.asarray(ref_k[by]) == np.asarray(xla[by])
        assert agree.mean() > 0.98, k
        np.testing.assert_array_equal(got[k].numpy()[agree], np.asarray(ref_k[k])[agree], err_msg=k)
    for k in ("d_ref", "dl5", "dr5"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_k[k]), atol=1e-5, rtol=0, err_msg=k)
    # the inputs exercise what they are meant to: vertex lanes, straddles
    assert bool(got["coll_l"].any()) and not bool(got["coll_l"].all())
    assert bool((got["d_ref"] == 0).any())


def test_sweep_plain_matches_port_helpers():
    """sweep_all_plain against the port's own plain-path helpers, which the
    scenario runs with pallas_sweeps=False."""
    p, pid, pos, rot = _sweep_inputs(2)
    tables = rtk.build_tables(p, "cpu")
    pid, pos, rot = torch.as_tensor(pid), torch.as_tensor(pos), torch.as_tensor(rot)
    got = rtk.sweep_all_plain(tables, pid, pos, rot, **SWEEP_KW)
    c, lb, rb = (torch.as_tensor(a)[pid] for a in (p.center, p.left_b, p.right_b))
    n_c, n_l, n_r = (torch.as_tensor(a.astype(np.int64))[pid] for a in (p.n_points, p.n_left, p.n_right))
    verts = trt.rectangle_vertices(pos, rot, 0.08, 0.16)
    pts = torch.cat([pos[:, :, None], verts[:, :, :4]], 2)
    d_ref, idx_ref = trt.perpendicular_distances(pos, c, n_c)
    dl5, il = trt.perpendicular_distances(pts, lb[:, :, None], n_l[..., None].expand(-1, -1, 5))
    st, _ = trt.short_term_path(c, idx_ref, 3, torch.as_tensor(p.is_loop)[pid], n_c, 2, 1)
    assert torch.equal(got["idx_ref"], idx_ref) and torch.equal(got["idx_l"], il[..., 0])
    assert torch.equal(got["d_ref"], d_ref) and torch.equal(got["dl5"], dl5)
    assert torch.equal(got["short_term"], st)
    assert torch.equal(got["coll_l"], trt.interX_any(verts, lb))
    assert torch.equal(got["coll_r"], trt.interX_any(verts, rb))


# -- (d) observations --------------------------------------------------------

def _obs_inputs(seed, B=8, A=6, S=3):
    """Random egos, with exact distance ties in env 0 (agents 1 and 2 mirror
    each other about ego 0) and some agents beyond the mask threshold."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.5, 2.5, (B, A, 2))
    pos[0, 0], pos[0, 1], pos[0, 2] = (0.0, 0.0), (0.3, 0.4), (-0.3, 0.4)
    pos[0, 3:] = rng.uniform(1.0, 2.5, (A - 3, 2))
    rot = rng.uniform(-np.pi, np.pi, (B, A))
    vel = rng.uniform(-1, 1, (B, A, 2))
    st = pos[:, :, None] + rng.uniform(-0.3, 0.3, (B, A, S, 2))
    verts = np.asarray(jrt.rectangle_vertices(jnp.asarray(pos, jnp.float32), jnp.asarray(rot, jnp.float32), 0.08, 0.16))
    d = rng.uniform(0, 0.2, (3, B, A))
    f = lambda a: np.asarray(a, np.float32)
    return [f(pos), f(rot), f(vel), f(st), f(verts), f(d[0]), f(d[1]), f(d[2])]


@pytest.mark.parametrize("K,apply_mask", [(2, True), (3, False)])
def test_obs_plain_matches_jax_kernel(K, apply_mask):
    for seed in (0, 1):
        xs = _obs_inputs(seed)
        kw = dict(K=K, apply_mask=apply_mask, norm_pos=float(np.float32(1.6)), norm_v=1.0, norm_dist=0.45,
                  thresh=float(np.float32(1.6)))
        got = rtk.obs_all_plain(*(torch.as_tensor(x) for x in xs), **kw)
        want = np.asarray(jrtk.obs_all(*(jnp.asarray(x) for x in xs), **kw))
        assert got.shape == want.shape == (6, 8, 1 + 6 + 3 + 11 * K)
        # the same neighbours: each chosen agent's distance entry, exactly
        # where the far mask is off
        d_cols = [10 + 11 * k + 10 for k in range(K)]
        np.testing.assert_array_equal(got.numpy()[..., d_cols] == 1.0, want[..., d_cols] == 1.0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        if apply_mask:
            assert bool((got[..., d_cols] == 1.0).any()) and not bool((got[..., d_cols] == 1.0).all())


def test_obs_kernel_path_matches_per_agent_hook():
    env = torch_make_env("road_traffic", 8, device="cpu", seed=2, **SMALL)
    for _ in range(3):
        env.step(env.get_random_actions())
    sc, st = env.scenario, env.state
    fast = sc.observations(st)
    slow = [sc.observation(a, st) for a in env.agents]
    for f, s in zip(fast, slow):
        np.testing.assert_allclose(f.numpy(), s.numpy(), atol=5e-5, rtol=0)


def test_obs_tie_goes_to_the_lowest_index():
    xs = [torch.as_tensor(x) for x in _obs_inputs(0)]
    o = rtk.obs_all_plain(*xs, K=1, apply_mask=False, norm_pos=1.6, norm_v=1.0, norm_dist=0.45, thresh=1.6)
    ci, si = np.cos(xs[1][0, 0]), np.sin(xs[1][0, 0])
    vx, vy = xs[4][0, 1, 0].numpy()  # agent 1's first corner, in ego 0's frame
    np.testing.assert_allclose(o[0, 0, 10:12].numpy(), [(vx * ci + vy * si) / 1.6, (vy * ci - vx * si) / 1.6],
                               atol=1e-6)


# -- (e) env steps against the JAX package ------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    cache = {}

    def make(kernels):
        if kernels not in cache:
            kw = dict(SMALL, pallas_sweeps=kernels, pallas_obs=kernels)
            jenv = vmas_tpu.make_env("road_traffic", 4, seed=0, **kw)
            tenv = torch_make_env("road_traffic", 4, device="cpu", seed=0, **kw)
            cache[kernels] = (jenv, tenv)
        return cache[kernels]

    return make


def _inject(jenv, tenv):
    js = jenv.state
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    arrays["u"] = [np.asarray(u) for u in js.u]
    arrays["scenario"] = {k: np.asarray(v) for k, v in js.scenario.items() if k not in ("rng", "__obs_key")}
    tenv.state = state_from_numpy(tenv.world, arrays)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_env_step_matches_jax(jax_pair, kernels):
    jenv, tenv = jax_pair(kernels)
    jenv.reset(seed=0)
    _inject(jenv, tenv)
    assert tenv.scenario.pallas_sweeps is kernels and tenv.scenario.pallas_obs is kernels
    rng = np.random.default_rng(3)
    B, A = 4, 4
    for t in range(3):
        acts = np.stack([rng.uniform(-1, 1, (A, B)), rng.uniform(-0.6, 0.6, (A, B))], -1).astype(np.float32)
        jo, jr, jd, _ = jenv.step([jnp.asarray(a) for a in acts])
        to, tr, td, ti = tenv.step([torch.as_tensor(a) for a in acts])
        np.testing.assert_allclose(tenv.state.pos.numpy(), np.asarray(jenv.state.pos), atol=1e-5, err_msg=f"pos {t}")
        for i in range(A):
            np.testing.assert_allclose(to[i].numpy(), np.asarray(jo[i]), atol=5e-5, rtol=0, err_msg=f"obs[{i}] {t}")
            np.testing.assert_allclose(tr[i].numpy(), np.asarray(jr[i]), atol=5e-5, rtol=0, err_msg=f"rew[{i}] {t}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"dones {t}")
        js, ts = jenv.state.scenario, tenv.state.scenario
        for k in ("path_id", "idx_ref", "idx_left", "idx_right", "coll_lanelets", "coll_agents", "coll_entry"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=f"{k} {t}")
        np.testing.assert_allclose(ts["short_term"].numpy(), np.asarray(js["short_term"]), atol=1e-5)
        assert set(ti[0]) == set(jenv.scenario.info(jenv.agents[0], jenv.state))


# -- (f) golden replay ---------------------------------------------------------

def _assert_close_but(arr, ref, atol, n_chaotic, msg, cap=1.0):
    """Every env within atol except at most n_chaotic, all within cap
    (tests/test_scenario_parity.py::_assert_close)."""
    err = np.abs(np.asarray(arr, np.float64) - np.asarray(ref, np.float64))
    per_env = err.reshape(err.shape[0], -1).max(1)
    assert (per_env <= cap).all(), f"{msg}: beyond the cap ({per_env.max():.4f})"
    bad = np.flatnonzero(per_env > atol)
    assert len(bad) <= n_chaotic, f"{msg}: envs {bad} beyond atol={atol} (max {per_env.max():.4f})"


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_golden_road_traffic_replay(kernels):
    """The recorded reference trajectory (16 envs x 20 vehicles x 50 steps)
    from its injected initial state and path assignment, as
    tests/test_scenario_parity.py::_rebuild_road_traffic does for the JAX
    package."""
    d = np.load(GOLDEN)
    B, T, atol, n_chaotic = d["init_pos"].shape[0], d["actions"].shape[0], 2e-3, 1
    env = torch_make_env("road_traffic", B, device="cpu", seed=0, is_add_noise=False,
                         pallas_sweeps=kernels, pallas_obs=kernels)
    sc = env.scenario
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    z = torch.zeros_like
    state = env.state.replace(
        pos=torch.as_tensor(d["init_pos"]), vel=torch.as_tensor(d["init_vel"]),
        rot=torch.as_tensor(d["init_rot"]), ang_vel=torch.as_tensor(d["init_ang_vel"]),
        force=z(env.state.force), torque=z(env.state.torque),
    )
    scr = dict(state.scenario)
    scr["path_id"] = torch.as_tensor(d["extra_path_id"], dtype=torch.int64)
    scr["point_id"] = torch.as_tensor(d["extra_point_id"], dtype=torch.int64)
    scr = sc._update_distances(state, scr)
    scr["short_term"] = z(scr["short_term"])
    scr = sc._refresh_short_term(scr)
    pos, _, _ = sc._agent_arrays(state)
    scr.update(prev_pos=pos, steering_cur=z(scr["steering_cur"]), steering_prev=z(scr["steering_prev"]),
               rew_all=z(scr["rew_all"]))
    env.state = state.replace(scenario=scr)
    for t in range(T):
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)])
        _assert_close_but(env.state.pos, d["pos"][t], atol, n_chaotic, f"pos at step {t}")
        _assert_close_but(env.state.vel, d["vel"][t], 10 * atol, n_chaotic, f"vel at step {t}")
        _assert_close_but(env.state.rot, d["rot"][t], 10 * atol, n_chaotic, f"rot at step {t}")
        for i in range(env.n_agents):
            _assert_close_but(obs[i], d[f"obs_{i}"][t], 10 * atol, n_chaotic, f"obs[{i}] at step {t}")
            _assert_close_but(rews[i].reshape(B, -1), d["rewards"][t, i].reshape(B, -1), 10 * atol, n_chaotic,
                              f"reward[{i}] at step {t}")
        assert int((dones.numpy() != d["done"][t]).sum()) <= n_chaotic, f"dones at step {t}"


# -- (g) observation noise -----------------------------------------------------

def test_observation_noise_streams():
    """Noise is uniform in [0, noise_level), differs between agents, steps
    and seeds, and is the same on the kernel path and the per-agent hook."""
    acts = [torch.full((4, 2), 0.3) for _ in range(4)]

    def run(seed, noise, kernels=True):
        env = torch_make_env("road_traffic", 4, device="cpu", seed=seed, n_agents=4, is_add_noise=noise,
                             pallas_obs=kernels)
        obs = [env.reset()]
        for _ in range(2):
            obs.append(env.step(acts)[0])
        return env, obs

    env, noisy = run(0, True)
    _, clean = run(0, False)
    level = env.scenario.noise_level
    noise = [torch.stack([n - c for n, c in zip(on, off)]) for on, off in zip(noisy, clean)]  # [A, B, W] per call
    for nz, on, off in zip(noise, noisy, clean):
        assert all(a.shape == b.shape == (4, 32) for a, b in zip(on, off))
        assert bool((nz >= -1e-6).all()) and bool((nz < level + 1e-6).all())
        assert float(nz.mean()) == pytest.approx(level / 2, rel=0.2)
        assert not torch.allclose(nz[0], nz[1])  # agents draw from streams of their own
    assert not torch.allclose(noise[1], noise[2])  # a fresh stream each step
    _, other = run(1, True)
    assert not torch.allclose(other[0][0], noisy[0][0])
    _, hook = run(0, True, kernels=False)
    for a, b in zip(hook[2], noisy[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=0)


# -- (h) gradients -------------------------------------------------------------

def test_grad_enabled_turns_the_kernels_off_and_gradients_flow():
    env = torch_make_env("road_traffic", 2, device="cpu", seed=0, n_agents=4, grad_enabled=True)
    assert env.scenario.pallas_sweeps is False and env.scenario.pallas_obs is False
    acts = [torch.tensor([[0.5, 0.2], [0.4, -0.1]], requires_grad=True) for _ in range(4)]
    obs, rews, _, _ = env.step(acts)
    loss = sum(r.sum() for r in rews) + sum(o.sum() for o in obs)
    loss.backward()
    grads = torch.stack([a.grad for a in acts])
    assert bool(torch.isfinite(grads).all()) and bool((grads != 0).any())


# -- what is not ported --------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(map_type="2"), dict(map_type="3", n_agents=4), dict(is_testing_mode=True)],
                         ids=["map2", "map3", "testing_mode"])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_make_env("road_traffic", 2, device="cpu", **kw)


@pytest.mark.parametrize("probs", [None, [0.5, 0.5, 0.0]], ids=["default", "mixed_scenarios"])
def test_reset_places_agents_apart_on_their_paths(probs):
    """Agents sit on their paths' centre-line vertices, apart, at the
    point range the JAX package draws from: [6, n/2) with the default
    scenario_probabilities, [3, n-5) otherwise (road_traffic.py:377-380)."""
    kw = {} if probs is None else dict(scenario_probabilities=probs)
    env = torch_make_env("road_traffic", 64, device="cpu", seed=4, **kw)
    sc, s = env.scenario, env.state.scenario
    pos, rot, _ = sc._agent_arrays(env.state)
    assert torch.equal(pos, sc.P["center"][s["path_id"], s["point_id"]])
    assert torch.equal(rot, sc.P["yaw"][s["path_id"], s["point_id"]])
    d = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None], dim=-1) + torch.eye(20) * 10
    assert int((d < sc.reset_agent_min_distance).sum()) < 64 * 20 * 19 * 0.01
    n = sc.P["n_points"][s["path_id"]]
    lo, hi = (6, torch.div(n, 2, rounding_mode="trunc")) if probs is None else (3, n - 5)
    assert bool((s["point_id"] >= lo).all()) and bool((s["point_id"] < hi).all())
    if probs is not None:  # the wider range is used
        assert bool((s["point_id"] >= torch.div(n, 2, rounding_mode="trunc")).any())
