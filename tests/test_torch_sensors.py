"""The port's ray casting and Lidar (vmas_tpu_torch/core/raycast.py,
sensors.py, World.cast_rays) and the respawn pick of
``ScenarioUtils.find_random_pos_for_entity_vectorized``, against the JAX
package's and the recorded reference.

* ``cast_rays`` on the recorded mixed box/sphere/line world
  (tests/golden/data/raycast.npz, atol 1e-4 as tests/test_lidar.py), and
  against the JAX package's ``cast_rays`` on random worlds of boxes,
  spheres, lines and all three, from the same state and rays made from a
  seed with numpy (atol 2e-5: XLA's cos and sin against torch's, through
  distances of order 1).
* The Lidar's ray angles bitwise the JAX package's (the full-circle rule),
  and its measures on turned agents against the JAX package's.
* pollock: the vectorized Lidar against the per-ray loop (atol 1e-5, as
  tests/test_lidar.py), and the world on the plain physics (the JAX
  package's ``supports`` refuses it).
* pollock's recorded reference trajectory, free-running for 10 steps and
  re-synced for 50, with tests/test_scenario_parity.py's atol and its one
  env a step that may fork on a knife-edge contact.
* The respawn's pick of the first clear candidate on the JAX package's own
  candidates, bitwise.
* A finite gradient through navigation's Lidar on the plain path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import Agent as JAgent, Box as JBox, Landmark as JLandmark, Line as JLine, Sphere as JSphere
from vmas_tpu.core import World as JWorld
from vmas_tpu.core import fused as JF
from vmas_tpu.scenarios.debug import pollock as jax_pollock
from vmas_tpu.utils import ScenarioUtils as JUtils
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
from vmas_tpu_torch.core import Agent, Box, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.sensors import Lidar
from vmas_tpu_torch.utils import ScenarioUtils

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "raycast.npz")


def _ray_world(core, B, shapes, device=None):
    """An agent and the landmarks of ``shapes`` ("box", "sphere", "line"),
    built with ``core``'s World/Agent/Landmark and shapes (the JAX
    package's or the port's)."""
    W, A, L, Bx, S, Ln = core
    kw = {} if device is None else {"device": device}
    w = W(B, **kw)
    w.add_agent(A("a0", shape=S(0.05)))
    for k, kind in enumerate(shapes):
        shape = {"box": lambda: Bx(length=0.4, width=0.2), "sphere": lambda: S(0.25),
                 "line": lambda: Ln(length=0.7)}[kind]()
        w.add_landmark(L(f"{kind}{k}", shape=shape))
    w.finalize()
    return w


JAX_CORE = (JWorld, JAgent, JLandmark, JBox, JSphere, JLine)
PORT_CORE = (World, Agent, Landmark, Box, Sphere, Line)


def test_cast_rays_vs_reference_oracle():
    """The recorded reference distances on a box, a sphere and a line."""
    gold = np.load(GOLDEN)
    B = gold["angles"].shape[0]
    w = _ray_world(PORT_CORE, B, ("box", "sphere", "line"), device="cpu")
    state = w.spawn_state().replace(pos=torch.as_tensor(gold["pos"]), rot=torch.as_tensor(gold["rot"]))
    dist = w.cast_rays(state, w.agents[0], torch.as_tensor(gold["angles"]), max_range=2.0,
                       entity_filter=lambda e: True)
    np.testing.assert_allclose(dist.numpy(), gold["dist"], atol=1e-4)
    assert 0 < int((dist < 2.0).sum()) < dist.numel()


@pytest.mark.parametrize("shapes", [("box", "box", "box"), ("sphere", "sphere"), ("line", "line", "line"),
                                    ("box", "sphere", "line", "box", "line")])
def test_cast_rays_matches_jax(shapes):
    """``World.cast_rays`` and ``cast_ray`` against the JAX package's on the
    same random world and rays: half the rays aimed at a landmark (hits),
    the rest at random; each landmark turned at random."""
    B, R = 64, 9
    rng = np.random.default_rng(len(shapes) * 7 + len(shapes[0]))
    E = 1 + len(shapes)
    pos = rng.uniform(-1, 1, (B, E, 2)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, (B, E)).astype(np.float32)
    aim = np.arctan2(pos[:, 1:, 1] - pos[:, :1, 1], pos[:, 1:, 0] - pos[:, :1, 0])
    angles = rng.uniform(-np.pi, np.pi, (B, R))
    angles[:, : R // 2] = aim[np.arange(B)[:, None], rng.integers(0, E - 1, (B, R // 2))] + rng.normal(
        0, 0.1, (B, R // 2))
    angles = angles.astype(np.float32)
    jw = _ray_world(JAX_CORE, B, shapes)
    js = jw.spawn_state().replace(pos=jnp.asarray(pos), rot=jnp.asarray(rot))
    want = np.asarray(jw.cast_rays(js, jw.agents[0], jnp.asarray(angles), 1.5, lambda e: True))
    w = _ray_world(PORT_CORE, B, shapes, device="cpu")
    st = w.spawn_state().replace(pos=torch.as_tensor(pos), rot=torch.as_tensor(rot))
    got = w.cast_rays(st, w.agents[0], torch.as_tensor(angles), 1.5, lambda e: True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert int((got < 1.5).sum()) > B // 2
    one = w.cast_ray(st, w.agents[0], torch.as_tensor(angles[:, 3]), 1.5, lambda e: True)
    np.testing.assert_allclose(one.numpy(), want[:, 3], atol=2e-5, rtol=0)
    # a filter that admits nothing leaves every ray at its range
    none = w.cast_rays(st, w.agents[0], torch.as_tensor(angles), 1.5)
    assert bool((none == 1.5).all())


@pytest.mark.parametrize("start,end,n", [(0.0, 2 * np.pi, 12), (0.05, 2 * np.pi + 0.05, 12), (0.0, np.pi, 7)])
def test_lidar_angles_match_jax(start, end, n):
    """The ray angles, f32 from ``np.linspace``, the end ray dropped over a
    full circle: bitwise the JAX package's."""
    from vmas_tpu.sensors import Lidar as JLidar

    mine = Lidar(None, angle_start=start, angle_end=end, n_rays=n)._angles
    want = np.asarray(JLidar(None, angle_start=start, angle_end=end, n_rays=n)._angles)
    assert mine.dtype == np.float32 and np.array_equal(mine, want)


def test_lidar_measure_turns_with_the_agent():
    """A Lidar on a rotatable agent in pollock, the agents turned at random:
    the vectorized and per-ray measures against the JAX package's (atol
    2e-5), and a half turn of the agent maps each ray onto the opposite
    one."""
    kw = dict(lidar=True, n_agents=4, n_lines=3, n_boxes=3)
    env = torch_make_env("pollock", 32, device="cpu", seed=1, **kw)
    jenv = vmas_tpu.make_env("pollock", 32, seed=1, **kw)
    rng = np.random.default_rng(4)
    E = len(env.world.entities)
    pos = rng.uniform(-0.5, 0.5, (32, E, 2)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, (32, E)).astype(np.float32)
    st = env.state.replace(pos=torch.as_tensor(pos), rot=torch.as_tensor(rot))
    js = jenv.state.replace(pos=jnp.asarray(pos), rot=jnp.asarray(rot))
    for a, ja in zip(env.world.agents, jenv.world.agents):
        want = np.asarray(ja.sensors[0].measure(js))
        for vec in (True, False):
            got = a.sensors[0].measure(st, vectorized=vec)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        assert int((got < 0.5).sum()) > 0
    a = env.world.agents[0]
    half = st.replace(rot=st.rot + torch.where(torch.arange(E) == a.index, float(np.pi), 0.0))
    np.testing.assert_allclose(a.sensors[0].measure(half).numpy(),
                               torch.roll(a.sensors[0].measure(st), 8, dims=1).numpy(), atol=2e-5)


def test_pollock_vectorized_lidar_equals_loop():
    """pollock's vectorized Lidar against its per-ray loop from the same
    reset and actions (atol 1e-5, as tests/test_lidar.py), the one on the
    fused step (with no outputs: a cut pollock fuses, as in the JAX
    package), the other on the plain physics. At its defaults (45 entities)
    the JAX package's ``supports`` refuses the world, and so does the
    port's, which then runs it unfused."""
    kw = dict(lidar=True, n_agents=4, n_lines=3, n_boxes=3)
    env_v = torch_make_env("pollock", 4, device="cpu", seed=5, vectorized_lidar=True, fused_physics=True, **kw)
    env_l = torch_make_env("pollock", 4, device="cpu", seed=5, vectorized_lidar=False, **kw)
    assert env_v.world.fused and env_v._fused_outputs is None
    jax_world = lambda **k: jax_pollock.Scenario().env_make_world(2, None, **k)
    assert TF.supports(env_v.world) is JF.supports(jax_world(**kw)) is True
    big = torch_make_env("pollock", 2, device="cpu", seed=0, fused_physics=True, lidar=True)
    assert len(big.world.entities) == 45 and big._fused_outputs is None
    assert TF.supports(big.world) is JF.supports(jax_world()) is False
    assert big.step(big.get_random_actions())[0][0].shape == (2, 16)
    for a, b in zip(env_v.reset(seed=5), env_l.reset(seed=5)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for _ in range(3):
        acts = env_v.get_random_actions()
        o_v, o_l = env_v.step(acts)[0], env_l.step(acts)[0]
        for a, b in zip(o_v, o_l):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
            assert bool(torch.isfinite(a).all())
    assert any(int((o < 0.5).sum()) for o in o_v)


def test_pollock_golden_replay():
    """pollock's recorded reference trajectory (16 envs, 5 agents, 5 lines,
    5 boxes, Lidar on) through the port's env.step on the plain physics:
    free-running for 10 steps, then each of the 50 steps re-synced to the
    recorded state; as in the JAX package's replay, one env a step may fork
    on a knife-edge contact (within a cap of 1)."""
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_pollock.npz"))
    nb, atol = d["init_pos"].shape[0], 2e-3
    env = torch_make_env("pollock", nb, device="cpu", seed=0, n_agents=5, n_lines=5, n_boxes=5, lidar=True)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]

    def inject(pos, vel, rot, ang_vel):
        z = torch.zeros_like
        return env.state.replace(pos=torch.as_tensor(pos), vel=torch.as_tensor(vel), rot=torch.as_tensor(rot),
                                 ang_vel=torch.as_tensor(ang_vel), force=z(env.state.force),
                                 torque=z(env.state.torque))

    def close(a, ref, tol, msg):
        err = np.abs(np.asarray(a, np.float64).reshape(np.shape(ref)) - np.asarray(ref, np.float64))
        per_env = err.reshape(nb, -1).max(1)
        assert per_env.max() <= 1.0 and int((per_env > tol).sum()) <= 1, f"{msg}: {per_env.max():.4f}"

    for resync in (False, True):
        env.state = inject(d["init_pos"], d["init_vel"], d["init_rot"], d["init_ang_vel"])
        for t in range(d["actions"].shape[0] if resync else 10):
            if resync and t > 0:
                env.state = inject(d["pos"][t - 1], d["vel"][t - 1], d["rot"][t - 1], d["ang_vel"][t - 1])
            obs = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)])[0]
            tag = f"{'re-synced' if resync else 'free-running'}, step {t}"
            close(env.state.pos, d["pos"][t], atol, f"pos, {tag}")
            close(env.state.vel, d["vel"][t], 10 * atol, f"vel, {tag}")
            close(env.state.rot, d["rot"][t], 10 * atol, f"rot, {tag}")
            for i in range(env.n_agents):
                close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}], {tag}")


@pytest.mark.parametrize("n_occ", [0, 3, 12])
def test_first_clear_candidate_matches_jax(n_occ):
    """The respawn's pick on the JAX package's own candidates (its draw from
    a key), bitwise its pick: the first candidate clear of every occupied
    position, else the first (dense occupied sets leave some envs with
    none clear)."""
    B, K = 256, 8
    occ = np.random.default_rng(n_occ).uniform(-1, 1, (B, n_occ, 2)).astype(np.float32)
    key = jax.random.PRNGKey(n_occ)
    bounds = ((-1.0, 1.0), (-1.0, 1.0))
    want = np.asarray(JUtils.find_random_pos_for_entity_vectorized(jnp.asarray(occ), key, None, 0.6, *bounds))
    kx, ky = jax.random.split(key)
    cands = np.stack([np.asarray(jax.random.uniform(kx, (B, K), minval=-1.0, maxval=1.0)),
                      np.asarray(jax.random.uniform(ky, (B, K), minval=-1.0, maxval=1.0))], -1)
    got = ScenarioUtils.first_clear_candidate(torch.as_tensor(occ), torch.as_tensor(cands), 0.6)
    assert got.shape == (B, 1, 2) and np.array_equal(got.numpy(), want)
    if n_occ == 12:
        d = np.linalg.norm(occ[:, None] - cands[:, :, None], axis=-1)
        none = ~(d >= 0.6).all(-1).any(-1)
        assert none.any() and np.array_equal(got.numpy()[none, 0], cands[none, 0])
    # the port's own draw: in the bounds, one pick per env
    g = torch.Generator().manual_seed(0)
    mine = ScenarioUtils.find_random_pos_for_entity_vectorized(torch.as_tensor(occ), g, None, 0.6, *bounds)
    assert mine.shape == (B, 1, 2) and bool((mine.abs() <= 1).all())


def test_navigation_lidar_gradient_is_finite():
    """On the plain path (grad_enabled) a gradient flows from navigation's
    Lidar observations back to the actions, finite, where the rays hit
    another agent."""
    env = torch_make_env("navigation", 8, device="cpu", seed=0, grad_enabled=True)
    env.state = state_from_numpy(env.world, testing.sensor_state(env, np.random.default_rng(2)))
    acts = [torch.zeros((8, 2), requires_grad=True) for _ in env.agents]
    obs = env.step(acts)[0]
    lidar = torch.stack([o[:, 6:] for o in obs])
    assert int((lidar > 0).sum()) > 0
    lidar.sum().backward()
    grads = torch.stack([a.grad for a in acts])
    assert bool(torch.isfinite(grads).all()) and bool((grads != 0).any())


def test_agent_sensors():
    """An agent takes its sensors at construction or through add_sensor,
    each bound to it; a blind agent (obs_range 0) takes none."""
    w = World(2, device="cpu")
    lidar = Lidar(w, n_rays=4)
    a = Agent("a", sensors=[lidar])
    assert a.sensors == [lidar] and lidar.agent is a
    extra = Lidar(w, n_rays=2)
    a.add_sensor(extra)
    assert a.sensors == [lidar, extra] and extra.agent is a
    assert Agent("b").sensors == []
    with pytest.raises(AssertionError, match="Blind agent"):
        Agent("c", obs_range=0.0, sensors=[Lidar(w)])
