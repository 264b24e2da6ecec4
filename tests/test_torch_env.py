"""The port's transport environment as a whole (vmas_tpu_torch.make_env on
``device="cpu"``) against the JAX package's, from injected states.

Resets cannot match the JAX package bitwise (threefry and torch's generator
give different numbers), so the same state, made from a seed with numpy, is
injected on both sides (test_torch_fused.contact_rich) and the same numpy
actions are replayed. Tolerances:
state atol 1e-5 rtol 1e-5, observations atol 2e-5 rtol 1e-5, rewards atol
2e-3 (the shaping factor of 100 amplifies position noise), dones equal; the
golden replay uses the JAX package's own 2e-3 (tests/test_scenario_parity.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu
from test_torch_fused import contact_rich, jax_state
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.interop import state_from_numpy

torch.set_num_threads(1)

STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_transport.npz")


def _pair(num_envs, jax_fused, n_agents=4):
    jenv = vmas_tpu.make_env("transport", num_envs, seed=0, n_agents=n_agents, fused_physics=jax_fused)
    tenv = torch_make_env("transport", num_envs, device="cpu", seed=0, n_agents=n_agents, fused_physics=True)
    arrays = contact_rich(jenv, seed=num_envs)
    jenv.state = jax_state(jenv, arrays)
    tenv.state = state_from_numpy(tenv.world, arrays)
    return jenv, tenv


def _step_both(jenv, tenv, n_steps, seed):
    rng = np.random.default_rng(seed)
    B, A = tenv.num_envs, tenv.n_agents
    for t in range(n_steps):
        acts = rng.uniform(-1, 1, (A, B, 2)).astype(np.float32)
        jo, jr, jd, _ = jenv.step([jnp.asarray(a) for a in acts])
        to, tr, td, _ = tenv.step([torch.as_tensor(a) for a in acts])
        for name in FIELDS:
            np.testing.assert_allclose(getattr(tenv.state, name).numpy(), np.asarray(getattr(jenv.state, name)),
                                       **STATE_TOL, err_msg=f"{name} at step {t}")
        for i in range(A):
            np.testing.assert_allclose(to[i].numpy(), np.asarray(jo[i]), atol=2e-5, rtol=1e-5,
                                       err_msg=f"obs[{i}] at step {t}")
            np.testing.assert_allclose(tr[i].numpy(), np.asarray(jr[i]), atol=2e-3, err_msg=f"rew[{i}] at step {t}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"dones at step {t}")


def test_env_step_matches_jax_fused():
    """B = 7: the port's fused env.step against the JAX package's, whose
    fused step is the Pallas kernel in interpret mode."""
    jenv, tenv = _pair(7, jax_fused=True)
    _step_both(jenv, tenv, 4, seed=1)


def test_env_step_full_width_matches_jax_plain():
    """4096 envs x 4 agents: the port's fused env.step against the JAX
    package's XLA physics path (which tests/test_fused.py holds to the
    Pallas kernel at 1e-5)."""
    jenv, tenv = _pair(4096, jax_fused=False)
    _step_both(jenv, tenv, 3, seed=2)


def _assert_close(arr, ref, atol, msg):
    np.testing.assert_allclose(np.asarray(arr, np.float64), np.asarray(ref, np.float64), atol=atol, rtol=0,
                               err_msg=msg)


@pytest.mark.parametrize("fused", [False, True])
def test_golden_transport_replay(fused):
    """Replay the recorded reference trajectory (16 envs, 50 steps) from its
    injected initial state, as tests/test_scenario_parity.py does for the
    JAX package, through the port's plain physics and its fused step."""
    d = np.load(GOLDEN)
    B, T, atol = d["init_pos"].shape[0], d["actions"].shape[0], 2e-3
    env = torch_make_env("transport", B, device="cpu", seed=0, n_agents=4, fused_physics=fused)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    z = torch.zeros_like
    state = env.state.replace(
        pos=torch.as_tensor(d["init_pos"]), vel=torch.as_tensor(d["init_vel"]),
        rot=torch.as_tensor(d["init_rot"]), ang_vel=torch.as_tensor(d["init_ang_vel"]),
        force=z(env.state.force), torque=z(env.state.torque),
    )
    # one discarded reward cycle recomputes the shaping baseline from the
    # injected positions, as the reference's reset did
    state = env.scenario.pre_rewards(state)
    env.state = env.scenario.post_rewards(state)
    for t in range(T):
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(env.n_agents)])
        _assert_close(env.state.pos, d["pos"][t], atol, f"pos at step {t}")
        _assert_close(env.state.vel, d["vel"][t], 10 * atol, f"vel at step {t}")
        _assert_close(env.state.rot, d["rot"][t], 10 * atol, f"rot at step {t}")
        for i in range(env.n_agents):
            _assert_close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}] at step {t}")
            _assert_close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}] at step {t}")
        np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done at step {t}")


def test_reset_invariants():
    """Spawned positions lie inside the world bounds and keep the scenario's
    minimum distances: agents from agents, goal and package from the agents
    and from each other."""
    env = torch_make_env("transport", 256, device="cpu", seed=3, n_agents=4, fused_physics=True)
    for seed in (3, 4):
        env.reset(seed=seed)
        sc, pos = env.scenario, env.state.pos
        assert bool((pos.abs() <= sc.world_semidim).all())
        ai = [a.index for a in env.world.agents]
        big = [sc.goal.index] + [p.index for p in sc.packages]
        big_min = max(p.shape.circumscribed_radius() + sc.goal.shape.radius + 0.01 for p in sc.packages)

        def dist(i, j):
            return torch.linalg.vector_norm(pos[:, i] - pos[:, j], dim=-1)

        for n, i in enumerate(ai):
            for j in ai[n + 1:]:
                assert bool((dist(i, j) >= 2 * sc.agent_radius).all())
        for n, i in enumerate(big):
            for j in ai + big[:n]:
                assert bool((dist(i, j) >= big_min).all())
        og = env.state.scenario["on_goal"]
        assert og.shape == (256, 1) and not bool(og.any())
        assert torch.equal(env.steps, torch.zeros_like(env.steps))


@pytest.mark.parametrize("how", ["reset_at", "reset_mask"])
def test_partial_reset_blends_only_masked_envs(how):
    env = torch_make_env("transport", 16, device="cpu", seed=5, n_agents=4, fused_physics=True)
    for _ in range(3):
        env.step(env.get_random_actions())
    before = env.state
    mask = torch.zeros(16, dtype=torch.bool)
    if how == "reset_at":
        mask[6] = True
        env.reset_at(6)
    else:
        mask[[1, 2, 9]] = True
        env.reset_mask(mask)
    after = env.state
    for name in FIELDS:
        a, b = getattr(after, name), getattr(before, name)
        assert torch.equal(a[~mask], b[~mask]), name
    assert bool((after.pos[mask] != before.pos[mask]).any(-1).any(-1).all())
    assert bool((after.vel[mask] == 0).all())
    for k, v in after.scenario.items():
        assert torch.equal(v[~mask], before.scenario[k][~mask]), k
    assert bool((env.steps[mask] == 0).all()) and bool((env.steps[~mask] == 3).all())


def test_default_device_needs_a_gpu(monkeypatch):
    """``device=None`` means the GPU; without one, make_env raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_make_env("transport", 4, n_agents=4, fused_physics=True)


def test_only_transport_is_registered():
    """A name outside the registry raises (every name of the JAX package's
    registry is ported, sampling the last of them)."""
    with pytest.raises(ValueError, match="not ported"):
        torch_make_env("no_such_scenario", 4, device="cpu")
    assert torch_make_env("sampling", 4, device="cpu").n_agents == 3
