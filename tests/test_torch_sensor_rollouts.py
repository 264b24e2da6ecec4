"""The rows rollouts of the sensor worlds (vmas_tpu_torch/parallel/rollout.py):
the random-action rows rollout with the ``"state"`` read (each step's state
rebuilt from its carry rows for the Lidar, in chunks of steps) and
flocking's target on the action rows (``script_slots``/``script_us``),
bitwise ``rollout_fn``; the rows policy rollout on navigation without its
Lidar, bitwise the env.step policy rollout; and the refusals and
eligibility of the JAX package's rows paths (its
tests/test_rows_rollout.py), against its ``rows_rollout_supported``.
"""

import importlib

import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.parallel.rollout import rows_rollout_supported as jax_rows_rollout_supported
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch import testing
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.heuristic_policy import rollout_policy
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel.rollout import (
    rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios import navigation

torch.set_num_threads(1)

# the module (the package exports a function of the same name)
R = importlib.import_module("vmas_tpu_torch.parallel.rollout")


def _rollouts_equal(sa, ta, sb, tb):
    assert testing.same_trajectory(ta, tb)
    for field in ("pos", "vel", "rot", "ang_vel", "force", "rendering"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    assert sa.scenario.keys() == sb.scenario.keys()
    assert all(torch.equal(sa.scenario[k], sb.scenario[k]) for k in sa.scenario), "scratch"


ROLLOUTS = {
    "navigation": ("navigation", {}, 1),
    "navigation,no_lidar": ("navigation", {"collisions": False}, 1),
    "navigation,no_lidar,k4": ("navigation", {"collisions": False}, 4),
    "navigation,all_goals": ("navigation", {"shared_rew": False, "observe_all_goals": True}, 1),
    "flocking": ("flocking", {}, 1),
    "flocking,discrete": ("flocking", {"continuous_actions": False}, 1),
}


@pytest.mark.parametrize("chunk", ["whole", "chunks"])
@pytest.mark.parametrize("config", sorted(ROLLOUTS))
def test_rows_rollout_equals_step_rollout(config, chunk, monkeypatch):
    """The rows rollout against rollout_fn (the env's own step on the fused
    step) from a state with collisions and Lidar hits, bitwise: rewards,
    dones, observations (the Lidar on each step's rebuilt state, in one
    batch of all T x B env-steps or in chunks of 3 steps), the final state
    with its u (flocking's target's the script's last), rendering and
    scratch (flocking's clock t0 + horizon)."""
    name, kw, k = ROLLOUTS[config]
    env = torch_make_env(name, 16, device="cpu", seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env)
    if chunk == "chunks":
        monkeypatch.setattr(R, "_STATE_CHUNK", 3 * 16)
    s0 = state_from_numpy(env.world, testing.sensor_state(env, np.random.default_rng(9)))
    st0 = env.steps
    sa, ta_steps, ta = rollout_fn(env, horizon=8)(s0, st0, torch.Generator().manual_seed(7))
    sb, tb_steps, tb = rows_rollout_fn(env, horizon=8, k_steps=k)(s0, st0, torch.Generator().manual_seed(7))
    assert tb["rewards"].shape == (8, 16, env.n_agents) and torch.equal(ta_steps, tb_steps)
    _rollouts_equal(sa, ta, sb, tb)
    assert not torch.equal(sb.pos, s0.pos)
    if name == "flocking":
        assert torch.equal(sb.scenario["t"], s0.scenario["t"] + 8)
        target = env.scenario._target
        t_last = s0.scenario["t"] + 7
        assert torch.equal(sb.u[target.slot], torch.stack([torch.cos(TF._div(t_last, 30.0)),
                                                           torch.sin(TF._div(t_last, 30.0))], -1))
    if "collisions" not in kw:
        # the Lidar saw something on the way
        lidar = torch.stack([o[..., 6:] for o in tb["obs"]])
        assert bool((lidar != (0.0 if name == "navigation" else 0.2)).any())


def test_rows_rollout_refusals():
    """``k_steps > 1`` with the ``"state"`` read, and the rows policy
    rollout on the ``"state"`` read or a precomputed script, refuse with
    the JAX package's messages; ``rollout()`` with a policy then takes
    ``rollout_fn``, with no policy the rows path."""
    nav = torch_make_env("navigation", 8, device="cpu", seed=0, fused_physics=True)
    with pytest.raises(AssertionError, match="k_steps>1 cannot record per-step carries"):
        rows_rollout_fn(nav, horizon=4, k_steps=2)
    policy = rollout_policy(nav, navigation.HeuristicPolicy(True))
    with pytest.raises(AssertionError, match="need per-step state reconstruction"):
        rows_policy_rollout_fn(nav, policy, horizon=2)
    flock = torch_make_env("flocking", 8, device="cpu", seed=0, fused_physics=True)
    with pytest.raises(AssertionError):
        rows_policy_rollout_fn(flock, lambda o, g: tuple(x[:, :2] for x in o), horizon=2)
    flock._fused_outputs.unpack_reads = ()
    with pytest.raises(AssertionError, match="precomputed scripted-agent actions"):
        rows_policy_rollout_fn(flock, lambda o, g: tuple(x[:, :2] for x in o), horizon=2)
    for env, pol, want in ((nav, policy, "rollout_fn"), (nav, None, "rows_rollout_fn")):
        calls = []
        orig = {n: getattr(R, n) for n in ("rollout_fn", "rows_rollout_fn", "rows_policy_rollout_fn")}
        for n, f in orig.items():
            setattr(R, n, lambda *a, _f=f, _n=n, **k: calls.append(_n) or _f(*a, **k))
        try:
            traj = rollout(env, pol, horizon=2, generator=torch.Generator().manual_seed(1))
        finally:
            for n, f in orig.items():
                setattr(R, n, f)
        assert calls == [want] and bool(torch.isfinite(traj["obs"][0]).all())


@pytest.mark.parametrize("name,kw,eligible", [
    ("navigation", {}, True),
    ("navigation", {"collisions": False}, True),
    ("flocking", {}, True),
    ("discovery", {}, False),
    ("discovery", {"targets_respawn": False, "agent_collision_penalty": -1.0}, False),
])
def test_rows_rollout_supported_matches_jax(name, kw, eligible, monkeypatch):
    """Eligibility as the JAX package's: navigation (its Lidar rebuilt from
    the carry rows, or off) and flocking (the target's script precomputed)
    are eligible; discovery is not (its post_rewards respawn and its
    ``finish_obs``: with the respawn and a scratch carry granted, the
    override of ``finish_obs`` alone still refuses it), and steps through
    rollout_fn with its Lidar after the respawn."""
    env = torch_make_env(name, 8, device="cpu", seed=0, fused_physics=True, **kw)
    jenv = vmas_tpu.make_env(name, 8, seed=0, fused_physics=True, **kw)
    assert rows_rollout_supported(env) is jax_rows_rollout_supported(jenv) is eligible
    if eligible:
        return
    with pytest.raises(AssertionError, match="not eligible"):
        rows_rollout_fn(env, horizon=2)
    s, _, traj = rollout_fn(env, horizon=5)(env.state, env.steps, torch.Generator().manual_seed(3))
    assert traj["obs"][0].shape == (5, 8, 19) and bool(torch.isfinite(traj["obs"][0]).all())
    fo = env._fused_outputs
    monkeypatch.setattr(type(env.scenario), "post_rewards", BaseScenario.post_rewards)
    monkeypatch.setattr(fo, "carry_extra_idx", (), raising=False)
    assert not rows_rollout_supported(env)
    monkeypatch.setattr(type(fo), "finish_obs", TF.FusedOutputs.finish_obs)
    assert rows_rollout_supported(env)


def test_rows_step_supported_scripts():
    """The rule for scripted agents (the JAX package's): every scripted agent
    declared in ``script_slots`` with ``script_us``; in-kernel scripts
    (``kernel_script_slots``), undeclared scripts and noisy scripted agents
    refused."""
    env = torch_make_env("flocking", 4, device="cpu", seed=0, fused_physics=True)
    world, fo, agents = env.world, env._fused_outputs, env.agents
    assert TF.rows_step_supported(world, fo, agents)
    fo.kernel_script_slots = (fo.script_slots[0],)
    assert not TF.rows_step_supported(world, fo, agents)
    del fo.kernel_script_slots
    fo.script_slots = ()
    assert not TF.rows_step_supported(world, fo, agents)
    fo.script_slots = (env.scenario._target.index,)
    target = env.scenario._target
    target.u_noise_array = np.full_like(target.u_noise_array, 0.1)
    assert not TF.rows_step_supported(world, fo, agents)


def test_navigation_heuristic_drives_rows_policy_rollout():
    """navigation without its Lidar (``collisions=False``) on the rows policy
    rollout, driven by its CLF-QP heuristic: bitwise the env.step policy
    rollout; the agents close on their goals."""
    env = torch_make_env("navigation", 16, device="cpu", seed=0, fused_physics=True, collisions=False)
    policy = rollout_policy(env, navigation.HeuristicPolicy(True))
    s0, st0 = env.state, env.steps
    sa, _, ta = rollout_fn(env, policy, horizon=6)(s0, st0, torch.Generator().manual_seed(3))
    sb, _, tb = rows_policy_rollout_fn(env, policy, horizon=6)(s0, st0, torch.Generator().manual_seed(3))
    _rollouts_equal(sa, ta, sb, tb)
    goal = lambda s: torch.stack([torch.linalg.vector_norm(a.pos(s) - a.goal.pos(s), dim=-1) for a in env.agents])
    assert float(goal(sb).mean()) < float(goal(s0).mean())
