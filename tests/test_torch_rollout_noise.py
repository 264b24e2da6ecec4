"""The rows rollouts' noise streams: with noisy actions (``u_noise``), a
noisy comm channel (``c_noise``) or observation noise drawn in ``unpack``
(``unpack_reads = ("obs_key",)``), ``rows_rollout_fn`` and
``rows_policy_rollout_fn`` draw from the steps' generator what
``Environment._step_fn_raw`` draws from it at each step, in its order and
shapes (``Environment._step_draws``, which the step itself uses), and so give
``rollout_fn``'s trajectory and final state bitwise for the same generator
seed: at ``k_steps`` 1 and 4, with ``reset_every``, and with a policy.

Configs: give_way's observation noise; joint_passage's observed joint
angle with its noise; joint_passage_size's observed joint angle with its
noise and the observation noise; simple_spread with noisy actions;
simple_reference with noisy actions and comm (its speakers' comm noise).
Port only (no JAX: the port's random streams are torch's), at 8 envs and
8 steps.
"""

import numpy as np
import pytest
import torch

from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.parallel.rollout import (
    _chunked_reset_rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)

torch.set_num_threads(1)

B, T = 8, 8
CONFIGS = {
    "give_way,obs_noise": ("give_way", {"obs_noise": 0.1}, None),
    "joint_passage,joint_angle": ("joint_passage", {"observe_joint_angle": True, "joint_angle_obs_noise": 0.1},
                                  None),
    "joint_passage_size,noise": ("joint_passage_size", {"observe_joint_angle": True, "joint_angle_obs_noise": 0.2,
                                                        "obs_noise": 0.1}, None),
    "simple_spread,u_noise": ("simple_spread", {}, "u"),
    "simple_reference,c_noise": ("simple_reference", {}, "uc"),
}


def noisy_env(config):
    name, kw, noise = CONFIGS[config]
    env = torch_make_env(name, B, device="cpu", seed=0, fused_physics=True, **kw)
    for a in env.agents:
        if noise is not None:
            a.u_noise_array = np.full_like(a.u_noise_array, 0.1)
        if noise == "uc" and not a.silent:
            a.c_noise = 0.2
    assert rows_rollout_supported(env)
    return env


def same(sa, ta, sb, tb):
    """Two rollouts' outputs and final states, bitwise."""
    assert torch.equal(ta["rewards"], tb["rewards"]) and torch.equal(ta["dones"], tb["dones"])
    assert all(torch.equal(x, y) for x, y in zip(ta["obs"], tb["obs"]))
    for field in ("pos", "vel", "rot", "ang_vel", "force", "c", "uc", "rendering"):
        assert torch.equal(getattr(sa, field), getattr(sb, field)), field
    assert all(torch.equal(x, y) for x, y in zip(sa.u, sb.u)), "u"
    for k, v in sa.scenario.items():
        if isinstance(v, dict):
            assert all(torch.equal(v[k2], sb.scenario[k][k2]) for k2 in v), k
        else:
            assert torch.equal(v, sb.scenario[k]), k


def run_both(env, ref, rows, seed, obs_seed=3):
    """``ref`` and ``rows`` (each ``run(state, steps, generator)``) from the
    env's state, each started from the observation seed ``obs_seed``, with
    the observation seed each leaves behind."""
    out = []
    for run in (ref, rows):
        env.scenario.obs_seed = obs_seed
        out.append(run(env.state, env.steps, torch.Generator().manual_seed(seed)) + (env.scenario.obs_seed,))
    return out


@pytest.mark.parametrize("k_steps", [1, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_rollout_noise_bitwise(config, k_steps):
    """rows_rollout_fn against rollout_fn with the noise on: the same
    trajectory, final state and observation seed; the noise is there (a
    noise-free run differs)."""
    env = noisy_env(config)
    (sa, na, ta, oa), (sb, nb, tb, ob) = run_both(env, rollout_fn(env, horizon=T),
                                                  rows_rollout_fn(env, horizon=T, k_steps=k_steps), 11)
    same(sa, ta, sb, tb)
    assert torch.equal(na, nb) and oa == ob
    quiet = torch_make_env(CONFIGS[config][0], B, device="cpu", seed=0, fused_physics=True,
                           **{k: v for k, v in CONFIGS[config][1].items() if "noise" not in k})
    _, _, tq = rollout_fn(quiet, horizon=T)(env.state, env.steps, torch.Generator().manual_seed(11))
    assert not all(torch.equal(x, y) for x, y in zip(ta["obs"], tq["obs"]))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_rollout_noise_reset_every(config):
    """With resets every 4 steps (k_steps 2): the rows rollout against
    rollout_fn chunked the same way, bitwise; the resets draw from the
    caller's generator between the chunks' forks in both."""
    env = noisy_env(config)
    ref = _chunked_reset_rollout(env, rollout_fn(env, horizon=4), T, 4)
    (sa, _, ta, oa), (sb, _, tb, ob) = run_both(env, ref, rows_rollout_fn(env, horizon=T, k_steps=2, reset_every=4),
                                                12)
    same(sa, ta, sb, tb)
    assert oa == ob and bool(tb["dones"][3].all())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rows_policy_rollout_noise_bitwise(config):
    """rows_policy_rollout_fn against rollout_fn with a policy and the noise
    on: each step's observations (which the policy acts on) drawn from that
    step's seed, bitwise; with resets every 4 steps too."""
    env = noisy_env(config)
    obs = env._observations(env.state)
    rng = np.random.default_rng(4)
    W = [torch.as_tensor(rng.normal(0, 0.3, (o.shape[-1], env.get_agent_action_size(a))), dtype=torch.float32)
         for o, a in zip(obs, env.agents)]
    sizes = [a.action_size for a in env.agents]

    def policy(obs, generator):
        # continuous actions, comm in [0, 1]
        return tuple(torch.cat([torch.tanh((o @ w)[:, :n]), torch.sigmoid((o @ w)[:, n:])], -1)
                     for o, w, n in zip(obs, W, sizes))

    (sa, _, ta, oa), (sb, _, tb, ob) = run_both(env, rollout_fn(env, policy, T), rows_policy_rollout_fn(env, policy, T),
                                                13)
    same(sa, ta, sb, tb)
    assert oa == ob
    ref = _chunked_reset_rollout(env, rollout_fn(env, policy, 4), T, 4)
    (sa, _, ta, _), (sb, _, tb, _) = run_both(env, ref, rows_policy_rollout_fn(env, policy, T, reset_every=4), 14)
    same(sa, ta, sb, tb)


def test_noise_streams_follow_the_step():
    """The streams are env.step's own: per step the observation seed, then
    per agent its action noise and its comm noise, from the steps' fork of
    the caller's generator; the rows paths' T steps of draws are T single
    steps' draws, stacked."""
    from vmas_tpu_torch.environment.environment import _obs_seed
    from vmas_tpu_torch.parallel.rollout import _fork

    env = noisy_env("simple_reference,c_noise")
    _, g_step = _fork(torch.Generator().manual_seed(21), 2)
    seeds, noise = env._step_draws(g_step, 2)
    _, g_step = _fork(torch.Generator().manual_seed(21), 2)
    _, g_one = _fork(torch.Generator().manual_seed(21), 2)
    for t in range(2):
        seed_t, noise_t = env._step_draws(g_one)
        assert seeds[t] == seed_t == _obs_seed(g_step)
        for a, (un, cn), (un_t, cn_t) in zip(env.agents, noise, noise_t):
            assert torch.equal(un[t], un_t) and torch.equal(un_t, torch.randn((B, a.action_size), generator=g_step))
            if not a.silent:
                assert torch.equal(cn[t], cn_t)
                assert torch.equal(cn_t, torch.randn((B, env.world.dim_c), generator=g_step))
    assert all(un is not None for un, _ in noise) and any(cn is not None for _, cn in noise)
