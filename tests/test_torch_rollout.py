"""The port's rollouts (vmas_tpu_torch/parallel/rollout.py) on the CPU.

``rows_rollout_fn`` carries the fused step's row buffer from launch to
launch; ``rollout_fn`` loops the environment's own step. Both reach one
plain function (``core.fused._step_rows``) with the same inputs, so from
the same generator seed they give bitwise the same trajectory, as the JAX
package's rollouts do (tests/test_rows_rollout.py).
"""

import pytest
import torch

from test_torch_fused import contact_rich
from vmas_tpu_torch import make_env
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.parallel.rollout import rollout_fn, rows_rollout_fn, rows_rollout_supported

torch.set_num_threads(1)


@pytest.mark.parametrize("num_envs,continuous", [(4096, True), (64, False)])
def test_rows_rollout_equals_step_rollout(num_envs, continuous):
    env = make_env("transport", num_envs, device="cpu", seed=0, n_agents=4, fused_physics=True,
                   continuous_actions=continuous)
    horizon = 7
    # from a contact-rich state, so the package moves and rewards are shaped
    s0, st0 = state_from_numpy(env.world, contact_rich(env, seed=7)), env.steps
    sa, sta, ta = rollout_fn(env, horizon=horizon)(s0, st0, torch.Generator().manual_seed(11))
    sb, stb, tb = rows_rollout_fn(env, horizon=horizon)(s0, st0, torch.Generator().manual_seed(11))
    assert tb["rewards"].shape == (horizon, num_envs, 4) and tb["dones"].shape == (horizon, num_envs)
    assert len(tb["obs"]) == 4 and all(o.shape == (horizon, num_envs, 11) for o in tb["obs"])
    assert torch.equal(ta["rewards"], tb["rewards"])
    assert torch.equal(ta["dones"], tb["dones"])
    for oa, ob in zip(ta["obs"], tb["obs"]):
        assert torch.equal(oa, ob)
    for name in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    for ua, ub in zip(sa.u, sb.u):
        assert torch.equal(ua, ub)
    for k in sa.scenario:
        assert torch.equal(sa.scenario[k], sb.scenario[k]), k
    assert torch.equal(sta, stb) and bool((stb == horizon).all())
    # the trajectory moved: agents pushed, rewards shaped
    assert not torch.equal(sb.pos, s0.pos) and bool((tb["rewards"] != 0).any())


def test_rollout_fn_with_a_policy():
    """A policy acts on the previous step's observations."""
    env = make_env("transport", 8, device="cpu", seed=2, n_agents=4, fused_physics=True)
    seen = []

    def policy(obs, generator):
        seen.append(obs[0].clone())
        return [torch.full((8, 2), 0.5) for _ in obs]

    state, steps, traj = rollout_fn(env, policy, horizon=3)(env.state, env.steps, torch.Generator())
    assert torch.equal(seen[0], env._observations(env.state)[0])
    assert torch.equal(seen[1], traj["obs"][0][0]) and torch.equal(seen[2], traj["obs"][0][1])
    assert torch.equal(state.u[0], torch.full((8, 2), 0.5 * 0.6))
    assert bool((steps == 3).all())


def test_rows_rollout_truncates_at_max_steps():
    env = make_env("transport", 8, device="cpu", seed=1, n_agents=4, fused_physics=True, max_steps=3)
    _, steps, traj = rows_rollout_fn(env, horizon=5)(env.state, env.steps, torch.Generator().manual_seed(0))
    assert traj["dones"][:2].logical_not().all() and traj["dones"][2:].all()
    assert bool((steps == 5).all())


@pytest.mark.parametrize(
    "kwargs,supported",
    [
        (dict(fused_physics=True), True),
        (dict(fused_physics=True, continuous_actions=False), True),
        (dict(fused_physics=True, clamp_actions=True), False),
        (dict(fused_physics=False), False),
    ],
)
def test_rows_rollout_supported(kwargs, supported):
    env = make_env("transport", 4, device="cpu", seed=0, n_agents=4, **kwargs)
    assert rows_rollout_supported(env) is supported
    if not supported:
        with pytest.raises(AssertionError, match="not eligible"):
            rows_rollout_fn(env, horizon=2)
