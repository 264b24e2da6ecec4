"""A minimal sharded learner fed by the sharded simulator (counterpart of
vmas_tpu/parallel/learner.py).

Each rank steps its env shard (``parallel.distribute``) and feeds a
data-parallel learner: parameters are replicated, and after the backward
pass the gradients and the loss are averaged over the mesh in one
flattened all-reduce. The simulator's plain path is differentiable, so the
learner trains by analytic policy gradients through the physics
(``grad_enabled=True``; the fused kernel defines no backward pass, so a
fused env is refused at construction, as in the JAX package).

Parameters are the JAX package's layout, a list of ``{"w": [in, out],
"b": [out]}`` (``interop.learner_params_from_numpy`` carries the JAX
package's ``init_mlp`` pytree across).
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core.utils import resolve_device, tree_map
from vmas_tpu_torch.parallel.mesh import mean_over_ranks, mesh_size


def init_mlp(sizes, generator=None, device=None):
    """Each weight ``N(0, 1) / sqrt(fan_in)`` from ``generator``, biases 0;
    on the GPU unless ``device`` says otherwise."""
    device = resolve_device(device)
    return [
        {"w": torch.randn((m, n), generator=generator, device=device) / math.sqrt(m),
         "b": torch.zeros((n,), device=device)}
        for m, n in zip(sizes[:-1], sizes[1:])
    ]


def mlp(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return torch.tanh(x)  # actions in [-1, 1]


def make_train_step(env, horizon: int = 5, lr: float = 1e-3):
    """``train_step(params, state, steps, generator) -> (params', state',
    steps', loss)``.

    Differentiable-rollout policy optimization: loss = -mean reward over an
    unrolled horizon, the gradient taken through the physics. The rollout
    body is the environment's own step (``_step_fn_raw``, its draws from
    ``generator``), so action semantics (u_multiplier, u_noise, comm) match
    ``env.step``. On a mesh of more than one rank (``env.mesh``) the
    gradients and the loss are averaged over the ranks in one flattened
    all-reduce: every rank then takes the same step, the step of the global
    batch. Episode boundaries are the caller's job: keep ``horizon`` below
    the episode length and reset between train steps for episodic
    scenarios. The returned state and parameters carry no graph."""
    if not env.grad_enabled:
        raise ValueError("make_train_step differentiates through the env's action decode; "
                         "build the env with grad_enabled=True")
    agents = env.agents
    dim_c = env.world.dim_c
    ranges = [torch.as_tensor(a.u_range_array, device=env.device) for a in agents]

    def policy_actions(params, obs):
        actions = []
        for i, a in enumerate(agents):
            w = mlp(params, obs[i])  # [-1, 1]
            u = w[:, : a.action_size] * ranges[i][None]
            if dim_c != 0 and not a.silent:
                # exactly dim_c comm columns: the shared MLP may be sized to
                # the widest agent, so an open slice would grab padding too
                comm = (w[:, a.action_size: a.action_size + dim_c] + 1) / 2
                u = torch.cat([u, comm], dim=-1)
            actions.append(u)
        return actions

    def train_step(params, state, steps, generator):
        params = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
        leaves = [p for layer in params for p in (layer["w"], layer["b"])]
        total = 0.0
        obs = env._observations(state)
        for _ in range(horizon):
            state, obs, rews, _, _, _, steps = env._step_fn_raw(state, steps, policy_actions(params, obs), generator)
            total = total + torch.mean(torch.stack(rews, dim=-1))
        loss = -total / horizon
        # a loss that no parameter reaches (a reward the actions do not move
        # within the horizon) has zero gradients, as in the JAX package
        grads = torch.autograd.grad(loss, leaves, allow_unused=True) if loss.requires_grad else [None] * len(leaves)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss = loss.detach()
        mesh = getattr(env, "mesh", None)
        if mesh_size(mesh) > 1:
            *grads, loss = mean_over_ranks([*grads, loss], mesh)
        new = iter([p.detach() - lr * g for p, g in zip(leaves, grads)])
        params = [{"w": next(new), "b": next(new)} for _ in params]
        return params, tree_map(lambda t: t.detach(), state), steps, loss

    return train_step
