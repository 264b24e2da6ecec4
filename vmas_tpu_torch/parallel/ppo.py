"""PPO training on the port's environments.

Counterpart of vmas_tpu/parallel/ppo.py: one shared actor-critic over all
agents (parameter sharing, the standard VMAS baseline), a diagonal Gaussian
in the pre-scale action space [-1, 1] with the agents folded into the batch,
and the clipped-surrogate PPO update with GAE over full-batch epochs.

Two ways to collect experience, each a rollout with ``policy_aux`` (the
raw samples and log-probs recorded at sampling time) feeding one batch
build, ``rows_batch``, which computes the values after the loop in one
batched pass over T+1 steps:

* ``collect="rows"``: ``rows_policy_rollout_fn``, the policy plus one launch
  of the fused rows step per env step. No autoreset inside the rollout:
  episodes end by GAE's mask, or every ``reset_every`` steps for every env
  at once. Needs ``rows_rollout_supported(env)``.
* ``collect="step"``: ``rollout_fn(autoreset=True)``, the env's own step
  per step (the fused step with ``fused_physics=True``) and a masked reset
  of the envs that finished after each step. Works on every env.

``collect="auto"`` picks rows where eligible. ``compute_dtype=torch.bfloat16``
runs the MLPs' hidden activations in bf16 with the JAX package's casts;
parameters, sampling and the loss stay f32. On an env sharded over more
than one rank (``parallel.distribute``, ``env.mesh``) each rank collects
on its shard, and the update is the global batch's: the advantages are
normalized with the global mean and std, the gradients are averaged over
the ranks before each optimizer step, and the metrics are global means.

How the API maps onto the JAX one: ``init_actor_critic(key, obs_dim,
act_dim)``'s pytree is an :class:`ActorCritic` module here
(``interop.actor_critic_from_numpy`` / ``actor_critic_to_numpy`` carry
weights across); ``make_ppo_update`` returns ``(update, make_optimizer)``
in place of ``(update, optax.adam(lr))``, ``make_optimizer(model)`` being
``torch.optim.Adam`` with optax's defaults; and ``update(params, opt_state,
state, steps, key) -> (params', opt_state', state', steps', metrics)``
becomes ``update(model, optimizer, state, steps, generator) -> (state',
steps', metrics)``, the model and optimizer updated in place.

Spans (``profiling.span``, each on the device's clock): an update is
``vmas.ppo.update``, tiled by ``vmas.ppo.collect`` (the rollout),
``vmas.ppo.batch`` (``rows_batch``: values and GAE) and ``vmas.ppo.fit``
(``fit``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as Fn

from vmas_tpu_torch.core.utils import resolve_device
from vmas_tpu_torch.parallel.mesh import all_reduce, mean_over_ranks, mesh_size
from vmas_tpu_torch.parallel.rollout import (
    _noisy,
    _rows_policy_rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_supported,
)
from vmas_tpu_torch.profiling import span

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class ActorCritic(nn.Module):
    """The policy trunk ``pi`` and the value trunk ``v``, each a tanh MLP of
    ``nn.Linear`` layers, and the policy's ``log_std``. Use
    ``init_actor_critic`` for the JAX package's initialization."""

    def __init__(self, obs_dim, act_dim, hidden=(128, 128), device=None):
        super().__init__()
        sizes = (obs_dim,) + tuple(hidden)

        def trunk(n_out):
            dims = list(zip(sizes[:-1], sizes[1:])) + [(sizes[-1], n_out)]
            return nn.ModuleList(nn.utils.skip_init(nn.Linear, m, n, device=device) for m, n in dims)

        self.pi = trunk(act_dim)
        self.v = trunk(1)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5, device=device))


def init_actor_critic(obs_dim, act_dim, hidden=(128, 128), generator=None, device=None):
    """The JAX package's initialization: each weight ``N(0, 1) * scale /
    sqrt(fan_in)``, biases 0, scale 0.01 on the policy head and 1
    elsewhere, ``log_std = -0.5``. On the GPU unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    model = ActorCritic(obs_dim, act_dim, hidden, device=device)
    with torch.no_grad():
        for layers in (model.pi, model.v):
            for k, layer in enumerate(layers):
                scale = 0.01 if layers is model.pi and k == len(layers) - 1 else 1.0
                m = layer.in_features
                w = torch.randn((layer.out_features, m), generator=generator, device=device)
                layer.weight.copy_(w * scale / math.sqrt(m))
                layer.bias.zero_()
    return model


def _mlp(layers, x, dtype=None):
    """The shared MLP trunk. With ``dtype`` (bf16) the hidden activations
    stay in that type as in the JAX package: the input cast once, each
    layer's weight and bias cast, the product and the bias added and the
    tanh taken in ``dtype``; the head's product in ``dtype``, then cast to
    f32 and its f32 bias added."""
    if dtype is not None:
        x = x.to(dtype)
        for layer in layers[:-1]:
            x = torch.tanh(x @ layer.weight.to(dtype).T + layer.bias.to(dtype))
        last = layers[-1]
        return (x @ last.weight.to(dtype).T).float() + last.bias
    for layer in layers[:-1]:
        x = torch.tanh(Fn.linear(x, layer.weight, layer.bias))
    return Fn.linear(x, layers[-1].weight, layers[-1].bias)


def policy_dist(model, obs, dtype=None):
    """Diagonal Gaussian in the pre-scale action space [-1, 1]: (mean, std)."""
    return torch.tanh(_mlp(model.pi, obs, dtype)), torch.exp(model.log_std)


def gaussian_logp(mean, std, x):
    return (-0.5 * ((x - mean) / std) ** 2 - torch.log(std) - _HALF_LOG_2PI).sum(-1)


def _check_homogeneous(env):
    agents = env.agents
    assert env.continuous_actions, "the PPO helpers sample a Gaussian policy"
    assert len({a.action_size for a in agents}) == 1, (
        "the shared actor-critic folds agents into the batch -- it needs homogeneous action sizes"
    )
    assert env.world.dim_c == 0 or all(a.silent for a in agents), (
        "these helpers do not model communication actions; pick a comm-free scenario"
    )


def obs_dim_of(env):
    """The (asserted homogeneous) per-agent observation width."""
    dims = {int(o.shape[-1]) for o in env._observations(env.state)}
    assert len(dims) == 1, f"shared actor-critic needs homogeneous obs widths, got {dims}"
    return dims.pop()


def _ranges(env):
    return torch.stack([torch.as_tensor(a.u_range_array, device=env.device) for a in env.agents])  # [A, act]


def make_gaussian_policy(env, dtype=None):
    """``policy(model, obs_tuple, generator) -> (actions_tuple, aux)``: samples
    the Gaussian, clips the raw sample to [-1, 1], scales each agent's by its
    ``u_range``, and returns ``aux = {"raw": [B, A, act], "logp": [B, A]}``
    taken at sampling time (the rollouts' ``policy_aux`` contract)."""
    ranges = _ranges(env)

    @torch.no_grad()
    def policy(model, obs, generator):
        x = torch.stack(obs, dim=1)  # [B, A, O]
        mean, std = policy_dist(model, x, dtype)
        raw = mean + std * torch.randn(mean.shape, generator=generator, device=mean.device)
        raw = torch.clamp(raw, -1.0, 1.0)
        logp = gaussian_logp(mean, std, raw)
        scaled = raw * ranges
        return tuple(scaled[:, i] for i in range(ranges.shape[0])), {"raw": raw, "logp": logp}

    return policy


def _global_moments(x, mesh):
    """The mean and population std of ``x`` over every rank's shard: its
    sum, sum of squares and count, in float64, summed in one all-reduce."""
    x64 = x.detach().double()
    stats = all_reduce(torch.stack([x64.sum(), (x64 * x64).sum(), x64.new_tensor(x.numel())]), mesh)
    mean = stats[0] / stats[2]
    var = torch.clamp(stats[1] / stats[2] - mean * mean, min=0.0)
    return mean.to(x.dtype), var.sqrt().to(x.dtype)


def ppo_loss(model, batch, clip=0.2, vf_coeff=0.5, ent_coeff=0.0, dtype=None, mesh=None):
    """The clipped-surrogate loss on ``batch = {obs, act, logp, adv, ret}``:
    ``(loss, (pg, vf))``. The advantages are normalized with the population
    std, as ``jnp.std``; on a ``mesh`` of more than one rank, with the mean
    and std of the global batch (every rank's shard of it)."""
    mean, std = policy_dist(model, batch["obs"], dtype)
    logp = gaussian_logp(mean, std, batch["act"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    if mesh_size(mesh) > 1:
        adv_mean, adv_std = _global_moments(adv, mesh)
        adv = (adv - adv_mean) / (adv_std + 1e-8)
    else:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    value = _mlp(model.v, batch["obs"], dtype)[..., 0]
    vf = ((value - batch["ret"]) ** 2).mean()
    entropy = (torch.log(std) + 0.5 * math.log(2 * math.pi * math.e)).sum()
    return pg + vf_coeff * vf - ent_coeff * entropy, (pg, vf)


def gae(rews, dones, values, gamma=0.99, lam=0.95):
    """Generalized advantage estimates by a reverse loop over T: rews
    ``[T, B, A]``, dones ``[T, B]``, values ``[T+1, B, A]`` -> (advantages,
    returns), each ``[T, B, A]``."""
    nonterm = 1.0 - dones[..., None].to(torch.float32)  # [T, B, 1]
    deltas = rews + gamma * nonterm * values[1:] - values[:-1]
    advs = torch.empty_like(deltas)
    adv = torch.zeros_like(values[-1])
    for t in range(deltas.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * nonterm[t] * adv
        advs[t] = adv
    return advs, advs + values[:-1]


def fit(model, optimizer, batch, epochs, mesh=None, **loss_kw):
    """``epochs`` full-batch optimizer steps on ``ppo_loss`` (no minibatch
    shuffle: the whole batch fits on the device); returns the last loss. On
    a ``mesh`` of more than one rank, each batch is this rank's shard of the
    global batch: the gradients and the loss are averaged over the ranks in
    one flattened all-reduce before ``optimizer.step()``, so every rank
    takes the global batch's step."""
    params = [p for p in model.parameters() if p.requires_grad]
    with span("vmas.ppo.fit", device=batch["obs"]):
        for _ in range(epochs):
            loss, _ = ppo_loss(model, batch, mesh=mesh, **loss_kw)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh_size(mesh) > 1:
                *grads, loss = mean_over_ranks([p.grad for p in params] + [loss.detach()], mesh)
                for p, g in zip(params, grads):
                    p.grad.copy_(g)
            optimizer.step()
        return loss.detach()


def rows_batch(model, traj, gamma=0.99, lam=0.95, dtype=None):
    """The training batch of a policy rollout's trajectory (``policy_aux``,
    either collect mode). The action at step t was sampled from the
    observations recorded at t-1 (``obs0`` at t=0; post-reset where an env
    reset); the last recorded observations only bootstrap the value tail."""
    with span("vmas.ppo.batch", device=traj["rewards"]):
        obs_emitted = torch.stack(traj["obs"], dim=2)  # [T, B, A, O]
        obs0 = torch.stack(traj["obs0"], dim=1)  # [B, A, O]
        obs_act = torch.cat([obs0[None], obs_emitted[:-1]])
        with torch.no_grad():
            values = _mlp(model.v, torch.cat([obs_act, obs_emitted[-1:]]), dtype)[..., 0]  # [T+1, B, A]
        advs, rets = gae(traj["rewards"], traj["dones"], values, gamma, lam)
        return {
            "obs": obs_act, "act": traj["policy_aux"]["raw"], "logp": traj["policy_aux"]["logp"],
            "adv": advs, "ret": rets,
        }


def make_ppo_update(env, horizon=32, lr=3e-4, gamma=0.99, lam=0.95, clip=0.2, epochs=4,
                    vf_coeff=0.5, ent_coeff=0.0, collect="auto", compute_dtype=None,
                    reset_every: Optional[int] = None):
    """Build ``(update, make_optimizer)``.

    ``update(model, optimizer, state, steps, generator) -> (state', steps',
    metrics)`` collects ``horizon`` steps of experience with the model's
    policy, then takes ``epochs`` full-batch Adam steps on it; ``metrics``
    holds the last epoch's ``loss``, the ``mean_reward`` and the
    ``episode_done_frac`` of the collected steps (0-d tensors on the env's
    device). ``make_optimizer(model)`` is ``torch.optim.Adam(lr,
    betas=(0.9, 0.999), eps=1e-8)``, optax.adam's formula.
    ``reset_every=N`` (rows): every env resets every N collection steps.

    The collection is built once, here, and takes the model on each call.
    With ``collect="rows"`` on a CUDA env whose steps draw no noise, its
    steps (the policy, the draw, the decode, the kernel's launch and the
    step's observations, for the whole horizon or each ``reset_every``
    chunk) are one CUDA graph: captured in the first call, after that
    call's eager steps, and replayed bitwise in every later call with the
    same model's parameters in place (``rollout._StepsGraph``)."""
    _check_homogeneous(env)
    if collect == "auto":
        collect = "rows" if rows_rollout_supported(env) else "step"
    assert collect in ("rows", "step"), collect
    if collect == "rows":
        assert rows_rollout_supported(env), (
            "collect='rows' needs a rows-eligible env (rows_rollout_supported) -- use collect='step'"
        )
    dtype = compute_dtype
    policy = make_gaussian_policy(env, dtype=dtype)
    if collect == "rows":
        graphed = torch.device(env.device).type == "cuda" and not _noisy(env)
        run = _rows_policy_rollout(env, policy, horizon, True, reset_every, graphed)
    else:
        run = rollout_fn(env, policy, horizon, autoreset=True, policy_aux=True)
    loss_kw = dict(clip=clip, vf_coeff=vf_coeff, ent_coeff=ent_coeff, dtype=dtype)

    def make_optimizer(model):
        return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def update(model, optimizer, state, steps, generator):
        with span("vmas.ppo.update", device=env.device):
            with span("vmas.ppo.collect", device=env.device), torch.no_grad():
                state, steps, traj = run(state, steps, generator, model)
            batch = rows_batch(model, traj, gamma, lam, dtype)
            mesh = getattr(env, "mesh", None)
            loss = fit(model, optimizer, batch, epochs, mesh=mesh, **loss_kw)
            means = [traj["rewards"].mean(), traj["dones"].to(torch.float32).mean()]
            if mesh_size(mesh) > 1:
                # the global batch's means: the shards are equal, so the ranks' mean
                means = mean_over_ranks(means, mesh)
        return state, steps, {"loss": loss, "mean_reward": means[0], "episode_done_frac": means[1]}

    return update, make_optimizer


def make_evaluate(env, horizon=100):
    """Deterministic evaluation: ``run(model, state, steps, generator) ->
    (state', steps', metrics)`` runs the policy mean (no sampling) through
    the rows policy rollout where eligible, else ``rollout_fn``; metrics
    hold the mean per-step reward and the share of envs that finished an
    episode."""
    _check_homogeneous(env)
    ranges = _ranges(env)
    rows_ok = rows_rollout_supported(env)

    def run(model, state, steps, generator):
        @torch.no_grad()
        def policy(obs, _generator):
            mean, _ = policy_dist(model, torch.stack(obs, dim=1))
            scaled = mean * ranges
            return tuple(scaled[:, i] for i in range(ranges.shape[0]))

        build = rows_policy_rollout_fn(env, policy, horizon) if rows_ok else rollout_fn(env, policy, horizon)
        state, steps, traj = build(state, steps, generator)
        return state, steps, {
            "mean_reward": traj["rewards"].mean(),
            "episode_done_frac": traj["dones"].any(dim=0).to(torch.float32).mean(),
        }

    return run
