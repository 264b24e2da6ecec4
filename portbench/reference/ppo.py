"""Plain reference of the PPO update: one shared tanh actor-critic over the
agents, a diagonal Gaussian policy in the pre-scale action space [-1, 1],
values over T+1 steps and GAE, and full-batch epochs of the clipped
surrogate loss under Adam. A frozen copy of the port's PPO arithmetic
(``make_gaussian_policy``, ``rows_batch``, ``gae``, ``ppo_loss``, ``fit``),
with nothing of the port imported.

``mlp_dtype`` is the type of the networks' hidden activations: bfloat16 as
the ``ppo`` traffic runs them, or ``"fp8"`` for the lower-precision control,
which rounds each layer's input and weight to float8 (e4m3) with a scale per
tensor (its largest magnitude to e4m3's largest, 448) before its bfloat16
product.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as Fn

from portbench.reference.rollout import policy_rollout

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class ActorCritic(nn.Module):
    """The policy trunk ``pi`` and the value trunk ``v`` (tanh MLPs of
    ``nn.Linear``) and the policy's ``log_std``: the parameter names and
    order of the program's model."""

    def __init__(self, obs_dim, act_dim, hidden, device):
        super().__init__()
        sizes = (obs_dim,) + tuple(hidden)

        def trunk(n_out):
            dims = list(zip(sizes[:-1], sizes[1:])) + [(sizes[-1], n_out)]
            return nn.ModuleList(nn.utils.skip_init(nn.Linear, m, n, device=device) for m, n in dims)

        self.pi = trunk(act_dim)
        self.v = trunk(1)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5, device=device))


def make_weights(obs_dim, act_dim, hidden, generator, device):
    """The model's initial weights from ``generator``, in one draw on the
    device: each weight ``N(0, 1) * scale / sqrt(fan_in)``, scale 0.01 on
    the policy head and 1 elsewhere, biases 0, ``log_std`` -0.5 ->
    {parameter name: tensor}."""
    sizes = (obs_dim,) + tuple(hidden)
    shapes = []
    for trunk, n_out in (("pi", act_dim), ("v", 1)):
        dims = list(zip(sizes[:-1], sizes[1:])) + [(sizes[-1], n_out)]
        for k, (m, n) in enumerate(dims):
            scale = 0.01 if trunk == "pi" and k == len(dims) - 1 else 1.0
            shapes.append((f"{trunk}.{k}", n, m, scale))
    flat = torch.randn((sum(n * m for _, n, m, _ in shapes),), generator=generator, device=device)
    out, at = {}, 0
    for name, n, m, scale in shapes:
        out[f"{name}.weight"] = flat[at:at + n * m].view(n, m) * scale / math.sqrt(m)
        out[f"{name}.bias"] = torch.zeros((n,), device=device)
        at += n * m
    out["log_std"] = torch.full((act_dim,), -0.5, device=device)
    return out


def load_weights(model, weights):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


class _Fp8(torch.autograd.Function):
    """A tensor rounded to float8 e4m3 with one scale per tensor (its
    largest magnitude to e4m3's largest, 448), as bfloat16; its gradient
    passes through unrounded in the input's type, as in training with
    float8 products."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        scale = torch.clamp(x.abs().amax().float() / 448.0, min=1e-30)
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype)


def _cast(x, dtype):
    return _Fp8.apply(x) if dtype == "fp8" else x.to(dtype)


def mlp(layers, x, dtype=None):
    """The shared trunk. With ``dtype`` the hidden activations stay in that
    type: the input cast once, each layer's weight and bias cast, the
    product, the bias and the tanh in that type; the head's product cast
    to f32 before its f32 bias."""
    if dtype is not None:
        x = _cast(x, dtype)
        for layer in layers[:-1]:
            x = torch.tanh(x @ _cast(layer.weight, dtype).T + _cast(layer.bias, dtype))
            if dtype == "fp8":
                x = _cast(x, dtype)
        last = layers[-1]
        return (x @ _cast(last.weight, dtype).T).float() + last.bias
    for layer in layers[:-1]:
        x = torch.tanh(Fn.linear(x, layer.weight, layer.bias))
    return Fn.linear(x, layers[-1].weight, layers[-1].bias)


def policy_dist(model, obs, dtype=None):
    return torch.tanh(mlp(model.pi, obs, dtype)), torch.exp(model.log_std)


def gaussian_logp(mean, std, x):
    return (-0.5 * ((x - mean) / std) ** 2 - torch.log(std) - HALF_LOG_2PI).sum(-1)


def gaussian_policy(model, ranges, dtype):
    """``policy(obs_tuple, generator) -> (actions, aux)``: the raw sample
    clipped to [-1, 1] and scaled by each agent's u_range (``ranges`` [A,
    2]), with ``aux = {raw, logp}`` taken at sampling time."""

    @torch.no_grad()
    def policy(obs, generator):
        x = torch.stack(obs, dim=1)
        mean, std = policy_dist(model, x, dtype)
        raw = mean + std * torch.randn(mean.shape, generator=generator, device=mean.device)
        raw = torch.clamp(raw, -1.0, 1.0)
        logp = gaussian_logp(mean, std, raw)
        scaled = raw * ranges
        return tuple(scaled[:, i] for i in range(ranges.shape[0])), {"raw": raw, "logp": logp}

    return policy


def gae(rews, dones, values, gamma=0.99, lam=0.95):
    nonterm = 1.0 - dones[..., None].to(torch.float32)
    deltas = rews + gamma * nonterm * values[1:] - values[:-1]
    advs = torch.empty_like(deltas)
    adv = torch.zeros_like(values[-1])
    for t in range(deltas.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * nonterm[t] * adv
        advs[t] = adv
    return advs, advs + values[:-1]


def ppo_loss(model, batch, clip=0.2, vf_coeff=0.5, ent_coeff=0.0, dtype=None):
    mean, std = policy_dist(model, batch["obs"], dtype)
    logp = gaussian_logp(mean, std, batch["act"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
    value = mlp(model.v, batch["obs"], dtype)[..., 0]
    vf = ((value - batch["ret"]) ** 2).mean()
    entropy = (torch.log(std) + 0.5 * math.log(2 * math.pi * math.e)).sum()
    return pg + vf_coeff * vf - ent_coeff * entropy


def make_optimizer(model, lr):
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def update(cfg, spec, model, optimizer, carry, obs0, generator, horizon, epochs, dtype):
    """One PPO update from the rows ``carry`` with the policy acting first on
    ``obs0``: collection, batch and ``epochs`` full-batch Adam steps ->
    (carry', the last step's observations, the last epoch's loss)."""
    # every agent's u_range is 1 in the configurations trained here
    ranges = torch.ones((len(cfg.ACT_SLOTS), 2), device=carry.device)
    policy = gaussian_policy(model, ranges, dtype)
    with torch.no_grad():
        carry, extras, aux = policy_rollout(cfg, spec, policy, carry, obs0, generator, horizon)
        obs_t, rews, dones = cfg.unpack(extras.to(torch.float32))
        obs_emitted = torch.stack(obs_t, dim=2)
        obs_act = torch.cat([torch.stack(obs0, dim=1)[None], obs_emitted[:-1]])
        values = mlp(model.v, torch.cat([obs_act, obs_emitted[-1:]]), dtype)[..., 0]
        advs, rets = gae(torch.stack(rews, dim=-1), dones, values)
    batch = {"obs": obs_act, "act": aux["raw"], "logp": aux["logp"], "adv": advs, "ret": rets}
    for _ in range(epochs):
        loss = ppo_loss(model, batch, dtype=dtype)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    last_obs = tuple(o[-1] for o in obs_t)
    return carry, last_obs, loss.detach()
