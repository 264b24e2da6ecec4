"""The vectorized RL environment.

Counterpart of vmas_tpu/environment/environment.py, run eagerly: one step
is action decode, process_action (per agent, or per group of agents whose
dynamics run as one ``[B, A]`` computation: ``_plan_process_action``),
pre_step, the physics step (the fused kernel with ``fused_physics=True``),
post_step, then the observations, rewards and dones; the state that leaves
the step has each agent's ``u`` at its spawn width (``_canonical_u``).
Randomness comes from one ``torch.Generator`` on the env's device, seeded
from ``seed``; each step and each reset also draws from it a fresh seed for
the observation noise (``BaseScenario.obs_generator``).

The env runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU present it raises instead of falling back. gymnasium is imported only
when a space is asked for (``action_space``, ``observation_space``,
``get_action_space``, ``get_observation_space``,
``get_agent_action_space``); random actions need none.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vmas_tpu_torch.core import fused as _fused
from vmas_tpu_torch.core.state import WorldState, blend
from vmas_tpu_torch.core.utils import resolve_device
from vmas_tpu_torch.core.world import Agent
from vmas_tpu_torch.scenario import BaseScenario


def _obs_seed(generator: torch.Generator) -> int:
    """A fresh 64-bit seed for one step's (or reset's) observation noise,
    drawn from ``generator``: a hash of its state, which is then advanced by
    one draw so that the next call gets another seed. The state of a CUDA
    generator lives on the host, so this does not wait for the device."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8).digest()
    torch.empty((1,), device=generator.device).random_(generator=generator)
    return int.from_bytes(digest, "little")


class Environment:
    metadata = {"render.modes": ["human", "rgb_array"], "runtime.vectorized": True}

    def __init__(
        self,
        scenario: BaseScenario,
        num_envs: int = 32,
        device=None,
        max_steps: Optional[int] = None,
        continuous_actions: bool = True,
        seed: Optional[int] = None,
        dict_spaces: bool = False,
        multidiscrete_actions: bool = False,
        clamp_actions: bool = False,
        grad_enabled: bool = False,
        terminated_truncated: bool = False,
        fused_physics: bool = False,
        **kwargs,
    ):
        if multidiscrete_actions:
            assert not continuous_actions, (
                "When asking for multidiscrete_actions, make sure continuous_actions=False"
            )
        if fused_physics and grad_enabled:
            # the kernel defines no backward pass
            raise ValueError(
                "fused_physics is forward-only; use the default plain physics for "
                "differentiable rollouts"
            )
        self.scenario = scenario
        self.num_envs = num_envs
        self.batch_dim = num_envs
        self.device = resolve_device(device)
        self.world = scenario.env_make_world(num_envs, self.device, **kwargs)
        if grad_enabled:
            # scenario kernels (road_traffic's path sweeps and all-ego
            # observations) are forward-only like the fused physics; the
            # plain path stays differentiable
            for flag in ("pallas_sweeps", "pallas_obs"):
                if getattr(scenario, flag, False):
                    setattr(scenario, flag, False)
        self._fused_outputs = None
        if fused_physics:
            # as in the JAX package, a world runs fused where supports()
            # admits it and on the plain physics otherwise (World.step);
            # a fused world beyond a cap of the port's kernel raises here
            self.world.fused = True
            if _fused.supports(self.world):
                mk = getattr(scenario, "make_fused_outputs", None)
                if mk is not None:
                    self._fused_outputs = mk(self.world)
                _fused.check_fusable(self.world, self._fused_outputs)
        self.agents = self.world.policy_agents
        self.n_agents = len(self.agents)
        self.max_steps = max_steps
        self.continuous_actions = continuous_actions
        self.dict_spaces = dict_spaces
        self.clamp_action = clamp_actions
        self.grad_enabled = grad_enabled
        self.terminated_truncated = terminated_truncated
        self.multidiscrete_actions = multidiscrete_actions

        self._pa_singles, self._pa_groups = self._plan_process_action()

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed if seed is not None else 0)
        self.state: Optional[WorldState] = None
        self.steps = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        self._spaces = {}
        self._do_reset()

    # ------------------------------------------------------------------
    # the step pipeline
    # ------------------------------------------------------------------
    def _plan_process_action(self):
        """The agents of ``world.agents`` for the process_action phase, as
        ``(singles, groups)``, fixed when the env is built (JAX
        environment.py:118-168).

        An agent whose ``env_process_action`` is its dynamics alone (no
        ``action_script``, the scenario does not override
        ``process_action``) and whose dynamics advertise a ``batch_spec``
        joins the group of its ``(batch_spec, action_size)``; a group runs
        one ``[B, A]`` ``process_action_batch``. Every other agent, and a
        group of one, runs per agent in agent order. By default only
        ``batch_exact`` models group (the holonomic family, static,
        rotation: bitwise the loop); ``VMAS_TPU_BATCH_DYNAMICS=1`` (or
        ``true``/``on``) groups every model with a ``batch_spec``
        (kinematic_bicycle, diff_drive and forward compute sin/cos/tan on
        the stacked shape, which may round an ulp apart from the loop), and
        ``0`` (``false``/``off``) turns grouping off."""
        agents = list(self.world.agents)
        flag = os.environ.get("VMAS_TPU_BATCH_DYNAMICS", "exact").strip().lower()
        if flag in ("0", "false", "off"):
            return agents, []
        all_models = flag in ("1", "true", "on")
        if type(self.scenario).process_action is not BaseScenario.process_action:
            return agents, []
        groups: Dict = {}
        singles = []
        for a in agents:
            spec = None
            if a.action_script is None and a.action_size >= a.dynamics.needed_action_size:
                if all_models or a.dynamics.batch_exact():
                    spec = a.dynamics.batch_spec()
            if spec is None:
                singles.append(a)
            else:
                groups.setdefault((spec, a.action_size), []).append(a)
        out = []
        for grp in groups.values():
            if len(grp) >= 2:
                out.append(tuple(grp))
            else:
                singles.extend(grp)
        singles.sort(key=lambda a: a.index)
        return singles, out

    def _canonical_u(self, state: WorldState) -> WorldState:
        """``state`` with each agent's ``u`` cut or zero-padded back to its
        ``action_size``. A scenario's process_action may write a wider u
        (debug/drone prepends the thrust), which the step's hooks see; the
        state that leaves the step keeps the spawn-time shape, and the next
        step overwrites every u when it decodes the actions."""
        new_u, changed = [], False
        for a, u in zip(self.world.agents, state.u):
            w = a.action_size
            if u.shape[1] > w:
                u, changed = u[:, :w], True
            elif u.shape[1] < w:
                u, changed = torch.nn.functional.pad(u, (0, w - u.shape[1])), True
            new_u.append(u)
        return state.replace(u=tuple(new_u)) if changed else state

    def _outputs(self, state: WorldState, steps, obs_seed: int, with_rewards: bool = True, fused_extra=None):
        scenario = self.scenario
        # the observation-noise seed of this call (BaseScenario.obs_generator)
        scenario.obs_seed = obs_seed
        if fused_extra is not None:
            # obs/rewards/termination came out of the fused step as rows;
            # unpack replaces the pre_rewards/reward/observation/done hooks
            obs, rews, terminated, scratch_updates = self._fused_outputs.unpack(fused_extra, state)
            state = state.replace(scenario={**state.scenario, **scratch_updates})
            state = scenario.post_rewards(state)
            # the observation parts that must see the state after
            # post_rewards, as the hooks would (discovery's Lidar after its
            # covered targets respawn)
            obs = self._fused_outputs.finish_obs(obs, state)
        else:
            rews = None
            if with_rewards:
                # observations see the post-reward state
                state = scenario.pre_rewards(state)
                rews = tuple(scenario.reward(a, state) for a in self.agents)
                state = scenario.post_rewards(state)
            obs = self._observations(state)
            terminated = scenario.done(state)
        infos = tuple(scenario.info(a, state) for a in self.agents)
        if self.max_steps is not None:
            truncated = steps >= self.max_steps
        else:
            truncated = torch.zeros_like(terminated)
        return state, obs, rews, terminated, truncated, infos

    def _observations(self, state: WorldState):
        obs = self.scenario.observations(state)
        if obs is None:
            obs = tuple(self.scenario.observation(a, state) for a in self.agents)
        return obs

    def _reset_fn(self, state: WorldState, steps, generator, mask):
        obs_seed = _obs_seed(generator)
        fresh = self.scenario.env_reset_world_at(state, generator)
        if mask is None:
            state = fresh
            steps = torch.zeros_like(steps)
        else:
            state = blend(mask, fresh, state)
            steps = torch.where(mask, torch.zeros_like(steps), steps)
        state, obs, _, terminated, truncated, infos = self._outputs(state, steps, obs_seed, with_rewards=False)
        return state, steps, obs, terminated, truncated, infos

    def _act(self, state: WorldState, actions, noise) -> WorldState:
        """The part of a step before the physics: decode each policy agent's
        action (with its drawn ``noise``, ``_step_draws``), process_action
        (per agent and per group, ``_plan_process_action``), pre_step."""
        for i, agent in enumerate(self.agents):
            state = self._decode_action(state, agent, actions[i], noise[i])
        for agent in self._pa_singles:
            state = self.scenario.env_process_action(agent, state)
        for group in self._pa_groups:
            state = group[0].dynamics.process_action_batch(self.world, state, group)
        return self.scenario.pre_step(state)

    def _step_fn_raw(self, state: WorldState, steps, actions, generator):
        """One env step on explicit state: (state, steps, actions,
        generator) -> (state, obs, rews, terminated, truncated, infos,
        steps)."""
        obs_seed, noise = self._step_draws(generator)
        state = self._act(state, actions, noise)
        if self._fused_outputs is not None:
            state, fused_extra = self.world.step_with_outputs(state, self._fused_outputs)
        else:
            state = self.world.step(state)
            fused_extra = None
        state = self.scenario.post_step(state)
        steps = steps + 1
        out = self._outputs(state, steps, obs_seed, fused_extra=fused_extra)
        return (self._canonical_u(out[0]),) + out[1:] + (steps,)

    # ------------------------------------------------------------------
    # action decoding
    # ------------------------------------------------------------------
    def _noise_shapes(self):
        """Per policy agent, the shapes of the noise a step draws for it: its
        action noise ``[B, action_size]`` where a ``u_noise`` is positive and
        its comm noise ``[B, dim_c]`` where it speaks with ``c_noise > 0``
        (None where it draws none)."""
        B, dim_c = self.num_envs, self.world.dim_c
        return [((B, a.action_size) if np.any(a.u_noise_array > 0) else None,
                 (B, dim_c) if dim_c > 0 and not a.silent and a.c_noise > 0 else None) for a in self.agents]

    def _step_draws(self, generator, horizon=None):
        """What one env step draws from ``generator``, in this order: its
        observation seed (``_obs_seed``), then per policy agent its action
        noise and then its comm noise (``_noise_shapes``; None where it
        draws none). Returns ``(seed, noise)``, ``noise`` per agent a pair
        ``(u_noise, c_noise)``. With ``horizon``, the draws of that many
        steps, step by step (one draw of ``[T, B, 2]`` is not T draws of
        ``[B, 2]``): the seeds as a list and each noise stacked over a
        leading T axis."""
        shapes = self._noise_shapes()
        draw = lambda shape: None if shape is None else torch.randn(shape, generator=generator, device=self.device)

        def one():
            seed = _obs_seed(generator)
            return seed, [(draw(u_shape), draw(c_shape)) for u_shape, c_shape in shapes]

        if horizon is None:
            return one()
        seeds, steps = zip(*(one() for _ in range(horizon)))
        stack = lambda xs: None if xs[0] is None else torch.stack(xs)
        return list(seeds), [tuple(stack(xs) for xs in zip(*per_agent)) for per_agent in zip(*steps)]

    def _add_noise(self, agent: Agent, u, comm, noise):
        """The decoded action ``u`` and comm action ``comm`` (any leading
        axes) with the agent's drawn ``noise`` (``_step_draws``) added."""
        u_noise, c_noise = noise
        if u_noise is not None:
            u = u + u_noise * torch.as_tensor(agent.u_noise_array, device=self.device)[None]
        if c_noise is not None:
            comm = comm + c_noise * agent.c_noise
        return u, comm

    def _decode_action(self, state: WorldState, agent: Agent, action, noise) -> WorldState:
        dim_c = self.world.dim_c
        has_comm = dim_c > 0 and not agent.silent
        dev = self.device
        u_range = torch.as_tensor(agent.u_range_array, device=dev)
        u_mult = torch.as_tensor(agent.u_multiplier_array, device=dev)
        action = torch.as_tensor(action, device=dev)
        if action.ndim == 1:
            action = action[:, None]
        if not self.grad_enabled:
            action = action.detach()
        comm_action = None

        if self.continuous_actions:
            action = action.to(torch.float32)
            u = action[:, : agent.action_size]
            if has_comm:
                comm_action = action[:, agent.action_size:]
            if self.clamp_action:
                u = torch.clamp(u, -u_range[None], u_range[None])
                if comm_action is not None:
                    comm_action = torch.clamp(comm_action, 0.0, 1.0)
        else:
            nvec = list(agent.discrete_action_nvec) + ([dim_c] if has_comm else [])
            if not self.multidiscrete_actions:
                # flat Discrete -> multidiscrete mixed-radix decode; an out of
                # range index is clamped into the valid range
                flat = torch.clamp(action[:, 0].to(torch.int64), 0, math.prod(nvec) - 1)
                cols = []
                for i in range(len(nvec)):
                    n = math.prod(nvec[i + 1:])
                    cols.append(flat // n)
                    flat = flat % n
                action = torch.stack(cols, dim=-1)
            action = action.to(torch.int64)

            us = []
            for j, n in enumerate(agent.discrete_action_nvec):
                a = action[:, j]
                if n % 2 != 0:
                    # odd n: action 0 maps to zero control
                    stay = a == 0
                    decrement = (a > 0) & (a <= n // 2)
                    a = torch.where(stay, n // 2, torch.where(decrement, a - 1, a))
                u_max = u_range[j]
                us.append((a.to(torch.float32) / (n - 1)) * (2 * u_max) - u_max)
            u = torch.stack(us, dim=-1)
            if has_comm:
                comm_idx = action[:, len(agent.discrete_action_nvec)]
                comm_action = torch.nn.functional.one_hot(comm_idx, dim_c).to(torch.float32)

        u, comm_action = self._add_noise(agent, u * u_mult[None], comm_action, noise)
        state = agent.set_u(state, u)

        if has_comm:
            uc = state.uc.clone()
            uc[:, agent.slot] = comm_action
            state = state.replace(uc=uc)
        return state

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def seed(self, seed=None):
        seed = 0 if seed is None else seed
        self.generator.manual_seed(seed)
        return [seed]

    def _do_reset(self, seed=None, return_observations=True, return_info=False, return_dones=False):
        if seed is not None:
            self.seed(seed)
        if self.state is None:
            self.state = self.world.spawn_state()
        self.state, self.steps, obs, terminated, truncated, infos = self._reset_fn(
            self.state, self.steps, self.generator, None
        )
        return self._pack_result(obs, None, terminated, truncated, infos,
                                 return_observations, False, return_info, return_dones)

    def reset(self, seed=None, return_observations=True, return_info=False, return_dones=False):
        return self._do_reset(seed, return_observations, return_info, return_dones)

    def reset_at(self, index: int, return_observations=True, return_info=False, return_dones=False):
        assert 0 <= index < self.num_envs, f"Index must be between 0 and {self.num_envs}, got {index}"
        mask = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        mask[index] = True
        return self.reset_mask(mask, return_observations, return_info, return_dones)

    def reset_mask(self, mask, return_observations=True, return_info=False, return_dones=False):
        """Reset an arbitrary subset of envs ([B] bool mask) in one call."""
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        self.state, self.steps, obs, terminated, truncated, infos = self._reset_fn(
            self.state, self.steps, self.generator, mask
        )
        return self._pack_result(obs, None, terminated, truncated, infos,
                                 return_observations, False, return_info, return_dones)

    def step(self, actions: Union[List, Dict, Sequence]):
        """Vectorized step. Accepts a list (agent order) or dict (agent-name
        keyed) of per-agent actions shaped [num_envs, action_size]."""
        actions = self._normalize_actions(actions)
        (self.state, obs, rews, terminated, truncated, infos, self.steps) = self._step_fn_raw(
            self.state, self.steps, actions, self.generator
        )
        return self._pack_result(obs, rews, terminated, truncated, infos, True, True, True, True)

    def done(self):
        terminated = self.scenario.done(self.state)
        truncated = self.steps >= self.max_steps if self.max_steps is not None else None
        if self.terminated_truncated:
            return terminated, torch.zeros_like(terminated) if truncated is None else truncated
        return terminated if truncated is None else terminated | truncated

    def get_from_scenario(self, get_observations: bool, get_rewards: bool, get_infos: bool, get_dones: bool,
                          dict_agent_names: Optional[bool] = None):
        """The observations, rewards, dones and infos of the current state,
        in that order, each where asked for (JAX environment.py:447-488).
        The reward hooks run only where rewards are asked for, and then
        their scratch updates stay in ``self.state``; the observations see
        the state after them, with a fresh observation-noise seed drawn from
        the env's generator."""
        if not any([get_observations, get_rewards, get_infos, get_dones]):
            return
        if dict_agent_names is None:
            dict_agent_names = self.dict_spaces
        self.scenario.obs_seed = _obs_seed(self.generator)
        state = self.state
        rews = None
        if get_rewards:
            state = self.scenario.pre_rewards(state)
            rews = tuple(self.scenario.reward(a, state) for a in self.agents)
            state = self.scenario.post_rewards(state)
            self.state = state
        obs = self._observations(state) if get_observations else None
        infos = tuple(self.scenario.info(a, state) for a in self.agents) if get_infos else None

        result = [self._maybe_dict(vals, dict_agent_names) for vals in (obs, rews) if vals is not None]
        if get_dones:
            d = self.done()
            if self.terminated_truncated:
                result.extend(d)
            else:
                result.append(d)
        if infos is not None:
            result.append(self._maybe_dict(infos, dict_agent_names))
        return result

    def to(self, device):
        """``self`` where ``device`` is the env's own device (the JAX
        package's ``to`` leaves placement as it is); a built env does not
        move, so any other device raises."""
        want = torch.device(device)
        index = lambda d: d.index if d.index is not None else (torch.cuda.current_device() if d.type == "cuda" else 0)
        if want.type != self.device.type or index(want) != index(self.device):
            raise ValueError(f"this environment lives on {self.device} and cannot move to {want}; "
                             f"build it there with make_env(..., device={str(want)!r})")
        return self

    # ------------------------------------------------------------------
    # spaces (gymnasium, imported on first access)
    # ------------------------------------------------------------------
    def get_agent_action_size(self, agent: Agent):
        if self.continuous_actions:
            return agent.action_size + (self.world.dim_c if not agent.silent else 0)
        elif self.multidiscrete_actions:
            return agent.action_size + (1 if not agent.silent and self.world.dim_c != 0 else 0)
        return 1

    def discrete_action_nvec(self, agent: Agent):
        """The sizes of the agent's discrete actions, then of its comm action
        where it has one: the MultiDiscrete space's ``nvec``; the Discrete
        space's ``n`` is their product."""
        dim_c = self.world.dim_c
        return list(agent.discrete_action_nvec) + ([dim_c] if not agent.silent and dim_c != 0 else [])

    def get_agent_action_space(self, agent: Agent):
        from gymnasium import spaces

        dim_c = self.world.dim_c
        if self.continuous_actions:
            return spaces.Box(
                low=np.array(
                    (-agent.u_range_array).tolist() + [0] * (dim_c if not agent.silent else 0),
                    dtype=np.float32,
                ),
                high=np.array(
                    agent.u_range_array.tolist() + [1] * (dim_c if not agent.silent else 0),
                    dtype=np.float32,
                ),
                shape=(self.get_agent_action_size(agent),),
                dtype=np.float32,
            )
        elif self.multidiscrete_actions:
            return spaces.MultiDiscrete(self.discrete_action_nvec(agent))
        return spaces.Discrete(math.prod(self.discrete_action_nvec(agent)))

    def get_action_space(self):
        """The action space of all policy agents: a Tuple of theirs in agent
        order, or a Dict keyed by agent name under ``dict_spaces``."""
        from gymnasium import spaces

        if not self.dict_spaces:
            return spaces.Tuple([self.get_agent_action_space(a) for a in self.agents])
        return spaces.Dict({a.name: self.get_agent_action_space(a) for a in self.agents})

    @property
    def action_space(self):
        if "action" not in self._spaces:
            self._spaces["action"] = self.get_action_space()
        return self._spaces["action"]

    def get_agent_observation_space(self, agent: Agent, obs):
        """The agent's observation space from one observation of it: a Box
        of its per-env shape, or a Dict of them where the scenario observes
        a dict (football's ``dict_obs``)."""
        from gymnasium import spaces

        if isinstance(obs, dict):
            return spaces.Dict({k: self.get_agent_observation_space(agent, v) for k, v in obs.items()})
        return spaces.Box(low=-np.float32("inf"), high=np.float32("inf"), shape=tuple(obs.shape[1:]),
                          dtype=np.float32)

    def get_observation_space(self, observations):
        """The observation space of all policy agents from one set of their
        observations (a list in agent order, or a dict keyed by agent name
        under ``dict_spaces``, as ``step`` returns them)."""
        from gymnasium import spaces

        if not self.dict_spaces:
            return spaces.Tuple(
                [self.get_agent_observation_space(a, observations[i]) for i, a in enumerate(self.agents)]
            )
        return spaces.Dict(
            {a.name: self.get_agent_observation_space(a, observations[a.name]) for a in self.agents}
        )

    @property
    def observation_space(self):
        if "observation" not in self._spaces:
            self._spaces["observation"] = self.get_observation_space(self._maybe_dict(self._observations(self.state)))
        return self._spaces["observation"]

    # ------------------------------------------------------------------
    # random actions
    # ------------------------------------------------------------------
    def get_random_action(self, agent: Agent):
        dev, gen, B = self.device, self.generator, self.num_envs
        if self.continuous_actions:
            ranges = torch.as_tensor(agent.u_range_array, device=dev)
            u = (torch.rand((B, agent.action_size), generator=gen, device=dev) * 2 - 1) * ranges[None]
            if self.world.dim_c != 0 and not agent.silent:
                comm = torch.rand((B, self.world.dim_c), generator=gen, device=dev)
                u = torch.cat([u, comm], dim=-1)
            return u
        nvec = self.discrete_action_nvec(agent)
        if self.multidiscrete_actions:
            cols = [torch.randint(0, n, (B,), generator=gen, device=dev) for n in nvec]
            return torch.stack(cols, dim=-1)
        return torch.randint(0, math.prod(nvec), (B,), generator=gen, device=dev)

    def get_random_actions(self):
        return [self.get_random_action(agent) for agent in self.agents]

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _normalize_actions(self, actions):
        if isinstance(actions, dict):
            missing = [a.name for a in self.agents if a.name not in actions]
            if missing:
                raise AssertionError(f"Agent '{missing[0]}' not contained in action dict")
            actions = [actions[a.name] for a in self.agents]
        assert len(actions) == self.n_agents, (
            f"Expecting actions for {self.n_agents}, got {len(actions)} actions"
        )
        out = []
        for i, a in enumerate(actions):
            a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=self.device)
            if a.ndim == 1:
                a = a[:, None]
            assert a.shape[0] == self.num_envs, (
                f"Actions used in input of env must be of len {self.num_envs}, got {a.shape[0]}"
            )
            assert a.shape[1] == self.get_agent_action_size(self.agents[i]), (
                f"Action for agent {self.agents[i].name} has shape {a.shape[1]}, "
                f"but should have shape {self.get_agent_action_size(self.agents[i])}"
            )
            out.append(a)
        return out

    def _maybe_dict(self, vals, dict_agent_names=None):
        if self.dict_spaces if dict_agent_names is None else dict_agent_names:
            return {a.name: v for a, v in zip(self.agents, vals)}
        return list(vals)

    def _pack_result(self, obs, rews, terminated, truncated, infos,
                     ret_obs, ret_rews, ret_info, ret_dones):
        result = []
        if ret_obs:
            result.append(self._maybe_dict(obs))
        if ret_rews and rews is not None:
            result.append(self._maybe_dict(rews))
        if ret_dones:
            if self.terminated_truncated:
                result.append(terminated)
                result.append(truncated)
            else:
                result.append(terminated | truncated if self.max_steps is not None else terminated)
        if ret_info:
            result.append(self._maybe_dict(infos))
        if len(result) == 1:
            return result[0]
        return result
