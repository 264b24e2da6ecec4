"""RLlib-style vector-env wrapper.

Counterpart of vmas_tpu/environment/rllib.py: per-env observation lists,
the reward averaged over the agents with each agent's reward in the infos.
It subclasses ``ray.rllib.VectorEnv`` where ray is installed, and is a plain
class with the same methods (``vector_reset``, ``reset_at``,
``vector_step``, ``seed``, ``try_render_at``, ``get_sub_environments``)
where it is not; that class builds its spaces on first access, so that it
needs gymnasium only for them. Tensors become numpy arrays at the boundary,
copied off the GPU where the env lives there.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

import numpy as np
import torch

from vmas_tpu_torch.environment.environment import Environment

if importlib.util.find_spec("ray") is not None:
    from ray import rllib

    _Base = rllib.VectorEnv
    _HAS_RAY = True
else:
    _Base = object
    _HAS_RAY = False


class VectorEnvWrapper(_Base):
    def __init__(self, env: Environment):
        assert not env.terminated_truncated, (
            "Rllib wrapper is not compatible with termination and truncation flags. "
            "Please set `terminated_truncated=False` in the environment."
        )
        self._env = env
        if _HAS_RAY:
            super().__init__(
                observation_space=env.observation_space, action_space=env.action_space, num_envs=env.num_envs
            )
        else:
            self.num_envs = env.num_envs

    if not _HAS_RAY:
        # built on first access, as the gymnasium wrappers' are: only the
        # spaces need gymnasium

        @property
        def observation_space(self):
            return self._env.observation_space

        @property
        def action_space(self):
            return self._env.action_space

    @property
    def env(self):
        return self._env

    def vector_reset(self):
        obs = self._to_numpy(self._env.reset())
        return self._read_data(obs)[0]

    def reset_at(self, index: Optional[int] = None):
        assert index is not None
        obs = self._to_numpy(self._env.reset_at(index))
        return self._read_data(obs, env_index=index)[0]

    def vector_step(self, actions):
        actions = self._action_list_to_array(actions)
        obs, rews, dones, infos = self._to_numpy(list(self._env.step(actions)))
        obs, infos, rews = self._read_data(obs, infos, rews)
        return obs, rews, list(dones), infos

    def seed(self, seed=None):
        return self._env.seed(seed)

    def try_render_at(self, index: Optional[int] = None, mode="human", agent_index_focus: Optional[int] = None,
                      visualize_when_rgb: bool = False, **kwargs):
        if index is None:
            index = 0
        return self._env.render(mode=mode, env_index=index, agent_index_focus=agent_index_focus,
                                visualize_when_rgb=visualize_when_rgb, **kwargs)

    def get_sub_environments(self) -> List[Environment]:
        return [self._env]

    # -- conversion -------------------------------------------------------
    def _to_numpy(self, data):
        if isinstance(data, dict):
            return {k: self._to_numpy(v) for k, v in data.items()}
        if isinstance(data, (list, tuple)):
            return [self._to_numpy(v) for v in data]
        if isinstance(data, torch.Tensor):
            return data.detach().cpu().numpy()
        return np.asarray(data)

    def _action_list_to_array(self, list_in: List) -> List[torch.Tensor]:
        """Per-env lists of per-agent actions -> per agent a ``[num_envs,
        action_size]`` tensor on the env's device."""
        if len(list_in) == self.num_envs:
            actions = [
                np.zeros((self.num_envs, self._env.get_agent_action_size(a)), np.float32) for a in self._env.agents
            ]
            for j in range(self.num_envs):
                assert len(list_in[j]) == self._env.n_agents, (
                    f"Expecting actions for {self._env.n_agents} agents, got {len(list_in[j])} actions"
                )
                for i in range(self._env.n_agents):
                    act = self._to_numpy(list_in[j][i]).astype(np.float32)
                    if act.ndim == 0:
                        assert self._env.get_agent_action_size(self._env.agents[i]) == 1
                        act = act[None]
                    actions[i][j] = act
            return [torch.as_tensor(a, device=self._env.device) for a in actions]
        raise TypeError("Input action is not in correct format")

    def _read_data(self, obs, info=None, reward=None, env_index: Optional[int] = None):
        if env_index is None:
            obs_list, info_list, rew_list = [], [], []
            for i in range(self.num_envs):
                o, inf, r = self._get_data_at_env_index(i, obs, info, reward)
                obs_list.append(o)
                if info:
                    info_list.append(inf)
                if reward:
                    rew_list.append(r)
            return obs_list, info_list if info else None, rew_list if reward else None
        return self._get_data_at_env_index(env_index, obs, info, reward)

    def _get_data_at_env_index(self, env_index, obs, info=None, reward=None):
        total_rew = 0.0
        new_info = {"rewards": {}} if info else None
        if isinstance(obs, Dict):
            new_obs = {}
            for agent_index, agent in enumerate(self._env.agents):
                new_obs[agent.name] = self._agent_data_at(env_index, obs[agent.name])
                if info:
                    new_info[agent.name] = self._agent_data_at(env_index, info[agent.name])
                if reward:
                    r = self._agent_data_at(env_index, reward[agent.name])
                    new_info["rewards"][agent_index] = r
                    total_rew += r
        else:
            new_obs = []
            for agent_index, agent in enumerate(self._env.agents):
                new_obs.append(self._agent_data_at(env_index, obs[agent_index]))
                if info:
                    new_info[agent.name] = self._agent_data_at(env_index, info[agent_index])
                if reward:
                    r = self._agent_data_at(env_index, reward[agent_index])
                    new_info["rewards"][agent_index] = r
                    total_rew += r
        return new_obs, new_info if info else None, total_rew / self._env.n_agents if reward else None

    def _agent_data_at(self, env_index, agent_data):
        if isinstance(agent_data, Dict):
            return {k: self._agent_data_at(env_index, v) for k, v in agent_data.items()}
        agent_data = np.asarray(agent_data)
        assert agent_data.shape[0] == self._env.num_envs
        if agent_data.ndim == 1 or (agent_data.ndim == 2 and agent_data.shape[1] == 1):
            return agent_data[env_index].item()
        return agent_data[env_index]
