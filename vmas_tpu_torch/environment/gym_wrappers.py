"""Gym and gymnasium interop wrappers.

Counterpart of vmas_tpu/environment/gym_wrappers.py: tensors become numpy
arrays at the boundary (copied off the GPU where the env lives there), the
non-vectorized wrappers take env 0, and the infos are keyed by agent name.
``GymWrapper`` keeps the classic 4-tuple step without the old ``gym``
package. The gymnasium wrappers subclass ``gymnasium.Env`` where gymnasium
is installed, and a plain class where it is not; their spaces are built on
first access, and only those need gymnasium. Rendering is not ported yet.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

from vmas_tpu_torch.environment.environment import Environment

try:
    from gymnasium import Env as _GymnasiumEnv
except ImportError:
    class _GymnasiumEnv:
        """Stands in for ``gymnasium.Env`` where gymnasium is not installed."""

EnvData = namedtuple("EnvData", ["obs", "rews", "terminated", "truncated", "done", "info"])


def _to_numpy(data):
    if isinstance(data, dict):
        return {k: _to_numpy(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [_to_numpy(v) for v in data]
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _extract_index(data, index):
    if isinstance(data, dict):
        return {k: _extract_index(v, index) for k, v in data.items()}
    return data[index]


class BaseGymWrapper(ABC):
    """The conversions the three wrappers share."""

    def __init__(self, env: Environment, return_numpy: bool, vectorized: bool):
        self._env = env
        self.return_numpy = return_numpy
        self.dict_spaces = env.dict_spaces
        self.vectorized = vectorized

    @property
    def env(self):
        return self._env

    def _maybe_to_numpy(self, data):
        return _to_numpy(data) if self.return_numpy else data

    def _convert_output(self, data, item: bool = False):
        if not self.vectorized:
            data = _extract_index(data, 0)
            if item:
                return data.item() if hasattr(data, "item") else data
        return self._maybe_to_numpy(data)

    def _compress_infos(self, infos):
        if isinstance(infos, dict):
            return infos
        return {self._env.agents[i].name: info for i, info in enumerate(infos)}

    def _convert_env_data(self, obs=None, rews=None, info=None, terminated=None, truncated=None, done=None):
        keys = [a.name for a in self._env.agents] if self.dict_spaces else range(self._env.n_agents)
        for k in keys:
            if obs is not None:
                obs[k] = self._convert_output(obs[k])
            if info is not None:
                info[k] = self._convert_output(info[k])
            if rews is not None:
                rews[k] = self._convert_output(rews[k], item=True)
        terminated = self._convert_output(terminated, item=True) if terminated is not None else None
        truncated = self._convert_output(truncated, item=True) if truncated is not None else None
        done = self._convert_output(done, item=True) if done is not None else None
        info = self._compress_infos(info) if info is not None else None
        return EnvData(obs=obs, rews=rews, terminated=terminated, truncated=truncated, done=done, info=info)

    def _action_list_to_array(self, list_in) -> List[torch.Tensor]:
        """Per agent a ``[num_envs, action_size]`` tensor on the env's
        device, from a list in agent order or a dict keyed by agent name."""
        env = self._env
        if isinstance(list_in, dict):
            list_in = [list_in[a.name] for a in env.agents]
        assert len(list_in) == env.n_agents, (
            f"Expecting actions for {env.n_agents} agents, got {len(list_in)} actions"
        )
        dtype = torch.float32 if env.continuous_actions else torch.int64
        return [
            torch.as_tensor(np.asarray(act) if not isinstance(act, torch.Tensor) else act, device=env.device)
            .to(dtype).reshape(env.num_envs, env.get_agent_action_size(agent))
            for agent, act in zip(env.agents, list_in)
        ]

    @abstractmethod
    def step(self, action): ...

    @abstractmethod
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None): ...


class GymWrapper(BaseGymWrapper):
    """The classic single-env gym API: ``reset() -> obs``, ``step(action)
    -> (obs, rews, done, info)``."""

    metadata = Environment.metadata

    @property
    def unwrapped(self) -> Environment:
        return self._env

    def __init__(self, env: Environment, return_numpy: bool = True):
        super().__init__(env, return_numpy=return_numpy, vectorized=False)
        assert env.num_envs == 1, f"GymEnv wrapper is not vectorised, got env.num_envs: {env.num_envs}"
        assert not env.terminated_truncated, (
            "GymWrapper is not compatible with termination and truncation flags. "
            "Please set `terminated_truncated=False` in the environment."
        )

    @property
    def observation_space(self):
        return self._env.observation_space

    @property
    def action_space(self):
        return self._env.action_space

    def step(self, action):
        action = self._action_list_to_array(action)
        obs, rews, done, info = self._env.step(action)
        d = self._convert_env_data(obs=obs, rews=rews, info=info, done=done)
        return d.obs, d.rews, d.done, d.info

    def reset(self, *, seed: Optional[int] = None, return_info: bool = False, options: Optional[dict] = None):
        if seed is not None:
            self._env.seed(seed)
        obs = self._env.reset_at(index=0)
        return self._convert_env_data(obs=obs).obs


class GymnasiumWrapper(_GymnasiumEnv, BaseGymWrapper):
    """The gymnasium single-env API (``terminated_truncated=True``)."""

    metadata = Environment.metadata

    @property
    def unwrapped(self) -> Environment:
        return self._env

    def __init__(self, env: Environment, return_numpy: bool = True, render_mode: str = "human"):
        BaseGymWrapper.__init__(self, env, return_numpy=return_numpy, vectorized=False)
        assert env.num_envs == 1, (
            "GymnasiumEnv wrapper only supports singleton environments! "
            "For vectorized environments, use wrapper=gymnasium_vec."
        )
        assert env.terminated_truncated, "GymnasiumWrapper requires terminated_truncated=True in the environment."
        self.render_mode = render_mode

    @property
    def observation_space(self):
        return self._env.observation_space

    @property
    def action_space(self):
        return self._env.action_space

    def step(self, action):
        action = self._action_list_to_array(action)
        obs, rews, terminated, truncated, info = self._env.step(action)
        d = self._convert_env_data(obs=obs, rews=rews, info=info, terminated=terminated, truncated=truncated)
        return d.obs, d.rews, d.terminated, d.truncated, d.info

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._env.seed(seed)
        obs, info = self._env.reset_at(index=0, return_info=True)
        d = self._convert_env_data(obs=obs, info=info)
        return d.obs, d.info


class GymnasiumVectorizedWrapper(_GymnasiumEnv, BaseGymWrapper):
    """The gymnasium API over all envs at once (no auto-reset, as
    upstream's): each output keeps its leading ``num_envs`` axis."""

    metadata = Environment.metadata

    @property
    def unwrapped(self) -> Environment:
        return self._env

    def __init__(self, env: Environment, return_numpy: bool = True, render_mode: str = "human"):
        BaseGymWrapper.__init__(self, env, return_numpy=return_numpy, vectorized=True)
        assert env.terminated_truncated, (
            "GymnasiumVectorizedWrapper requires terminated_truncated=True in the environment."
        )
        self._num_envs = env.num_envs
        self.render_mode = render_mode

    @property
    def single_observation_space(self):
        return self._env.observation_space

    @property
    def single_action_space(self):
        return self._env.action_space

    @property
    def observation_space(self):
        from gymnasium.vector.utils import batch_space

        return batch_space(self.single_observation_space, n=self._num_envs)

    @property
    def action_space(self):
        from gymnasium.vector.utils import batch_space

        return batch_space(self.single_action_space, n=self._num_envs)

    def step(self, action):
        action = self._action_list_to_array(action)
        obs, rews, terminated, truncated, info = self._env.step(action)
        d = self._convert_env_data(obs=obs, rews=rews, info=info, terminated=terminated, truncated=truncated)
        return d.obs, d.rews, d.terminated, d.truncated, d.info

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._env.seed(seed)
        obs, info = self._env.reset(return_info=True)
        d = self._convert_env_data(obs=obs, info=info)
        return d.obs, d.info
