"""Sensors.

Counterpart of vmas_tpu/sensors.py. ``measure`` is functional: it takes the
state and casts every ray of the sensor in one batched ``World.cast_rays``
(``[B, entities, rays]``), or one ray at a time (``vectorized=False``), the
form the batched one is held to.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Callable, Tuple, Union

import numpy as np
import torch

from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import Color


class Sensor(ABC):
    def __init__(self, world):
        self._world = world
        self._agent = None

    @property
    def agent(self):
        return self._agent

    @agent.setter
    def agent(self, agent):
        self._agent = agent

    @abstractmethod
    def measure(self, state: WorldState): ...

    def render(self, env_index: int = 0):
        return []


class Lidar(Sensor):
    """``n_rays`` rays from ``angle_start`` to ``angle_end`` in the agent's
    frame (over a full circle the end ray is left out, as it would repeat
    the first), each returning the distance to the nearest collidable that
    ``entity_filter`` admits, or ``max_range``. The viewer draws its ray fan
    in ``render_color`` while ``set_render`` leaves it on
    (``render/viewer.py``)."""

    def __init__(
        self,
        world,
        angle_start: float = 0.0,
        angle_end: float = 2 * math.pi,
        n_rays: int = 8,
        max_range: float = 1.0,
        entity_filter: Callable = lambda _: True,
        render_color: Union[Color, Tuple[float, float, float]] = Color.GRAY,
        alpha: float = 1.0,
        render: bool = True,
    ):
        super().__init__(world)
        if (angle_start - angle_end) % (2 * math.pi) < 1e-5:
            angles = np.linspace(angle_start, angle_end, n_rays + 1, dtype=np.float32)[:n_rays]
        else:
            angles = np.linspace(angle_start, angle_end, n_rays, dtype=np.float32)
        self._angles = angles  # [R] f32 on the host, put on the state's device at each measure
        self.max_range = max_range
        self._render = render
        self.entity_filter = entity_filter
        self._render_color = render_color
        self.alpha = alpha

    @property
    def render_color(self):
        if isinstance(self._render_color, Color):
            return self._render_color.value
        return self._render_color

    def set_render(self, render: bool):
        self._render = render

    def measure(self, state: WorldState, vectorized: bool = True):
        """[B, n_rays] hit distances; the rays turn with the agent's
        heading."""
        angles = torch.as_tensor(self._angles, device=state.device)[None, :] + self.agent.rot(state)[:, None]
        if vectorized:
            return self._world.cast_rays(state, self.agent, angles, self.max_range, self.entity_filter)
        return torch.stack([
            self._world.cast_ray(state, self.agent, angles[:, i], self.max_range, self.entity_filter)
            for i in range(angles.shape[1])
        ], dim=1)
