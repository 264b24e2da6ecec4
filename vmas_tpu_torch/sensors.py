"""Sensors.

Counterpart of vmas_tpu/sensors.py. ``measure`` is functional: it takes the
state and casts every ray of the sensor in one batched ``World.cast_rays``
(``[B, entities, rays]``), or one ray at a time (``vectorized=False``), the
form the batched one is held to.

A Lidar's measure is the span ``vmas.sensors.lidar`` (on the device's
clock) with the counters ``vmas.sensors.lidar.casts`` (B: one sensing
agent's env-steps), ``.rays`` (B x rays) and, by the shape tested,
``.tests.sphere``, ``.tests.box`` and ``.tests.line`` (the rays times the
entities of that shape the filter admits: the ray-entity tests the cast
makes), worked out from shapes (``profiling.span``, ``profiling.count``).
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Callable, Tuple, Union

import numpy as np
import torch

from vmas_tpu_torch import profiling
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
        self._angles = angles  # [R] f32 on the host
        self._device_angles = {}  # the same on each device measured on, copied once
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
        with profiling.span("vmas.sensors.lidar", device=state.device):
            angles = self._angles_on(state.device)[None, :] + self.agent.rot(state)[:, None]
            if profiling.recording():
                self._count(angles.numel())
            if vectorized:
                return self._world.cast_rays(state, self.agent, angles, self.max_range, self.entity_filter)
            return torch.stack([
                self._world.cast_ray(state, self.agent, angles[:, i], self.max_range, self.entity_filter)
                for i in range(angles.shape[1])
            ], dim=1)

    def _angles_on(self, device) -> torch.Tensor:
        """The ray angles on ``device``, copied there once (a copy from the
        host's pageable memory waits for the device)."""
        key = str(device)
        t = self._device_angles.get(key)
        if t is None:
            t = self._device_angles[key] = torch.as_tensor(self._angles, device=device)
        return t

    def _count(self, rays: int) -> None:
        """The measure's counters: ``rays`` = B x n_rays, each tested
        against every entity the filter admits, counted by its shape (as
        ``core/raycast.py``'s cast groups them)."""
        targets = {}
        for e in self._world.entities:
            if e is not self.agent and self.entity_filter(e):
                shape = type(e.shape).__name__.lower()
                targets[shape] = targets.get(shape, 0) + 1
        profiling.count("vmas.sensors.lidar.casts", rays // len(self._angles))
        profiling.count("vmas.sensors.lidar.rays", rays)
        for shape, n in targets.items():
            profiling.count(f"vmas.sensors.lidar.tests.{shape}", rays * n)
