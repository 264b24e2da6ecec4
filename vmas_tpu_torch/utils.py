"""Scenario utilities.

Counterpart of vmas_tpu/utils.py (ScenarioUtils). The rejection-sampling
spawn loop resamples only the envs that still overlap, and gives up after
``MAX_SPAWN_TRIES`` rounds, as the JAX package does. Its draws come from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from vmas_tpu_torch.core.state import WorldState

MAX_SPAWN_TRIES = 50_000


class ScenarioUtils:
    @staticmethod
    def find_random_pos_for_entity(
        occupied_positions: torch.Tensor,  # [B, N, 2]
        generator: torch.Generator,
        world,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
    ):
        """[B, 1, 2] positions clear of all occupied positions."""
        B = occupied_positions.shape[0]
        device = occupied_positions.device

        def sample():
            u = torch.rand((B, 1, 2), generator=generator, device=device)
            x = u[..., 0] * (x_bounds[1] - x_bounds[0]) + x_bounds[0]
            y = u[..., 1] * (y_bounds[1] - y_bounds[0]) + y_bounds[0]
            return torch.stack([x, y], dim=-1)

        pos = sample()
        if occupied_positions.shape[1] == 0:
            return pos

        def overlapping(p):
            dist = torch.linalg.vector_norm(occupied_positions - p, dim=-1)  # [B, N]
            return torch.any(dist < min_dist_between_entities, dim=-1)  # [B]

        tries = 0
        bad = overlapping(pos)
        while tries < MAX_SPAWN_TRIES and bool(bad.any()):
            pos = torch.where(bad[:, None, None], sample(), pos)
            bad = overlapping(pos)
            tries += 1
        return pos

    @staticmethod
    def spawn_entities_randomly(
        entities,
        world,
        state: WorldState,
        generator: torch.Generator,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
        occupied_positions: torch.Tensor = None,
    ) -> WorldState:
        """Sequential rejection-sampling spawn: each entity lands clear of
        the occupied positions and of the entities placed before it."""
        B = state.batch_dim
        if occupied_positions is None:
            occupied_positions = torch.zeros((B, 0, world.dim_p), dtype=torch.float32, device=state.device)

        for entity in entities:
            pos = ScenarioUtils.find_random_pos_for_entity(
                occupied_positions, generator, world, min_dist_between_entities, x_bounds, y_bounds
            )
            occupied_positions = torch.cat([occupied_positions, pos], dim=1)
            state = entity.set_pos(state, pos[:, 0])
        return state

    @staticmethod
    def check_kwargs_consumed(dictionary_of_kwargs: dict, warn: bool = True):
        if len(dictionary_of_kwargs) > 0:
            message = f"Scenario kwargs: {dictionary_of_kwargs} passed but not used by the scenario."
            if warn:
                warnings.warn(message + " This will turn into an error in future versions.")
            else:
                raise ValueError(message)
