"""Scenario utilities.

Counterpart of vmas_tpu/utils.py (ScenarioUtils, and the rendering helpers
``extract_nested_with_index`` and ``x_to_rgb_colormap``). The rejection-sampling
spawn loop resamples only the envs that still overlap, and gives up after
``MAX_SPAWN_TRIES`` rounds, as the JAX package does. Its draws come from the
caller's ``torch.Generator``. ``find_random_pos_for_entity_vectorized``
draws a batch of candidates at once and keeps the first clear one, with
no loop (the form for per-step hooks); its draw and its pick are separate
functions, so that the pick can be held to the JAX package's on the same
candidates.
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
    def random_candidates(
        batch_dim: int,
        generator: torch.Generator,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
        n_candidates: int = 8,
        device=None,
    ):
        """[B, K, 2] uniform positions within the bounds, K = ``n_candidates``."""
        u = torch.rand((batch_dim, n_candidates, 2), generator=generator, device=device)
        x = u[..., 0] * (x_bounds[1] - x_bounds[0]) + x_bounds[0]
        y = u[..., 1] * (y_bounds[1] - y_bounds[0]) + y_bounds[0]
        return torch.stack([x, y], dim=-1)

    @staticmethod
    def first_clear_candidate(occupied_positions: torch.Tensor, candidates: torch.Tensor,
                              min_dist_between_entities: float):
        """[B, 1, 2]: per env the first of the candidates [B, K, 2] at least
        ``min_dist_between_entities`` from every occupied position [B, N,
        2], or candidate 0 where none is (the JAX package's pick: an argmax
        over an all-False mask gives 0)."""
        if occupied_positions.shape[1] == 0:
            return candidates[:, :1]
        dist = torch.linalg.vector_norm(occupied_positions[:, None] - candidates[:, :, None], dim=-1)  # [B, K, N]
        ok = torch.all(dist >= min_dist_between_entities, dim=-1)  # [B, K]
        first = torch.argmax(ok.to(torch.int32), dim=-1)  # the first maximum
        return torch.gather(candidates, 1, first[:, None, None].expand(-1, 1, 2))

    @staticmethod
    def find_random_pos_for_entity_vectorized(
        occupied_positions: torch.Tensor,  # [B, N, 2]
        generator: torch.Generator,
        world,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
        n_candidates: int = 8,
    ):
        """[B, 1, 2] like ``find_random_pos_for_entity``, from
        ``n_candidates`` proposals drawn in one batch: the first clear one,
        else the first (the loop-free form for per-step hooks, such as
        discovery's covered-target respawn)."""
        cands = ScenarioUtils.random_candidates(occupied_positions.shape[0], generator, x_bounds, y_bounds,
                                                n_candidates, occupied_positions.device)
        return ScenarioUtils.first_clear_candidate(occupied_positions, cands, min_dist_between_entities)

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


def extract_nested_with_index(data, index: int):
    """Index a tensor or a (nested) dict of them at ``index`` along the
    leading (env) axis."""
    if isinstance(data, dict):
        return {key: extract_nested_with_index(value, index) for key, value in data.items()}
    return data[index]


def x_to_rgb_colormap(
    x,
    low: float = None,
    high: float = None,
    alpha: float = 1.0,
    cmap_name: str = "viridis",
    cmap_res: int = 10,
):
    """Map scalar field values (a host array) to RGBA rows through a
    ``cmap_res``-entry colormap with linear interpolation between adjacent
    entries. Host-side numpy, a rendering helper; matplotlib is imported
    here, not with the module.

    Returns ``[N, 4]`` float rows in [0, 1]."""
    import numpy as np
    from matplotlib import colormaps

    colormap = colormaps[cmap_name].resampled(cmap_res)(range(cmap_res))[:, :-1]
    x = np.asarray(x, dtype=np.float64)
    if low is None:
        low = np.min(x)
    if high is None:
        high = np.max(x)
    x = np.clip(x, low, high)
    if high - low > 1e-5:
        x = (x - low) / (high - low) * (cmap_res - 1)
    x_c0_idx = np.floor(x).astype(int)
    x_c1_idx = np.ceil(x).astype(int)
    x_c0 = colormap[x_c0_idx, :]
    x_c1 = colormap[x_c1_idx, :]
    t = x - x_c0_idx
    rgb = t[:, None] * x_c1 + (1 - t)[:, None] * x_c0
    return np.concatenate([rgb, alpha * np.ones((rgb.shape[0], 1))], axis=-1)
