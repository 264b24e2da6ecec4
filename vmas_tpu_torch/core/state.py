"""The world state: one struct of ``[B, E, ...]`` tensors.

Counterpart of vmas_tpu/core/state.py. The flax pytree becomes a plain
dataclass; ``replace`` returns a new state that shares the unchanged
tensors. Partial reset is ``blend`` with a ``[B]`` boolean mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass
class WorldState:
    pos: torch.Tensor  # [B, E, 2]
    vel: torch.Tensor  # [B, E, 2]
    rot: torch.Tensor  # [B, E]
    ang_vel: torch.Tensor  # [B, E]
    # persistent per-entity action force/torque; only agent rows are written
    force: torch.Tensor  # [B, E, 2]
    torque: torch.Tensor  # [B, E]
    c: torch.Tensor  # [B, A, dim_c] (dim_c may be 0)
    u: Tuple[torch.Tensor, ...]  # per-agent [B, action_size_i]
    uc: torch.Tensor  # [B, A, dim_c] comm actions
    dyn: Tuple[Any, ...]  # per-agent dynamics hidden state
    joint_fixed_rot: torch.Tensor  # [B, J]
    rendering: torch.Tensor  # [B, E] bool
    scenario: Dict[str, Any]  # scenario scratch
    dyn_gravity: Any = None  # [B, E, 2] when the world has dynamic gravity

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)

    @property
    def batch_dim(self) -> int:
        return self.pos.shape[0]

    @property
    def n_entities(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device


def _blend_value(mask, new, old):
    if isinstance(new, dict):
        return {k: _blend_value(mask, v, old[k]) if k in old else v for k, v in new.items()}
    if isinstance(new, tuple):
        return tuple(_blend_value(mask, n, o) for n, o in zip(new, old))
    if not isinstance(new, torch.Tensor):
        return new
    # leaves without a leading env axis cannot be masked per env: the fresh
    # value wins
    if new.ndim == 0 or new.shape[0] != mask.shape[0]:
        return new
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def blend(mask: torch.Tensor, new_state: WorldState, old_state: WorldState) -> WorldState:
    """Select ``new_state`` where ``mask`` ([B] bool) else ``old_state``,
    field by field and through the ``scenario`` dict."""
    return WorldState(
        **{
            f.name: _blend_value(mask, getattr(new_state, f.name), getattr(old_state, f.name))
            for f in dataclasses.fields(WorldState)
        }
    )
