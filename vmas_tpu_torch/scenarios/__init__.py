"""Scenario registry. Only ``transport`` is ported so far; every other
scenario of the JAX package raises ``ValueError`` when loaded."""

from __future__ import annotations

import importlib

_PORTED = {"transport": "vmas_tpu_torch.scenarios.transport"}


def load(name: str):
    """Load a scenario module by name (``.py`` suffix accepted)."""
    if name.endswith(".py"):
        name = name[:-3]
    if name not in _PORTED:
        raise ValueError(
            f"Scenario {name!r} is not ported to vmas_tpu_torch yet. Available: {sorted(_PORTED)}"
        )
    return importlib.import_module(_PORTED[name])
