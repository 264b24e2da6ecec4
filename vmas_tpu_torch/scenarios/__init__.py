"""Scenario registry: every scenario name of the JAX package (43 of 43).
``balance``, ``ball_passage``, ``ball_trajectory``, ``buzz_wire``,
``construction``, ``discovery``, ``dispersion``, ``dropout``, ``flocking``,
``football``, ``give_way``, ``joint_passage``, ``joint_passage_size``,
``multi_give_way``, ``navigation``, ``painting``, ``passage``,
``reverse_transport``, ``road_traffic``, ``sampling``, ``transport``,
``wheel``, ``wind_flocking``, the MPE family (``simple``, ``simple_adversary``,
``simple_crypto``, ``simple_push``, ``simple_reference``, ``simple_speaker_listener``,
``simple_spread``, ``simple_tag``, ``simple_world_comm``) and the debug
scenarios ``asym_joint``, ``circle_trajectory``, ``diff_drive``, ``drone``,
``goal``, ``het_mass``, ``kinematic_bicycle``, ``line_trajectory``,
``pollock``, ``vel_control`` and ``waterfall``; any other name raises
``ValueError`` when loaded."""

from __future__ import annotations

import importlib

# the JAX package's three name lists, in its order (vmas_tpu/scenarios/__init__.py)
_MAIN = [
    "balance", "ball_passage", "ball_trajectory", "buzz_wire", "discovery",
    "dispersion", "dropout", "flocking", "football", "give_way",
    "joint_passage", "joint_passage_size", "multi_give_way", "navigation",
    "passage", "reverse_transport", "sampling", "transport", "wheel",
    "wind_flocking", "painting", "construction", "road_traffic",
]
_DEBUG = [
    "asym_joint", "circle_trajectory", "goal", "het_mass", "line_trajectory",
    "vel_control", "waterfall", "diff_drive", "kinematic_bicycle", "pollock",
    "drone",
]
_MPE = [
    "simple", "simple_adversary", "simple_crypto", "simple_push",
    "simple_reference", "simple_speaker_listener", "simple_spread",
    "simple_tag", "simple_world_comm",
]

_PORTED = {
    **{n: f"vmas_tpu_torch.scenarios.{n}" for n in _MAIN},
    **{n: f"vmas_tpu_torch.scenarios.debug.{n}" for n in _DEBUG},
    **{n: f"vmas_tpu_torch.scenarios.mpe.{n}" for n in _MPE},
}


def load(name: str):
    """Load a scenario module by name (``.py`` suffix accepted)."""
    if name.endswith(".py"):
        name = name[:-3]
    if name not in _PORTED:
        raise ValueError(
            f"Scenario {name!r} is not a scenario of vmas_tpu, so it is not ported to vmas_tpu_torch. "
            f"Available: {sorted(_PORTED)}"
        )
    return importlib.import_module(_PORTED[name])
