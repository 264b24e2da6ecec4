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

_PORTED = {
    "asym_joint": "vmas_tpu_torch.scenarios.debug.asym_joint",
    "balance": "vmas_tpu_torch.scenarios.balance",
    "ball_passage": "vmas_tpu_torch.scenarios.ball_passage",
    "ball_trajectory": "vmas_tpu_torch.scenarios.ball_trajectory",
    "buzz_wire": "vmas_tpu_torch.scenarios.buzz_wire",
    "circle_trajectory": "vmas_tpu_torch.scenarios.debug.circle_trajectory",
    "construction": "vmas_tpu_torch.scenarios.construction",
    "diff_drive": "vmas_tpu_torch.scenarios.debug.diff_drive",
    "discovery": "vmas_tpu_torch.scenarios.discovery",
    "dispersion": "vmas_tpu_torch.scenarios.dispersion",
    "drone": "vmas_tpu_torch.scenarios.debug.drone",
    "dropout": "vmas_tpu_torch.scenarios.dropout",
    "flocking": "vmas_tpu_torch.scenarios.flocking",
    "football": "vmas_tpu_torch.scenarios.football",
    "give_way": "vmas_tpu_torch.scenarios.give_way",
    "goal": "vmas_tpu_torch.scenarios.debug.goal",
    "het_mass": "vmas_tpu_torch.scenarios.debug.het_mass",
    "joint_passage": "vmas_tpu_torch.scenarios.joint_passage",
    "joint_passage_size": "vmas_tpu_torch.scenarios.joint_passage_size",
    "kinematic_bicycle": "vmas_tpu_torch.scenarios.debug.kinematic_bicycle",
    "line_trajectory": "vmas_tpu_torch.scenarios.debug.line_trajectory",
    "multi_give_way": "vmas_tpu_torch.scenarios.multi_give_way",
    "navigation": "vmas_tpu_torch.scenarios.navigation",
    "painting": "vmas_tpu_torch.scenarios.painting",
    "passage": "vmas_tpu_torch.scenarios.passage",
    "pollock": "vmas_tpu_torch.scenarios.debug.pollock",
    "reverse_transport": "vmas_tpu_torch.scenarios.reverse_transport",
    "road_traffic": "vmas_tpu_torch.scenarios.road_traffic",
    "sampling": "vmas_tpu_torch.scenarios.sampling",
    "simple": "vmas_tpu_torch.scenarios.mpe.simple",
    "simple_adversary": "vmas_tpu_torch.scenarios.mpe.simple_adversary",
    "simple_crypto": "vmas_tpu_torch.scenarios.mpe.simple_crypto",
    "simple_push": "vmas_tpu_torch.scenarios.mpe.simple_push",
    "simple_reference": "vmas_tpu_torch.scenarios.mpe.simple_reference",
    "simple_speaker_listener": "vmas_tpu_torch.scenarios.mpe.simple_speaker_listener",
    "simple_spread": "vmas_tpu_torch.scenarios.mpe.simple_spread",
    "simple_tag": "vmas_tpu_torch.scenarios.mpe.simple_tag",
    "simple_world_comm": "vmas_tpu_torch.scenarios.mpe.simple_world_comm",
    "transport": "vmas_tpu_torch.scenarios.transport",
    "vel_control": "vmas_tpu_torch.scenarios.debug.vel_control",
    "waterfall": "vmas_tpu_torch.scenarios.debug.waterfall",
    "wheel": "vmas_tpu_torch.scenarios.wheel",
    "wind_flocking": "vmas_tpu_torch.scenarios.wind_flocking",
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
