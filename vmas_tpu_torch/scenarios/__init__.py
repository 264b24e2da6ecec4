"""Scenario registry. ``balance``, ``ball_passage``, ``ball_trajectory``,
``buzz_wire``, ``discovery``, ``dispersion``, ``dropout``, ``flocking``,
``football``, ``give_way``, ``joint_passage``, ``joint_passage_size``,
``multi_give_way``, ``navigation``, ``passage``, ``reverse_transport``,
``road_traffic``, ``transport``, ``wheel``, ``wind_flocking``, the MPE
family (``simple``, ``simple_adversary``, ``simple_crypto``,
``simple_push``, ``simple_reference``, ``simple_speaker_listener``,
``simple_spread``, ``simple_tag``, ``simple_world_comm``) and the debug
scenarios ``asym_joint``, ``het_mass``, ``pollock`` and ``waterfall`` are
ported so far; every other scenario of the JAX package raises
``ValueError`` when loaded."""

from __future__ import annotations

import importlib

_PORTED = {
    "asym_joint": "vmas_tpu_torch.scenarios.debug.asym_joint",
    "balance": "vmas_tpu_torch.scenarios.balance",
    "ball_passage": "vmas_tpu_torch.scenarios.ball_passage",
    "ball_trajectory": "vmas_tpu_torch.scenarios.ball_trajectory",
    "buzz_wire": "vmas_tpu_torch.scenarios.buzz_wire",
    "discovery": "vmas_tpu_torch.scenarios.discovery",
    "dispersion": "vmas_tpu_torch.scenarios.dispersion",
    "dropout": "vmas_tpu_torch.scenarios.dropout",
    "flocking": "vmas_tpu_torch.scenarios.flocking",
    "football": "vmas_tpu_torch.scenarios.football",
    "give_way": "vmas_tpu_torch.scenarios.give_way",
    "het_mass": "vmas_tpu_torch.scenarios.debug.het_mass",
    "joint_passage": "vmas_tpu_torch.scenarios.joint_passage",
    "joint_passage_size": "vmas_tpu_torch.scenarios.joint_passage_size",
    "multi_give_way": "vmas_tpu_torch.scenarios.multi_give_way",
    "navigation": "vmas_tpu_torch.scenarios.navigation",
    "passage": "vmas_tpu_torch.scenarios.passage",
    "pollock": "vmas_tpu_torch.scenarios.debug.pollock",
    "reverse_transport": "vmas_tpu_torch.scenarios.reverse_transport",
    "road_traffic": "vmas_tpu_torch.scenarios.road_traffic",
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
            f"Scenario {name!r} is not ported to vmas_tpu_torch yet. Available: {sorted(_PORTED)}"
        )
    return importlib.import_module(_PORTED[name])
