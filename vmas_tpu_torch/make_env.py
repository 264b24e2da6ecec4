"""Top-level environment factory (counterpart of vmas_tpu/make_env.py).
``device=None`` means the GPU. ``wrapper`` (a ``Wrapper`` or its name:
"gym", "gymnasium", "gymnasium_vec", "rllib") returns the environment
wrapped, built with ``wrapper_kwargs``."""

from __future__ import annotations

from typing import Optional, Union

from vmas_tpu_torch.environment import Environment, Wrapper
from vmas_tpu_torch.scenario import BaseScenario
from vmas_tpu_torch.scenarios import load as _load_scenario


def make_env(
    scenario: Union[str, BaseScenario],
    num_envs: int,
    device=None,
    continuous_actions: bool = True,
    wrapper: Optional[Union[Wrapper, str]] = None,
    max_steps: Optional[int] = None,
    seed: Optional[int] = None,
    dict_spaces: bool = False,
    multidiscrete_actions: bool = False,
    clamp_actions: bool = False,
    grad_enabled: bool = False,
    terminated_truncated: bool = False,
    fused_physics: bool = False,
    wrapper_kwargs: Optional[dict] = None,
    **kwargs,
):
    if isinstance(scenario, str):
        scenario = _load_scenario(scenario).Scenario()
    env = Environment(
        scenario,
        num_envs=num_envs,
        device=device,
        continuous_actions=continuous_actions,
        max_steps=max_steps,
        seed=seed,
        dict_spaces=dict_spaces,
        multidiscrete_actions=multidiscrete_actions,
        clamp_actions=clamp_actions,
        grad_enabled=grad_enabled,
        terminated_truncated=terminated_truncated,
        fused_physics=fused_physics,
        **kwargs,
    )

    if wrapper is not None and isinstance(wrapper, str):
        wrapper = Wrapper[wrapper.upper()]
    if wrapper_kwargs is None:
        wrapper_kwargs = {}
    return wrapper.get_env(env, **wrapper_kwargs) if wrapper is not None else env
