"""Heuristic policies (counterpart of vmas_tpu/heuristic_policy.py): the
base classes, and ``rollout_policy``, which makes a rollout's policy of one
heuristic per agent."""

from vmas_tpu_torch.scenario import BaseHeuristicPolicy, RandomPolicy

__all__ = ["BaseHeuristicPolicy", "RandomPolicy", "rollout_policy"]


def rollout_policy(env, heuristic: BaseHeuristicPolicy):
    """``policy(obs_tuple, generator) -> actions_tuple`` for the rollouts
    (``rollout_fn``, ``rows_policy_rollout_fn``): ``heuristic``'s action for
    each policy agent on its observations, within the agent's u_range (its
    first dimension's, as the JAX package's tests drive the heuristics)."""
    u_ranges = [float(a.u_range_array[0]) for a in env.agents]

    def policy(obs, generator):
        return tuple(heuristic.compute_action(o, u) for o, u in zip(obs, u_ranges))

    return policy
