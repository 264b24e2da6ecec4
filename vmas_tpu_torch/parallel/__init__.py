from vmas_tpu_torch.parallel.mesh import distribute, env_mesh, shard_state
from vmas_tpu_torch.parallel.ppo import (
    ActorCritic,
    gaussian_logp,
    init_actor_critic,
    make_evaluate,
    make_gaussian_policy,
    make_ppo_update,
    obs_dim_of,
    policy_dist,
)
from vmas_tpu_torch.parallel.rollout import (
    rollout,
    rollout_fn,
    rows_policy_rollout_fn,
    rows_rollout_fn,
    rows_rollout_supported,
)

__all__ = [
    "env_mesh",
    "shard_state",
    "distribute",
    "ActorCritic",
    "gaussian_logp",
    "init_actor_critic",
    "make_evaluate",
    "make_gaussian_policy",
    "make_ppo_update",
    "obs_dim_of",
    "policy_dist",
    "rollout",
    "rollout_fn",
    "rows_policy_rollout_fn",
    "rows_rollout_fn",
    "rows_rollout_supported",
]
