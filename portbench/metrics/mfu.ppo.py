"""The whole PPO update's share of the card's peak: the horizon times K2's
counted bound plus the actor-critic's counted matmul FLOPs over the bf16
peak, over an update's time (CUDA events around the window's own ``update``
call, the profiler off)."""


def read(r):
    if r.get("kind") != "ppo" or not r.get("update_s") or "update_bound_s" not in r:
        return None
    return 100.0 * r["update_bound_s"] / r["update_s"]
