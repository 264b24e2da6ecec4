"""Milliseconds of one update's collection (``rows_policy_rollout_fn`` over
the horizon), by CUDA events around the call, mean over the split updates."""


def read(r):
    if r.get("kind") != "ppo" or "collect_s" not in r:
        return None
    return 1e3 * r["collect_s"]
