"""The whole rollout step's share of the card's peak: the steps of a stretch
of calls times the counted bound of a step, over the stretch's time (CUDA
events, the profiler off)."""


def read(r):
    if r.get("kind") != "rollout" or not r.get("stretch_s") or "k2_bound_s" not in r:
        return None
    return 100.0 * r["steps"] * r["k2_bound_s"] / r["stretch_s"]
