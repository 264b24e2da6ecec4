"""K2's share of its roofline in PPO's collection: its counted bound per
launch over its mean device time per launch, by kernel name in the trace."""


def read(r):
    if r.get("kind") != "ppo" or not r.get("k2_launches") or not r.get("k2_s"):
        return None
    return 100.0 * r["k2_bound_s"] / (r["k2_s"] / r["k2_launches"])
