"""K2's share of its roofline in a rollout: its counted bound per launch (the
larger of operations over the f32 peak and bytes over the memory peak) over
its mean device time per launch, by kernel name in the trace."""


def read(r):
    if r.get("kind") != "rollout" or not r.get("k2_launches") or not r.get("k2_s"):
        return None
    return 100.0 * r["k2_bound_s"] / (r["k2_s"] / r["k2_launches"])
