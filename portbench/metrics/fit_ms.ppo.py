"""Milliseconds of one update's ``fit`` (its epochs of Adam steps), by CUDA
events around the call, mean over the split updates."""


def read(r):
    if r.get("kind") != "ppo" or "fit_s" not in r:
        return None
    return 1e3 * r["fit_s"]
