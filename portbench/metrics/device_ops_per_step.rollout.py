"""Device operations per env step of a rollout, counted in the trace of the
traced calls (kernels, copies and fills)."""


def read(r):
    if r.get("kind") != "rollout" or not r.get("steps") or "device_ops" not in r:
        return None
    return r["device_ops"] / r["steps"]
