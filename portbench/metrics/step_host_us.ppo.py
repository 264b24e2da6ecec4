"""Host microseconds of one step of the PPO collection's loop (the
policy, the decode, the launch, the step's observations): the program's
span ``vmas.rows.policy_step``, median over the traced updates' steps."""

from portbench import spans


def read(r):
    if r.get("kind") != "ppo":
        return None
    ms = spans.host_median_ms("vmas.rows.policy_step")
    return None if ms is None else 1e3 * ms
