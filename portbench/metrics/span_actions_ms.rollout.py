"""Host milliseconds of a rollout call's actions (the generators' fork, the
random actions, their decode and the action rows, up to the first launch):
the program's span ``vmas.rows.actions``, median over the traced calls."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    return spans.host_median_ms("vmas.rows.actions")
