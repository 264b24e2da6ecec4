"""Milliseconds of a rollout call's finale (``_finish_rows_rollout``: the
one ``unpack`` over the output rows and the final state) on the device's
clock: the program's span ``vmas.rows.finish``, median over the traced calls."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    return spans.device_median_ms("vmas.rows.finish")
