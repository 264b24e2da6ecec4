"""Share of the traced updates' collections that replayed the captured
CUDA graph of their steps: 100 x the count of the program's span
``vmas.rows.replay`` over the count of ``vmas.ppo.collect`` in the traced
stretch. None where the program records no replay (a program whose
collection is not a graph)."""

from portbench import spans


def read(r):
    if r.get("kind") != "ppo":
        return None
    replay, collect = spans.summary_of("vmas.rows.replay"), spans.summary_of("vmas.ppo.collect")
    if replay is None or collect is None:
        return None
    return 100.0 * replay["count"] / collect["count"]
