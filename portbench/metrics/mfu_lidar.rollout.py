"""The whole rollout step's share of the card's peak where a Lidar runs in
it: the steps of a stretch of calls times (K2's counted bound a step plus the
Lidar's counted bound a step, ``lidar_counts.py``), over the stretch's time
(CUDA events, the profiler off), as ``mfu.rollout`` with the Lidar added. The
Lidar's bound a step is that of the work the program counted over the traced
calls (``vmas.sensors.lidar.*``) over the K2 launches those calls made
(``vmas.rows.launch``'s count, one step each in a rollout cell). Nothing
where the program counted no Lidar work."""

from portbench import lidar_counts, spans


def read(r):
    if r.get("kind") != "rollout" or not r.get("stretch_s") or "k2_bound_s" not in r:
        return None
    from vmas_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    launches = spans.summary_of("vmas.rows.launch")
    if counters is None or not launches:
        return None
    lidar_s = lidar_counts.counted_bound(counters())
    if lidar_s is None:
        return None
    return 100.0 * r["steps"] * (r["k2_bound_s"] + lidar_s / launches["count"]) / r["stretch_s"]
