"""Milliseconds of a rollout call's Lidar on the device's clock: the
program's span ``vmas.sensors.lidar`` (one per sensing agent and chunk of
steps), summed over the traced calls, over the calls (``vmas.rows.call``'s
count)."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    lidar, calls = spans.summary_of("vmas.sensors.lidar"), spans.summary_of("vmas.rows.call")
    if not lidar or not lidar.get("device_ms") or not calls:
        return None
    return sum(lidar["device_ms"]) / calls["count"]
