"""The Lidar's share of its roofline in a rollout: the counted bound
(``lidar_counts.py``) of the casts, rays and ray-sphere tests the program
counted over the traced calls (``vmas.sensors.lidar.casts``, ``.rays``,
``.tests.sphere``), over the device seconds of its span
``vmas.sensors.lidar`` summed over the same calls. Nothing where the program
counted nothing, or counted a test of a shape without a count."""

from portbench import lidar_counts, spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    from vmas_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    lidar = spans.summary_of("vmas.sensors.lidar")
    if counters is None or not lidar or not lidar.get("device_ms"):
        return None
    bound_s = lidar_counts.counted_bound(counters())
    if bound_s is None:
        return None
    return 100.0 * bound_s / (sum(lidar["device_ms"]) / 1e3)
