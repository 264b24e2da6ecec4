"""The yardstick of the Lidar's share: the least work a Lidar's measure
needs, counted from the counts the program records
(``vmas.sensors.lidar.casts``, ``.rays``, ``.tests.<shape>``) and the card's
published peaks (``counts.py``).

The operations are the fewest that VMAS's ray-sphere distance
(``_cast_ray_to_sphere``) takes, not the steps any one implementation makes:
with u the sphere's centre less the ray's origin and d the ray's unit
direction, t = u.d, the squared miss |u|^2 - t^2, the hit and in-front
tests, and the distance t - sqrt(r^2 - miss^2). +, -, *, /, sqrt and a
compare (min, a logical and) count 1; cos and sin count ``TRIG_OPS``; a
select counts nothing. Work shared by a sensing agent's rays (u and |u|^2,
once per sphere an env-step) counts once, where it belongs. Bytes count each
sensing agent's position and heading read once per env-step and each ray's
distance written once. Counted are ray-sphere tests alone: a Lidar that
tests boxes or lines has no count here, and :func:`sphere_tests` says so.
"""

from __future__ import annotations

from portbench.counts import TRIG_OPS, bound_seconds

# per ray-sphere test: t = u.d 3, the squared miss |u|^2 - t^2 2, r^2 less
# it 1, the hit test 1, the in-front test 1, their and 1, the sqrt 1, t
# less it 1, the minimum over the ray's tests (the range's included) 1
SPHERE_TEST_OPS = 3 + 2 + 1 + 1 + 1 + 1 + 1 + 1 + 1
# per sphere a sensing agent sees in an env-step: u 2, |u|^2 3
SPHERE_PAIR_OPS = 2 + 3
# per ray: its angle (fixed angle + heading) 1, cos and sin
RAY_OPS = 1 + 2 * TRIG_OPS
# per cast (a sensing agent's env-step): its x, y and heading, f32
CAST_BYTES = 3 * 4
# per ray: its distance, f32
RAY_BYTES = 4

_TESTS = "vmas.sensors.lidar.tests."


def sphere_tests(counters):
    """The ray-sphere tests among the program's counters, or None where it
    counted none or counted a test of another shape, which has no count."""
    tests = {k[len(_TESTS):]: n for k, n in counters.items() if k.startswith(_TESTS) and n}
    if set(tests) != {"sphere"}:
        return None
    return tests["sphere"]


def lidar_work(casts, rays, tests):
    """(operations, bytes) of ``casts`` sensing agents' env-steps casting
    ``rays`` rays that make ``tests`` ray-sphere tests."""
    pairs = tests * casts // rays  # each sphere once per cast, not per ray
    ops = tests * SPHERE_TEST_OPS + pairs * SPHERE_PAIR_OPS + rays * RAY_OPS
    return ops, casts * CAST_BYTES + rays * RAY_BYTES


def lidar_bound(casts, rays, tests):
    """The least time the card needs for that work -> (seconds, what binds),
    the larger of operations over the f32 peak and bytes over the memory
    peak."""
    ops, nbytes = lidar_work(casts, rays, tests)
    return bound_seconds(ops, nbytes)


def counted_bound(counters):
    """The bound of the Lidar work the program's counters hold -> seconds,
    or None where they hold none or a test this module does not count."""
    casts, rays = counters.get("vmas.sensors.lidar.casts"), counters.get("vmas.sensors.lidar.rays")
    tests = sphere_tests(counters)
    if not casts or not rays or tests is None:
        return None
    return lidar_bound(casts, rays, tests)[0]
