"""Distance and overlap queries used by scenario rewards and dones.

Counterpart of vmas_tpu/core/queries.py.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import geometry as G
from vmas_tpu_torch.core.shapes import Box, Line, Sphere
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, safe_norm


def _full(state, value):
    return torch.full((state.pos.shape[0],), value, dtype=torch.float32, device=state.pos.device)


def get_distance_from_point(world, state, entity, test_point_pos):
    """Distance from an entity's surface to a point. Returns [B]."""
    pos = entity.pos(state)
    rot = entity.rot(state)
    shape = entity.shape
    if isinstance(shape, Sphere):
        return safe_norm(pos - test_point_pos) - shape.radius
    elif isinstance(shape, Box):
        closest = G.closest_point_box(
            pos, rot, _full(state, shape.width), _full(state, shape.length), test_point_pos
        )
        return safe_norm(test_point_pos - closest) - LINE_MIN_DIST
    elif isinstance(shape, Line):
        closest = G.closest_point_line(pos, rot, _full(state, shape.length), test_point_pos)
        return safe_norm(test_point_pos - closest) - LINE_MIN_DIST
    raise RuntimeError("Distance not computable for given entity")


def get_distance(world, state, entity_a, entity_b):
    """Surface distance between two entities. Returns [B]."""
    a_shape, b_shape = entity_a.shape, entity_b.shape

    if isinstance(a_shape, Sphere) and isinstance(b_shape, Sphere):
        return get_distance_from_point(world, state, entity_a, entity_b.pos(state)) - b_shape.radius
    elif {type(a_shape), type(b_shape)} == {Box, Sphere}:
        box, sphere = (entity_a, entity_b) if isinstance(b_shape, Sphere) else (entity_b, entity_a)
        dist = get_distance_from_point(world, state, box, sphere.pos(state))
        ret = dist - sphere.shape.radius
        # inside the box the distance is -1
        return torch.where(is_overlapping(world, state, entity_a, entity_b), torch.full_like(ret, -1.0), ret)
    elif {type(a_shape), type(b_shape)} == {Line, Sphere}:
        line, sphere = (entity_a, entity_b) if isinstance(b_shape, Sphere) else (entity_b, entity_a)
        dist = get_distance_from_point(world, state, line, sphere.pos(state))
        return dist - sphere.shape.radius
    elif isinstance(a_shape, Line) and isinstance(b_shape, Line):
        pa, pb = G.closest_points_line_line(
            entity_a.pos(state), entity_a.rot(state), _full(state, a_shape.length),
            entity_b.pos(state), entity_b.rot(state), _full(state, b_shape.length),
        )
        return safe_norm(pa - pb) - LINE_MIN_DIST
    elif {type(a_shape), type(b_shape)} == {Box, Line}:
        box, line = (entity_a, entity_b) if isinstance(b_shape, Line) else (entity_b, entity_a)
        p_box, p_line = G.closest_line_box(
            box.pos(state), box.rot(state),
            _full(state, box.shape.width), _full(state, box.shape.length),
            line.pos(state), line.rot(state), _full(state, line.shape.length),
        )
        return safe_norm(p_box - p_line) - LINE_MIN_DIST
    elif isinstance(a_shape, Box) and isinstance(b_shape, Box):
        pa, pb = G.closest_box_box(
            entity_a.pos(state), entity_a.rot(state),
            _full(state, a_shape.width), _full(state, a_shape.length),
            entity_b.pos(state), entity_b.rot(state),
            _full(state, b_shape.width), _full(state, b_shape.length),
        )
        return safe_norm(pa - pb) - LINE_MIN_DIST
    raise RuntimeError("Distance not computable for given entities")


def is_overlapping(world, state, entity_a, entity_b):
    """Whether two entities overlap. Returns [B] bool."""
    a_shape, b_shape = entity_a.shape, entity_b.shape
    if {type(a_shape), type(b_shape)} == {Box, Sphere}:
        box, sphere = (entity_a, entity_b) if isinstance(b_shape, Sphere) else (entity_b, entity_a)
        closest = G.closest_point_box(
            box.pos(state), box.rot(state),
            _full(state, box.shape.width), _full(state, box.shape.length),
            sphere.pos(state),
        )
        d_sphere_closest = safe_norm(sphere.pos(state) - closest)
        d_sphere_box = safe_norm(sphere.pos(state) - box.pos(state))
        d_closest_box = safe_norm(box.pos(state) - closest)
        dist_min = sphere.shape.radius + LINE_MIN_DIST
        return (d_sphere_box < d_closest_box) | (d_sphere_closest < dist_min)
    return get_distance(world, state, entity_a, entity_b) < 0
