"""Batched closest-point geometry.

Counterpart of vmas_tpu/core/geometry.py: the five closest-point families
over arbitrary leading batch dims, rotations trailing-scalar, divisions
guarded so autograd never sees ``0 * inf``. Ties go to the first candidate
of minimal distance (``torch.argmin`` returns the first minimum).
"""

from __future__ import annotations

import math

import torch

from vmas_tpu_torch.core.utils import TorchUtils, safe_div, safe_norm


def _pick_closest(candidates_1, candidates_2):
    """Per batch lane, the (p1, p2) pair of ``[K, ..., 2]`` stacks with
    minimal |p1 - p2|; the first minimum wins ties."""
    d = safe_norm(candidates_1 - candidates_2)  # [K, ...]
    idx = torch.argmin(d, dim=0)  # [...]
    idx_e = idx[None, ..., None].expand((1,) + candidates_1.shape[1:])
    p1 = torch.gather(candidates_1, 0, idx_e)[0]
    p2 = torch.gather(candidates_2, 0, idx_e)[0]
    return p1, p2


def closest_point_line(line_pos, line_rot, line_length, test_point_pos, limit_to_line_length: bool = True):
    """Closest point on a segment to a point."""
    d = torch.stack([torch.cos(line_rot), torch.sin(line_rot)], dim=-1)
    delta_pos = line_pos - test_point_pos
    dot_p = torch.sum(delta_pos * d, dim=-1)
    sign = torch.sign(dot_p)
    dist_from_center = torch.abs(dot_p)
    if limit_to_line_length:
        dist_from_center = torch.minimum(dist_from_center, line_length / 2)
    return line_pos - (sign * dist_from_center)[..., None] * d


def line_extrema(line_pos, line_rot, line_length):
    """Both endpoints of a segment."""
    half = (line_length / 2)[..., None]
    xy = torch.stack([torch.cos(line_rot), torch.sin(line_rot)], dim=-1) * half
    return line_pos + xy, line_pos - xy


def intersection_point_line_line(point_a1, point_a2, point_b1, point_b2):
    """Segment-segment intersection: (point, intersects); the point is +inf
    where the segments do not intersect."""
    r = point_a2 - point_a1
    s = point_b2 - point_b1
    p = point_a1
    q = point_b1
    cross_qp_r = TorchUtils.cross(q - p, r)
    cross_qp_s = TorchUtils.cross(q - p, s)
    cross_r_s = TorchUtils.cross(r, s)
    u = safe_div(cross_qp_r, cross_r_s)
    t = safe_div(cross_qp_s, cross_r_s)
    parallel = cross_r_s == 0.0
    cond = (~parallel) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    point = torch.where(cond[..., None], p + t[..., None] * r, torch.full_like(r, math.inf))
    return point, cond


def closest_points_line_line(line_pos, line_rot, line_length, line2_pos, line2_rot, line2_length):
    """Closest point pair between two segments."""
    a1, a2 = line_extrema(line_pos, line_rot, line_length)
    b1, b2 = line_extrema(line2_pos, line2_rot, line2_length)

    point_i, intersects = intersection_point_line_line(a1, a2, b1, b2)

    a1_on_b = closest_point_line(line2_pos, line2_rot, line2_length, a1)
    a2_on_b = closest_point_line(line2_pos, line2_rot, line2_length, a2)
    b1_on_a = closest_point_line(line_pos, line_rot, line_length, b1)
    b2_on_a = closest_point_line(line_pos, line_rot, line_length, b2)

    cand1 = torch.stack([a1, a2, b1_on_a, b2_on_a], dim=0)
    cand2 = torch.stack([a1_on_b, a2_on_b, b1, b2], dim=0)
    p1, p2 = _pick_closest(cand1, cand2)

    cond = intersects[..., None]
    return torch.where(cond, point_i, p1), torch.where(cond, point_i, p2)


def all_lines_box(box_pos, box_rot, box_width, box_length):
    """The 4 edge segments of a box as (pos, rot, length), each with a
    leading axis of 4 in the order +length side, -length side, +width side,
    -width side."""
    v_len = torch.stack([torch.cos(box_rot), torch.sin(box_rot)], dim=-1)
    rot2 = box_rot + math.pi / 2
    v_wid = torch.stack([torch.cos(rot2), torch.sin(rot2)], dim=-1)

    half_l = (box_length / 2)[..., None]
    half_w = (box_width / 2)[..., None]

    p1 = box_pos + v_len * half_l
    p2 = box_pos - v_len * half_l
    p3 = box_pos + v_wid * half_w
    p4 = box_pos - v_wid * half_w

    pos = torch.stack([p1, p2, p3, p4], dim=0)
    rot = torch.stack([rot2, rot2, box_rot, box_rot], dim=0)
    length = torch.stack([box_width, box_width, box_length, box_length], dim=0)
    return pos, rot, length


def closest_point_box(box_pos, box_rot, box_width, box_length, test_point_pos):
    """Closest point on a box's perimeter to a point."""
    lines_pos, lines_rot, lines_length = all_lines_box(box_pos, box_rot, box_width, box_length)
    pts = closest_point_line(lines_pos, lines_rot, lines_length, test_point_pos[None])
    tp = test_point_pos[None].expand(pts.shape)
    p, _ = _pick_closest(pts, tp)
    return p


def closest_line_box(box_pos, box_rot, box_width, box_length, line_pos, line_rot, line_length):
    """Closest pair between a box perimeter and a segment:
    (point_on_box, point_on_line)."""
    lines_pos, lines_rot, lines_length = all_lines_box(box_pos, box_rot, box_width, box_length)
    ps_box, ps_line = closest_points_line_line(
        lines_pos,
        lines_rot,
        lines_length,
        line_pos[None].expand(lines_pos.shape),
        line_rot[None].expand(lines_rot.shape),
        line_length[None].expand(lines_length.shape),
    )
    return _pick_closest(ps_box, ps_line)


def closest_box_box(box_pos, box_rot, box_width, box_length, box2_pos, box2_rot, box2_width, box2_length):
    """Closest pair between two box perimeters: 4 candidates from box1's
    edges against box2, then 4 from box2's edges against box1."""
    p_box2_a, p_box1_a = _box_vs_lines(
        box2_pos, box2_rot, box2_width, box2_length, box_pos, box_rot, box_width, box_length
    )
    p_box1_b, p_box2_b = _box_vs_lines(
        box_pos, box_rot, box_width, box_length, box2_pos, box2_rot, box2_width, box2_length
    )
    cand1 = torch.cat([p_box1_a, p_box1_b], dim=0)
    cand2 = torch.cat([p_box2_a, p_box2_b], dim=0)
    return _pick_closest(cand1, cand2)


def _box_vs_lines(box_pos, box_rot, box_width, box_length, other_pos, other_rot, other_width, other_length):
    """Closest pairs between ``box``'s perimeter and each of ``other``'s 4
    edges: ([4, ..., 2] points on box, [4, ..., 2] points on the edges)."""
    lines_pos, lines_rot, lines_length = all_lines_box(other_pos, other_rot, other_width, other_length)
    return closest_line_box(
        box_pos[None].expand(lines_pos.shape),
        box_rot[None].expand(lines_rot.shape),
        box_width[None].expand(lines_length.shape),
        box_length[None].expand(lines_length.shape),
        lines_pos,
        lines_rot,
        lines_length,
    )


def inner_point_box(outside_point, surface_point, box_pos):
    """Mirror point inside the box for non-hollow push-out:
    (inner_point, distance from the surface point to the inner point)."""
    v = surface_point - outside_point
    u = box_pos - surface_point
    v_norm = safe_norm(v)[..., None]
    x_magnitude = safe_div(torch.sum(v * u, dim=-1)[..., None], v_norm)
    x = safe_div(v, v_norm) * x_magnitude
    degenerate = v_norm == 0.0
    # the degenerate lane substitutes the SURFACE POINT for the offset
    # (inner = 2 * surface), as the JAX package does
    x = torch.where(degenerate, surface_point, x)
    x_magnitude = torch.where(degenerate, torch.zeros_like(x_magnitude), x_magnitude)
    return surface_point + x, torch.abs(x_magnitude[..., 0])
