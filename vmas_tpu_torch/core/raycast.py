"""Vectorized ray casting for Lidar sensors.

Counterpart of vmas_tpu/core/raycast.py, in plain PyTorch: the JAX package
computes its raycast in XLA, outside any Pallas kernel, so there is no hand
kernel here either. The world's entities are grouped by shape when the cast
is called (from the static entity list and the filter); each group is one
``[B, N, R]`` computation, and the distances take the minimum over the
entities. The divisions that would meet a zero denominator are guarded
(``safe_div``, ``safe_norm``), so a gradient through a Lidar observation on
the plain path stays finite.
"""

from __future__ import annotations

import torch

from vmas_tpu_torch.core import geometry as G
from vmas_tpu_torch.core.shapes import Box, Line, Sphere
from vmas_tpu_torch.core.utils import TorchUtils, safe_div, safe_norm


def _dir(angle):
    """Unit vectors [..., 2] of the angles [...]."""
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def cast_rays_to_box(box_pos, box_rot, box_length, box_width, ray_origin, ray_direction, max_range):
    """Slab-method ray-box distances. ``box_*``: [B, N, ...]; ``ray_origin``:
    [B, 2]; ``ray_direction``: [B, R]. Returns [B, N, R] (``max_range`` where
    the ray misses)."""
    ro = ray_origin[:, None, None, :]
    rd = ray_direction[:, None, :]
    b_pos = box_pos[:, :, None, :]
    b_rot = box_rot[:, :, None]
    b_len = box_length[:, :, None]
    b_wid = box_width[:, :, None]

    pos_aabb = TorchUtils.rotate_vector(ro - b_pos, -b_rot)
    ray_dir_aabb = TorchUtils.rotate_vector(_dir(rd), -b_rot)
    inf = torch.tensor(float("inf"), device=box_pos.device)

    def slab(p, d, half):
        zero = d == 0.0
        inv = 1.0 / torch.where(zero, torch.ones_like(d), d)
        t1 = (-half - p) * inv
        t2 = (half - p) * inv
        tmin = torch.minimum(t1, t2)
        tmax = torch.maximum(t1, t2)
        inside = (p >= -half) & (p <= half)
        tmin = torch.where(zero, torch.where(inside, -inf, inf), tmin)
        tmax = torch.where(zero, torch.where(inside, inf, -inf), tmax)
        return tmin, tmax

    txmin, txmax = slab(pos_aabb[..., 0], ray_dir_aabb[..., 0], b_len / 2)
    tymin, tymax = slab(pos_aabb[..., 1], ray_dir_aabb[..., 1], b_wid / 2)
    tmin = torch.maximum(txmin, tymin)
    tmax = torch.minimum(txmax, tymax)

    collision = (tmax >= tmin) & (tmin > 0.0)
    t_hit = torch.where(collision, tmin, torch.zeros_like(tmin))
    intersect_aabb = t_hit[..., None] * ray_dir_aabb + pos_aabb
    intersect_world = TorchUtils.rotate_vector(intersect_aabb, b_rot) + b_pos
    dist = safe_norm(ro - intersect_world)
    return torch.where(collision, dist, torch.full_like(dist, max_range))


def cast_rays_to_sphere(sphere_pos, sphere_radius, ray_origin, ray_direction, max_range):
    """Ray-sphere distances, [B, N, R]."""
    ro = ray_origin[:, None, None, :]
    rd = ray_direction[:, None, :]
    s_pos = sphere_pos[:, :, None, :]
    s_rad = sphere_radius[:, :, None]

    ray_dir_world = _dir(rd)
    line_pos = ro + ray_dir_world * (max_range / 2)
    line_rot = rd.expand(line_pos.shape[:-1])
    closest = G.closest_point_line(
        line_pos, line_rot, torch.full_like(line_rot, max_range), s_pos, limit_to_line_length=False
    )

    d = s_pos - closest
    d_norm = safe_norm(d)
    ray_intersects = d_norm < s_rad
    a = s_rad**2 - d_norm**2
    m = torch.sqrt(torch.where(a > 0, a, torch.full_like(a, 1e-8)))

    u = s_pos - ro
    u1 = closest - ro
    sphere_is_in_front = torch.sum(u * ray_dir_world, dim=-1) > 0.0
    dist = safe_norm(u1) - m
    return torch.where(ray_intersects & sphere_is_in_front, dist, torch.full_like(dist, max_range))


def cast_rays_to_line(line_pos, line_rot, line_length, ray_origin, ray_direction, max_range):
    """Ray-segment distances, [B, N, R]."""
    ro = ray_origin[:, None, None, :]
    rd = ray_direction[:, None, :]
    l_pos = line_pos[:, :, None, :]
    l_rot = line_rot[:, :, None]
    l_len = line_length[:, :, None]

    r = _dir(l_rot) * l_len[..., None]
    s = _dir(rd)
    s = s.expand(r.shape[:2] + s.shape[2:])

    rxs = TorchUtils.cross(r, s)
    qp = ro - l_pos
    t = safe_div(TorchUtils.cross(qp, s), rxs)
    u = safe_div(TorchUtils.cross(qp, r), rxs)
    d = torch.abs(u)  # |u * s|, |s| being 1

    no_hit = (rxs == 0.0) | (t > 0.5) | (t < -0.5) | (u < 0.0)
    return torch.where(no_hit, torch.full_like(d, max_range), d)


def cast_rays(world, state, entity, angles, max_range, entity_filter=lambda _: False):
    """Distances [B, R] along the world-frame ray directions ``angles``
    [B, R] from ``entity`` to the nearest collidable that ``entity_filter``
    admits, ``max_range`` where none is hit."""
    pos = entity.pos(state)
    B = pos.shape[0]
    dev = pos.device
    dists = [torch.full_like(angles, max_range)[..., None]]  # [B, R, 1]

    boxes, spheres, lines = [], [], []
    for e in world.entities:
        if e is entity or not entity_filter(e):
            continue
        assert e.collides(entity) and entity.collides(e), "Rays are only casted among collidables"
        if isinstance(e.shape, Box):
            boxes.append(e)
        elif isinstance(e.shape, Sphere):
            spheres.append(e)
        elif isinstance(e.shape, Line):
            lines.append(e)
        else:
            raise RuntimeError(f"Shape {e.shape} currently not handled by cast_ray")

    def consts(ents, attr):
        return torch.tensor([getattr(e.shape, attr) for e in ents], dtype=torch.float32, device=dev)[None].expand(
            B, len(ents))

    if boxes:
        idx = [e.index for e in boxes]
        d = cast_rays_to_box(state.pos[:, idx], state.rot[:, idx], consts(boxes, "length"), consts(boxes, "width"),
                             pos, angles, max_range)
        dists.append(d.movedim(1, -1))  # [B, R, N]
    if spheres:
        idx = [e.index for e in spheres]
        d = cast_rays_to_sphere(state.pos[:, idx], consts(spheres, "radius"), pos, angles, max_range)
        dists.append(d.movedim(1, -1))
    if lines:
        idx = [e.index for e in lines]
        d = cast_rays_to_line(state.pos[:, idx], state.rot[:, idx], consts(lines, "length"), pos, angles, max_range)
        dists.append(d.movedim(1, -1))

    return torch.cat(dists, dim=-1).min(dim=-1).values  # [B, R]


def cast_ray(world, state, entity, angles, max_range, entity_filter=lambda _: False):
    """One ray per env, ``angles`` [B]: :func:`cast_rays` with one ray, the
    per-ray form the vectorized Lidar is held to."""
    return cast_rays(world, state, entity, angles[:, None], max_range, entity_filter)[:, 0]
