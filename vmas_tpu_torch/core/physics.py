"""The plain physics step, on ``[B, E, ...]`` tensors.

Counterpart of vmas_tpu/core/physics.py: the per-step pair bucketing is
hoisted to build time (:func:`build_spec`), each shape-pair type and the
joint table are one dense ``[B, P]`` computation followed by a
scatter-add, and the force accumulation order is the JAX package's:
action, friction, gravity, then the joint constraints, then the pair types
in spec order. It stays differentiable through autograd.

The port covers all six shape-pair contact types (sphere-sphere,
line-sphere, line-line, box-sphere, box-line, box-box) and joint
constraints (attractive and repulsive anchor forces, and the rotation
torque of ``rotate=False`` constraints).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from vmas_tpu_torch.core import geometry as G
from vmas_tpu_torch.core.shapes import Box, Line, Sphere
from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import LINE_MIN_DIST, TorchUtils, safe_norm


# ---------------------------------------------------------------------------
# build-time spec
# ---------------------------------------------------------------------------

def build_spec(world) -> SimpleNamespace:
    """Bake all static world structure into numpy arrays."""
    entities = world.entities
    E = len(entities)
    agents = world.agents

    def arr(fn, dtype=np.float32):
        return np.asarray([fn(e) for e in entities], dtype=dtype)

    spec = SimpleNamespace()
    spec.movable = arr(lambda e: e.movable, bool)
    spec.rotatable = arr(lambda e: e.rotatable, bool)
    spec.is_agent = np.asarray([isinstance(e, _agent_cls()) for e in entities], bool)
    spec.mass = arr(lambda e: e.mass)
    spec.inv_mass = 1.0 / spec.mass
    spec.moi = arr(lambda e: e.moment_of_inertia)
    # static entities may have a zero moment of inertia; they never rotate
    spec.inv_moi = np.where(spec.moi > 0, 1.0 / np.where(spec.moi > 0, spec.moi, 1.0), 0.0)
    spec.drag = arr(lambda e: world.drag if e.drag is None else e.drag)
    spec.lin_fric = arr(lambda e: world.linear_friction if e.linear_friction is None else e.linear_friction)
    spec.ang_fric = arr(lambda e: world.angular_friction if e.angular_friction is None else e.angular_friction)
    spec.has_lin_fric = bool((spec.lin_fric != 0).any())
    spec.has_ang_fric = bool((spec.ang_fric != 0).any())
    spec.ent_gravity = np.stack(
        [np.zeros(2, np.float32) if e.gravity is None else np.asarray(e.gravity, np.float32) for e in entities]
    )
    spec.has_ent_gravity = bool((spec.ent_gravity != 0).any())
    spec.has_world_gravity = bool(any(g != 0 for g in world.gravity))
    spec.max_speed = arr(lambda e: np.inf if e.max_speed is None else e.max_speed)
    spec.v_range = arr(lambda e: np.inf if e.v_range is None else e.v_range)
    spec.has_max_speed = bool(np.isfinite(spec.max_speed).any())
    spec.has_v_range = bool(np.isfinite(spec.v_range).any())

    # agent force/torque limits, padded over the entity axis
    inf = np.full(E, np.inf, np.float32)
    spec.max_f, spec.f_range, spec.max_t, spec.t_range = inf.copy(), inf.copy(), inf.copy(), inf.copy()
    for a in agents:
        if a.max_f is not None:
            spec.max_f[a.index] = a.max_f
        if a.f_range is not None:
            spec.f_range[a.index] = a.f_range
        if a.max_t is not None:
            spec.max_t[a.index] = a.max_t
        if a.t_range is not None:
            spec.t_range[a.index] = a.t_range
    spec.has_max_f = bool(np.isfinite(spec.max_f).any())
    spec.has_f_range = bool(np.isfinite(spec.f_range).any())
    spec.has_max_t = bool(np.isfinite(spec.max_t).any())
    spec.has_t_range = bool(np.isfinite(spec.t_range).any())

    spec.silent = np.asarray([a.silent for a in agents], bool)

    # ---- collision pair buckets and the joint table -------------------------
    # the joint table takes the order of this enumeration, not add_joint's;
    # a rigid (dist 0) constraint takes its pair out of collision
    ss, ls, ll, bs, bl, bb, joints = [], [], [], [], [], [], []
    for ai in range(E):
        for bi in range(ai + 1, E):
            ea, eb = entities[ai], entities[bi]
            constraint = world._constraints.get(frozenset({ea.name, eb.name}))
            if constraint is not None:
                joints.append(constraint)
                if constraint.dist == 0:
                    continue
            if not world.collides(ea, eb):
                continue
            sa, sb = ea.shape, eb.shape
            if isinstance(sa, Sphere) and isinstance(sb, Sphere):
                ss.append((ea, eb))
            elif {type(sa), type(sb)} == {Line, Sphere}:
                line, sphere = (ea, eb) if isinstance(sb, Sphere) else (eb, ea)
                ls.append((line, sphere))
            elif isinstance(sa, Line) and isinstance(sb, Line):
                ll.append((ea, eb))
            elif {type(sa), type(sb)} == {Box, Sphere}:
                box, sphere = (ea, eb) if isinstance(sb, Sphere) else (eb, ea)
                bs.append((box, sphere))
            elif {type(sa), type(sb)} == {Box, Line}:
                box, line = (ea, eb) if isinstance(sb, Line) else (eb, ea)
                bl.append((box, line))
            elif isinstance(sa, Box) and isinstance(sb, Box):
                bb.append((ea, eb))

    idx = lambda pairs, k: np.asarray([p[k].index for p in pairs], np.int64)
    prop = lambda pairs, k, f, dt=np.float32: np.asarray([f(p[k]) for p in pairs], dt)

    spec.ss_a, spec.ss_b = idx(ss, 0), idx(ss, 1)
    spec.ss_ra, spec.ss_rb = prop(ss, 0, lambda e: e.shape.radius), prop(ss, 1, lambda e: e.shape.radius)

    spec.ls_line, spec.ls_sphere = idx(ls, 0), idx(ls, 1)
    spec.ls_len = prop(ls, 0, lambda e: e.shape.length)
    spec.ls_rad = prop(ls, 1, lambda e: e.shape.radius)

    spec.ll_a, spec.ll_b = idx(ll, 0), idx(ll, 1)
    spec.ll_la, spec.ll_lb = prop(ll, 0, lambda e: e.shape.length), prop(ll, 1, lambda e: e.shape.length)

    spec.bs_box, spec.bs_sphere = idx(bs, 0), idx(bs, 1)
    spec.bs_len, spec.bs_wid = prop(bs, 0, lambda e: e.shape.length), prop(bs, 0, lambda e: e.shape.width)
    spec.bs_not_hollow = prop(bs, 0, lambda e: not e.shape.hollow, bool)
    spec.bs_rad = prop(bs, 1, lambda e: e.shape.radius)

    spec.bl_box, spec.bl_line = idx(bl, 0), idx(bl, 1)
    spec.bl_blen, spec.bl_bwid = prop(bl, 0, lambda e: e.shape.length), prop(bl, 0, lambda e: e.shape.width)
    spec.bl_not_hollow = prop(bl, 0, lambda e: not e.shape.hollow, bool)
    spec.bl_llen = prop(bl, 1, lambda e: e.shape.length)

    spec.bb_a, spec.bb_b = idx(bb, 0), idx(bb, 1)
    spec.bb_la, spec.bb_wa = prop(bb, 0, lambda e: e.shape.length), prop(bb, 0, lambda e: e.shape.width)
    spec.bb_nha = prop(bb, 0, lambda e: not e.shape.hollow, bool)
    spec.bb_lb, spec.bb_wb = prop(bb, 1, lambda e: e.shape.length), prop(bb, 1, lambda e: e.shape.width)
    spec.bb_nhb = prop(bb, 1, lambda e: not e.shape.hollow, bool)

    spec.joint_idx_a = np.asarray([c.entity_a.index for c in joints], np.int64)
    spec.joint_idx_b = np.asarray([c.entity_b.index for c in joints], np.int64)
    spec.joint_anchor_a = np.asarray(
        [c.entity_a.shape.get_delta_from_anchor(c.anchor_a) for c in joints], np.float32
    ).reshape(-1, 2)
    spec.joint_anchor_b = np.asarray(
        [c.entity_b.shape.get_delta_from_anchor(c.anchor_b) for c in joints], np.float32
    ).reshape(-1, 2)
    spec.joint_dist = np.asarray([c.dist for c in joints], np.float32)
    spec.joint_rotate = np.asarray([c.rotate for c in joints], bool)
    spec.joint_fixed_rot_init = np.asarray(
        [0.0 if c.fixed_rotation is None else c.fixed_rotation for c in joints], np.float32
    )
    for t, c in enumerate(joints):
        c.table_index = t
    return spec


def _agent_cls():
    from vmas_tpu_torch.core.world import Agent

    return Agent


def _dev(world):
    """The spec arrays the step reads, as tensors on the world's device
    (built once per world)."""
    spec = world.spec
    if getattr(spec, "dev", None) is None:
        d = world.device
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=d)
        spec.dev = SimpleNamespace(
            movable=t(spec.movable, torch.bool),
            rotatable=t(spec.rotatable, torch.bool),
            act_mask=t(spec.is_agent & spec.movable, torch.bool),
            rot_mask=t(spec.is_agent & spec.rotatable, torch.bool),
            mass=t(spec.mass), inv_mass=t(spec.inv_mass),
            moi=t(spec.moi), inv_moi=t(spec.inv_moi),
            drag=t(spec.drag), lin_fric=t(spec.lin_fric), ang_fric=t(spec.ang_fric),
            ent_gravity=t(spec.ent_gravity), world_gravity=t(np.asarray(world.gravity)),
            max_f=t(spec.max_f), f_range=t(spec.f_range),
            max_t=t(spec.max_t), t_range=t(spec.t_range),
            max_speed=t(spec.max_speed), v_range=t(spec.v_range),
            silent=t(spec.silent, torch.bool),
            ss_a=t(spec.ss_a, torch.long), ss_b=t(spec.ss_b, torch.long),
            ss_dmin=t(spec.ss_ra + spec.ss_rb),
            ls_line=t(spec.ls_line, torch.long), ls_sphere=t(spec.ls_sphere, torch.long),
            ls_len=t(spec.ls_len), ls_dmin=t(spec.ls_rad + LINE_MIN_DIST),
            ll_a=t(spec.ll_a, torch.long), ll_b=t(spec.ll_b, torch.long),
            ll_la=t(spec.ll_la), ll_lb=t(spec.ll_lb),
            bs_box=t(spec.bs_box, torch.long), bs_sphere=t(spec.bs_sphere, torch.long),
            bs_len=t(spec.bs_len), bs_wid=t(spec.bs_wid),
            bs_not_hollow=t(spec.bs_not_hollow, torch.bool), bs_rad=t(spec.bs_rad),
            bl_box=t(spec.bl_box, torch.long), bl_line=t(spec.bl_line, torch.long),
            bl_blen=t(spec.bl_blen), bl_bwid=t(spec.bl_bwid), bl_llen=t(spec.bl_llen),
            bl_not_hollow=t(spec.bl_not_hollow, torch.bool),
            bb_a=t(spec.bb_a, torch.long), bb_b=t(spec.bb_b, torch.long),
            bb_la=t(spec.bb_la), bb_wa=t(spec.bb_wa), bb_lb=t(spec.bb_lb), bb_wb=t(spec.bb_wb),
            bb_nha=t(spec.bb_nha, torch.bool), bb_nhb=t(spec.bb_nhb, torch.bool),
            joint_a=t(spec.joint_idx_a, torch.long), joint_b=t(spec.joint_idx_b, torch.long),
            joint_anchor_a=t(spec.joint_anchor_a), joint_anchor_b=t(spec.joint_anchor_b),
            joint_dist=t(spec.joint_dist), joint_rotate=t(spec.joint_rotate, torch.bool),
        )
    return spec.dev


# ---------------------------------------------------------------------------
# force model
# ---------------------------------------------------------------------------

def constraint_forces(contact_margin, pos_a, pos_b, dist_min, force_multiplier, attractive=False):
    """Soft logaddexp penalty force pair."""
    min_dist = 1e-6
    delta = pos_a - pos_b
    dist = safe_norm(delta)
    sign = -1.0 if attractive else 1.0
    k = contact_margin
    x = (dist_min - dist) * sign / k
    penetration = torch.logaddexp(torch.zeros_like(x), x) * k
    den = torch.where(dist > 0, dist, torch.full_like(dist, 1e-8))
    force = sign * force_multiplier * delta / den[..., None] * penetration[..., None]
    zero = torch.zeros_like(force)
    force = torch.where((dist < min_dist)[..., None], zero, force)
    if not attractive:
        force = torch.where((dist > dist_min)[..., None], zero, force)
    else:
        force = torch.where((dist < dist_min)[..., None], zero, force)
    return force, -force


def constraint_torques(rot_a, rot_b, force_multiplier):
    """Exponential rotation-constraint torque pair."""
    min_delta_rot = 1e-9
    delta_rot = rot_a - rot_b
    abs_delta = torch.abs(delta_rot)
    penetration = torch.exp(abs_delta) - 1.0
    torque = force_multiplier * torch.sign(delta_rot) * penetration
    torque = torch.where(abs_delta < min_delta_rot, torch.zeros_like(torque), torque)
    return -torque, torque


def _add_force(forces, movable, idx, f):
    mv = movable[idx]
    return forces.index_add(1, idx, torch.where(mv[None, :, None], f, torch.zeros_like(f)))


def _add_torque(torques, rotatable, idx, t):
    ro = rotatable[idx]
    return torques.index_add(1, idx, torch.where(ro[None, :], t, torch.zeros_like(t)))


def _action_forces(world, state, forces, torques):
    """Clamped agent action forces/torques; the clamp writes back into the
    persistent state.force, as the original does on agent.state.force."""
    spec, dv = world.spec, _dev(world)
    f = state.force
    act_mask = dv.act_mask[None, :, None]
    if spec.has_max_f:
        f = torch.where(act_mask, TorchUtils.clamp_with_norm(f, dv.max_f[None, :, None]), f)
    if spec.has_f_range:
        r = dv.f_range[None, :, None]
        f = torch.where(act_mask, torch.clamp(f, -r, r), f)
    t = state.torque
    rot_mask = dv.rot_mask[None, :]
    if spec.has_max_t:
        t = torch.where(rot_mask, torch.clamp(t, -dv.max_t[None, :], dv.max_t[None, :]), t)
    if spec.has_t_range:
        t = torch.where(rot_mask, torch.clamp(t, -dv.t_range[None, :], dv.t_range[None, :]), t)
    state = state.replace(force=f, torque=t)
    forces = forces + torch.where(dv.movable[None, :, None], f, torch.zeros_like(f))
    torques = torques + torch.where(dv.rotatable[None, :], t, torch.zeros_like(t))
    return state, forces, torques


def _friction_force(vel, coeff, mass, sub_dt):
    """Coulomb friction. ``vel``: [B, E, D]."""
    speed = safe_norm(vel)  # [B, E]
    static = speed == 0.0
    fconst = (coeff * mass)[None, :, None]
    ff = -(vel / torch.where(static, torch.ones_like(speed), speed)[..., None]) * torch.minimum(
        fconst, (torch.abs(vel) / sub_dt) * mass[None, :, None]
    )
    return torch.where(static[..., None], torch.zeros_like(ff), ff)


def _environment_forces(world, state, forces, torques):
    """The joint constraints, then the six shape-pair contact forces, in
    the JAX package's order: ss, ls, ll, bs, bl, bb."""
    spec, dv = world.spec, _dev(world)
    cm = world.contact_margin
    cf = world.collision_force

    if len(spec.joint_idx_a):
        ia, ib = dv.joint_a, dv.joint_b
        pos_a, pos_b = state.pos[:, ia], state.pos[:, ib]
        rot_a, rot_b = state.rot[:, ia], state.rot[:, ib]
        pja = pos_a + TorchUtils.rotate_vector(dv.joint_anchor_a[None].expand(pos_a.shape), rot_a)
        pjb = pos_b + TorchUtils.rotate_vector(dv.joint_anchor_b[None].expand(pos_b.shape), rot_b)
        dist = dv.joint_dist[None, :]
        fa_att, fb_att = constraint_forces(cm, pja, pjb, dist, world.joint_force, attractive=True)
        fa_rep, fb_rep = constraint_forces(cm, pja, pjb, dist, world.joint_force, attractive=False)
        force_a = fa_att + fa_rep
        force_b = fb_att + fb_rep
        ta_rot = TorchUtils.compute_torque(force_a, pja - pos_a)
        tb_rot = TorchUtils.compute_torque(force_b, pjb - pos_b)
        ta_fix, tb_fix = constraint_torques(rot_a, rot_b + state.joint_fixed_rot, world.torque_constraint_force)
        rotate = dv.joint_rotate[None, :]
        torque_a = torch.where(rotate, ta_rot, ta_rot + ta_fix)
        torque_b = torch.where(rotate, tb_rot, tb_rot + tb_fix)
        forces = _add_force(forces, dv.movable, ia, force_a)
        torques = _add_torque(torques, dv.rotatable, ia, torque_a)
        forces = _add_force(forces, dv.movable, ib, force_b)
        torques = _add_torque(torques, dv.rotatable, ib, torque_b)

    if len(spec.ss_a):
        pa, pb = state.pos[:, dv.ss_a], state.pos[:, dv.ss_b]
        fa, fb = constraint_forces(cm, pa, pb, dv.ss_dmin[None, :], cf)
        forces = _add_force(forces, dv.movable, dv.ss_a, fa)
        forces = _add_force(forces, dv.movable, dv.ss_b, fb)

    if len(spec.ls_line):
        pos_l, pos_s = state.pos[:, dv.ls_line], state.pos[:, dv.ls_sphere]
        rot_l = state.rot[:, dv.ls_line]
        length = dv.ls_len[None, :].expand(rot_l.shape)
        closest = G.closest_point_line(pos_l, rot_l, length, pos_s)
        f_sphere, f_line = constraint_forces(cm, pos_s, closest, dv.ls_dmin[None, :], cf)
        t_line = TorchUtils.compute_torque(f_line, closest - pos_l)
        forces = _add_force(forces, dv.movable, dv.ls_line, f_line)
        torques = _add_torque(torques, dv.rotatable, dv.ls_line, t_line)
        forces = _add_force(forces, dv.movable, dv.ls_sphere, f_sphere)

    if len(spec.ll_a):
        pos_a, pos_b = state.pos[:, dv.ll_a], state.pos[:, dv.ll_b]
        rot_a, rot_b = state.rot[:, dv.ll_a], state.rot[:, dv.ll_b]
        la = dv.ll_la[None, :].expand(rot_a.shape)
        lb = dv.ll_lb[None, :].expand(rot_b.shape)
        point_a, point_b = G.closest_points_line_line(pos_a, rot_a, la, pos_b, rot_b, lb)
        fa, fb = constraint_forces(cm, point_a, point_b, LINE_MIN_DIST, cf)
        forces = _add_force(forces, dv.movable, dv.ll_a, fa)
        torques = _add_torque(torques, dv.rotatable, dv.ll_a, TorchUtils.compute_torque(fa, point_a - pos_a))
        forces = _add_force(forces, dv.movable, dv.ll_b, fb)
        torques = _add_torque(torques, dv.rotatable, dv.ll_b, TorchUtils.compute_torque(fb, point_b - pos_b))

    if len(spec.bs_box):
        pos_box, pos_s = state.pos[:, dv.bs_box], state.pos[:, dv.bs_sphere]
        rot_box = state.rot[:, dv.bs_box]
        wid = dv.bs_wid[None, :].expand(rot_box.shape)
        leng = dv.bs_len[None, :].expand(rot_box.shape)
        closest = G.closest_point_box(pos_box, rot_box, wid, leng, pos_s)
        inner_point = closest
        d = torch.zeros_like(rot_box)
        if spec.bs_not_hollow.any():
            inner_h, d_h = G.inner_point_box(pos_s, closest, pos_box)
            nh = dv.bs_not_hollow[None, :]
            inner_point = torch.where(nh[..., None], inner_h, inner_point)
            d = torch.where(nh, d_h, d)
        f_sphere, f_box = constraint_forces(
            cm, pos_s, inner_point, dv.bs_rad[None, :] + LINE_MIN_DIST + d, cf
        )
        t_box = TorchUtils.compute_torque(f_box, closest - pos_box)
        forces = _add_force(forces, dv.movable, dv.bs_box, f_box)
        torques = _add_torque(torques, dv.rotatable, dv.bs_box, t_box)
        forces = _add_force(forces, dv.movable, dv.bs_sphere, f_sphere)

    if len(spec.bl_box):
        pos_box, pos_line = state.pos[:, dv.bl_box], state.pos[:, dv.bl_line]
        rot_box, rot_line = state.rot[:, dv.bl_box], state.rot[:, dv.bl_line]
        bwid = dv.bl_bwid[None, :].expand(rot_box.shape)
        blen = dv.bl_blen[None, :].expand(rot_box.shape)
        llen = dv.bl_llen[None, :].expand(rot_line.shape)
        point_box, point_line = G.closest_line_box(pos_box, rot_box, bwid, blen, pos_line, rot_line, llen)
        inner_point = point_box
        d = torch.zeros_like(rot_box)
        if spec.bl_not_hollow.any():
            inner_h, d_h = G.inner_point_box(point_line, point_box, pos_box)
            nh = dv.bl_not_hollow[None, :]
            inner_point = torch.where(nh[..., None], inner_h, inner_point)
            d = torch.where(nh, d_h, d)
        f_box, f_line = constraint_forces(cm, inner_point, point_line, LINE_MIN_DIST + d, cf)
        forces = _add_force(forces, dv.movable, dv.bl_box, f_box)
        torques = _add_torque(
            torques, dv.rotatable, dv.bl_box, TorchUtils.compute_torque(f_box, point_box - pos_box)
        )
        forces = _add_force(forces, dv.movable, dv.bl_line, f_line)
        torques = _add_torque(
            torques, dv.rotatable, dv.bl_line, TorchUtils.compute_torque(f_line, point_line - pos_line)
        )

    if len(spec.bb_a):
        pos_a, pos_b = state.pos[:, dv.bb_a], state.pos[:, dv.bb_b]
        rot_a, rot_b = state.rot[:, dv.bb_a], state.rot[:, dv.bb_b]
        wa = dv.bb_wa[None, :].expand(rot_a.shape)
        la = dv.bb_la[None, :].expand(rot_a.shape)
        wb = dv.bb_wb[None, :].expand(rot_b.shape)
        lb = dv.bb_lb[None, :].expand(rot_b.shape)
        point_a, point_b = G.closest_box_box(pos_a, rot_a, wa, la, pos_b, rot_b, wb, lb)
        inner_a, d_a = point_a, torch.zeros_like(rot_a)
        if spec.bb_nha.any():
            ih, dh = G.inner_point_box(point_b, point_a, pos_a)
            nh = dv.bb_nha[None, :]
            inner_a = torch.where(nh[..., None], ih, inner_a)
            d_a = torch.where(nh, dh, d_a)
        inner_b, d_b = point_b, torch.zeros_like(rot_b)
        if spec.bb_nhb.any():
            ih, dh = G.inner_point_box(point_a, point_b, pos_b)
            nh = dv.bb_nhb[None, :]
            inner_b = torch.where(nh[..., None], ih, inner_b)
            d_b = torch.where(nh, dh, d_b)
        fa, fb = constraint_forces(cm, inner_a, inner_b, d_a + d_b + LINE_MIN_DIST, cf)
        forces = _add_force(forces, dv.movable, dv.bb_a, fa)
        torques = _add_torque(torques, dv.rotatable, dv.bb_a, TorchUtils.compute_torque(fa, point_a - pos_a))
        forces = _add_force(forces, dv.movable, dv.bb_b, fb)
        torques = _add_torque(torques, dv.rotatable, dv.bb_b, TorchUtils.compute_torque(fb, point_b - pos_b))

    return forces, torques


def _integrate(world, state: WorldState, forces, torques, substep: int) -> WorldState:
    """Semi-implicit Euler with sub-stepping."""
    spec, dv = world.spec, _dev(world)
    mv = dv.movable[None, :]
    ro = dv.rotatable[None, :]
    vel, ang_vel, pos, rot = state.vel, state.ang_vel, state.pos, state.rot

    if substep == 0:
        vel = torch.where(mv[..., None], vel * (1 - dv.drag)[None, :, None], vel)
        ang_vel = torch.where(ro, ang_vel * (1 - dv.drag)[None, :], ang_vel)

    accel = forces * dv.inv_mass[None, :, None]
    vel = torch.where(mv[..., None], vel + accel * world.sub_dt, vel)
    if spec.has_max_speed:
        vel = torch.where(mv[..., None], TorchUtils.clamp_with_norm(vel, dv.max_speed[None, :, None]), vel)
    if spec.has_v_range:
        r = dv.v_range[None, :, None]
        vel = torch.where(mv[..., None], torch.clamp(vel, -r, r), vel)
    new_pos = pos + vel * world.sub_dt
    nx, ny = new_pos[..., 0], new_pos[..., 1]
    if world.x_semidim is not None:
        nx = torch.clamp(nx, -world.x_semidim, world.x_semidim)
    if world.y_semidim is not None:
        ny = torch.clamp(ny, -world.y_semidim, world.y_semidim)
    pos = torch.where(mv[..., None], torch.stack([nx, ny], dim=-1), pos)

    ang_vel = torch.where(ro, ang_vel + torques * dv.inv_moi[None, :] * world.sub_dt, ang_vel)
    rot = torch.where(ro, rot + ang_vel * world.sub_dt, rot)

    return state.replace(pos=pos, vel=vel, rot=rot, ang_vel=ang_vel)


def physics_step(world, state: WorldState) -> WorldState:
    """Full world step: ``substeps`` rounds of force accumulation and
    integration, then the comm state update."""
    spec, dv = world.spec, _dev(world)
    B, E = state.pos.shape[:2]
    for substep in range(world.substeps):
        forces = torch.zeros((B, E, 2), dtype=torch.float32, device=state.device)
        torques = torch.zeros((B, E), dtype=torch.float32, device=state.device)
        state, forces, torques = _action_forces(world, state, forces, torques)
        if spec.has_lin_fric:
            forces = forces + _friction_force(state.vel, dv.lin_fric, dv.mass, world.sub_dt)
        if spec.has_ang_fric:
            torques = torques + _friction_force(
                state.ang_vel[..., None], dv.ang_fric, dv.moi, world.sub_dt
            )[..., 0]
        if spec.has_world_gravity or spec.has_ent_gravity or state.dyn_gravity is not None:
            g = dv.world_gravity[None, None, :] + dv.ent_gravity[None]
            if state.dyn_gravity is not None:
                g = g + state.dyn_gravity
            gf = dv.mass[None, :, None] * g
            forces = forces + torch.where(dv.movable[None, :, None], gf, torch.zeros_like(gf))
        forces, torques = _environment_forces(world, state, forces, torques)
        state = _integrate(world, state, forces, torques, substep)

    if world.dim_c > 0 and len(world.agents):
        c = torch.where(dv.silent[None, :, None], state.c, state.uc)
        state = state.replace(c=c)
    return state
