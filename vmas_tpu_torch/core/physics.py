"""The plain physics step, on ``[B, E, ...]`` tensors.

Counterpart of vmas_tpu/core/physics.py: the per-step pair bucketing is
hoisted to build time (:func:`build_spec`), each shape-pair type is one
dense ``[B, P]`` computation followed by a scatter-add, and the force
accumulation order is the JAX package's: action, friction, gravity, then
the pair types in spec order. It stays differentiable through autograd.

The port covers sphere-sphere and box-sphere contacts. Line pairs, box-line
and box-box pairs, and joints are not ported yet: ``build_spec`` raises
``NotImplementedError`` naming the missing type.
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

    # ---- collision pair buckets -------------------------------------------
    ss, bs = [], []
    for ai in range(E):
        for bi in range(ai + 1, E):
            ea, eb = entities[ai], entities[bi]
            if not world.collides(ea, eb):
                continue
            sa, sb = ea.shape, eb.shape
            if isinstance(sa, Sphere) and isinstance(sb, Sphere):
                ss.append((ea, eb))
            elif {type(sa), type(sb)} == {Box, Sphere}:
                box, sphere = (ea, eb) if isinstance(sb, Sphere) else (eb, ea)
                bs.append((box, sphere))
            else:
                kind = {
                    frozenset({Line, Sphere}): "line-sphere",
                    frozenset({Line}): "line-line",
                    frozenset({Box, Line}): "box-line",
                    frozenset({Box}): "box-box",
                }[frozenset({type(sa), type(sb)})]
                raise NotImplementedError(
                    f"{kind} contact ({ea.name}, {eb.name}) is not ported to "
                    "vmas_tpu_torch yet: only sphere-sphere and box-sphere pairs are"
                )

    idx = lambda pairs, k: np.asarray([p[k].index for p in pairs], np.int64)
    prop = lambda pairs, k, f, dt=np.float32: np.asarray([f(p[k]) for p in pairs], dt)

    spec.ss_a, spec.ss_b = idx(ss, 0), idx(ss, 1)
    spec.ss_ra, spec.ss_rb = prop(ss, 0, lambda e: e.shape.radius), prop(ss, 1, lambda e: e.shape.radius)

    spec.bs_box, spec.bs_sphere = idx(bs, 0), idx(bs, 1)
    spec.bs_len, spec.bs_wid = prop(bs, 0, lambda e: e.shape.length), prop(bs, 0, lambda e: e.shape.width)
    spec.bs_not_hollow = prop(bs, 0, lambda e: not e.shape.hollow, bool)
    spec.bs_rad = prop(bs, 1, lambda e: e.shape.radius)

    # joints are not ported; the table stays empty so layouts keep J = 0
    spec.joint_idx_a = np.zeros(0, np.int64)
    spec.joint_fixed_rot_init = np.zeros(0, np.float32)
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
            bs_box=t(spec.bs_box, torch.long), bs_sphere=t(spec.bs_sphere, torch.long),
            bs_len=t(spec.bs_len), bs_wid=t(spec.bs_wid),
            bs_not_hollow=t(spec.bs_not_hollow, torch.bool), bs_rad=t(spec.bs_rad),
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
    """The ss and bs shape-pair contact forces."""
    spec, dv = world.spec, _dev(world)
    cm = world.contact_margin
    cf = world.collision_force

    if len(spec.ss_a):
        pa, pb = state.pos[:, dv.ss_a], state.pos[:, dv.ss_b]
        fa, fb = constraint_forces(cm, pa, pb, dv.ss_dmin[None, :], cf)
        forces = _add_force(forces, dv.movable, dv.ss_a, fa)
        forces = _add_force(forces, dv.movable, dv.ss_b, fb)

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
