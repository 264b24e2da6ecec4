"""Worlds and states that hold the fused step to its plain version.

Shared by chip_smoke.py (on the GPU) and the CPU tests (against the JAX
package): the all-pairs world, in which all six contact pair types occur,
a packed state of it in which every type touches, a balance state with
contacts of its four types, and the margin of balance's flags to their
thresholds; a small world of every kind of joint constraint and a state of
it, a joint_passage state with contacts of its four types and its joints
pulled apart, a waterfall state with all six types touching and its
fixed-rotation torques active, and the margin of joint_passage's flags;
give_way and multi_give_way states with the agents pressed into their
corridor walls and into each other and their velocity controllers'
memory set, actions that drive every branch of the in-kernel PID, and
the count of lanes each branch acted in; a transport state with the
agents pressed against the package, a wind_flocking state with the big
agent's wind rescaled, an MPE state with agents overlapping, a state
of the other MPE worlds with catches, contacts, food eaten and comm set,
a state of each of the other holonomic worlds (reverse_transport,
wheel, passage, dispersion, dropout, het_mass) with its contacts and
events, and the count of those events in a step's rows; a state of each
sensor world (navigation, flocking, discovery) with its Lidar hits,
collisions, goals reached and targets covered, and their count in a
step's rows; a football state with goals scored, the ball at rest, near
the walls and in the goal mouth, and agents against the walls, and the
count of its events in a step's rows; a state of each dynamics and
controller debug world (diff_drive, kinematic_bicycle, drone, goal,
vel_control, circle_trajectory, line_trajectory) with its first agents in
contact, the drone's hidden state tilted, the controllers' memory set,
actions beyond the controllers' clamp, and the events of a step's rows; a
state of the DOTS worlds (painting, construction) and of sampling with
agents pressed into the walls (the bound) and into each other, painting's
knowledge matched and on goal, and sampling's field and visited cells.
The states are numpy dicts made from a seeded generator, so that both
packages can load the same one. For road_traffic's path sweeps: lanes on
centre-line vertices and padded tails, and on left-boundary vertices.
"""

from __future__ import annotations

import numpy as np
import torch

from vmas_tpu_torch.core import fused as F
from vmas_tpu_torch.core.utils import LINE_MIN_DIST


def all_pairs_world(core, batch_dim, device=None):
    """The all-pairs world, from ``core`` (``vmas_tpu.core`` or
    ``vmas_tpu_torch.core``): spheres s0-s5, lines l0-l1, boxes b0-b2 (b2
    hollow), all agents, in that entity order, substeps 1: E = 11 with ss
    15, ls 12, ll 1, bs 18, bl 6 and bb 3 pairs. Lines and boxes weigh 5, so
    that their small moments of inertia do not turn an ulp of a contact
    normal into a visible spin."""
    w = core.World(batch_dim, device, substeps=1)
    for i in range(6):
        w.add_agent(core.Agent(name=f"s{i}", shape=core.Sphere(0.04)))
    for i in range(2):
        w.add_agent(core.Agent(name=f"l{i}", shape=core.Line(0.3), mass=5))
    for i in range(3):
        w.add_agent(core.Agent(name=f"b{i}", shape=core.Box(0.2, 0.1, hollow=i == 2), mass=5))
    w.finalize()
    return w


def joints_world(core, batch_dim, device=None):
    """A small world of every kind of joint constraint, from ``core``
    (``vmas_tpu.core`` or ``vmas_tpu_torch.core``), substeps 2: sphere
    agents a0-a2; a bar (a collidable line) joining a0 and a1 at their
    surfaces; a box rigidly joined to a2 at a fixed rotation of 0.3 rad; a
    non-collidable line joining a1 (its rotation held at the one inferred
    at sync) and a2; a static floor line. E = 7 with 5 constraints and ss
    3, ls 4, ll 1, bs 2, bl 2 pairs."""
    w = core.World(batch_dim, device, substeps=2, joint_force=300)
    a = [core.Agent(name=f"a{i}", shape=core.Sphere(0.05)) for i in range(3)]
    for ag in a:
        w.add_agent(ag)
    w.add_joint(core.Joint(a[0], a[1], anchor_a=(1, 0), anchor_b=(-1, 0), dist=0.3, collidable=True))
    box = core.Landmark(name="box", shape=core.Box(0.2, 0.1), movable=True, rotatable=True, collide=True)
    w.add_landmark(box)
    w.add_joint(core.Joint(a[2], box, dist=0.0, rotate_a=False, rotate_b=False,
                           fixed_rotation_a=0.3, fixed_rotation_b=0.3))
    w.add_joint(core.Joint(a[1], a[2], dist=0.2, rotate_a=False, rotate_b=True))
    w.add_landmark(core.Landmark(name="floor", shape=core.Line(2.0), collide=True))
    w.finalize()
    return w


def joints_state(world, rng):
    """A numpy state dict of ``joints_world`` with every constraint pulled
    apart by millimetres to centimetres and contacts of four pair types: a0
    and a1 0.4 apart with the bar between them, a2 and the box touching a1
    from below (sphere-sphere, box-sphere), the floor touching a2 and the
    box (line-sphere, box-line); jittered per env."""
    B = world.batch_dim
    idx = {e.name: e.index for e in world.entities}
    pos = np.zeros((B, len(idx), 2))
    rot = np.zeros((B, len(idx)))
    j = lambda s: rng.normal(0, s, (B, 2))
    pos[:, idx["a0"]] = (-0.2, 0.0) + j(0.01)
    pos[:, idx["a1"]] = (0.2, 0.0) + j(0.001)
    pos[:, idx["a2"]] = (0.2, -0.098) + j(0.001)
    pos[:, idx["box"]] = pos[:, idx["a2"]] + j(0.001)
    pos[:, idx["floor"]] = (0.0, -0.152) + j(0.001)
    bar, link = (e.name for e in world.landmarks if e.name.startswith("joint"))
    for name, (p, q) in ((bar, ("a0", "a1")), (link, ("a1", "a2"))):
        mid = (pos[:, idx[p]] + pos[:, idx[q]]) / 2
        d = pos[:, idx[q]] - pos[:, idx[p]]
        pos[:, idx[name]] = mid + j(0.004)
        rot[:, idx[name]] = np.arctan2(d[:, 1], d[:, 0]) + rng.normal(0, 0.05, B)
    rot[:, idx["a1"]] = rng.normal(0, 0.3, B)
    rot[:, idx["a2"]] = rng.normal(0, 0.3, B)
    rot[:, idx["box"]] = rng.normal(0, 0.05, B)
    rot[:, idx["floor"]] = rng.normal(0, 0.005, B)
    E = len(idx)
    f32 = lambda a: np.asarray(a, np.float32)
    J = len(world.spec.joint_idx_a)
    return {
        "pos": f32(pos), "rot": f32(rot),
        "vel": f32(rng.normal(0, 0.02, (B, E, 2))), "ang_vel": f32(rng.normal(0, 0.1, (B, E))),
        "force": f32(rng.normal(0, 0.2, (B, E, 2))), "torque": f32(rng.normal(0, 0.01, (B, E))),
        "joint_fixed_rot": f32(np.asarray(world.spec.joint_fixed_rot_init)[None] + rng.normal(0, 0.05, (B, J))),
    }


def all_pairs_state(rng, batch_dim):
    """A numpy state dict [B, 11, ...] of the all-pairs world in which every
    pair type touches, clear of near ties: b1 beside b0 with a
    tilt, so one corner is nearest (bb); l0 under the hollow b2 and l1 under
    l0, each within LINE_MIN_DIST, tilted, and l1 shifted along l0 (bl, ll);
    s0 and s1 side by side on b0 (ss, bs), s2 on b2 (bs hollow), s3 under
    l1 (ls), s4 and s5 side by side against b1 (ss, bs). Everything is
    placed in its neighbour's frame, then the scene is shifted."""
    u = lambda lo, hi: rng.uniform(lo, hi, batch_dim)
    sign = lambda: rng.choice([-1.0, 1.0], batch_dim)
    pos = np.zeros((batch_dim, 11, 2))
    rot = np.zeros((batch_dim, 11))

    def put(e, ref, x, y):
        c, s = np.cos(rot[:, ref]), np.sin(rot[:, ref])
        pos[:, e, 0] = pos[:, ref, 0] + c * x - s * y
        pos[:, e, 1] = pos[:, ref, 1] + s * x + c * y

    rot[:, 8] = u(-0.02, 0.02)
    tilt = sign() * u(0.03, 0.08)
    rot[:, 9] = rot[:, 8] + tilt
    # b1's nearest corner 2-5 mm off b0's face
    reach = 0.1 * np.cos(tilt) + 0.05 * np.abs(np.sin(tilt))
    put(9, 8, 0.1 + u(0.002, 0.005) + reach, u(-0.02, 0.02))
    rot[:, 10] = u(-0.01, 0.01)
    put(10, 8, 0.0, -0.25)
    rot[:, 6] = rot[:, 10] + sign() * u(0.003, 0.006)
    put(6, 10, u(-0.03, 0.03), -0.05 - u(0.003, 0.005))
    rot[:, 7] = rot[:, 6] + sign() * u(0.003, 0.005)
    put(7, 6, sign() * u(0.01, 0.03), -u(0.003, 0.005))
    put(0, 8, -0.04, 0.05 + 0.04 - u(0.0, 0.004))
    put(1, 8, 0.039, 0.05 + 0.04 - u(0.0, 0.004))
    put(2, 10, u(-0.05, 0.05), 0.05 + 0.04 - u(0.0, 0.004))
    put(3, 7, u(-0.05, 0.05), -0.04 - u(0.0, 0.005))
    t = u(-0.045, -0.035)
    put(4, 9, 0.1 + 0.04 - u(0.0, 0.004), t)
    put(5, 9, 0.1 + 0.04 - u(0.0, 0.004), t + 0.079)
    rot[:, :6] = u(-np.pi, np.pi)[:, None]
    pos += rng.uniform(-0.5, 0.5, (batch_dim, 1, 2))
    f32 = lambda a: np.asarray(a, np.float32)
    # slow, so that in one step no gap closes to where an ulp of a contact
    # normal shows
    return {
        "pos": f32(pos), "rot": f32(rot),
        "vel": f32(rng.normal(0, 0.005, (batch_dim, 11, 2))),
        "ang_vel": f32(rng.normal(0, 0.02, (batch_dim, 11))),
        "force": f32(rng.normal(0, 0.05, (batch_dim, 11, 2))),
        "torque": f32(rng.normal(0, 0.005, (batch_dim, 11))),
    }


def balance_contact_state(env, rng):
    """A numpy state dict of a balance env in which every contact type of
    balance touches: agents 0 and 1 side by side on the floor
    (sphere-sphere, box-sphere), agent 2 on the floor, the line resting on
    agent 1 (and pressing on agent 0) with its left end 2-12 mm above the
    floor, so that in some envs it touches (box-line) and the episode is
    over, and the package on the line (line-sphere). The goal lies near the
    package."""
    cpu = lambda t: t.detach().cpu().numpy()
    st, sc = env.state, env.scenario
    b, e = st.pos.shape[:2]
    u = lambda lo, hi: rng.uniform(lo, hi, b)
    ag = [a.index for a in sc.world.agents]
    r_a, r_p = sc.agent_radius, sc.package.shape.radius
    top = -sc.world.y_semidim - sc.agent_radius  # the floor's top face
    pos = np.zeros((b, e, 2))
    rot = np.zeros((b, e))
    pos[:, sc.floor.index] = (0.0, top - sc.floor.shape.width / 2)
    x0 = u(-0.6, 0.2)
    for a, dx in zip(ag, (0.0, 0.059, None)):
        pos[:, a, 0] = x0 + (u(0.3, 0.5) if dx is None else dx)
        pos[:, a, 1] = top + r_a - u(0.0, 0.003)
    th = u(0.12, 0.2)
    along = np.stack([np.cos(th), np.sin(th)], -1)
    normal = np.stack([-np.sin(th), np.cos(th)], -1)
    on_a1 = pos[:, ag[1]] + normal * (r_a + LINE_MIN_DIST - u(0.0005, 0.003))[:, None]
    left = on_a1 - along * ((on_a1[:, 1] - top - u(0.002, 0.012)) / np.sin(th))[:, None]
    pos[:, sc.line.index] = left + along * (sc.line_length / 2)
    rot[:, sc.line.index] = th
    pkg = left + along * u(0.5, 0.7)[:, None] + normal * (r_p + LINE_MIN_DIST - u(0.0005, 0.003))[:, None]
    pos[:, sc.package.index] = pkg
    pos[:, sc.goal.index] = pkg + rng.normal(0, 0.1, (b, 2))
    f32 = lambda a: np.asarray(a, np.float32)
    d = np.linalg.norm(pkg - pos[:, sc.goal.index], axis=-1)
    return {
        "pos": f32(pos), "rot": f32(rot),
        "vel": f32(rng.normal(0, 0.01, (b, e, 2))),
        "ang_vel": f32(rng.normal(0, 0.02, (b, e))),
        "force": f32(rng.normal(0, 0.1, (b, e, 2))),
        "torque": f32(np.zeros((b, e))),
        "c": cpu(st.c), "uc": cpu(st.uc), "u": [cpu(x) for x in st.u],
        "joint_fixed_rot": cpu(st.joint_fixed_rot), "rendering": cpu(st.rendering),
        "scenario": {
            "on_the_ground": np.zeros(b, bool),
            "global_shaping": f32(d * 100 + rng.normal(0, 1, b)),
            "pos_rew": np.zeros(b, np.float32),
            "ground_rew": np.zeros(b, np.float32),
        },
    }


def balance_flag_margin(fo, rows):
    """Per env, the smallest distance of one of balance's on_ground and done
    tests to its threshold, on the post-step state rows [9E, B] (``fo``:
    its ``BalanceOutputs``)."""
    E = len(rows) // 9
    px, py, rot = rows[:E], rows[E:2 * E], rows[4 * E:5 * E]
    fi, pi, li, gi = fo.floor_i, fo.pkg_i, fo.line_i, fo.goal_i
    fx, fy, fc, fs = px[fi], py[fi], torch.cos(rot[fi]), torch.sin(rot[fi])
    bx, by, lx, ly = F._closest_line_box(fx, fy, fc, fs, fo.floor_hw, fo.floor_hl, px[li], py[li],
                                        torch.cos(rot[li]), torch.sin(rot[li]), fo.line_half)
    cx, cy = F._closest_point_box(fx, fy, fc, fs, fo.floor_hw, fo.floor_hl, px[pi], py[pi])
    dist = F._norm(px[pi] - px[gi], py[pi] - py[gi])
    return torch.stack([
        (F._norm(bx - lx, by - ly) - LINE_MIN_DIST).abs(),
        (F._norm(px[pi] - fx, py[pi] - fy) - F._norm(fx - cx, fy - cy)).abs(),
        (F._norm(px[pi] - cx, py[pi] - cy) - (fo.pkg_r + LINE_MIN_DIST)).abs(),
        (dist - fo.pkg_r - fo.goal_r).abs(),
    ]).min(0).values


def _np_state(state, pos, rot, vel, ang_vel, force):
    """A numpy state dict from ``state``, with the physical fields replaced
    (f32) and the scenario scratch copied."""
    from vmas_tpu_torch.interop import state_to_numpy

    out = state_to_numpy(state)
    f32 = lambda a: np.asarray(a, np.float32)
    out.update(pos=f32(pos), rot=f32(rot), vel=f32(vel), ang_vel=f32(ang_vel), force=f32(force),
               torque=np.zeros(rot.shape, np.float32))
    return out


def joint_passage_contact_state(env, rng):
    """A numpy state dict of a joint_passage env (default config) in which
    each of its contact types touches and the joints are pulled apart, by
    env index mod 4: (0) the bar tilted through the gap, across a side
    face of the passage beside it (box-line); (1) the bar level under or
    over the row of passages, the agents 0.5-4 mm short of touching the
    passages' faces and the mass pulled off its anchor to touch too
    (box-sphere); (2) the bar upright beside a side wall, the agents
    touching the wall (line-sphere); (3) the agents touching each other,
    the bar across them (sphere-sphere; its anchors some 0.22 m away). In
    every env the agents and the mass sit 0-3 mm off their anchors; the
    scratch holds noisy shapings, some episodes passed, and non-zero
    controller memory."""
    sc = env.scenario
    B, E = env.state.pos.shape[:2]
    st = env.state
    cpu = lambda t: t.detach().cpu().numpy().astype(np.float64)
    pos, rot = cpu(st.pos), cpu(st.rot)
    u = lambda lo, hi: rng.uniform(lo, hi, B)
    sign = lambda: rng.choice([-1.0, 1.0], B)
    jl, ms, gl = sc.joint.landmark.index, sc.mass.index, sc.goal.index
    a0, a1 = (a.index for a in sc.world.agents)
    r_a, r_m, half = sc.agent_radius, sc.mass_radius, sc.joint_length / 2
    gap_x = float(pos[0, sc.non_collide_passages[0].index, 0])
    wall_x = 1 + r_a
    mode = np.arange(B) % 4

    cx, cy, th = np.zeros(B), np.zeros(B), np.zeros(B)
    s = sign()
    # (0) through the gap, across the face of the passage on side s
    m = mode == 0
    face = gap_x + s * sc.passage_length / 2
    cx[m] = (face - s * u(0.001, 0.005))[m]
    cy[m] = u(-0.08, 0.08)[m]
    th[m] = (np.pi / 2 + u(-0.15, 0.15))[m]
    # (1) level, under (s < 0) or over (s > 0) the row of passages
    m = mode == 1
    cx[m] = u(-0.7, 0.7)[m]
    cy[m] = (s * (sc.passage_width / 2 + r_a + LINE_MIN_DIST - u(0.0005, 0.004)))[m]
    th[m] = u(-0.01, 0.01)[m]
    # (2) upright beside the wall on side s
    m = mode == 2
    cx[m] = (s * (wall_x - r_a - LINE_MIN_DIST + u(0.0005, 0.004)))[m]
    cy[m] = (sign() * u(0.45, 0.7))[m]
    th[m] = (np.pi / 2 + u(-0.02, 0.02))[m]
    # (3) the agents overlapping by 0.5-4 mm, the bar across them
    m = mode == 3
    cx[m], cy[m], th[m] = u(-0.5, 0.5)[m], u(0.3, 0.7)[m], u(-np.pi, np.pi)[m]

    along = np.stack([np.cos(th), np.sin(th)], -1)
    centre = np.stack([cx, cy], -1)
    jitter = lambda: rng.normal(0, 0.0015, (B, 2))
    pos[:, jl], rot[:, jl] = centre, th
    pos[:, a0] = centre - along * half + jitter()
    pos[:, a1] = centre + along * half + jitter()
    pos[:, ms] = centre + along * (sc.mass_position * half) + jitter()
    m = mode == 1
    pos[m, ms, 1] -= (np.sign(cy) * (r_a - r_m))[m]
    m = mode == 3
    gap = (2 * r_a - u(0.0005, 0.004))[m]
    pos[m, a0] = centre[m] - along[m] * gap[:, None] / 2
    pos[m, a1] = centre[m] + along[m] * gap[:, None] / 2
    pos[:, gl] = np.stack([u(-0.7, 0.7), u(0.3, 0.9)], -1)
    rot[:, gl] = u(-np.pi / 2, np.pi / 2)

    movable = [jl, ms, a0, a1]
    vel = np.zeros((B, E, 2))
    vel[:, movable] = rng.normal(0, 0.02, (B, 4, 2))
    ang_vel = np.zeros((B, E))
    ang_vel[:, [jl, a0, a1]] = rng.normal(0, 0.1, (B, 3))
    force = np.zeros((B, E, 2))
    force[:, [a0, a1]] = rng.normal(0, 0.3, (B, 2, 2))
    out = _np_state(env.state, pos, rot, vel, ang_vel, force)

    def angle_dist(a, b):
        a, b = np.mod(a, np.pi), np.mod(b, np.pi)
        return np.minimum(np.abs(a - b), np.minimum(np.abs(a - (b - np.pi)), np.abs((a - np.pi) - b)))

    f32 = lambda a: np.asarray(a, np.float32)
    noise = lambda: rng.normal(0, 0.01, B)
    d_pass = np.linalg.norm(pos[:, jl] - pos[:, sc.non_collide_passages[0].index], axis=-1)
    scratch = out["scenario"]
    scratch.update(
        pos_shaping_pre=f32(d_pass + noise()),
        pos_shaping_post=f32(np.linalg.norm(pos[:, jl] - pos[:, gl], axis=-1) + noise()),
        rot_shaping_pre=f32(angle_dist(th, np.pi / 2) + noise()),
        rot_shaping_post=f32(angle_dist(th, rot[:, gl]) + noise()),
        passed=f32(rng.choice([0.0, 100.0], B)),
    )
    for a in sc.world.agents:
        scratch[f"__vel_ctrl_{a.name}"] = {
            "accum_errs": f32(rng.normal(0, 0.01, (B, 2))), "prev_err": f32(rng.normal(0, 0.1, (B, 2))),
        }
    return out


def joint_passage_flag_margin(fo, rows):
    """Per env, the smallest distance of one of joint_passage's discrete
    tests (bar past the wall, agents past the passages, done's two
    distances) to its threshold, on the post-step state rows [9E, B]
    (``fo``: its ``JointPassageOutputs``)."""
    from vmas_tpu_torch.scenarios.joint_passage import _angle_dist

    E = len(rows) // 9
    px, py, rot = rows[:E], rows[E:2 * E], rows[4 * E:5 * E]
    jl, gi = fo.jl_i, fo.goal_i
    tests = [py[jl].abs(), (F._norm(px[jl] - px[gi], py[jl] - py[gi]) - 0.01).abs(),
             (_angle_dist(rot[jl], rot[gi]) - 0.01).abs()]
    tests += [(py[ai] - fo.pw_half).abs() for ai in fo.agent_i]
    return torch.stack(tests).min(0).values


def waterfall_contact_state(env, rng):
    """A numpy state dict of a waterfall env (default config) laid out on
    its floor so that all six pair types touch by 0.5-4 mm, with tilts
    that keep every closest point clear of a tie: the chain's agents on
    the floor (line-sphere), the first turned so that its bar's end lies on
    the floor (line-line), the second and third side by side (sphere-
    sphere; the bar between them pulled 5 cm off both anchors), a box
    across the last two (box-sphere), the joined box standing on the floor
    (box-line) with its bar a few cm off its anchors, and two boxes on the
    floor, one tilted against the other's side (box-line, box-box). The
    joints are synced, then the two fixed rotations set 0.02-0.1 rad off,
    so that their torque acts; velocities slow, random forces on the
    agents."""
    sc, world = env.scenario, env.world
    B, E = env.state.pos.shape[:2]
    st = env.state
    u = lambda lo, hi: rng.uniform(lo, hi, B)
    sign = lambda: rng.choice([-1.0, 1.0], B)
    r = sc.agent_radius
    gap = lambda: LINE_MIN_DIST - u(0.0005, 0.004)  # a surface gap in contact range
    floor_y = -1.0
    ag = [a.index for a in world.agents]
    lms = world.landmarks
    joined = lms[sc.n_agents - 1].index
    boxes = [lm.index for lm in lms[sc.n_agents + 1:-1]]
    pos = st.pos.detach().cpu().numpy().astype(np.float64)
    rot = np.zeros((B, E))
    x0 = u(-0.9, -0.8)
    y_on_floor = lambda: floor_y + r + gap()
    # agent 0 turned down: its anchor (1, 0) lies on the floor, and the
    # next agent where that anchor is one bar length from its own
    turn = u(0.05, 0.15)
    rot[:, ag[0]] = -np.pi / 2 + turn
    pos[:, ag[0]] = np.stack([x0, floor_y + gap() + r * np.cos(turn)], -1)
    a0 = pos[:, ag[0]] + r * np.stack([np.cos(rot[:, ag[0]]), np.sin(rot[:, ag[0]])], -1)
    y1 = y_on_floor()
    dy = y1 - a0[:, 1]
    pos[:, ag[1]] = np.stack([a0[:, 0] + np.sqrt(sc.agent_dist ** 2 - dy ** 2) + r, y1], -1)
    # agents 1 and 2 overlapping, 2-4 spaced by a bar
    pos[:, ag[2]] = np.stack([pos[:, ag[1], 0] + 2 * r - u(0.0005, 0.004), y_on_floor()], -1)
    for k in (3, 4):
        pos[:, ag[k]] = np.stack([pos[:, ag[k - 1], 0] + sc.agent_dist + 2 * r, y_on_floor()], -1)
    # a box across agents 3 and 4, tilted
    b0 = boxes[0]
    rot[:, b0] = sign() * u(0.01, 0.04)
    top = np.maximum(pos[:, ag[3], 1], pos[:, ag[4], 1]) + r
    mid_x = (pos[:, ag[3], 0] + pos[:, ag[4], 0]) / 2
    pos[:, b0] = np.stack([mid_x, top + 0.05 + gap() + 0.09 * np.abs(np.sin(rot[:, b0]))], -1)
    # the joined box standing on the floor right of agent 4
    rot[:, joined] = u(-0.02, 0.02)
    pos[:, joined] = np.stack([pos[:, ag[4], 0] + 2 * r + sc.agent_dist + u(0.005, 0.015),
                               floor_y + 0.15 + gap() + 0.04 * np.abs(np.sin(rot[:, joined]))], -1)
    # two boxes on the floor, the second's corner against the first's side
    b1, b2 = boxes[1], boxes[2]
    rot[:, b1] = sign() * u(0.005, 0.02)
    pos[:, b1] = np.stack([u(0.2, 0.3), floor_y + 0.05 + gap() + 0.15 * np.abs(np.sin(rot[:, b1]))], -1)
    tilt = sign() * u(0.03, 0.08)
    rot[:, b2] = rot[:, b1] + tilt
    reach = 0.15 * np.cos(tilt) + 0.05 * np.abs(np.sin(tilt))
    c, s_ = np.cos(rot[:, b1]), np.sin(rot[:, b1])
    off_x, off_y = 0.15 + u(0.002, 0.005) + reach, u(0.015, 0.03)
    pos[:, b2] = pos[:, b1] + np.stack([c * off_x - s_ * off_y, s_ * off_x + c * off_y], -1)
    # the last two boxes apart, above
    for k, b in enumerate(boxes[3:]):
        pos[:, b] = np.stack([u(-0.7, 0.7), np.full(B, -0.3 + 0.3 * k)], -1)
        rot[:, b] = u(-np.pi, np.pi)
    dev = st.device
    state = st.replace(pos=torch.as_tensor(pos, dtype=torch.float32, device=dev),
                       rot=torch.as_tensor(rot, dtype=torch.float32, device=dev))
    state = world.sync_joints(state)
    jfr = state.joint_fixed_rot.detach().cpu().numpy().astype(np.float64)
    free = ~world.spec.joint_rotate
    jfr[:, free] += rng.choice([-1.0, 1.0], (B, int(free.sum()))) * rng.uniform(0.02, 0.1, (B, int(free.sum())))
    cpu = lambda t: t.detach().cpu().numpy().astype(np.float64)
    moving = [e.index for e in world.entities if e.movable]
    vel = np.zeros((B, E, 2))
    vel[:, moving] = rng.normal(0, 0.01, (B, len(moving), 2))
    ang_vel = np.zeros((B, E))
    ang_vel[:, moving] = rng.normal(0, 0.02, (B, len(moving)))
    force = np.zeros((B, E, 2))
    force[:, ag] = rng.normal(0, 0.1, (B, len(ag), 2))
    out = _np_state(state, cpu(state.pos), cpu(state.rot), vel, ang_vel, force)
    out["joint_fixed_rot"] = np.asarray(jfr, np.float32)
    return out


def _pid_memory(scratch, env, rng, cutoff_every=4):
    """Random velocity-controller memory in ``scratch`` (numpy), with the
    integrator of every ``cutoff_every``-th env at its windup cutoff."""
    f32 = lambda a: np.asarray(a, np.float32)
    B = env.num_envs
    for a in env.scenario.world.agents:
        vc = env.scenario.controllers[a.name]
        cut = vc.integrator_windup_cutoff
        acc = rng.normal(0, 0.05, (B, 2))
        at_cut = np.arange(B) % cutoff_every == 1
        acc[at_cut] = rng.choice([-1.0, 1.0], (int(at_cut.sum()), 2)) * cut
        scratch[vc.key] = {"accum_errs": f32(acc), "prev_err": f32(rng.normal(0, 0.1, (B, 2)))}


def give_way_contact_state(env, rng):
    """A numpy state dict of a give_way env (default config) in which its
    contact types touch, by env index mod 4: (0) the agents touching each
    other (0.5-4 mm overlap), both pressed into the floor; (1) agent 0
    pressed into an end wall, agent 1 into a small ceiling; (2) agent 0 in
    the side passage, pressed into its side wall, agent 1 into the floor;
    (3) both free in the corridor. Pressed means 0.5-4 mm into the contact
    range of the wall (sphere-line). Velocities and forces are random, the
    shapings noisy, some goals reached, and the controllers' memory random
    with every 4th env's integrator at its cutoff."""
    sc = env.scenario
    B, E = env.state.pos.shape[:2]
    st = env.state
    pos = st.pos.detach().cpu().numpy().astype(np.float64)
    u = lambda lo, hi: rng.uniform(lo, hi, B)
    side = lambda: rng.choice([-1.0, 1.0], B)
    r = sc.agent_radius
    press = lambda: r + LINE_MIN_DIST - u(0.0005, 0.004)  # centre to wall
    a0, a1 = (a.index for a in sc.world.agents)
    half_w = sc.corridor_width / 2  # floor and ceilings at -half_w, +half_w
    end = sc.scenario_length / 2
    mode = np.arange(B) % 4
    p0 = np.stack([u(-1.5, 1.5), u(-0.02, 0.02)], -1)
    p1 = p0 + np.stack([u(1.0, 1.6), u(-0.02, 0.02)], -1)
    m = mode == 0
    floor_y = -half_w + press()
    p0[m] = np.stack([u(-2.0, 1.5), floor_y], -1)[m]
    p1[m] = p0[m] + np.stack([2 * r - u(0.0005, 0.004), np.zeros(B)], -1)[m]
    m = mode == 1
    s = side()
    p0[m] = np.stack([s * (end - press()), u(-0.02, 0.02)], -1)[m]
    p1[m] = np.stack([-s * u(0.6, 2.0), half_w - press()], -1)[m]
    m = mode == 2
    s = side()
    p0[m] = np.stack([s * (sc.passage_length / 2 - press()), half_w + u(0.1, 0.3)], -1)[m]
    p1[m] = np.stack([u(0.8, 2.0), -half_w + press()], -1)[m]
    pos[:, a0], pos[:, a1] = p0, p1
    vel = np.zeros((B, E, 2))
    vel[:, [a0, a1]] = rng.normal(0, 0.1, (B, 2, 2))
    force = np.zeros((B, E, 2))
    force[:, [a0, a1]] = rng.normal(0, 0.3, (B, 2, 2))
    out = _np_state(st, pos, st.rot.detach().cpu().numpy(), vel, np.zeros((B, E)), force)
    goals = [pos[:, a.goal.index] for a in sc.world.agents]
    d = np.stack([np.linalg.norm(pos[:, a] - g, axis=-1) for a, g in zip((a0, a1), goals)], -1)
    f32 = lambda a: np.asarray(a, np.float32)
    out["scenario"].update(shaping=f32(d * sc.pos_shaping_factor + rng.normal(0, 0.01, (B, 2))),
                           goal_reached=rng.random(B) < 0.25)
    _pid_memory(out["scenario"], env, rng)
    return out


def multi_give_way_contact_state(env, rng):
    """A numpy state dict of a multi_give_way env in which its contact types
    touch, by env index mod 3: (0) agents 0 and 1 touching each other in the
    x corridor, agent 2 pressed into a long wall, agent 3 into the end wall;
    (1) the same in the y corridor with agents 2, 3 touching and agents 0, 1
    at the walls; (2) the agents near their starts. Pressed means 0.5-4 mm
    into the wall's contact range. Velocities and forces are random, the
    shapings noisy, the latch set in some envs, and the controllers' memory
    random with every 4th env's integrator at its cutoff."""
    sc = env.scenario
    B, E = env.state.pos.shape[:2]
    st = env.state
    pos = st.pos.detach().cpu().numpy().astype(np.float64)
    u = lambda lo, hi: rng.uniform(lo, hi, B)
    r = sc.agent_radius
    press = lambda: r + LINE_MIN_DIST - u(0.0005, 0.004)
    ag = [a.index for a in sc.world.agents]
    half_w, end = sc.scenario_width / 2, sc.scenario_length / 2
    mode = np.arange(B) % 3
    # (x, y) in the x corridor; mode 1 swaps the axes and the agent pairs
    pair = u(-2.0, -1.0)
    q = np.zeros((B, 4, 2))
    q[:, 0] = np.stack([pair, u(-0.02, 0.02)], -1)
    q[:, 1] = q[:, 0] + np.stack([2 * r - u(0.0005, 0.004), u(-0.02, 0.02)], -1)
    q[:, 2] = np.stack([u(0.6, 1.2), half_w - press()], -1)
    q[:, 3] = np.stack([end - press(), u(-0.02, 0.02)], -1)
    m = mode == 1
    q[m] = q[m][:, [2, 3, 0, 1]][..., ::-1]
    for k, e in enumerate(ag):
        pos[:, e] = np.where((mode == 2)[:, None], pos[:, e] + rng.normal(0, 0.05, (B, 2)), q[:, k])
    vel = np.zeros((B, E, 2))
    vel[:, ag] = rng.normal(0, 0.1, (B, 4, 2))
    force = np.zeros((B, E, 2))
    force[:, ag] = rng.normal(0, 0.3, (B, 4, 2))
    out = _np_state(st, pos, st.rot.detach().cpu().numpy(), vel, np.zeros((B, E)), force)
    d = np.stack([np.linalg.norm(pos[:, a.index] - pos[:, a.goal.index], axis=-1) for a in sc.world.agents], -1)
    f32 = lambda a: np.asarray(a, np.float32)
    out["scenario"].update(shaping=f32(d * sc.pos_shaping_factor + rng.normal(0, 0.01, (B, 4))),
                           reached_goal=rng.random(B) < 0.25)
    _pid_memory(out["scenario"], env, rng)
    return out


def pid_actions(env, rng):
    """Per policy agent ``[B, 2]`` actions (numpy) that drive every branch
    of the in-kernel PID, by env index mod 4: (0) below ``min_input_norm``
    (zeroed, and the memory reset); (1) beyond ``u_range``, so the clamp
    acts; (2, 3) uniform in the action space."""
    B = env.num_envs
    out = []
    for a in env.agents:
        rng_u = float(a.u_range)
        act = rng.uniform(-rng_u, rng_u, (B, 2))
        mode = np.arange(B) % 4
        ang = rng.uniform(-np.pi, np.pi, B)
        ring = np.stack([np.cos(ang), np.sin(ang)], -1)
        act[mode == 0] = (ring * rng.uniform(0.0, 0.05, B)[:, None])[mode == 0]
        act[mode == 1] = (ring * rng.uniform(1.05, 1.4, B)[:, None] * rng_u)[mode == 1]
        out.append(np.asarray(act, np.float32))
    return out


def pid_counts(world, fo, carry, act):
    """Over the PID-controlled agents and envs of the carry rows [R_in, B]
    and action rows [2A, B] of one rows step, how many (agent, env) lanes
    the ``u_range`` clamp (``clamp``), the ``min_input_norm`` zeroing
    (``min_input``), the memory reset (``reset``) and the integrator's
    windup cutoff (``cutoff``) act in, computed as ``fused.PidActRows``
    computes them."""
    pid = fo.process_act_rows
    E = len(world.entities)
    A = len(pid.slots)
    base = F.rows_layout(world, fo) - fo.n_ctrl
    counts = {"clamp": 0, "min_input": 0, "reset": 0, "cutoff": 0}
    for i, e in enumerate(pid.slots):
        ux, uy = act[i], act[A + i]
        if pid.u_range is not None:
            ux, uy, over = F.clamp_rows(ux, uy, pid.u_range)
            counts["clamp"] += int(over.sum())
        if pid.min_in is not None:
            small = F._norm(ux, uy) < pid.min_in
            counts["min_input"] += int(small.sum())
            ux, uy = torch.where(small, 0.0, ux), torch.where(small, 0.0, uy)
        reset = F._norm(ux, uy) < 1e-3
        counts["reset"] += int(reset.sum())
        dt, _, _, use_i, _, cutoff, _ = pid.params[i]
        if use_i and cutoff is not None:
            for c, v in ((0, 2 * E + e), (1, 3 * E + e)):
                acc = torch.where(reset, 0.0, carry[base + 4 * i + c])
                acc = acc + dt * ((ux if c == 0 else uy) - carry[v])
                counts["cutoff"] += int((acc.abs() > cutoff).sum())
    return counts


def transport_contact_state(env, rng):
    """A numpy state dict of a transport env in which every env is in
    contact: agents 0 and 1 side by side against the package's -x face,
    the other agents around it at contact range, the goal near the
    package; random rotations, velocities and forces (``chip_smoke.py``'s
    ``contact_rich``, made from a numpy generator)."""
    sc = env.scenario
    B, E = env.state.pos.shape[:2]
    pi, gi = sc.packages[0].index, sc.goal.index
    ai = [a.index for a in env.world.agents]
    pos = np.zeros((B, E, 2))
    pkg = rng.uniform(-0.8, 0.8, (B, 2))
    pos[:, pi] = pkg
    pos[:, gi] = pkg + rng.normal(0, 0.15, (B, 2))
    pos[:, ai[0]] = pkg + np.array([-0.1, 0.024]) + rng.normal(0, 0.004, (B, 2))
    pos[:, ai[1]] = pkg + np.array([-0.1, -0.024]) + rng.normal(0, 0.004, (B, 2))
    for a in ai[2:]:
        ang = rng.uniform(0, 2 * np.pi, B)
        r = 0.1 + rng.normal(0, 0.01, B)
        pos[:, a] = pkg + np.stack([np.cos(ang), np.sin(ang)], -1) * r[:, None]
    return _np_state(env.state, pos, rng.uniform(-3.14159, 3.14159, (B, E)), rng.normal(0, 0.3, (B, E, 2)),
                     rng.normal(0, 0.2, (B, E)), rng.normal(0, 0.5, (B, E, 2)))


def wind_flocking_state(env, rng):
    """A numpy state dict of a wind_flocking env: the pair about 1 m apart
    at any angle (so that the big agent is below the small one in about half
    of the envs, where its wind weakens), the agents 1-2 cm into each other's
    contact range in every 4th env, random velocities and forces, the big
    agent's wind a random share of the full wind and the small one's the
    full wind, the clock ``t`` between 0 and 11 (the energy and wind rewards
    start at 10 and 5), noisy shapings and random controller memory."""
    sc = env.scenario
    B, E = env.state.pos.shape[:2]
    st = env.state
    big, small = sc.big_agent.index, sc.small_agent.index
    ang = rng.uniform(-np.pi, np.pi, B)
    dist = rng.uniform(0.7, 1.3, B)
    touch = np.arange(B) % 4 == 3
    dist[touch] = 0.08 - rng.uniform(0.01, 0.02, int(touch.sum()))
    pos = np.zeros((B, E, 2))
    pos[:, small] = rng.uniform(-1.0, 1.0, (B, 2))
    pos[:, big] = pos[:, small] + dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    vel = rng.normal(0, 0.2, (B, E, 2))
    force = rng.normal(0, 0.5, (B, E, 2))
    out = _np_state(st, pos, np.zeros((B, E)), vel, np.zeros((B, E)), force)
    f32 = lambda a: np.asarray(a, np.float32)
    wind = st.dyn_gravity[0, small].detach().cpu().numpy()
    dg = np.zeros((B, E, 2))
    dg[:, big] = wind * rng.uniform(0.0, 1.0, (B, 1))
    dg[:, small] = wind
    out["dyn_gravity"] = f32(dg)
    scr = out["scenario"]
    scr["t"] = rng.integers(0, 12, B).astype(np.int32)
    for k in ("vel_shaping", "wind_shaping", "energy_shaping"):
        scr[k] = f32(np.abs(rng.normal(0.5, 0.3, (B, 2))))
    for k in ("distance_shaping", "pos_shaping", "rot_shaping"):
        scr[k] = f32(np.abs(rng.normal(0.3, 0.2, B)))
    _pid_memory(scr, env, rng)
    return out


def mpe_state(env, rng):
    """A numpy state dict of an MPE env (simple, simple_spread): entities
    uniform in [-1, 1]^2, with agent 1 0-10 cm from agent 0 in every other
    env (simple_spread's agents, of radius 0.15, then overlap), random
    velocities and forces."""
    B, E = env.state.pos.shape[:2]
    st = env.state
    pos = rng.uniform(-1.0, 1.0, (B, E, 2))
    ag = [a.index for a in env.world.agents]
    if len(ag) > 1:
        near = np.arange(B) % 2 == 0
        pos[near, ag[1]] = pos[near, ag[0]] + rng.uniform(-0.07, 0.07, (int(near.sum()), 2))
    return _np_state(st, pos, np.zeros((B, E)), rng.normal(0, 0.3, (B, E, 2)), np.zeros((B, E)),
                     rng.normal(0, 0.5, (B, E, 2)))


def mpe_family_state(env, rng):
    """A numpy state dict of an MPE world with teams, landmarks and comm
    (simple_push, simple_adversary, simple_tag, simple_reference,
    simple_speaker_listener, simple_world_comm, simple_crypto): entities
    uniform in [-1, 1]^2; in every other env each good agent at half to all
    of its catch distance from an adversary (simple_tag's and
    simple_world_comm's catches, the push's contact) and each landmark at
    half to all of its contact distance from an agent, the last agent first
    (simple_tag's obstacles, simple_world_comm's food eaten by the good
    agents); random velocities and forces; in a comm world the comm state
    and comm actions of every agent drawn in [0, 1) (silent agents keep
    their comm state through a step)."""
    st = env.state
    B, E = st.pos.shape[:2]
    pos = rng.uniform(-1.0, 1.0, (B, E, 2))
    near = np.arange(B) % 2 == 0
    n = int(near.sum())
    agents = env.world.agents
    advs = [a for a in agents if a.adversary]
    goods = [a for a in agents if not a.adversary]

    def put(e, ref):
        ang = rng.uniform(0.0, 2 * np.pi, n)
        d = rng.uniform(0.5, 1.0, n) * (e.shape.radius + ref.shape.radius)
        pos[near, e.index] = pos[near, ref.index] + np.stack([np.cos(ang), np.sin(ang)], -1) * d[:, None]

    if advs:
        for k, g in enumerate(goods):
            put(g, advs[k % len(advs)])
    for k, lm in enumerate(env.world.landmarks):
        put(lm, agents[-1 - k % len(agents)])
    out = _np_state(st, pos, np.zeros((B, E)), rng.normal(0, 0.3, (B, E, 2)), np.zeros((B, E)),
                    rng.normal(0, 0.5, (B, E, 2)))
    if env.world.dim_c:
        out["c"] = rng.uniform(0.0, 1.0, out["c"].shape).astype(np.float32)
        out["uc"] = rng.uniform(0.0, 1.0, out["uc"].shape).astype(np.float32)
    return out


def mpe_actions(env, rng):
    """Per-agent continuous actions of an MPE env: the physical ones in
    [-1, 1], then the comm ones of a speaking agent in [0, 1)."""
    B = env.num_envs
    acts = []
    for a in env.agents:
        u = rng.uniform(-1.0, 1.0, (B, a.action_size))
        w = env.get_agent_action_size(a) - a.action_size
        acts.append(np.concatenate([u, rng.uniform(0.0, 1.0, (B, w))], -1).astype(np.float32))
    return acts


def rt_vertex_lanes(tables, B, A, device, seed=5):
    """road_traffic sweep lanes [B, A] where first-min ties are exact:
    random paths and yaws, each agent on a vertex of its path's centre line
    (the even agents on the padded tail, points n-1 .. Mc-1) or of its left
    boundary. Returns (pid, pos on the centre line, pos on the left
    boundary, rot)."""
    g = torch.Generator(device=device).manual_seed(seed)
    NP, Mc = tables.center.shape[:2]
    pid = torch.randint(0, NP, (B, A), generator=g, device=device)
    n = tables.meta[pid, 0].long()
    u = torch.rand((B, A), generator=g, device=device)
    tail = torch.clamp(n - 1 + (u * (Mc - n + 1)).long(), max=Mc - 1)
    on = torch.where(torch.arange(A, device=device) % 2 == 0, tail, (u * n).long())
    rot = torch.rand((B, A), generator=g, device=device) * 6.283185307179586
    on_l = (u * tables.meta[pid, 1].long()).long()
    return pid, tables.center[pid, on].contiguous(), tables.left[pid, on_l].contiguous(), rot


def holonomic_state(env, rng):
    """A numpy state dict of one of the other holonomic worlds in which its
    contacts and events occur, in every other env where not said otherwise;
    random velocities, forces and (for rotating entities) angular
    velocities:

    * reverse_transport: the package anywhere and turned at random, each
      agent inside it, 0.4-0.9 of its contact distance (radius +
      LINE_MIN_DIST) from a random inner wall (box-sphere contacts); the
      goal inside the package, so that it is on the goal;
    * wheel: the line turned at random, each agent beside it at 0.3-0.9 of
      its contact distance (line-sphere contacts), agents 0 and 1 in
      contact with each other;
    * passage: the walls as the env's reset placed them, agent 0 on a wall's
      face at 0.3-0.9 of its contact distance and agent 1 0.5-0.9 of a
      diameter from agent 0 (wall and agent hits), in every fourth env each
      agent at rest and its goal within a tenth of a radius (done);
    * dispersion: the food anywhere, each agent within 0.2-0.9 of its eating
      range of a food item, a random share of the food already eaten (the
      scratch ``just_eaten`` zero, as every step leaves it);
    * dropout: agent 0 within 0.2-0.9 of its eating range of the goal, the
      goal already eaten in every fourth env;
    * het_mass: the agents anywhere."""
    sc, st = env.scenario, env.state
    B, E = st.pos.shape[:2]
    name = type(sc).__module__.rsplit(".", 1)[-1]
    near = np.arange(B) % 2 == 0
    n = int(near.sum())
    agents = env.world.agents
    pos = rng.uniform(-0.8, 0.8, (B, E, 2))
    rot = np.zeros((B, E))
    ang_vel = np.zeros((B, E))
    unit = lambda a: np.stack([np.cos(a), np.sin(a)], -1)
    scr = {}

    if name == "reverse_transport":
        pi, gi = sc.package.index, sc.goal.index
        rot[:, pi] = rng.uniform(-np.pi, np.pi, B)
        ang_vel[:, pi] = rng.normal(0, 0.2, B)
        c, s = np.cos(rot[:, pi]), np.sin(rot[:, pi])
        hl, hw = sc.package_length / 2, sc.package_width / 2
        for a in agents:
            dmin = a.shape.radius + LINE_MIN_DIST
            # a point on a random inner wall, in the package's frame, then
            # moved inwards by 0.4-0.9 of the contact distance
            side = rng.integers(0, 4, B)
            t = rng.uniform(-0.8, 0.8, B)
            d = dmin * rng.uniform(0.4, 0.9, B)
            lx = np.where(side < 2, np.where(side == 0, hl - d, -hl + d), t * hl)
            ly = np.where(side < 2, t * hw, np.where(side == 2, hw - d, -hw + d))
            rel = np.stack([c * lx - s * ly, s * lx + c * ly], -1)
            pos[:, a.index] = np.where(near[:, None], pos[:, pi] + rel, pos[:, a.index])
        pos[near, gi] = pos[near, pi] + rng.uniform(-0.1, 0.1, (n, 2))
    elif name == "wheel":
        li = sc.line.index
        pos[:, li] = 0.0
        pos[:, [e.index for e in env.world.landmarks]] = 0.0
        rot[:, li] = rng.uniform(-np.pi, np.pi, B)
        ang_vel[:, li] = rng.normal(0, 0.1, B)
        for a in agents:
            dmin = a.shape.radius + LINE_MIN_DIST
            along = rng.uniform(-0.9, 0.9, B) * sc.line_length / 2
            off = dmin * rng.uniform(0.3, 0.9, B) * rng.choice([-1.0, 1.0], B)
            p = unit(rot[:, li]) * along[:, None] + unit(rot[:, li] + np.pi / 2) * off[:, None]
            pos[:, a.index] = np.where(near[:, None], p, pos[:, a.index])
        a0, a1 = agents[0].index, agents[1].index
        pos[near, a1] = pos[near, a0] + unit(rng.uniform(0, 2 * np.pi, n)) * (
            rng.uniform(0.5, 0.9, n) * 2 * agents[0].shape.radius)[:, None]
    elif name == "passage":
        reset = st.pos.detach().cpu().numpy()
        for p in sc.passages:
            pos[:, p.index] = reset[:, p.index]
        walls = [p for p in sc.passages if p.collide]
        r = agents[0].shape.radius
        w = [walls[k].index for k in rng.integers(0, len(walls), B)]
        wx = reset[np.arange(B), w, 0]
        face = rng.choice([-1.0, 1.0], B)
        y = face * (sc.passage_width / 2 + (r + LINE_MIN_DIST) * rng.uniform(0.3, 0.9, B))
        x = np.clip(wx + rng.uniform(-0.4, 0.4, B) * sc.passage_length, -0.95, 0.95)
        a0, a1 = agents[0].index, agents[1].index
        pos[near, a0] = np.stack([x, y], -1)[near]
        pos[near, a1] = pos[near, a0] + unit(rng.uniform(0, 2 * np.pi, n)) * (
            rng.uniform(0.5, 0.9, n) * 2 * r)[:, None]
        on_goal = np.arange(B) % 4 == 1
        for a in agents:
            pos[on_goal, a.goal.index] = pos[on_goal, a.index] + rng.uniform(-0.1, 0.1, (int(on_goal.sum()), 2)) * r
        pos = np.clip(pos, -0.99, 0.99)
        scr["global_shaping"] = np.abs(rng.normal(50.0, 20.0, (B, len(agents)))).astype(np.float32)
    elif name == "dispersion":
        foods = env.world.landmarks
        F_ = len(foods)
        for a in agents:
            f = foods[rng.integers(0, F_)]
            reach = a.shape.radius + sc.food_radius
            pos[near, a.index] = pos[near, f.index] + unit(rng.uniform(0, 2 * np.pi, n)) * (
                rng.uniform(0.2, 0.9, n) * reach)[:, None]
        scr["eaten"] = rng.uniform(0, 1, (B, F_)) < 0.3
        scr["just_eaten"] = np.zeros((B, F_), bool)
    elif name == "dropout":
        gi, a0 = sc.goal.index, agents[0]
        reach = a0.shape.radius + sc.goal.shape.radius
        pos[near, a0.index] = pos[near, gi] + unit(rng.uniform(0, 2 * np.pi, n)) * (
            rng.uniform(0.2, 0.9, n) * reach)[:, None]
        scr["eaten"] = np.arange(B) % 4 == 2
    vel = rng.normal(0, 0.3, (B, E, 2))
    if name == "passage":
        # the agents at rest where their goals are within reach
        vel[np.ix_(np.arange(B) % 4 == 1, [a.index for a in agents])] = 0.0
    out = _np_state(st, pos, rot, vel, ang_vel, rng.normal(0, 0.5, (B, E, 2)))
    if name == "reverse_transport":
        d = np.linalg.norm(pos[:, sc.package.index] - pos[:, sc.goal.index], axis=-1)
        scr["global_shaping"] = (d * sc.shaping_factor + rng.normal(0, 1.0, B)).astype(np.float32)
    out["scenario"].update(scr)
    return out


def holonomic_events(env, y, extra):
    """The events one step of a holonomic world shows, from its output state
    rows ``y`` [9E, B] and emit rows ``extra`` [n_out, B] (the plain
    version's): reverse_transport's envs on the goal; passage's agent hits
    (ordered pairs closer than a diameter), wall hits (-pen / 10 less the
    agent hits) and envs done; dispersion's food items eaten this step;
    dropout's envs with the goal eaten."""
    fo = env._fused_outputs
    name = type(env.scenario).__module__.rsplit(".", 1)[-1]
    if name == "reverse_transport":
        return {"on_goal": int((extra[fo.base + 1] > 0.5).sum())}
    if name == "passage":
        E, A, ag = len(env.world.entities), fo.n_agents, fo.agent_i
        px, py = y[:E], y[E:2 * E]
        hits = 0
        for i in range(A):
            for j in range(A):
                if i != j:
                    d = F._norm(px[ag[min(i, j)]] - px[ag[max(i, j)]], py[ag[min(i, j)]] - py[ag[max(i, j)]])
                    hits += int(((d - fo.two_r) < 0).sum())
        pen = extra[fo.base + A:fo.base + 2 * A]
        walls = int(torch.round(-pen.sum() / 10)) - hits
        return {"agent_hits": hits, "wall_hits": walls, "done": int((extra[fo.base + 3 * A] > 0.5).sum())}
    if name == "dispersion":
        return {"food_eaten": int((extra[fo.o_hm:fo.o_hm + fo.n_food] > 0).sum())}
    if name == "dropout":
        return {"goal_eaten": int((extra[fo.base + 1] > 0.5).sum())}
    return {}


def rollout_path_and_reference(env, horizon, seed, obs_seed=0):
    """``rollout()`` on the env's state beside ``rollout_fn`` from the same
    state and generator seed, each started from the observation seed
    ``obs_seed``: ``(paths, traj, want)``, ``paths`` the rollout functions
    ``rollout()`` called (``["rows_rollout_fn"]`` where it took the rows
    path), ``traj`` its trajectory and ``want`` rollout_fn's. The env's
    state and step counts are left as they were."""
    import importlib

    # the module (the package exports a function of the same name)
    R = importlib.import_module("vmas_tpu_torch.parallel.rollout")

    paths = []
    originals = {n: getattr(R, n) for n in ("rollout_fn", "rows_rollout_fn")}
    for n, f in originals.items():
        setattr(R, n, lambda *a, _f=f, _n=n, **k: paths.append(_n) or _f(*a, **k))
    s0, st0 = env.state, env.steps
    try:
        env.scenario.obs_seed = obs_seed
        traj = R.rollout(env, horizon=horizon, generator=torch.Generator(device=env.device).manual_seed(seed))
    finally:
        for n, f in originals.items():
            setattr(R, n, f)
    env.scenario.obs_seed = obs_seed
    _, _, want = R.rollout_fn(env, horizon=horizon)(s0, st0, torch.Generator(device=env.device).manual_seed(seed))
    env.state, env.steps = s0, st0
    return paths, traj, want


def same_trajectory(a, b) -> bool:
    """Two rollouts' rewards, dones and observations, bitwise."""
    return (torch.equal(a["rewards"], b["rewards"]) and torch.equal(a["dones"], b["dones"])
            and all(torch.equal(x, y) for x, y in zip(a["obs"], b["obs"])))


# the standard deviation of the agents' offsets from their joints' anchors
# in the joint worlds' states (m)
JOINT_JITTER = 0.0005


def _bar_between(pos, rot, jl, a, b):
    """Pose a joint's bar ``jl`` between the ends ``a`` and ``b`` (its
    centre halfway, turned from a toward b), as ``Joint.sync`` does."""
    d = pos[:, b] - pos[:, a]
    pos[:, jl] = (pos[:, a] + pos[:, b]) / 2
    rot[:, jl] = np.arctan2(d[:, 1], d[:, 0])


def joint_worlds_state(env, rng):
    """A numpy state dict of one of the joint worlds (buzz_wire,
    ball_trajectory, ball_passage, joint_passage_size at any config) in
    which its contacts and events occur, by env index mod 4 where not said
    otherwise; each env's bodies moving together at a random small velocity,
    random small forces on the agents:

    * buzz_wire: the ball in the channel between the walls, (0) 0.1-0.5 of
      its contact distance (radius + LINE_MIN_DIST) from a wall, (1) as
      close to a floor (0.1-0.5 of it in both, the whole moving into the
      line at 0.3 m/s), (2) the goal within 3 mm of the ball (done), (3)
      0-3 cm off its contact distance from a wall and moving into it at
      0.3 m/s (ending the step in, beyond or short of the band where
      LINE_MIN_DIST decides a hit); the shaping scratch noisy;
    * ball_trajectory: the ball anywhere within the circle's reach, the
      agents at the joints' length from it, (0) turned about it until they
      overlap by 0.1-0.5 mm; the shaping scratch noisy;
    * ball_passage: the walls as the env's reset placed them, (0) agent 0
      and (1) the ball 0.3-0.9 of its contact distance from a wall's face,
      (2) the ball inside a wall (the overlap test's inner branch) or past
      the wall with the goal within 3 mm (done), (3) the ball out of the
      arena (done), agent 1 pushing the ball in both; the ball past the
      wall (y > 0) in every other env;
    * joint_passage_size: the map the reset chose, (0) the bar level
      under and (2) over the row of passages, the big agent 0.1-1 mm into
      its contact distance of the passages' faces, (1) the bar upright
      beside a side wall, the big agent as close to it, (3) both agents past the
      passages with ``passed`` 0 (just_passed) and the bar at rest on its
      goal, its ends on their anchors (done); the shaping scratch noisy, ``passed`` 100 in half the
      other envs.

    The agents (and joint_passage_size's mass) sit ``JOINT_JITTER`` off
    their anchors, so that the joints pull."""
    sc, st = env.scenario, env.state
    B, E = st.pos.shape[:2]
    name = type(sc).__module__.rsplit(".", 1)[-1]
    cpu = lambda t: t.detach().cpu().numpy().astype(np.float64)
    pos, rot = cpu(st.pos), cpu(st.rot)
    u = lambda lo, hi: rng.uniform(lo, hi, B)
    sign = lambda: rng.choice([-1.0, 1.0], B)
    unit = lambda a: np.stack([np.cos(a), np.sin(a)], -1)
    mode = np.arange(B) % 4
    agents = env.world.agents
    f32 = lambda a: np.asarray(a, np.float32)
    noise = lambda: rng.normal(0, 0.01, B)
    scr = {}

    if name in ("buzz_wire", "ball_trajectory"):
        bi = sc.ball.index
        r_b = sc.ball.shape.radius
        if name == "buzz_wire":
            wall_x = sc.agent_spacing / 4
            ball = np.stack([u(-0.05, 0.05), u(-0.8, 0.8)], -1)
            m = mode == 0
            s = sign()
            ball[m, 0] = (s * (wall_x - (r_b + LINE_MIN_DIST) * u(0.1, 0.5)))[m]
            # (3) the ball 0-3 cm off its contact distance from a wall and
            # moving into it at 0.3 m/s: it ends the step in, beyond or
            # short of the band where LINE_MIN_DIST decides the hit test
            m = mode == 3
            ball[m, 0] = (s * (wall_x - r_b - LINE_MIN_DIST - u(0.0, 0.03)))[m]
            th = u(-np.pi / 6, np.pi / 6)
            half = sc.agent_spacing / 2
        else:
            ball = rng.uniform(-0.5, 0.5, (B, 2))
            th = u(-np.pi, np.pi)
            half = sc.agent_spacing / 2
        if name == "buzz_wire":
            # the ball at a floor, 0.3-0.9 of its contact distance off it
            m = mode == 1
            ball[m, 1] = (sign() * (1 - (r_b + LINE_MIN_DIST) * u(0.1, 0.5)))[m]
        pos[:, bi] = ball
        ends = [ball - unit(th) * half, ball + unit(th) * half]
        if name == "ball_trajectory":
            # agent 1 turned about the ball toward agent 0 until the two
            # overlap by 0.5-3 mm, both joints at their length
            m = mode == 0
            gap = 2 * sc.agent_radius - u(0.0001, 0.0005)
            delta = 2 * np.arcsin(gap / (2 * half))
            ends[1][m] = (ball + unit(th + np.pi + delta) * half)[m]
        for a, p in zip(agents, ends):
            pos[:, a.index] = p
        for j, a in zip(sc.world._joint_objects, agents):
            _bar_between(pos, rot, j.landmark.index, a.index, bi)
        # the agents off their anchors by a fraction of a mm, so that the
        # joints pull (more makes the light bars spin fast, and their
        # angular velocities ill-conditioned)
        for a in agents:
            pos[:, a.index] += rng.normal(0, JOINT_JITTER, (B, 2))
        if name == "buzz_wire":
            gi = sc.goal.index
            pos[:, gi] = np.stack([u(-0.03, 0.03), u(-0.9, 0.9)], -1)
            m = mode == 2
            pos[m, gi] = ball[m] + rng.uniform(-0.003, 0.003, (int(m.sum()), 2))
    elif name == "ball_passage":
        reset = cpu(st.pos)
        bi, gi = sc.ball.index, sc.goal.index
        walls = [p for p in sc.passages if p.collide]
        w = [walls[k].index for k in rng.integers(0, len(walls), B)]
        wx = reset[np.arange(B), w, 0]
        face = sign()
        near = lambda r: face * (sc.passage_width / 2 + (r + LINE_MIN_DIST) * u(0.3, 0.9))
        x = np.clip(wx + u(-0.4, 0.4) * sc.passage_length, -0.95, 0.95)
        ball = rng.uniform(-0.8, 0.8, (B, 2))
        ball[:, 1] = np.abs(ball[:, 1]) * np.where(np.arange(B) % 2 == 0, 1.0, -1.0)
        m = mode == 1
        ball[m] = np.stack([x, near(sc.ball_radius)], -1)[m]
        m = (mode == 2) & (np.arange(B) % 8 == 2)
        ball[m] = np.stack([wx, u(-0.03, 0.03)], -1)[m]
        m = mode == 3
        ball[m, 0] = (sign() * (1 - sc.ball_radius + u(0.0, 0.01)))[m]
        pos[:, bi] = ball
        th = u(-np.pi, np.pi)
        half = sc.agent_spacing / 2
        pos[:, agents[0].index] = ball - unit(th) * half
        pos[:, agents[1].index] = ball + unit(th) * half
        m = mode == 0
        pos[m, agents[0].index] = np.stack([x, near(sc.agent_radius)], -1)[m]
        # agent 1 pushing the ball, 0.1-0.5 mm into its contact distance
        m = mode >= 2
        touch = sc.agent_radius + sc.ball_radius - u(0.0001, 0.0005)
        pos[m, agents[1].index] = (ball + unit(u(-np.pi, np.pi)) * touch[:, None])[m]
        pos[:, gi] = rng.uniform(-0.8, 0.8, (B, 2))
        m = (mode == 2) & (np.arange(B) % 8 == 6)
        pos[m, gi] = ball[m] + rng.uniform(-0.003, 0.003, (int(m.sum()), 2))
        pos = np.clip(pos, -1.0, 1.0)
        for p in sc.passages:
            pos[:, p.index] = reset[:, p.index]
        d_open = np.min(np.stack([np.linalg.norm(pos[:, bi] - pos[:, p.index], axis=-1)
                                  for p in sc.passages if not p.collide], -1), -1)
        scr["pos_shaping_pre"] = f32(d_open + noise())
        scr["pos_shaping_post"] = f32(np.linalg.norm(pos[:, bi] - pos[:, gi], axis=-1) + noise())
    elif name == "joint_passage_size":
        jl, gl = sc.joint.landmark.index, sc.goal.index
        a0, a1 = agents[0].index, agents[1].index
        r0, r1 = sc.agent_radius, sc.agent_radius_2
        half = sc.joint_length / 2
        cx, cy, th = u(-0.6, 0.6), u(-0.7, -0.3), u(-np.pi, np.pi)
        s = sign()
        # (0) level under the passages: the agents' tops in contact reach of
        # the boxes' lower faces
        m = mode == 0
        th[m] = u(-0.01, 0.01)[m]
        cy[m] = (-(sc.passage_width / 2 + r1 + LINE_MIN_DIST - u(0.0001, 0.001)))[m]
        # (1) upright beside the wall on side s
        m = mode == 1
        cx[m] = (s * (1 + sc.agent_radius - r1 - LINE_MIN_DIST + u(0.0001, 0.001)))[m]
        th[m] = (np.pi / 2 + u(-0.02, 0.02))[m]
        # (2) level over the row of passages, the agents' bottoms in contact
        # reach of the boxes' upper faces
        m = mode == 2
        th[m] = u(-0.01, 0.01)[m]
        cy[m] = (sc.passage_width / 2 + r1 + LINE_MIN_DIST - u(0.0001, 0.001))[m]
        # (3) both agents past the passages, on the goal
        m = mode == 3
        cy[m] = u(0.4, 0.6)[m]
        th[m] = u(-0.3, 0.3)[m]
        centre = np.stack([cx, cy], -1)
        along = unit(th)
        pos[:, a0] = centre - along * half
        pos[:, a1] = centre + along * half
        pos[:, jl], rot[:, jl] = centre, th
        if sc.asym_package:
            pos[:, sc.mass.index] = centre + along * (sc.mass_position * half)
        pos0 = pos.copy()
        pos[:, [a0, a1]] += rng.normal(0, JOINT_JITTER, (B, 2, 2))
        if sc.asym_package:
            pos[:, sc.mass.index] += rng.normal(0, JOINT_JITTER, (B, 2))
        pos[:, gl] = np.stack([u(-0.7, 0.7), u(0.3, 0.9)], -1)
        rot[:, gl] = u(-np.pi / 2, np.pi / 2)
        m = mode == 3
        pos[m, gl] = centre[m] + rng.uniform(-0.0005, 0.0005, (int(m.sum()), 2))
        rot[m, gl] = th[m] + u(-0.001, 0.001)[m]
        s0 = st.scenario
        pc = cpu(s0["pass_center"])
        d_pass = np.linalg.norm(pos[:, jl] - pc, axis=-1)
        scr["pos_shaping_pre"] = f32(d_pass + noise())
        scr["pos_shaping_post"] = f32(np.linalg.norm(pos[:, jl] - pos[:, gl], axis=-1) + noise())
        scr["rot_shaping_pre"] = f32(rng.normal(0, 0.5, B))
        scr["passed"] = f32(np.where(mode == 3, 0.0, rng.choice([0.0, 100.0], B)))
        scr["t"] = f32(rng.integers(0, 50, B))
        for a in agents:
            scr[f"__vel_ctrl_{a.name}"] = {
                "accum_errs": f32(rng.normal(0, 0.01, (B, 2))), "prev_err": f32(rng.normal(0, 0.1, (B, 2))),
            }

    # each env's bodies moving together (a joint's ends at one velocity, its
    # bar not turning), with a little spread: a light bar between two stiff
    # constraints turns fast from any difference
    movable = [e.index for e in env.world.entities if e.movable]
    vel = np.zeros((B, E, 2))
    vel[:, movable] = rng.normal(0, 0.05, (B, 1, 2)) + rng.normal(0, 0.002, (B, len(movable), 2))
    ang_vel = np.zeros((B, E))
    ang_vel[:, [a.index for a in agents]] = rng.normal(0, 0.1, (B, len(agents)))
    force = np.zeros((B, E, 2))
    force[:, [a.index for a in agents]] = rng.normal(0, 0.3, (B, len(agents), 2))
    if name == "buzz_wire":
        # the assembly moving at 0.3 m/s into the line it touches, so that
        # the ball still overlaps it after the step's push back
        push = np.zeros((B, 2))
        push[mode == 0, 0] = np.sign(pos[mode == 0, sc.ball.index, 0]) * 0.3
        push[mode == 1, 1] = np.sign(pos[mode == 1, sc.ball.index, 1]) * 0.3
        push[mode == 3, 0] = np.sign(pos[mode == 3, sc.ball.index, 0]) * 0.3
        vel[:, movable] += push[:, None]
    if name == "joint_passage_size":
        # the bar at rest on its goal, its ends on their anchors, so that it
        # stays done through a step
        rest = mode == 3
        vel[rest], ang_vel[rest], force[rest] = 0.0, 0.0, 0.0
        ends = [a0, a1] + ([sc.mass.index] if sc.asym_package else [])
        pos[np.ix_(rest, ends)] = pos0[np.ix_(rest, ends)]
    out = _np_state(st, pos, rot, vel, ang_vel, force)
    if name == "buzz_wire":
        d = np.linalg.norm(pos[:, sc.ball.index] - pos[:, sc.goal.index], axis=-1)
        scr["pos_shaping"] = f32(d + noise())
    if name == "ball_trajectory":
        for k in ("pos_shaping", "speed_shaping", "dist_shaping"):
            scr[k] = f32(np.abs(rng.normal(0.5, 0.3, B)))
    out["scenario"].update(scr)
    return out


def asym_joint_state(env, rng):
    """A numpy state dict of an asym_joint env: the bar anywhere and turned
    at random, its ends and the mass ``JOINT_JITTER`` off their anchors
    (every joint pulls), random small velocities and forces."""
    sc, st = env.scenario, env.state
    B, E = st.pos.shape[:2]
    pos = np.zeros((B, E, 2))
    rot = np.zeros((B, E))
    jl = sc.joint.landmark.index
    th = rng.uniform(-np.pi, np.pi, B)
    along = np.stack([np.cos(th), np.sin(th)], -1)
    centre = rng.uniform(-0.5, 0.5, (B, 2))
    half = sc.joint_length / 2
    pos[:, jl], rot[:, jl] = centre, th
    a0, a1 = (a.index for a in env.world.agents)
    pos[:, a0] = centre - along * half
    pos[:, a1] = centre + along * half
    if sc.asym_package:
        pos[:, sc.mass.index] = centre + along * (sc.mass_position * half)
    movable = [e.index for e in env.world.entities if e.movable]
    pos[:, movable] += rng.normal(0, JOINT_JITTER, (B, len(movable), 2))
    vel = np.zeros((B, E, 2))
    vel[:, movable] = rng.normal(0, 0.02, (B, len(movable), 2))
    ang_vel = np.zeros((B, E))
    ang_vel[:, movable] = rng.normal(0, 0.1, (B, len(movable)))
    out = _np_state(st, pos, rot, vel, ang_vel, rng.normal(0, 0.3, (B, E, 2)))
    out["scenario"]["rot_shaping_pre"] = np.asarray(rng.normal(0, 0.5, B), np.float32)
    return out


def joint_worlds_events(env, extra, y=None):
    """The events one step of a joint world shows, from its emit rows
    ``extra`` [n_out, B] (the plain version's) and, where given, its output
    state rows ``y`` [9E, B]: buzz_wire's line hits (its penalty over -10),
    envs done and (with ``y``) the (collidable, line) pairs that end the
    step in the band between touching the line and its contact distance,
    where LINE_MIN_DIST decides the hit test; ball_passage's box hits (its
    penalty over -0.06) and envs done; joint_passage_size's just_passed
    and done."""
    fo = env._fused_outputs
    name = type(env.scenario).__module__.rsplit(".", 1)[-1]
    base = fo.base
    if name == "buzz_wire":
        out = {"line_hits": int(torch.round(extra[base + 2] / fo.coll_pen).sum()),
               "done": int((extra[base + 5] > 0.5).sum())}
        if y is not None:
            E = len(env.world.entities)
            px, py, rot = y[:E], y[E:2 * E], y[4 * E:5 * E]
            band = 0
            for ci, r in fo.coll:
                for li, half in fo.lines:
                    cx, cy = F._closest_point_line(px[li], py[li], torch.cos(rot[li]), torch.sin(rot[li]), half,
                                                   px[ci], py[ci])
                    d = F._norm(px[ci] - cx, py[ci] - cy)
                    band += int(((d - r >= 0) & (d - LINE_MIN_DIST - r < 0)).sum())
            out["line_band"] = band
        return out
    if name == "ball_passage":
        return {"box_hits": int(torch.round(extra[base + 2] / fo.coll_pen).sum()),
                "done": int((extra[base + 5] > 0.5).sum())}
    if name == "joint_passage_size":
        return {"just_passed": int((extra[base + 7] > 0.5).sum()), "done": int((extra[base + 8] > 0.5).sum())}
    return {}


def sensor_state(env, rng):
    """A numpy state dict of a sensor world in which its events occur, in
    every other env where not said otherwise; random velocities and forces:

    * navigation: agent 1 0.5-3 mm clear of agent 0, moving and pushed with
      it (collision penalties, each in the other's Lidar); in every fourth env
      every agent at rest with its goal within 0.3 of the goal's radius (on
      goal, all reached, done); the previous shapings random;
    * flocking: agent 1 and the target 0.5-3 mm clear of agent 0, moving
      and pushed with it (collisions, the target's share dropped), agent 2
      0.05-0.15 from an obstacle's surface (its Lidar hits); the clock a
      random whole number of steps, the previous shapings random;
    * discovery: agents 0 and 1 0.12-0.2 from target 0 (covered, covering
      agents, in their target Lidar's range), agent 3 0.5-3 mm clear of
      agent 2, moving and pushed with it (collision penalties)."""
    sc, st = env.scenario, env.state
    B, E = st.pos.shape[:2]
    name = type(sc).__module__.rsplit(".", 1)[-1]
    near = np.arange(B) % 2 == 0
    n = int(near.sum())
    agents = env.world.agents
    pos = rng.uniform(-0.8, 0.8, (B, E, 2))
    vel = rng.normal(0, 0.3, (B, E, 2))
    unit = lambda a: np.stack([np.cos(a), np.sin(a)], -1)
    force = rng.normal(0, 0.5, (B, E, 2))
    beside = lambda at, dist: pos[near, at] + unit(rng.uniform(0, 2 * np.pi, n)) * dist[:, None]

    def touching(a, b):
        # b just clear of a (within the collision distance), with a's
        # velocity and force
        pos[near, b.index] = beside(a.index, a.shape.radius + b.shape.radius + rng.uniform(5e-4, 3e-3, n))
        vel[near, b.index], force[near, b.index] = vel[near, a.index], force[near, a.index]

    scr = {}

    if name == "navigation":
        touching(agents[0], agents[1])
        rest = np.arange(B) % 4 == 1
        for a in agents:
            g = a.goal.index
            pos[rest, g] = pos[rest, a.index] + unit(rng.uniform(0, 2 * np.pi, int(rest.sum()))) * (
                rng.uniform(0, 0.3, int(rest.sum())) * a.goal.shape.radius)[:, None]
            vel[rest, a.index] = 0.0
        scr["pos_shaping"] = rng.uniform(0.0, 2.0, (B, len(agents))).astype(np.float32)
    elif name == "flocking":
        policy, target = env.world.policy_agents, sc._target
        r = policy[0].shape.radius
        touching(policy[0], policy[1])
        touching(policy[0], target)
        ob = sc.obstacles[0]
        pos[near, policy[2].index] = beside(ob.index, ob.shape.radius + r + rng.uniform(0.05, 0.15, n))
        vel[:, [o.index for o in sc.obstacles]] = 0.0
        scr["t"] = rng.integers(0, 500, B).astype(np.float32)
        scr["distance_shaping"] = rng.uniform(0.0, 0.5, (B, len(policy))).astype(np.float32)
    elif name == "discovery":
        t0 = sc._targets[0]
        for a in agents[:2]:
            pos[near, a.index] = beside(t0.index, rng.uniform(0.12, 0.2, n))
        touching(agents[2], agents[3])
        vel[:, [t.index for t in sc._targets]] = 0.0
    pos = np.clip(pos, -0.99, 0.99)
    out = _np_state(st, pos, np.zeros((B, E)), vel, np.zeros((B, E)), force)
    out["scenario"].update(scr)
    return out


def sensor_events(env, y, extra):
    """The events of one step of a sensor world, from its output state rows
    ``y`` [9E, B] and emit rows ``extra`` [n_out, B] (the plain version's):
    navigation's agents on their goal, collision hits and envs done;
    flocking's collision hits; discovery's covered targets, covering agents
    and (with a penalty) collision hits."""
    fo = env._fused_outputs
    name = type(env.scenario).__module__.rsplit(".", 1)[-1]
    E = len(env.world.entities)
    px, py = y[:E], y[E:2 * E]
    if name == "navigation":
        A, base = fo.n_agents, fo.base
        on_goal = sum(int((F._norm(px[a] - px[g], py[a] - py[g]) < r).sum())
                      for a, g, r in zip(fo.agent_i, fo.goal_i, fo.goal_r))
        return {"on_goal": on_goal, "hits": int((extra[base + A:base + 2 * A] != 0).sum()),
                "done": int((extra[base + 3 * A + 1] > 0.5).sum())}
    if name == "flocking":
        A, base = fo.n_agents, fo.base
        return {"hits": int((extra[base:base + A] != 0).sum())}
    A, T = fo.n_agents, fo.n_targets
    out = {"covered": int((extra[5 * A:5 * A + T] > 0.5).sum()), "covering": int((extra[4 * A:5 * A] > 0).sum())}
    if fo.coll_pen != 0:
        out["hits"] = int((extra[5 * A + T + 1:6 * A + T + 1] != 0).sum())
    return out


def football_state(env, rng):
    """A numpy state dict of football in which its events occur, by env
    class (env index mod 8), with agents in the pitch at random, random
    velocities and forces, and every other env with an agent 0.5-3 mm clear
    of a wall (line-sphere contacts) and two agents touching:

    0. the ball just over the right goal line, inside the mouth (blue
       scores); 1. over the left line, inside the mouth (red scores);
    2. over the right line outside the mouth (no score);
    3. the ball at rest with no force, every agent at least 0.5 from it (the
       agent shaping live);
    4. the ball within the wall distance of the top or bottom edge, with a
       low vertical speed (the y impulse);
    5. the ball within the wall distance of an end, outside the mouth, with
       a low vertical speed (the x impulse);
    6. the ball within the wall distance of an end inside the mouth (its x
       impulse zeroed);
    7. the ball at random.

    The walls, goal parts and nets keep their reset poses; the previous
    shapings are random."""
    sc, st = env.scenario, env.state
    B, E = st.pos.shape[:2]
    pos = st.pos.cpu().numpy().astype(np.float64)
    rot = st.rot.cpu().numpy().astype(np.float64)
    vel = np.zeros((B, E, 2))
    force = np.zeros((B, E, 2))
    agents = [a for a in env.world.agents if a is not sc.ball]
    ai = [a.index for a in agents]
    hl, hw = sc.pitch_length / 2, sc.pitch_width / 2
    xs, ys = hl - sc.agent_size, hw - sc.agent_size
    pos[:, ai] = np.stack([rng.uniform(-xs, xs, (B, len(ai))), rng.uniform(-ys, ys, (B, len(ai)))], -1)
    vel[:, ai] = rng.normal(0, 0.1, (B, len(ai), 2))
    force[:, ai] = rng.normal(0, 0.05, (B, len(ai), 2))
    bi = sc.ball.index
    cls = np.arange(B) % 8
    sign = np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0)
    yg, dt = sc.goal_size / 2, sc.agent_size * 2
    bx = rng.uniform(-xs, xs, B)
    by = rng.uniform(-ys, ys, B)
    over = hl + sc.ball_size / 2 + rng.uniform(0.005, 0.03, B)
    bx = np.where(cls == 0, over, bx)
    bx = np.where(cls == 1, -over, bx)
    bx = np.where(cls == 2, over, bx)
    by = np.where((cls == 0) | (cls == 1), rng.uniform(-0.7, 0.7, B) * yg, by)
    by = np.where(cls == 2, sign * rng.uniform(yg + 0.05, ys, B), by)
    by = np.where(cls == 4, sign * (hw - rng.uniform(0.025, dt, B)), by)
    bx = np.where((cls == 5) | (cls == 6), sign * (hl - rng.uniform(0.02, dt - 0.005, B)), bx)
    by = np.where(cls == 5, np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0) * rng.uniform(yg + 0.05, ys, B), by)
    by = np.where(cls == 6, rng.uniform(-0.7, 0.7, B) * yg, by)
    pos[:, bi] = np.stack([bx, by], -1)
    bvel = rng.normal(0, 0.1, (B, 2))
    bvel[cls == 3] = 0.0
    vel[:, bi] = bvel
    force[:, bi] = np.where((cls == 3)[:, None], 0.0, rng.normal(0, 0.02, (B, 2)))
    # a resting ball at the centre spot, the agents within 0.5 of it moved
    # out along x
    rest = cls == 3
    pos[rest, bi] = 0.0
    px_ = pos[:, ai, 0]
    close = rest[:, None] & (np.abs(px_) < 0.6)
    pos[:, ai, 0] = np.where(close, np.where(px_ < 0, -1.0, 1.0) * rng.uniform(0.6, xs, px_.shape), px_)
    # every other env: agent 0 against the right top wall, agents 1 and 2
    # touching
    near = np.arange(B) % 2 == 1
    n = int(near.sum())
    wall = sc.walls["Right Top Wall"].index
    r0 = agents[0].shape.radius
    wy = pos[near, wall, 1]
    pos[near, ai[0]] = np.stack([hl - r0 - rng.uniform(5e-4, 3e-3, n),
                                 wy + rng.uniform(-0.2, 0.2, n)], -1)
    ang = rng.uniform(0, 2 * np.pi, n)
    d = agents[1].shape.radius + agents[2].shape.radius + rng.uniform(5e-4, 3e-3, n)
    pos[near, ai[2]] = pos[near, ai[1]] + np.stack([np.cos(ang), np.sin(ang)], -1) * d[:, None]
    out = _np_state(st, pos, rot, vel, np.zeros((B, E)), force)
    for key in ("pos_shaping_blue", "pos_shaping_red"):
        out["scenario"][key] = rng.uniform(5.0, 15.0, B).astype(np.float32)
    for key in ("pos_shaping_agent_blue", "pos_shaping_agent_red"):
        out["scenario"][key] = rng.uniform(0.0, 0.2, B).astype(np.float32)
    return out


def football_events(env, x, extra, hook=None):
    """The events of one football step, from the step's input rows ``x``
    [9E + ..., B] and its emit rows ``extra`` [n_out, B] (and, in the rows
    form, its hook rows ``hook`` [2, B], the ball's impulse): goals scored
    by each team, envs with the agent shaping live, envs done, and line-sphere
    contacts (the plain version's); with ``hook``, envs with a non-zero
    impulse and envs whose x impulse the goal mouth zeroed."""
    fo, sc = env._fused_outputs, env.scenario
    E = len(env.world.entities)
    o = fo.base
    out = {"blue_scores": int((extra[o] > 0).sum()), "red_scores": int((extra[o] < 0).sum()),
           "done": int((extra[o + 3] > 0.5).sum()),
           "agent_shaping": int(sum((extra[o + 4 + 5 * k + 1] != 0).sum() for k in range(fo.n_scratch_in // 2))),
           "ls": F.contact_counts(env.world, x)["ls"]}
    if hook is not None:
        bi = sc.ball.index
        px, py, vy = x[bi], x[E + bi], x[3 * E + bi]
        y_far = torch.full_like(py, sc.goal_size / 2 + 0.3)
        ax_raw = sc.ball_script.impulse(px, y_far, vy)[0]
        mouth = (py < sc.goal_size / 2) & (py > -sc.goal_size / 2)
        out["impulse"] = int(((hook[0] != 0) | (hook[1] != 0)).sum())
        out["x_zeroed"] = int((mouth & (ax_raw != 0)).sum())
    return out


DEBUG_WORLDS = ("diff_drive", "kinematic_bicycle", "drone", "goal", "vel_control", "circle_trajectory",
                "line_trajectory")


def debug_world_state(env, rng):
    """A numpy state dict of a dynamics or controller debug world
    (``DEBUG_WORLDS``) from a seeded generator: the first two agents in
    contact in every env (box-box for kinematic_bicycle, sphere-sphere for
    diff_drive and drone), random poses, velocities and spins; the drone's
    hidden state with its roll or pitch beyond 30 degrees in every other
    env; the controllers' memory, and the scenario's scratch, random."""
    sc, st = env.scenario, env.state
    name = type(sc).__module__.rsplit(".", 1)[-1]
    B, E = st.pos.shape[:2]
    agents = [a.index for a in env.world.agents]
    pos = np.zeros((B, E, 2))
    pos[:, agents] = rng.uniform(-1.0, 1.0, (B, len(agents), 2))
    for e in env.world.landmarks:
        pos[:, e.index] = rng.uniform(-1.0, 1.0, (B, 2))
    rot = np.zeros((B, E))
    rot[:, agents] = rng.uniform(-np.pi, np.pi, (B, len(agents)))
    if len(agents) > 1 and name in ("diff_drive", "kinematic_bicycle", "drone"):
        # the second agent within reach of the first: 0.08-0.095 between two
        # spheres of radius 0.05, 0.1-0.16 between two 0.2 x 0.1 boxes
        th = rng.uniform(-np.pi, np.pi, B)
        d = rng.uniform(0.1, 0.16, B) if name == "kinematic_bicycle" else rng.uniform(0.08, 0.095, B)
        pos[:, agents[1]] = pos[:, agents[0]] + np.stack([np.cos(th), np.sin(th)], -1) * d[:, None]
    vel = np.zeros((B, E, 2))
    vel[:, agents] = rng.normal(0, 0.4, (B, len(agents), 2))
    ang_vel = np.zeros((B, E))
    ang_vel[:, agents] = rng.normal(0, 0.5, (B, len(agents)))
    out = _np_state(st, pos, rot, vel, ang_vel, np.zeros((B, E, 2)))
    f32 = lambda a: np.asarray(a, np.float32)
    scratch = out["scenario"]
    if name == "drone":
        dyn = []
        for _ in env.world.agents:
            ds = np.concatenate([rng.uniform(-0.4, 0.4, (B, 3)), rng.normal(0, 0.5, (B, 3)),
                                 rng.normal(0, 0.3, (B, 3)), rng.normal(0, 0.5, (B, 3))], -1)
            tilt = np.arange(B) % 2 == 1  # roll or pitch 34-46 degrees
            n = int(tilt.sum())
            ds[tilt, rng.integers(0, 2)] = rng.choice([-1.0, 1.0], n) * rng.uniform(0.6, 0.8, n)
            dyn.append(f32(ds))
        out["dyn"] = dyn
    controllers = list(getattr(sc, "controllers", {}).values()) + ([sc.controller] if hasattr(sc, "controller") else [])
    for vc in controllers:
        scratch[vc.key] = {"accum_errs": f32(rng.normal(0, 0.1, (B, 2))), "prev_err": f32(rng.normal(0, 0.3, (B, 2)))}
    if name == "goal":
        scratch["pos_shaping"] = f32(rng.uniform(0, 3, B))
        pos[::4, sc.goal.index] = pos[::4, agents[0]] + 0.03  # on the goal: the reward's reached branch
        out["pos"] = f32(pos)
    if name == "line_trajectory":
        scratch["vel_action"] = f32(rng.normal(0, 1.0, (B, 2)))
    return out


def debug_world_actions(env, rng):
    """Per policy agent, actions ``[B, action_size]`` of up to twice its
    range (the controllers' commands beyond their clamp; the drone's
    torques at 1e-3 rather than its 1e-5 range, so that they turn it)."""
    B = env.num_envs
    out = []
    for a in env.agents:
        scale = 1e-3 if type(env.scenario).__module__.endswith("drone") else 2.0 * a.u_range_array
        out.append(np.asarray(rng.uniform(-1.0, 1.0, (B, a.action_size)) * scale, np.float32))
    return out


def debug_world_events(env, x):
    """The events of a debug world's fused step on its input state rows
    ``x`` [9E + J, B]: its contacts per pair type, the (env, agent) lanes
    with a non-zero torque row, and those whose force exceeds the agent's
    ``f_range`` in a component (the physics clamps it there: a controller
    asked for more)."""
    world = env.world
    E = len(world.entities)
    out = dict(F.contact_counts(world, x))
    idx = [a.index for a in world.agents]
    out["torque"] = int((x[8 * E:9 * E][idx] != 0).sum())
    clamped = 0
    for a in world.agents:
        if a.f_range is not None:
            over = (x[6 * E + a.index].abs() > a.f_range) | (x[7 * E + a.index].abs() > a.f_range)
            clamped += int(over.sum())
    out["clamped"] = clamped
    return out


# the DOTS and sampling worlds held to the JAX package and on the card: a
# name for each, its make_env name and kwargs (the defaults; painting also
# with task_type "full", its comm and knowledge mixing)
DOTS_WORLDS = {
    "painting": ("painting", {}),
    "painting_full": ("painting", {"task_type": "full"}),
    "construction": ("construction", {}),
    "sampling": ("sampling", {}),
}


def dots_world_state(env, rng):
    """A numpy state dict of a DOTS world (painting, construction) or of
    sampling from a seeded generator: in every env the first agent pressed
    0.5-4 mm into a wall (into the arena's bound in sampling, where the
    agents are 0.025 from it) and the second and third 0.5-4 mm into each
    other, the other agents and the landmarks at random, random
    velocities. Painting's scratch: random knowledge (each agent's mixed
    colour equal to its goal's expected one in every other env, where the
    agent then sits on that goal in every fourth), some seeking flags set,
    and a random comm state; sampling's: random Gaussian centres, a
    quarter of the grid's cells already sampled, and their ``max_pdf``."""
    sc, st = env.scenario, env.state
    name = type(sc).__module__.rsplit(".", 1)[-1]
    B, E = st.pos.shape[:2]
    agents = [a.index for a in env.world.agents if a.movable]
    f32 = lambda a: np.asarray(a, np.float32)
    pos = st.pos.detach().cpu().numpy().astype(np.float64)  # the walls where the reset put them
    if name == "sampling":
        lim, r = sc.x_semidim, sc.agent_radius
    else:
        lim, r = sc.arena_size / 2 - 0.05, sc.agent_radius
        for e in env.world.landmarks:
            if e not in env.world.walls:
                pos[:, e.index] = rng.uniform(-2.0, 2.0, (B, 2))
    pos[:, agents] = rng.uniform(-0.8 * lim, 0.8 * lim, (B, len(agents), 2))
    # agent 0 into a wall (sampling: onto the bound), on a side chosen per env
    side = rng.integers(0, 4, B)
    depth = rng.uniform(0.0005, 0.004, B)
    edge = (lim if name == "sampling" else lim - r) + depth
    axis, sign = side % 2, np.where(side < 2, -1.0, 1.0)
    pos[np.arange(B), agents[0], axis] = sign * edge
    # agents 1 and 2 into each other
    th = rng.uniform(-np.pi, np.pi, B)
    d = 2 * r - rng.uniform(0.0005, 0.004, B)
    pos[:, agents[2]] = pos[:, agents[1]] + np.stack([np.cos(th), np.sin(th)], -1) * d[:, None]
    rot = st.rot.detach().cpu().numpy()
    vel = np.zeros((B, E, 2))
    vel[:, agents] = rng.normal(0, 0.3, (B, len(agents), 2))
    out = _np_state(st, pos, rot, vel, np.zeros((B, E)), np.zeros((B, E, 2)))
    scratch = out["scenario"]
    if name == "painting":
        G = len(sc.goals)
        for g in sc.goals:
            scratch[g._ekey()] = f32(rng.uniform(0.01, 1.0, (B, 3)))
        for i, a in enumerate(sc.agent_list):
            k = rng.uniform(0.0, 1.0, (B,) + tuple(a.knowledge_shape))
            goal = sc.goals[i % G]
            match = np.arange(B) % 2 == 0
            k[match, 1] = scratch[goal._ekey()][match]
            scratch[a._kkey()] = f32(k)
            scratch[a._skey()] = rng.uniform(0, 1, B) < 0.25
            on = np.arange(B) % 4 == 0
            pos[on, goal.index] = pos[on, a.index] + rng.uniform(-0.05, 0.05, (int(on.sum()), 2))
        out["pos"] = f32(pos)
        if env.world.dim_c > 0:
            out["c"] = f32(rng.uniform(0.0, 1.0, out["c"].shape))
    if name == "sampling":
        locs = rng.uniform(-1.0, 1.0, (B, sc.n_gaussians, 2))
        scratch["locs"] = f32(locs)
        scratch["sampled"] = rng.uniform(0, 1, scratch["sampled"].shape) < 0.25
        scratch["max_pdf"] = sc._max_pdf(torch.as_tensor(f32(locs), device=st.device)).cpu().numpy()
    return out


def dots_world_actions(env, rng):
    """Per policy agent, actions ``[B, action width]``: u uniform in its
    range, then its comm action (where it speaks) uniform in [0, 1], so
    that about half the agents ask to mix colours."""
    B = env.num_envs
    out = []
    for a in env.agents:
        u = rng.uniform(-1.0, 1.0, (B, a.action_size)) * a.u_range_array
        width = env.get_agent_action_size(a)
        c = rng.uniform(0.0, 1.0, (B, width - a.action_size))
        out.append(np.asarray(np.concatenate([u, c], -1), np.float32))
    return out


def dots_world_events(env, x):
    """The contacts per pair type of a step's input state rows ``x``, and
    the (env, agent) lanes beyond the world's bounds (which the physics
    clamps: sampling's arena has no walls)."""
    world = env.world
    E = len(world.entities)
    out = dict(F.contact_counts(world, x))
    idx = [a.index for a in world.agents]
    beyond = torch.zeros((), dtype=torch.int64, device=x.device)
    if world.x_semidim is not None:
        beyond = beyond + (x[:E][idx].abs() > world.x_semidim).sum()
    if world.y_semidim is not None:
        beyond = beyond + (x[E:2 * E][idx].abs() > world.y_semidim).sum()
    out["beyond_bound"] = int(beyond)
    return out


def rt_events_state(env):
    """road_traffic's state with the events of maps 2 and 3 and testing
    mode placed, the distances recomputed there: agents 0 and 1 on each
    other (turned 0.3 rad apart) in the even envs; on map 3, agent 2 on its
    path's exit line in the envs 1 mod 4 and agent 3 on its entry line in
    the envs 3 mod 4, each along its path; on the whole map (whose paths
    are loops, with no entry or exit), agent 2 turned across its lane, over
    a boundary, in the envs 1 mod 4."""
    sc, st = env.scenario, env.state
    P = sc.P
    B, dev = st.batch_dim, st.device
    pos, rot, _ = (t.clone() for t in sc._agent_arrays(st))
    env_id = torch.arange(B, device=dev)
    even, one, three = env_id % 2 == 0, env_id % 4 == 1, env_id % 4 == 3
    pos[even, 1] = pos[even, 0] + 0.01
    rot[even, 1] = rot[even, 0] + 0.3
    pid = st.scenario["path_id"]
    if sc.map_type == "3":
        for m, i, line, at_end in ((one, 2, "exit", True), (three, 3, "entry", False)):
            p = pid[:, i]
            k = P["n_points"][p] - 2 if at_end else torch.ones_like(p)
            pos[m, i] = P[line][p].mean(1)[m]
            rot[m, i] = P["yaw"][p, k][m]
    else:
        rot[one, 2] = rot[one, 2] + torch.pi / 2
    idx = [a.index for a in env.world.agents]
    p_all, r_all = st.pos.clone(), st.rot.clone()
    p_all[:, idx], r_all[:, idx] = pos, rot
    state = st.replace(pos=p_all, rot=r_all)
    return state.replace(scenario=sc._update_distances(state, dict(state.scenario)))
