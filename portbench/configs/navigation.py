"""The plain reference of ``navigation``: VMAS's navigation scenario at its
defaults (4 holonomic sphere agents of radius 0.1, each with its own goal;
collisions on, so each agent carries a Lidar of 12 rays over the full
circle, range 0.35, that sees only the other agents; 2 substeps; a shared
reward: position shaping factor 1, final reward 0.01, collision penalty
-1; VMAS, arXiv:2207.03530).

Its world table (the entities in the simulator's order: the goals, then
the agents), the initial state the benchmark makes from a seed, and the
rows of one step: the goal terms, the collision penalties, the final
reward and done (a frozen copy of the port's plain
``NavigationOutputs.emit``, the rows the fused step writes), then each
agent's 12 Lidar distances from the step's positions and headings, as rows
after those. Plain PyTorch; it imports nothing of the port.

The Lidar is a frozen copy of the port's sphere ray cast
(``core/raycast.py`` ``cast_rays_to_sphere`` with its
``closest_point_line`` and guarded norm) and of ``Lidar.measure``'s angle
rule, which follow VMAS's ``Lidar`` and ``World._cast_ray_to_sphere``:
each ray's distance is the nearest of the other agents it hits in front
of it, or the range, and the observation is the range minus it. No matmul
is involved, so TF32 (off by default in PyTorch, and left so) does not
touch it. Departures from VMAS:

* the angles: ``linspace(0, 2 pi, 13)[:12]`` computed in float64 and
  rounded to float32, as the port's ``numpy.linspace(..., dtype=float32)``
  computes them; VMAS's ``torch.linspace`` in float32 gives rays 7 and 11
  one float32 step lower (2.4e-7 and 4.8e-7 rad);
* the norms are the port's guarded ``sqrt(x*x + y*y)``, where VMAS calls
  ``torch.linalg.vector_norm`` (the same value away from zero, where a ray
  test never needs it).

The initial headings are drawn uniform in [-pi, pi) (VMAS spawns the
agents at heading 0): a holonomic agent's heading moves nothing but its
Lidar's fan, and at 0 the fan's turn would go unchecked.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import physics as P

N_AGENTS = 4
AGENT_RADIUS = 0.1
GOAL_RADIUS = 0.05  # VMAS's default sphere: the goals' shape
U_MULTIPLIER = 1.0
N_RAYS = 12
LIDAR_RANGE = 0.35
POS_SHAPING_FACTOR = 1.0
FINAL_REWARD = 0.01
COLLISION_PENALTY = -1.0
MIN_COLLISION_DISTANCE = 0.005
SPAWN_DIST = AGENT_RADIUS * 2 + 0.05
WORLD_SEMIDIM = 1

AGENTS = [f"agent_{i}" for i in range(N_AGENTS)]
WORLD = {
    "dt": 0.1, "substeps": 2, "drag": 0.25, "collision_force": 100.0, "joint_force": 130.0,
    "x_semidim": None, "y_semidim": None,
    "entities": [
        {"name": f"goal {i}", "shape": ("sphere", GOAL_RADIUS), "mass": 1.0, "movable": False, "rotatable": False,
         "collide": False}
        for i in range(N_AGENTS)
    ] + [
        {"name": a, "shape": ("sphere", AGENT_RADIUS), "mass": 1.0, "movable": True, "rotatable": True,
         "collide": True, "agent": True}
        for a in AGENTS
    ],
}
ENTITY_NAMES = [e["name"] for e in WORLD["entities"]]
GOALS = list(range(N_AGENTS))
ACT_SLOTS = [N_AGENTS + i for i in range(N_AGENTS)]
# each pair of agents i > j that collide, in the port's loop order
PAIRS = [(i, j) for i in range(N_AGENTS) for j in range(N_AGENTS) if i > j]
OBS_W = 6
BASE = N_AGENTS * OBS_W
# the fused step's rows: per agent pos, vel and pos - goal; the per-agent
# position rewards, the collision penalties and the new shapings; then
# final_rew and done. The Lidar's N_AGENTS x N_RAYS distance rows follow
# them in the reference's rows alone
N_OUT = BASE + 3 * N_AGENTS + 2
CARRY_EXTRA_IDX = tuple(range(BASE + 2 * N_AGENTS, BASE + 3 * N_AGENTS))
# the first agent's position reward (the rewards are sums of rows)
REWARD_ROW = BASE
DONE_ROW = BASE + 3 * N_AGENTS + 1
LIDAR_ROW = N_OUT
# the fused step's emit's operations per env besides writing its rows, as
# the port's chip script counts them off csrc/fused_step.cu: 13 per agent
# (its goal terms), 13 per colliding pair, 3
EMIT_OPS = 13 * N_AGENTS + 13 * len(PAIRS) + 3

_ANGLES = {}


def _angles(ref):
    """The Lidar's ray angles [1, R] in ``ref``'s type on its device, made
    once (a step then creates no tensor from the host)."""
    key = (ref.dtype, str(ref.device))
    t = _ANGLES.get(key)
    if t is None:
        full = torch.linspace(0.0, 2 * math.pi, N_RAYS + 1, dtype=torch.float64)[:N_RAYS]
        t = _ANGLES[key] = full.to(ref.dtype).to(ref.device)[None, :]
    return t


def _safe_norm(vec):
    sq = torch.sum(vec * vec, dim=-1)
    is_zero = sq == 0.0
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))


def _closest_point_line(line_pos, line_rot, test_point_pos):
    """The closest point of the unbounded line through ``line_pos`` at
    angle ``line_rot`` to ``test_point_pos``."""
    d = torch.stack([torch.cos(line_rot), torch.sin(line_rot)], dim=-1)
    delta_pos = line_pos - test_point_pos
    dot_p = torch.sum(delta_pos * d, dim=-1)
    sign = torch.sign(dot_p)
    dist_from_center = torch.abs(dot_p)
    return line_pos - (sign * dist_from_center)[..., None] * d


def cast_rays_to_sphere(sphere_pos, radius, ray_origin, ray_direction, max_range):
    """Ray-sphere distances [B, N, R] of the spheres ``sphere_pos`` [B, N,
    2] of radius ``radius`` (a 0-d tensor) from ``ray_origin`` [B, 2] along
    the angles ``ray_direction`` [B, R]: the distance to the nearer crossing
    where the ray's line passes within the radius and the sphere's centre
    lies in front, else ``max_range``."""
    ro = ray_origin[:, None, None, :]
    rd = ray_direction[:, None, :]
    s_pos = sphere_pos[:, :, None, :]
    ray_dir_world = torch.stack([torch.cos(rd), torch.sin(rd)], dim=-1)
    line_pos = ro + ray_dir_world * (max_range / 2)
    line_rot = rd.expand(line_pos.shape[:-1])
    closest = _closest_point_line(line_pos, line_rot, s_pos)
    d = s_pos - closest
    d_norm = _safe_norm(d)
    ray_intersects = d_norm < radius
    a = radius**2 - d_norm**2
    m = torch.sqrt(torch.where(a > 0, a, torch.full_like(a, 1e-8)))
    u = s_pos - ro
    u1 = closest - ro
    sphere_is_in_front = torch.sum(u * ray_dir_world, dim=-1) > 0.0
    dist = _safe_norm(u1) - m
    return torch.where(ray_intersects & sphere_is_in_front, dist, torch.full_like(dist, max_range))


def lidar(px, py, rot):
    """Each agent's Lidar distances [B, R] from the rows of one state: its
    rays from its position at the fixed angles plus its heading, against
    the other agents, the nearest hit or the range."""
    pos = [torch.stack([px[a], py[a]], dim=-1) for a in ACT_SLOTS]  # [B, 2] each
    radius = P.const(px[0], AGENT_RADIUS)
    out = []
    for i, a in enumerate(ACT_SLOTS):
        angles = _angles(rot[a]) + rot[a][:, None]
        others = torch.stack([pos[j] for j in range(N_AGENTS) if j != i], dim=1)  # [B, A - 1, 2]
        d = cast_rays_to_sphere(others, radius, pos[i], angles, LIDAR_RANGE)
        dists = torch.cat([torch.full_like(angles, LIDAR_RANGE)[..., None], d.movedim(1, -1)], dim=-1)
        out.append(dists.min(dim=-1).values)
    return out


def emit(ctx):
    """The step's rows after the physics: each agent's observation (pos,
    vel, pos - goal), its position reward (the shaping's gain), the
    collision penalties (each pair within the minimum distance, the radii
    subtracted one at a time), the new shapings, the final reward (every
    agent on its goal) and done (every agent within its radius of its
    goal); then the agents' Lidar distances, ray by ray."""
    px, py, vx, vy = ctx["px"], ctx["py"], ctx["vx"], ctx["vy"]
    prev = ctx["scratch"]
    goal_rel = [(px[a] - px[g], py[a] - py[g]) for a, g in zip(ACT_SLOTS, GOALS)]
    dist = [P._norm(gx, gy) for gx, gy in goal_rel]
    shaping = [d * POS_SHAPING_FACTOR for d in dist]
    per_agent = [prev[i] - shaping[i] for i in range(N_AGENTS)]
    all_reached = None
    for i in range(N_AGENTS):
        og = dist[i] < GOAL_RADIUS
        all_reached = og if all_reached is None else (all_reached & og)
    final_rew = torch.where(all_reached, FINAL_REWARD, 0.0)
    coll = [torch.zeros_like(px[0]) for _ in range(N_AGENTS)]
    for i, j in PAIRS:
        ai, aj = ACT_SLOTS[i], ACT_SLOTS[j]
        d = P._norm(px[ai] - px[aj], py[ai] - py[aj]) - AGENT_RADIUS - AGENT_RADIUS
        hit = (d <= MIN_COLLISION_DISTANCE).to(px[0].dtype) * COLLISION_PENALTY
        coll[i] = coll[i] + hit
        coll[j] = coll[j] + hit
    done = None
    for i in range(N_AGENTS):
        d_ok = dist[i] < AGENT_RADIUS
        done = d_ok if done is None else (done & d_ok)
    rows = []
    for i, a in enumerate(ACT_SLOTS):
        rows += [px[a], py[a], vx[a], vy[a], goal_rel[i][0], goal_rel[i][1]]
    rows += per_agent + coll + shaping + [final_rew, done.to(px[0].dtype)]
    for d in lidar(px, py, ctx["rot"]):
        rows += list(d.unbind(-1))
    return rows


def _row_sum(rows):
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


def unpack(extra):
    """Rows [..., N_OUT + A x R, B] -> (per-agent observations [..., B, 18]:
    pos, vel, pos - goal and the range minus each ray's distance; per-agent
    rewards [..., B]: the shared position reward, the final reward and the
    agent's collision penalty; done [..., B])."""
    row = lambda r: extra[..., r, :]
    cols = lambda lo, hi: extra[..., lo:hi, :].transpose(-1, -2)
    obs = tuple(
        torch.cat([cols(i * OBS_W, (i + 1) * OBS_W),
                   LIDAR_RANGE - cols(LIDAR_ROW + i * N_RAYS, LIDAR_ROW + (i + 1) * N_RAYS)], dim=-1)
        for i in range(N_AGENTS)
    )
    pos_rew = _row_sum([row(BASE + i) for i in range(N_AGENTS)])
    final_rew = row(BASE + 3 * N_AGENTS)
    rews = tuple(pos_rew + final_rew + row(BASE + N_AGENTS + i) for i in range(N_AGENTS))
    return obs, rews, row(DONE_ROW) > 0.5


def _spawn(B, generator, device, n, occupied, tries=16):
    """``n`` positions per env, uniform in the world's [-1, 1]^2, each the
    first of ``tries`` draws at least ``SPAWN_DIST`` from the positions
    placed before it (the last draw where none is): the scenario's spawn
    rule, loop-free."""
    placed = list(occupied.unbind(1))
    out = []
    for _ in range(n):
        cand = (torch.rand((tries, B, 2), generator=generator, device=device) * 2 - 1) * WORLD_SEMIDIM
        ok = torch.ones((tries, B), dtype=torch.bool, device=device)
        for q in placed:
            ok &= torch.linalg.vector_norm(cand - q, dim=-1) >= SPAWN_DIST
        ok[-1] = True
        pick = cand[torch.argmax(ok.to(torch.int8), dim=0), torch.arange(B, device=device)]
        placed.append(pick)
        out.append(pick)
    return torch.stack(out, dim=1)


def initial_state(B, generator, device):
    """The first state, made from ``generator``: the agents, then their
    goals, each at least two radii plus 0.05 from those placed before it;
    the agents' headings uniform in [-pi, pi); everything at rest. Returns
    the per-entity fields [B, E, ...] and the scenario's scratch (the
    shapings the first step reads, and the rewards at zero)."""
    E = len(WORLD["entities"])
    agents = _spawn(B, generator, device, N_AGENTS, torch.zeros((B, 0, 2), device=device))
    goals = _spawn(B, generator, device, N_AGENTS, agents)
    heading = (torch.rand((B, N_AGENTS), generator=generator, device=device) * 2 - 1) * math.pi
    zeros = lambda *s: torch.zeros((B, E) + s, dtype=torch.float32, device=device)
    rot = zeros()
    rot[:, ACT_SLOTS] = heading
    rel = agents - goals
    shaping = torch.stack([P._norm(rel[:, i, 0], rel[:, i, 1]) * POS_SHAPING_FACTOR for i in range(N_AGENTS)], -1)
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.float32, device=device)
    return {
        "pos": torch.cat([goals, agents], dim=1), "vel": zeros(2), "rot": rot, "ang_vel": zeros(),
        "force": zeros(2), "torque": zeros(),
        "scenario": {"pos_shaping": shaping, "pos_rew_per_agent": z(N_AGENTS), "collision_rew": z(N_AGENTS),
                     "pos_rew": z(), "final_rew": z()},
    }


def scratch_rows(state):
    """The scratch rows a step reads: each agent's previous shaping."""
    return state["scenario"]["pos_shaping"].T


def state_rows(state, scratch):
    """The rows layout [9E + K, B]: px, py, vx, vy, rot, w, fx, fy, tq per
    entity, then the scratch rows (no joints here)."""
    pos, vel, force = state["pos"], state["vel"], state["force"]
    parts = [pos[..., 0].T, pos[..., 1].T, vel[..., 0].T, vel[..., 1].T, state["rot"].T, state["ang_vel"].T,
             force[..., 0].T, force[..., 1].T, state["torque"].T, scratch]
    return torch.cat(parts, dim=0).contiguous()
