"""The plain reference of ``transport``: VMAS's transport scenario at its
defaults (4 holonomic agents of radius 0.03 and u_multiplier 0.6 push one
0.15 x 0.15 box package of mass 50 onto a goal disc of radius 0.15; dense
shaping reward, factor 100; VMAS, arXiv:2207.03530).

Its world table (the entities in the simulator's order, landmarks first),
the initial state the benchmark makes from a seed, and the observation,
reward and done rows of one step (a frozen copy of the port's plain
``TransportOutputs.emit``), in plain PyTorch. It imports nothing of the
port.
"""

from __future__ import annotations

import torch

from portbench.reference import physics as P

N_AGENTS = 4
AGENT_RADIUS = 0.03
U_MULTIPLIER = 0.6
PACKAGE = 0.15
PACKAGE_MASS = 50
GOAL_RADIUS = 0.15
SHAPING_FACTOR = 100
WORLD_SEMIDIM = 1
SEMIDIM = WORLD_SEMIDIM + 2 * AGENT_RADIUS + PACKAGE

AGENTS = [f"agent_{i}" for i in range(N_AGENTS)]
WORLD = {
    "dt": 0.1, "substeps": 1, "drag": 0.25, "collision_force": 100.0, "joint_force": 130.0,
    "x_semidim": SEMIDIM, "y_semidim": SEMIDIM,
    "entities": [
        {"name": "goal", "shape": ("sphere", GOAL_RADIUS), "mass": 1.0, "movable": False, "rotatable": False,
         "collide": False},
        {"name": "package 0", "shape": ("box", PACKAGE, PACKAGE), "mass": PACKAGE_MASS, "movable": True,
         "rotatable": False, "collide": True},
    ] + [
        {"name": a, "shape": ("sphere", AGENT_RADIUS), "mass": 1.0, "movable": True, "rotatable": True,
         "collide": True, "agent": True}
        for a in AGENTS
    ],
}
GOAL, PKG = 0, 1
ACT_SLOTS = [2 + i for i in range(N_AGENTS)]
OBS_W = 11
# rows of a step's emit: per agent its 11 observations, the reward, the
# package's on-goal flag and its new shaping, which the next step reads
N_OUT = N_AGENTS * OBS_W + 3
CARRY_EXTRA_IDX = (N_AGENTS * OBS_W + 2,)
REWARD_ROW = N_AGENTS * OBS_W
DONE_ROW = N_AGENTS * OBS_W + 1
ENTITY_NAMES = [e["name"] for e in WORLD["entities"]]
# the emit's operations per env besides writing its rows: about 200 for
# its one package (the distance to the goal, the box-disc overlap test's
# closest point on the box and its two distances, the shaping and reward)
EMIT_OPS = 200


def emit(ctx):
    """The step's rows after the physics: each agent's observation (pos,
    vel, package - goal, package - agent, package vel, on goal), the
    reward (the package's shaping gain while it is off the goal), on goal
    (the box-disc overlap test) and the new shaping."""
    px, py, vx, vy, rot = ctx["px"], ctx["py"], ctx["vx"], ctx["vy"], ctx["rot"]
    prev = ctx["scratch"]
    gx, gy = px[GOAL], py[GOAL]
    hw = hl = PACKAGE / 2
    dx, dy = px[PKG] - gx, py[PKG] - gy
    dist = P._norm(dx, dy)
    cos, sin = torch.cos(rot[PKG]), torch.sin(rot[PKG])
    cx, cy = P._closest_point_box(px[PKG], py[PKG], cos, sin, hw, hl, gx, gy)
    d_sphere_closest = P._norm(gx - cx, gy - cy)
    d_closest_box = P._norm(px[PKG] - cx, py[PKG] - cy)
    og = (dist < d_closest_box) | (d_sphere_closest < GOAL_RADIUS + P.LINE_MIN_DIST)
    shaping = dist * float(SHAPING_FACTOR)
    rew = torch.where(og, 0.0, prev[0] - shaping)
    rows = []
    for ai in ACT_SLOTS:
        rows += [px[ai], py[ai], vx[ai], vy[ai], px[PKG] - gx, py[PKG] - gy, px[PKG] - px[ai], py[PKG] - py[ai],
                 vx[PKG], vy[PKG], og.to(rew.dtype)]
    return rows + [rew, og.to(rew.dtype), shaping]


def unpack(extra):
    """Emit rows [..., N_OUT, B] -> (per-agent observations [..., B, 11],
    per-agent rewards [..., B], done [..., B])."""
    obs = tuple(extra[..., i * OBS_W:(i + 1) * OBS_W, :].transpose(-1, -2) for i in range(N_AGENTS))
    rew = extra[..., REWARD_ROW, :]
    done = extra[..., DONE_ROW, :] > 0.5
    return obs, tuple(rew for _ in range(N_AGENTS)), done


def _spawn(B, generator, device, n, min_dist, occupied=None, tries=16):
    """``n`` positions per env, uniform in the world's [-1, 1]^2, each the
    first of ``tries`` draws at least ``min_dist`` from the positions placed
    before it (the last draw where none is): VMAS's random spawn."""
    placed = [] if occupied is None else list(occupied.unbind(1))
    out = []
    for _ in range(n):
        cand = (torch.rand((tries, B, 2), generator=generator, device=device) * 2 - 1) * WORLD_SEMIDIM
        ok = torch.ones((tries, B), dtype=torch.bool, device=device)
        for q in placed:
            ok &= torch.linalg.vector_norm(cand - q, dim=-1) >= min_dist
        ok[-1] = True
        pick = cand[torch.argmax(ok.to(torch.int8), dim=0), torch.arange(B, device=device)]
        placed.append(pick)
        out.append(pick)
    return torch.stack(out, dim=1)


def initial_state(B, generator, device):
    """The first state, made from ``generator``: the agents spread at least
    two radii apart, then the goal and the package at least the package's
    circumscribed radius plus the goal's plus 0.01 from each other and the
    agents; everything at rest. Returns the per-entity fields [B, E, ...]
    and the scratch the first step reads (the package's shaping), with
    the flags the observations read."""
    E = len(WORLD["entities"])
    agents = _spawn(B, generator, device, N_AGENTS, 2 * AGENT_RADIUS)
    circum = (2 * (PACKAGE / 2) ** 2) ** 0.5
    goal_pkg = _spawn(B, generator, device, 2, circum + GOAL_RADIUS + 0.01, occupied=agents)
    pos = torch.cat([goal_pkg, agents], dim=1)
    zeros = lambda *s: torch.zeros((B, E) + s, dtype=torch.float32, device=device)
    rows = state_rows({"pos": pos, "vel": zeros(2), "rot": zeros(), "ang_vel": zeros(), "force": zeros(2),
                       "torque": zeros()}, torch.zeros((0, B), device=device))
    # the shaping and the on-goal flag of the initial state: the emit's
    # terms, read with a zero previous shaping
    ctx = {k: list(rows[i * E:(i + 1) * E]) for i, k in enumerate(("px", "py", "vx", "vy", "rot", "w"))}
    ctx["scratch"] = [torch.zeros((B,), device=device)]
    out = emit(ctx)
    og, shaping = out[-2] > 0.5, out[-1]
    return {
        "pos": pos, "vel": zeros(2), "rot": zeros(), "ang_vel": zeros(), "force": zeros(2), "torque": zeros(),
        "scenario": {"on_goal": og[:, None], "global_shaping": shaping[:, None],
                     "rew": torch.zeros((B,), device=device)},
    }


def scratch_rows(state):
    """The scratch rows a step reads: the package's previous shaping."""
    return state["scenario"]["global_shaping"].T


def observations(state):
    """Each agent's observation of ``state`` (the scenario's observation
    hook): pos, vel, package - goal, package - agent, package vel, on goal."""
    pos, vel = state["pos"], state["vel"]
    og = state["scenario"]["on_goal"][:, 0:1].to(torch.float32)
    return tuple(
        torch.cat([pos[:, a], vel[:, a], pos[:, PKG] - pos[:, GOAL], pos[:, PKG] - pos[:, a], vel[:, PKG], og], dim=-1)
        for a in ACT_SLOTS
    )


def state_rows(state, scratch):
    """The rows layout [9E + J + K, B]: px, py, vx, vy, rot, w, fx, fy, tq
    per entity, then the scratch rows (no joints here)."""
    pos, vel, force = state["pos"], state["vel"], state["force"]
    parts = [pos[..., 0].T, pos[..., 1].T, vel[..., 0].T, vel[..., 1].T, state["rot"].T, state["ang_vel"].T,
             force[..., 0].T, force[..., 1].T, state["torque"].T, scratch]
    return torch.cat(parts, dim=0).contiguous()
