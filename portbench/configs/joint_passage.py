"""The plain reference of ``joint_passage``: VMAS's joint_passage scenario at
its defaults (two agents of radius 0.03333 joined by a 0.5 bar, with a mass
of 5 at three quarters of the bar (asym_package, mass_ratio 5), carry the
bar through the one open slot of a wall of 0.1476 x 0.2 boxes (one fixed
passage) to a goal pose; 10 substeps, joint force 900, collision force
2500, drag 0.15; VMAS, arXiv:2207.03530).

Its world table (the entities in the simulator's order: the bar the joint
makes, the mass, the goal, four walls, 14 passage boxes, the agents), the
initial state the benchmark makes from a seed, and the observation, reward
and flag rows of one step (a frozen copy of the port's plain
``JointPassageOutputs.emit``), in plain PyTorch. It imports nothing of the
port.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import physics as P

AGENT_RADIUS = 0.03333
MASS_RADIUS = AGENT_RADIUS * (2 / 3)
JOINT_LENGTH = 0.5
MASS_RATIO = 5
MASS_POSITION = 0.75
PASSAGE_WIDTH = 0.2
PASSAGE_LENGTH = 0.1476
U_MULTIPLIER = 0.8
N_BOXES = int((2 * 1 + 2 * AGENT_RADIUS) // PASSAGE_LENGTH)  # 14
OPEN_SLOT = N_BOXES // 2  # fixed_passage: the one open slot
MIDDLE_ANGLE = math.pi / 2
BAR = "joint agent_0 agent_1"

# the bar collides only with the boxes beside the open slot
_NEIGHBOURS = [f"passage {OPEN_SLOT - 1}", f"passage {OPEN_SLOT + 1}"]
WORLD = {
    "dt": 0.1, "substeps": 10, "drag": 0.15, "collision_force": 2500.0, "joint_force": 900.0,
    "x_semidim": 1, "y_semidim": 1,
    "entities": [
        {"name": BAR, "shape": ("line", JOINT_LENGTH), "mass": 1.0, "movable": True, "rotatable": True,
         "collide": True, "filter": {"names": _NEIGHBOURS}},
        {"name": "mass", "shape": ("sphere", MASS_RADIUS), "mass": MASS_RATIO, "movable": True,
         "rotatable": False, "collide": True, "filter": {"not_shape": "sphere"}},
        {"name": "joint_goal", "shape": ("line", JOINT_LENGTH), "mass": 1.0, "movable": False, "rotatable": False,
         "collide": False},
    ] + [
        {"name": f"wall {i}", "shape": ("line", 2 + AGENT_RADIUS * 2), "mass": 1.0, "movable": False,
         "rotatable": False, "collide": True}
        for i in range(4)
    ] + [
        {"name": f"passage {i}", "shape": ("box", PASSAGE_LENGTH, PASSAGE_WIDTH), "mass": 1.0, "movable": False,
         "rotatable": False, "collide": i != OPEN_SLOT, "filter": {"not_shape": "box"}}
        for i in range(N_BOXES)
    ] + [
        {"name": f"agent_{i}", "shape": ("sphere", AGENT_RADIUS), "mass": 1.0, "movable": True,
         "rotatable": True, "collide": True, "agent": True, "f_range": 0.8}
        for i in range(2)
    ],
    # the joint's two rigid constraints holding the agents at the bar's
    # ends, and the mass's on the bar
    "joints": [
        {"a": BAR, "b": "agent_0", "anchor_a": (-1, 0), "anchor_b": (0, 0), "dist": 0.0},
        {"a": BAR, "b": "agent_1", "anchor_a": (1, 0), "anchor_b": (0, 0), "dist": 0.0},
        {"a": "mass", "b": BAR, "anchor_a": (0, 0), "anchor_b": (MASS_POSITION, 0), "dist": 0.0},
    ],
}
ENTITY_NAMES = [e["name"] for e in WORLD["entities"]]
# the emit's operations per env besides writing its rows: the two angle
# distances' fmods (4 x TRIG_OPS) and their 10 compares and subtractions
# with the 10 of the passage tests, the goal's cos and sin (2 x TRIG_OPS),
# 5 per open passage (its distance and minimum) and 30 for the shapings,
# rewards and flags: 4 * 20 + 20 + 2 * 20 + 5 + 30
EMIT_OPS = 175
JL, MASS, GOAL = 0, 1, 2
WALLS = [3, 4, 5, 6]
PASSAGES = list(range(7, 7 + N_BOXES))
OPEN = [PASSAGES[OPEN_SLOT]]
ACT_SLOTS = [7 + N_BOXES, 8 + N_BOXES]
J = len(WORLD["joints"])
OBS_W = 6 + 2 * len(OPEN) + 2
BASE = 2 * OBS_W
# per agent its observations; then rew, pos_rew, rot_rew, the four new
# shapings, passed, just_passed and done
N_OUT = BASE + 10
CARRY_EXTRA_IDX = tuple(BASE + 3 + k for k in range(5))
REWARD_ROW = BASE
DONE_ROW = BASE + 9


def _angle_dist(angle, goal):
    """|angle - goal| on angles mod pi, the nearer way round."""
    angle = torch.remainder(angle, math.pi)
    goal = torch.remainder(goal if isinstance(goal, torch.Tensor) else P.const(angle, goal), math.pi)
    return torch.minimum(
        torch.abs(angle - goal),
        torch.minimum(torch.abs(angle - (goal - math.pi)), torch.abs((angle - math.pi) - goal)),
    )


def emit(ctx):
    """The step's rows after the physics: the shaping rewards (the bar's
    distance to the open passage until it has passed, then to the goal;
    its angle to the vertical until both agents have passed, then to the
    goal's), each agent's observations (pos, vel, pos - goal, pos - the open
    passage, the goal's direction), the new shapings and the flags."""
    px, py, vx, vy, rot = ctx["px"], ctx["py"], ctx["vx"], ctx["vy"], ctx["rot"]
    pp_pre, pp_post, rp_pre, rp_post, passed = ctx["scratch"]
    jl, gi = JL, GOAL
    joint_passed = py[jl] > 0
    all_passed = None
    for ai in ACT_SLOTS:
        ok = py[ai] > PASSAGE_WIDTH / 2
        all_passed = ok if all_passed is None else (all_passed & ok)
    dist_pass = None
    for pi in OPEN:
        d = P._norm(px[jl] - px[pi], py[jl] - py[pi])
        dist_pass = d if dist_pass is None else torch.minimum(dist_pass, d)
    shaping = dist_pass * 1.0
    pos_rew = torch.where(~joint_passed, pp_pre - shaping, 0.0)
    pp_pre_new = shaping
    dist_goal = P._norm(px[jl] - px[gi], py[jl] - py[gi])
    shaping = dist_goal * 1.0
    pos_rew = pos_rew + torch.where(joint_passed, pp_post - shaping, 0.0)
    pp_post_new = shaping
    rot_passed = all_passed
    shaping = _angle_dist(rot[jl], MIDDLE_ANGLE) * 1.0
    rot_rew = torch.where(~rot_passed, rp_pre - shaping, 0.0)
    rp_pre_new = shaping
    dist_rot_goal = _angle_dist(rot[jl], rot[gi])
    shaping = dist_rot_goal * 1.0
    rot_rew = rot_rew + torch.where(rot_passed, rp_post - shaping, 0.0)
    rp_post_new = shaping
    rew = pos_rew + rot_rew
    just_passed = all_passed & (passed == 0)
    passed_new = torch.where(just_passed, 100.0, passed)
    done = (dist_goal <= 0.01) & (dist_rot_goal <= 0.01)
    rows = []
    for ai in ACT_SLOTS:
        rows += [px[ai], py[ai], vx[ai], vy[ai], px[ai] - px[gi], py[ai] - py[gi]]
        for pi in OPEN:
            rows += [px[ai] - px[pi], py[ai] - py[pi]]
        rows += [torch.cos(rot[gi]), torch.sin(rot[gi])]
    f = rew.dtype
    return rows + [rew, pos_rew, rot_rew, pp_pre_new, pp_post_new, rp_pre_new, rp_post_new, passed_new,
                   just_passed.to(f), done.to(f)]


def unpack(extra):
    """Emit rows [..., N_OUT, B] -> (per-agent observations [..., B, 10],
    per-agent rewards [..., B], done [..., B])."""
    obs = tuple(extra[..., i * OBS_W:(i + 1) * OBS_W, :].transpose(-1, -2) for i in range(2))
    rew = extra[..., REWARD_ROW, :]
    return obs, (rew, rew), extra[..., DONE_ROW, :] > 0.5


def _slot_x(i):
    return -1 - AGENT_RADIUS + PASSAGE_LENGTH / 2 + PASSAGE_LENGTH * i


def initial_state(B, generator, device):
    """The first state, made from ``generator``: the bar at a uniform angle
    below the wall of boxes, its centre uniform where the agents clear the
    world's edges and the wall, the agents at its ends and the mass on it;
    the goal pose uniform above the wall, its angle within pi/2 of the
    horizontal; the walls and boxes at their fixed places; everything at
    rest. Returns the per-entity fields [B, E, ...] and the scratch the
    first step reads (the four shapings and ``passed``)."""
    E = len(WORLD["entities"])
    dev = device
    u = torch.rand((B, 6), generator=generator, device=dev)
    start = (u[:, 0] * 2 - 1) * math.pi
    goal_angle = (u[:, 1] * 2 - 1) * (math.pi / 2)
    half = JOINT_LENGTH / 2
    sdx, sdy = half * torch.cos(start), half * torch.sin(start)
    gdx, gdy = half * torch.cos(goal_angle), half * torch.sin(goal_angle)
    lo_x_s, hi_x_s = -1 + AGENT_RADIUS + sdx.abs(), 1 - AGENT_RADIUS - sdx.abs()
    lo_y_s, hi_y_s = -1 + AGENT_RADIUS + sdy.abs(), -2 * AGENT_RADIUS - PASSAGE_WIDTH / 2 - sdy.abs()
    lo_x_g, hi_x_g = -1 + AGENT_RADIUS + gdx.abs(), 1 - AGENT_RADIUS - gdx.abs()
    lo_y_g, hi_y_g = 2 * AGENT_RADIUS + PASSAGE_WIDTH / 2 + gdy.abs(), 1 - AGENT_RADIUS - gdy.abs()
    centre = torch.stack([lo_x_s + (hi_x_s - lo_x_s) * u[:, 2], lo_y_s + (hi_y_s - lo_y_s) * u[:, 3]], -1)
    goal = torch.stack([lo_x_g + (hi_x_g - lo_x_g) * u[:, 4], lo_y_g + (hi_y_g - lo_y_g) * u[:, 5]], -1)
    delta = torch.stack([sdx, sdy], -1)

    pos = torch.zeros((B, E, 2), dtype=torch.float32, device=dev)
    rot = torch.zeros((B, E), dtype=torch.float32, device=dev)
    pos[:, JL], rot[:, JL] = centre, start
    pos[:, MASS] = centre + MASS_POSITION * delta
    pos[:, GOAL], rot[:, GOAL] = goal, goal_angle
    r = AGENT_RADIUS
    for i, e in enumerate(WALLS):
        x = 0.0 if i % 2 else (1 + r if i == 0 else -1 - r)
        y = 0.0 if not i % 2 else (1 + r if i == 1 else -1 - r)
        pos[:, e] = torch.tensor([x, y], dtype=torch.float32, device=dev)
        rot[:, e] = math.pi / 2 if not i % 2 else 0.0
    for i, e in enumerate(PASSAGES):
        pos[:, e, 0] = _slot_x(torch.tensor(float(i), device=dev))
    pos[:, ACT_SLOTS[0]] = centre - delta
    pos[:, ACT_SLOTS[1]] = centre + delta
    zeros = lambda *s: torch.zeros((B, E) + s, dtype=torch.float32, device=dev)
    state = {"pos": pos, "vel": zeros(2), "rot": rot, "ang_vel": zeros(), "force": zeros(2), "torque": zeros(),
             "joint_fixed_rot": torch.zeros((B, J), device=dev)}
    # the shapings of the initial state: the emit's terms, with zero
    # previous shapings
    rows = state_rows(state, torch.zeros((0, B), device=dev))
    ctx = {k: list(rows[i * E:(i + 1) * E]) for i, k in enumerate(("px", "py", "vx", "vy", "rot", "w"))}
    ctx["scratch"] = [torch.zeros((B,), device=dev)] * 5
    out = emit(ctx)
    zero = torch.zeros((B,), device=dev)
    state["scenario"] = {
        "pos_shaping_pre": out[BASE + 3], "pos_shaping_post": out[BASE + 4], "rot_shaping_pre": out[BASE + 5],
        "rot_shaping_post": out[BASE + 6], "passed": zero,
    }
    return state


def scratch_rows(state):
    s = state["scenario"]
    return torch.stack([s["pos_shaping_pre"], s["pos_shaping_post"], s["rot_shaping_pre"], s["rot_shaping_post"],
                        s["passed"]])


def state_rows(state, scratch):
    """The rows layout [9E + J + K, B]: px, py, vx, vy, rot, w, fx, fy, tq
    per entity, the joints' fixed rotations, then the scratch rows."""
    pos, vel, force = state["pos"], state["vel"], state["force"]
    parts = [pos[..., 0].T, pos[..., 1].T, vel[..., 0].T, vel[..., 1].T, state["rot"].T, state["ang_vel"].T,
             force[..., 0].T, force[..., 1].T, state["torque"].T, state["joint_fixed_rot"].T, scratch]
    return torch.cat(parts, dim=0).contiguous()
