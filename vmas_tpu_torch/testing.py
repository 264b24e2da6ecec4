"""Worlds and states that hold the fused step to its plain version.

Shared by chip_smoke.py (on the GPU) and the CPU tests (against the JAX
package): the all-pairs world, in which all six contact pair types occur,
a packed state of it in which every type touches, a balance state with
contacts of its four types, and the margin of balance's flags to their
thresholds. The states are numpy dicts made from a seeded generator, so
that both packages can load the same one.
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
