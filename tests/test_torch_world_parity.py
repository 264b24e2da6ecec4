"""The port's physics step against the recorded reference trajectories of
tests/golden/data/world_cases.npz, as tests/test_world_parity.py holds the
JAX package's: the same ten worlds (free body with gravity and drag, two
colliding spheres, sphere and box, a line turned by contact, two boxes, box
and line, friction, the clamps, a line joint and a fixed-rotation joint),
constant action forces and torques written into the state before each
step, 25 steps of 8 envs, every entity's (pos, vel, rot, ang_vel)
trajectory within that file's tolerances (2e-3 where contacts or joints
act, 1e-4 elsewhere).

Each world steps on the plain physics and on the fused step (K1, its plain
version on the CPU).
"""

import os

import numpy as np
import pytest
import torch

from vmas_tpu_torch.core import Agent, Box, Joint, Landmark, Line, Sphere, World
from vmas_tpu_torch.core import fused as TF

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "golden", "data", "world_cases.npz")
B, T = 8, 25


def mk_world(name):
    """tests/test_world_parity.py's worlds, built with the port."""
    if name == "free_body":
        w = World(B, "cpu", gravity=(0.0, -0.05), drag=0.25)
        w.add_agent(Agent("a0", shape=Sphere(0.05), mass=2.0, gravity=(0.1, 0.0)))
        return w
    if name == "spheres_collide":
        w = World(B, "cpu")
        w.add_agent(Agent("a0", shape=Sphere(0.1), mass=1.0))
        w.add_agent(Agent("a1", shape=Sphere(0.15), mass=2.0))
        return w
    if name == "sphere_box":
        w = World(B, "cpu")
        w.add_agent(Agent("a0", shape=Sphere(0.05)))
        w.add_landmark(Landmark("box", shape=Box(length=0.3, width=0.2), movable=True, rotatable=True, mass=3.0))
        return w
    if name == "line_torque":
        w = World(B, "cpu")
        w.add_agent(Agent("a0", shape=Sphere(0.05)))
        w.add_landmark(Landmark("line", shape=Line(length=0.6), movable=True, rotatable=True, mass=1.5))
        return w
    if name == "boxes":
        w = World(B, "cpu")
        w.add_agent(Agent("a0", shape=Box(length=0.25, width=0.15), rotatable=True))
        w.add_landmark(Landmark("b2", shape=Box(length=0.3, width=0.1), movable=True, rotatable=True))
        return w
    if name == "box_line":
        w = World(B, "cpu")
        w.add_agent(Agent("a0", shape=Box(length=0.25, width=0.15), rotatable=True))
        w.add_landmark(Landmark("l", shape=Line(length=0.5), movable=True, rotatable=True))
        return w
    if name == "friction":
        w = World(B, "cpu", linear_friction=0.1, angular_friction=0.05)
        w.add_agent(Agent("a0", shape=Sphere(0.05), mass=1.5))
        return w
    if name == "clamps":
        w = World(B, "cpu", x_semidim=0.8, y_semidim=0.6)
        w.add_agent(Agent("a0", shape=Sphere(0.05), max_speed=0.7, f_range=0.4))
        w.add_agent(Agent("a1", shape=Sphere(0.05), v_range=0.3, max_f=0.5, collide=False))
        return w
    if name == "joint_line":
        w = World(B, "cpu", substeps=4)
        a0 = Agent("a0", shape=Sphere(0.05), mass=1.0)
        a1 = Agent("a1", shape=Sphere(0.05), mass=2.0)
        w.add_agent(a0)
        w.add_agent(a1)
        w.add_joint(Joint(a0, a1, anchor_a=(0, 0), anchor_b=(0, 0), dist=0.5, rotate_a=True, rotate_b=True))
        return w
    if name == "joint_fixed":
        w = World(B, "cpu", substeps=4)
        a0 = Agent("a0", shape=Sphere(0.05), rotatable=True)
        a1 = Agent("a1", shape=Sphere(0.05), rotatable=True)
        w.add_agent(a0)
        w.add_agent(a1)
        w.add_joint(Joint(a0, a1, anchor_a=(0, 0), anchor_b=(0, 0), dist=0.4, rotate_a=False, rotate_b=True))
        return w
    raise KeyError(name)


CASES = [
    "free_body", "spheres_collide", "sphere_box", "line_torque", "boxes",
    "box_line", "friction", "clamps", "joint_line", "joint_fixed",
]


@pytest.fixture(scope="module")
def gold():
    return np.load(DATA)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("name", CASES)
def test_world_parity(gold, name, fused):
    w = mk_world(name).finalize()
    w.fused = fused
    assert TF.supports(w)
    g = lambda k: torch.as_tensor(gold[f"{name}_{k}"])
    state = w.spawn_state().replace(pos=g("init_pos"), vel=g("init_vel"), rot=g("init_rot"),
                                    ang_vel=g("init_ang_vel"))
    state = w.sync_joints(state)
    idx = torch.as_tensor([a.index for a in w.agents])
    force, torque = g("force"), g("torque")
    traj = []
    for _ in range(T):
        f, tq = state.force.clone(), state.torque.clone()
        f[:, idx], tq[:, idx] = force, torque
        state = w.step(state.replace(force=f, torque=tq))
        traj.append(torch.cat([state.pos, state.vel, state.rot[..., None], state.ang_vel[..., None]], dim=-1))
    traj = torch.stack(traj).numpy()
    atol = 2e-3 if any(k in name for k in ("joint", "box", "line", "spheres")) else 1e-4
    np.testing.assert_allclose(traj, gold[f"{name}_traj"], atol=atol, err_msg=name)


def test_gradients_through_rollout(gold):
    """d(final pos)/d(force) through 5 plain physics steps of the colliding
    spheres is finite and non-zero, as tests/test_world_parity.py asks of
    the JAX package."""
    w = mk_world("spheres_collide").finalize()
    g = lambda k: torch.as_tensor(gold[f"spheres_collide_{k}"])
    state0 = w.spawn_state().replace(pos=g("init_pos"), vel=g("init_vel"), rot=g("init_rot"),
                                     ang_vel=g("init_ang_vel"))
    idx = torch.as_tensor([a.index for a in w.agents])
    force = g("force").clone().requires_grad_(True)
    state = state0
    for _ in range(5):
        f = state.force.clone()
        f[:, idx] = force
        state = w.step(state.replace(force=f))
    (grad,) = torch.autograd.grad((state.pos ** 2).sum(), force)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
