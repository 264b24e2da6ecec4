"""The port's fused step (vmas_tpu_torch/core/fused.py) against the JAX
package's Pallas kernel and physics.

The same contact-rich state, made from a seed with numpy, goes through the
JAX function and its counterpart in the port: the plain version of the
fused step against ``fused_physics_step`` (the Pallas kernel, in interpret
mode on the CPU), the plain rows step against ``make_rows_step``, and the
port's plain physics against ``physics_step``. Tolerances: state rows atol
1e-5 rtol 1e-5 (f32 reorder noise, as tests/test_fused.py); observation rows
atol 2e-5; the reward row atol 2e-3 (the shaping factor of 100 amplifies
position noise); on_goal rows exactly.
"""

import jax
import numpy as np
import pytest
import torch

import vmas_tpu
from vmas_tpu.core import fused as JF
from vmas_tpu.core import physics as JP
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core import physics as TP
from vmas_tpu_torch.interop import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

B = 7
STATE_ATOL = dict(atol=1e-5, rtol=1e-5)


def contact_rich(jenv, seed):
    """A numpy state dict in which agents touch the package and each other:
    agents 0 and 1 press side by side on the package's -length face, each
    other agent on one of the other faces; rotations, velocities and forces
    random. Agents sit off the box's corners, where the closest edge is a
    near tie that an ulp of cos/sin could flip, and off each other's
    centres, and move slowly, so that in a few steps none is kicked deep
    into the box: there the contact normal comes from the difference of two
    nearly equal points, and an ulp of cos/sin turns into a relative force
    error of 1e-4."""
    rng = np.random.default_rng(seed)
    st = jenv.state
    b, e = st.pos.shape[:2]
    sc = jenv.scenario
    package = sc.packages[0]
    gi, pi = sc.goal.index, package.index
    hl, hw = package.shape.length / 2, package.shape.width / 2
    rad = sc.agent_radius
    ai = [a.index for a in jenv.world.agents]
    rot = rng.uniform(-np.pi, np.pi, (b, e)).astype(np.float32)
    th = rot[:, pi].astype(np.float64)
    along_l = np.stack([np.cos(th), np.sin(th)], -1)  # the box's length axis
    along_w = np.stack([-np.sin(th), np.cos(th)], -1)
    pos = np.zeros((b, e, 2), np.float32)
    pkg = rng.uniform(-0.8, 0.8, (b, 2))
    pos[:, pi] = pkg
    pos[:, gi] = pkg + rng.normal(0, 0.15, (b, 2))

    def press(normal, half, tangent, t):
        depth = half + rad - rng.uniform(0.0, 0.004, (b, 1))
        return pkg + normal * depth + tangent * t

    pos[:, ai[0]] = press(-along_l, hl, along_w, 0.024)
    pos[:, ai[1]] = press(-along_l, hl, along_w, -0.024)
    faces = [(along_l, hl, along_w, hw), (along_w, hw, along_l, hl), (-along_w, hw, along_l, hl)]
    for k, a in enumerate(ai[2:]):
        normal, half, tangent, other = faces[k % 3]
        pos[:, a] = press(normal, half, tangent, rng.uniform(-0.6, 0.6, (b, 1)) * other)
    arrays = {
        "pos": pos,
        "vel": rng.normal(0, 0.05, (b, e, 2)).astype(np.float32),
        "rot": rot,
        "ang_vel": rng.normal(0, 0.2, (b, e)).astype(np.float32),
        "force": rng.normal(0, 0.5, (b, e, 2)).astype(np.float32),
        "torque": rng.normal(0, 0.2, (b, e)).astype(np.float32),
        "c": np.asarray(st.c), "uc": np.asarray(st.uc),
        "u": [np.asarray(u) for u in st.u],
        "joint_fixed_rot": np.asarray(st.joint_fixed_rot),
        "rendering": np.asarray(st.rendering),
    }
    d = np.linalg.norm(pos[:, pi] - pos[:, gi], axis=-1)
    arrays["scenario"] = {
        "on_goal": np.zeros((b, 1), bool),
        "global_shaping": (d[:, None] * 100 + rng.normal(0, 1, (b, 1))).astype(np.float32),
        "rew": np.zeros(b, np.float32),
    }
    return arrays


def jax_state(jenv, arrays):
    import jax.numpy as jnp

    kw = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("u", "scenario")}
    return jenv.state.replace(
        **kw,
        u=tuple(jnp.asarray(u) for u in arrays["u"]),
        scenario={k: jnp.asarray(v) for k, v in arrays["scenario"].items()},
    )


def assert_contacts(tenv, state):
    """Some sphere-sphere and some box-sphere penalty forces are non-zero,
    so the comparisons exercise both contact types."""
    ks = TF.KernelSpec(tenv.world)
    px, py = state.pos[..., 0].T, state.pos[..., 1].T
    n_ss = sum(
        int((TF._constraint_force(ks.cm, px[a], py[a], px[b], py[b], dmin, ks.cf)[0] != 0).sum())
        for a, b, dmin in ks.ss
    )
    zf = torch.zeros_like(state.force)
    forces, _ = TP._environment_forces(tenv.world, state.replace(pos=state.pos), zf, zf[..., 0])
    pkg = tenv.scenario.packages[0].index
    n_bs = int((forces[:, pkg] != 0).any(-1).sum())
    assert n_ss > 0 and n_bs > 0, f"vacuous state: {n_ss} ss and {n_bs} bs contacts"


def make_pair(n_agents, fused=True, num_envs=B):
    jenv = vmas_tpu.make_env("transport", num_envs, seed=0, n_agents=n_agents, fused_physics=fused)
    tenv = torch_make_env("transport", num_envs, device="cpu", seed=0, n_agents=n_agents, fused_physics=fused)
    return jenv, tenv


def compare_rows(t_out, j_out, E, A, obs_w, what):
    """Compare [9E + n_out, B] style rows group by group."""
    t_out, j_out = np.asarray(t_out), np.asarray(j_out)
    np.testing.assert_allclose(t_out[: 9 * E], j_out[: 9 * E], **STATE_ATOL, err_msg=f"{what}: state rows")
    base = 9 * E
    obs = slice(base, base + A * obs_w)
    np.testing.assert_allclose(t_out[obs], j_out[obs], atol=2e-5, rtol=1e-5, err_msg=f"{what}: obs rows")
    r = base + A * obs_w
    np.testing.assert_allclose(t_out[r], j_out[r], atol=2e-3, err_msg=f"{what}: reward row")
    np.testing.assert_array_equal(t_out[r + 1], j_out[r + 1], err_msg=f"{what}: on_goal row")
    np.testing.assert_allclose(t_out[r + 2:], j_out[r + 2:], atol=2e-3, err_msg=f"{what}: shaping rows")


@pytest.mark.parametrize("n_agents", [3, 4])
def test_fused_step_plain_matches_pallas(n_agents):
    jenv, tenv = make_pair(n_agents)
    arrays = contact_rich(jenv, seed=10 + n_agents)
    js = jax_state(jenv, arrays)
    ts = state_from_numpy(tenv.world, arrays)
    assert_contacts(tenv, ts)

    jfo, tfo = jenv._fused_outputs, tenv._fused_outputs
    j_state, j_extra = jax.jit(lambda s: jenv.world.step_with_outputs(s, jfo))(js)
    t_state, t_extra = tenv.world.step_with_outputs(ts, tfo)

    E = len(tenv.world.entities)
    for name in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)), **STATE_ATOL, err_msg=name
        )
    j_rows = np.concatenate([np.zeros((9 * E, B), np.float32), np.asarray(j_extra)])
    t_rows = np.concatenate([np.zeros((9 * E, B), np.float32), t_extra.numpy()])
    compare_rows(t_rows, j_rows, E, n_agents, tfo.obs_w, "fused step")


@pytest.mark.parametrize("n_agents", [3, 4])
def test_rows_step_plain_matches_pallas(n_agents):
    jenv, tenv = make_pair(n_agents)
    arrays = contact_rich(jenv, seed=20 + n_agents)
    js = jax_state(jenv, arrays)
    ts = state_from_numpy(tenv.world, arrays)
    jfo, tfo = jenv._fused_outputs, tenv._fused_outputs
    slots = [a.index for a in tenv.agents]
    rng = np.random.default_rng(n_agents)
    act = rng.uniform(-0.6, 0.6, (2 * n_agents, B)).astype(np.float32)

    bp = 128
    jstep = JF.make_rows_step(jenv.world, jfo, slots, bp)
    jcarry = JF.pack_carry(jenv.world, js, jfo, bp)
    jact = np.zeros((8, bp), np.float32)
    jact[: 2 * n_agents, :B] = act
    jc, je = jax.jit(jstep)(jcarry, jact)

    tc, te = TF.rows_step_plain(tenv.world, tfo, slots, TF.pack_carry(tenv.world, ts, tfo), torch.as_tensor(act))
    E = len(tenv.world.entities)
    jc, je = np.asarray(jc)[:, :B], np.asarray(je)[:, :B]
    assert tc.shape == (TF.rows_layout(tenv.world, tfo), B) and te.shape == (tfo.n_out, B)
    compare_rows(np.concatenate([tc[: 9 * E], te]), np.concatenate([jc[: 9 * E], je]), E, n_agents,
                 tfo.obs_w, "rows step")
    # the carried scratch rows are this step's shaping rows
    np.testing.assert_array_equal(tc[9 * E:].numpy(), te[-tfo.n_scratch_in:].numpy())
    # the make_rows_step wrapper runs the plain version on a CPU tensor and
    # writes the emit rows into the slice it is given
    out = torch.empty((tfo.n_out, B))
    tc2, te2 = TF.make_rows_step(tenv.world, tfo, slots)(TF.pack_carry(tenv.world, ts, tfo), torch.as_tensor(act), out)
    assert te2 is out and torch.equal(te2, te) and torch.equal(tc2, tc)


@pytest.mark.parametrize("n_agents", [3, 4])
def test_physics_step_matches_jax(n_agents):
    jenv, tenv = make_pair(n_agents, fused=False)
    arrays = contact_rich(jenv, seed=30 + n_agents)
    js = jax_state(jenv, arrays)
    ts = state_from_numpy(tenv.world, arrays)
    assert_contacts(tenv, ts)
    j_state = jax.jit(lambda s: JP.physics_step(jenv.world, s))(js)
    t_state = TP.physics_step(tenv.world, ts)
    for name in ("pos", "vel", "rot", "ang_vel", "force", "torque"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)), **STATE_ATOL, err_msg=name
        )


def test_plain_physics_is_differentiable():
    """The plain physics path stays differentiable through autograd."""
    jenv, tenv = make_pair(4, fused=False)
    ts = state_from_numpy(tenv.world, contact_rich(jenv, seed=3))
    force = ts.force.clone().requires_grad_(True)
    out = TP.physics_step(tenv.world, ts.replace(force=force))
    out.pos.sum().backward()
    assert torch.isfinite(force.grad).all() and (force.grad != 0).any()


def test_fused_refuses_grad():
    with pytest.raises(ValueError, match="forward-only"):
        torch_make_env("transport", 4, device="cpu", fused_physics=True, grad_enabled=True)


def _scenario(shape_fn, joint=False, dynamic_gravity=False, n_walls=1):
    from vmas_tpu_torch.core import Agent, Joint, Landmark, Sphere, World
    from vmas_tpu_torch.scenario import BaseScenario

    class S(BaseScenario):
        def make_world(self, batch_dim, device=None, **kwargs):
            w = World(batch_dim, device, substeps=2 if joint else 1)
            a = Agent("a", shape=Sphere(0.05))
            w.add_agent(a)
            for i in range(n_walls):
                w.add_landmark(Landmark(f"wall{i}", shape=shape_fn(), collide=True))
            if joint:
                b = Landmark("b", shape=Sphere(0.05), movable=True)
                w.add_landmark(b)
                w.add_joint(Joint(a, b, dist=0.2))
            w.dynamic_gravity = dynamic_gravity
            return w

        def reset_world_at(self, state, generator):
            return state

        def observation(self, agent, state):
            return agent.pos(state)

        def reward(self, agent, state):
            return state.pos[:, 0, 0]

    return S()


@pytest.mark.parametrize("kind", ["dynamic_gravity", "entities"])
def test_unported_worlds_raise(kind):
    """The worlds the fused kernel once refused. A world beyond the entity
    cap (``MAX_E`` + 1 entities, one the JAX package fuses) raises when its
    Environment is built; a 33-entity world, refused while the cap was 32,
    runs fused and its fused step matches the plain physics. A world with
    dynamic gravity is ported, and its fused step (the dynamic-gravity rows
    after the state rows) matches the plain physics."""
    from vmas_tpu_torch import _kernels as K
    from vmas_tpu_torch.core import Sphere
    from vmas_tpu_torch.core import fused as F
    from vmas_tpu_torch.environment import Environment

    if kind == "entities":
        beyond = _scenario(Sphere, n_walls=K.MAX_E)
        with pytest.raises(NotImplementedError, match=f"at most {K.MAX_E} entities"):
            Environment(beyond, num_envs=2, device="cpu", fused_physics=True)
        assert F.supports(beyond.world) and len(beyond.world.entities) == K.MAX_E + 1
        envs = [Environment(_scenario(Sphere, n_walls=32), num_envs=2, device="cpu", fused_physics=f)
                for f in (True, False)]
        assert envs[0].world.fused and len(envs[0].world.entities) == 33 and F.supports(envs[0].world)
        for env in envs:
            # the agent 2 cm into the first wall's contact range
            pos = torch.zeros((2, 33, 2))
            pos[:, 1:, 0] = torch.arange(32) * 0.5 + 0.08
            env.state = env.state.replace(pos=pos)
            env.step([torch.tensor([[0.5, 0.0], [0.0, -0.5]])])
        for field in ("pos", "vel"):
            torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), atol=1e-5,
                                       rtol=1e-5)
        assert bool((envs[0].state.vel[:, 0, 0] < 0.5 * 0.1).all())  # the wall pushed back
        return
    envs = [Environment(_scenario(Sphere, dynamic_gravity=True), num_envs=2, device="cpu", fused_physics=f)
            for f in (True, False)]
    assert envs[0].world.fused and envs[0].world.dynamic_gravity
    for env in envs:
        # the agent 3 cm into the static wall's contact range, each env in its own wind
        env.state = env.state.replace(pos=torch.tensor([[[0.0, 0.07], [0.0, 0.0]]] * 2))
        for e, g in zip(env.world.entities, ([0.5, -1.0], [[0.0, -2.0], [1.5, 0.25]])):
            env.state = e.set_gravity(env.state, torch.tensor(g))
        env.step([torch.tensor([[0.5, 0.0], [0.0, -0.5]])])
    for field in ("pos", "vel"):
        torch.testing.assert_close(getattr(envs[0].state, field), getattr(envs[1].state, field), atol=1e-5,
                                   rtol=1e-5)
    assert bool((envs[0].state.vel[:, 1] != 0).all())


def test_joint_world_fuses():
    """Joints are ported: a world with one steps through the fused step as
    through the plain physics."""
    from vmas_tpu_torch.core import Sphere
    from vmas_tpu_torch.environment import Environment

    envs = [Environment(_scenario(Sphere, joint=True), num_envs=2, device="cpu", fused_physics=f) for f in (True, False)]
    assert envs[0].world.fused and len(envs[0].world.spec.joint_idx_a) == 2
    for env in envs:
        # wall, b, the joint's line, a; b 5 cm beyond the joint's reach
        pos = torch.tensor([[[1.0, 1.0], [0.25, 0.0], [0.0, 0.0], [0.0, 0.0]]] * 2)
        env.state = env.world.sync_joints(env.state.replace(pos=pos))
        env.step([torch.tensor([[0.5, 0.0], [0.0, -0.5]])])
    torch.testing.assert_close(envs[0].state.pos, envs[1].state.pos, atol=1e-5, rtol=1e-5)
    assert bool((envs[0].state.pos[:, 1, 0] < 0.25).all())


def test_interop_round_trip():
    jenv, tenv = make_pair(4)
    arrays = contact_rich(jenv, seed=4)
    back = state_to_numpy(state_from_numpy(tenv.world, arrays))
    for k in ("pos", "vel", "rot", "force", "rendering"):
        np.testing.assert_array_equal(back[k], arrays[k])
    np.testing.assert_array_equal(back["scenario"]["global_shaping"], arrays["scenario"]["global_shaping"])
