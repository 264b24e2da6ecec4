"""Joint constraints in the port (vmas_tpu_torch/core/joints.py, the joint
table and joint forces of core/physics.py, the joint block of the fused
step's plain twin in core/fused.py) against the JAX package, and waterfall,
the debug world of all six pair types and both kinds of joint constraint.

The joints world (vmas_tpu_torch/testing.py): three sphere agents, a
collidable bar joining two of them, a box rigidly joined to the third at a
fixed rotation, a line joining two agents with one end's rotation held at
the one inferred at sync, a floor; substeps 2. It is built with both
packages' classes, and both step the same state, made from a seed with
numpy, in which every constraint is pulled apart and four pair types touch:
the plain physics against the JAX package's ``physics_step`` and the twin
against its Pallas kernel (interpret mode, compiled once per module).

The scenario worlds are held to the JAX package by their tables and their
joint sync. waterfall is held piecewise: its emit against the JAX
package's on the same rows, its fused step's twin against the port's plain
physics from a state in which all six pair types touch, and its plain
physics against the recorded reference trajectory. (Its Pallas kernel
takes some 37 s to trace and compile in interpret mode even at one
substep; the all-pairs world of tests/test_torch_pairs.py holds every pair
type of the twin to the Pallas kernel, the joints world every joint.)

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise, as
tests/test_fused.py); the fused step against the plain path in waterfall
atol 1e-4 rtol 5e-5 (tests/test_fused.py's for joint worlds: the two sum a
body's constraint forces in different orders); joint sync atol 1e-6; the
waterfall golden free run atol 2e-3 over its 50 steps
(tests/test_scenario_parity.py's default).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu.core as JC
import vmas_tpu_torch.core as TC
from vmas_tpu.core import fused as JF
from vmas_tpu.core import physics as JP
from vmas_tpu.scenarios import load as jax_load
from vmas_tpu_torch import make_env as torch_make_env
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core import physics as TP
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.scenarios import load as torch_load
from vmas_tpu_torch.testing import joints_state, joints_world, waterfall_contact_state

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
# the fused step against the plain path: tests/test_fused.py's tolerance
# for joint worlds. The kernel adds each constraint's two sides in table
# order, the plain path every first side and then every second side; the
# chain's bars (moment of inertia 8.3e-4) turn that reordering into
# visible angular velocity.
JOINT_PLAIN_TOL = dict(atol=1e-4, rtol=5e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
JOINT_FIELDS = ("joint_idx_a", "joint_idx_b", "joint_anchor_a", "joint_anchor_b", "joint_dist", "joint_rotate",
                "joint_fixed_rot_init")
PAIR_FIELDS = ("ss_a", "ss_b", "ss_ra", "ss_rb", "ls_line", "ls_sphere", "ls_len", "ls_rad", "ll_a", "ll_b",
               "ll_la", "ll_lb", "bs_box", "bs_sphere", "bs_len", "bs_wid", "bs_not_hollow", "bs_rad", "bl_box",
               "bl_line", "bl_blen", "bl_bwid", "bl_not_hollow", "bl_llen", "bb_a", "bb_b", "bb_la", "bb_wa",
               "bb_nha", "bb_lb", "bb_wb", "bb_nhb")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data", "scenario_waterfall.npz")


def _close(got, want, msg, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or STATE_TOL), err_msg=msg)


@pytest.fixture(scope="module")
def small():
    jw, tw = joints_world(JC, B), joints_world(TC, B, "cpu")
    arrays = joints_state(tw, np.random.default_rng(0))
    js = jw.spawn_state().replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state_from_numpy(tw, arrays)
    return jw, tw, js, ts


def _worlds(name):
    """The scenario's world built by each package (no env, no reset)."""
    return (jax_load(name).Scenario().env_make_world(B), torch_load(name).Scenario().env_make_world(B, "cpu"))


@pytest.mark.parametrize("name", ["small", "joint_passage", "waterfall"])
def test_joint_and_pair_tables_match_jax(name, small):
    jw, tw = small[:2] if name == "small" else _worlds(name)
    assert [e.name for e in tw.entities] == [e.name for e in jw.entities]
    for f in JOINT_FIELDS + PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(tw.spec, f), getattr(jw.spec, f), err_msg=f)
    assert [c.table_index for c in tw.joints] == [c.table_index for c in jw.joints]
    assert TF.supports(tw) and JF.supports(jw)
    TF.check_fusable(tw)
    ks = TF.KernelSpec(tw)
    sizes = (len(ks.joints), *(len(getattr(ks, t)) for t in TF.PAIR_TYPES))
    assert sizes == {
        "small": (5, 3, 4, 1, 2, 2, 0),
        "joint_passage": (3, 1, 12, 0, 39, 2, 0),
        "waterfall": (10, 10, 21, 15, 30, 35, 15),
    }[name]
    # the joint ends' rotations are read once per substep with the pairs'
    assert {e for r in ks.joints for e in r[:2]} <= set(ks.trig)


@pytest.mark.parametrize("name", ["small", "joint_passage", "waterfall"])
def test_sync_joints_matches_jax(name, small):
    """Joint.sync from the same random poses: the joint landmarks' poses
    and the inferred fixed rotations."""
    jw, tw = small[:2] if name == "small" else _worlds(name)
    rng = np.random.default_rng(5)
    E = len(tw.entities)
    arrays = {
        "pos": rng.uniform(-1, 1, (B, E, 2)).astype(np.float32),
        "rot": rng.uniform(-np.pi, np.pi, (B, E)).astype(np.float32),
    }
    js = jw.sync_joints(jw.spawn_state().replace(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    ts = tw.sync_joints(state_from_numpy(tw, arrays))
    for f in ("pos", "rot", "joint_fixed_rot"):
        _close(getattr(ts, f).numpy(), getattr(js, f), f, atol=1e-6, rtol=0)
    moved = ts.pos.numpy() != arrays["pos"]
    assert moved.any() == any(e.is_joint for e in tw.entities)
    if not tw.spec.joint_rotate.all():
        inferred = [c.table_index for c in tw.joints if not c.rotate and c.fixed_rotation is None]
        assert inferred and np.abs(ts.joint_fixed_rot.numpy()[:, inferred]).min() > 0


def test_joints_state_exercises_every_constraint(small):
    _, tw, _, ts = small
    x = torch.cat([TF.state_rows(ts), ts.joint_fixed_rot.T])
    assert TF.joint_counts(tw, x) == {"force": 5 * B, "torque": 2 * B}
    counts = TF.contact_counts(tw, x)
    assert all(counts[t] > 0 for t in ("ss", "ls", "bs", "bl")), counts


def test_joints_physics_matches_jax(small):
    jw, tw, js, ts = small
    j_state = jax.jit(lambda s: JP.physics_step(jw, s))(js)
    t_state = TP.physics_step(tw, ts)
    for name in FIELDS:
        _close(getattr(t_state, name).numpy(), getattr(j_state, name), name)


def test_joints_twin_matches_pallas(small, monkeypatch):
    """The plain twin of the fused kernel against the JAX package's Pallas
    kernel (interpret mode, every pair type in its lane-tile form, which
    compiles in 7 s against 11 s unrolled), 2 steps, the port re-synced to
    the JAX state before each."""
    jw, tw, js, _ = small
    monkeypatch.setenv("VMAS_TPU_FUSED_LANE_MIN", "1")
    jstep = jax.jit(lambda s: JF.fused_physics_step(jw, s))
    for t in range(2):
        ts = state_from_numpy(tw, {k: np.asarray(getattr(js, k)) for k in FIELDS + ("joint_fixed_rot",)})
        js, ts = jstep(js), TF.fused_physics_step(tw, ts)
        for name in FIELDS:
            _close(getattr(ts, name).numpy(), getattr(js, name), f"{name} at step {t}")


def test_joints_twin_matches_plain_physics(small):
    _, tw, _, ts = small
    a, b = TF.fused_physics_step(tw, ts), TP.physics_step(tw, ts)
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), **STATE_TOL)


def test_constraint_force_attractive_matches_jax():
    """The attractive penalty on rows: sign before the division by the
    margin, the force dropped inside dist_min and below 1e-6."""
    rng = np.random.default_rng(2)
    ax, ay, bx, by = rng.normal(0, 0.01, (4, 64)).astype(np.float32)
    ax[:4], ay[:4], bx[:4], by[:4] = 0.5, 0.5, 0.5, 0.5  # coincident points
    for dmin in (0.0, 0.004):
        got = TF._constraint_force(1e-3, *map(torch.as_tensor, (ax, ay, bx, by)), dmin, 900.0, attractive=True)
        want = JF._constraint_force(1e-3, *map(jnp.asarray, (ax, ay, bx, by)), dmin, 900.0, attractive=True)
        for g, w in zip(got, want):
            # XLA's and PyTorch's exp and log1p may round apart by an ulp
            _close(g.numpy(), w, f"dmin {dmin}", atol=0, rtol=2.5e-7)
        assert (got[0][:4] == 0).all()


@pytest.mark.parametrize("source", ["contacts", "golden"])
def test_waterfall_twin_matches_plain_physics(source):
    """waterfall's fused step (twin and emit) against the port's plain path:
    from a state with all six pair types touching and both fixed-rotation
    torques acting, and from step 19 of the recorded reference trajectory
    (its chain swinging, no contacts)."""
    env = torch_make_env("waterfall", B, device="cpu", seed=0, fused_physics=True)
    if source == "contacts":
        ts = state_from_numpy(env.world, waterfall_contact_state(env, np.random.default_rng(1)))
        x = torch.cat([TF.state_rows(ts), ts.joint_fixed_rot.T])
        assert all(v > 0 for v in TF.contact_counts(env.world, x).values())
        assert TF.joint_counts(env.world, x)["torque"] > 0
    else:
        d = np.load(GOLDEN)
        ts = env.state.replace(**{k: torch.as_tensor(d[k][19, :B]) for k in ("pos", "vel", "rot", "ang_vel")})
    fo = env._fused_outputs
    a, extra = env.world.step_with_outputs(ts, fo)
    b = TP.physics_step(env.world, ts)
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), **JOINT_PLAIN_TOL)
    obs, rews, done, updates = fo.unpack(extra, a)
    sc = env.scenario
    for i, agent in enumerate(env.agents):
        torch.testing.assert_close(obs[i], sc.observation(agent, a), atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(rews[i], sc.reward(agent, a), atol=2e-5, rtol=1e-5)
    assert not done.any() and updates == {}


def test_waterfall_emit_matches_jax():
    """waterfall's emit on the same post-step rows: the port's against the
    JAX package's (the function its kernel runs on these rows)."""
    jw, tw = _worlds("waterfall")
    jfo = jax_load("waterfall").Scenario().make_fused_outputs(jw)
    tfo = torch_load("waterfall").Scenario().make_fused_outputs(tw)
    rng = np.random.default_rng(6)
    E = len(tw.entities)
    rows = {k: rng.normal(0, 0.5, (E, B)).astype(np.float32) for k in ("px", "py", "vx", "vy", "rot", "w")}
    ctx = lambda conv: {**{k: [conv(r) for r in v] for k, v in rows.items()}, "scratch": []}
    got = tfo.emit(ctx(torch.as_tensor))
    want = jfo.emit(ctx(jnp.asarray))
    assert len(got) == len(want) == tfo.n_out == 5 * (4 + 2 * 12) + 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_golden_waterfall_replay():
    """The recorded reference trajectory (16 envs, 50 steps), run free
    through the port's plain physics as tests/test_scenario_parity.py runs
    the JAX package."""
    d = np.load(GOLDEN)
    nb, T, atol = d["init_pos"].shape[0], d["actions"].shape[0], 2e-3
    env = torch_make_env("waterfall", nb, device="cpu", seed=0)
    assert [e.name for e in env.world.entities] == [str(n) for n in d["entity_names"]]
    z = torch.zeros_like
    env.state = env.state.replace(
        pos=torch.as_tensor(d["init_pos"]), vel=torch.as_tensor(d["init_vel"]), rot=torch.as_tensor(d["init_rot"]),
        ang_vel=torch.as_tensor(d["init_ang_vel"]), force=z(env.state.force), torque=z(env.state.torque),
    )
    close = lambda a, ref, tol, msg: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(ref, np.float64), atol=tol, rtol=0, err_msg=msg)
    for t in range(T):
        obs, rews, dones, _ = env.step([torch.as_tensor(d["actions"][t, i]) for i in range(5)])
        close(env.state.pos, d["pos"][t], atol, f"pos at step {t}")
        close(env.state.vel, d["vel"][t], 10 * atol, f"vel at step {t}")
        close(env.state.rot, d["rot"][t], 10 * atol, f"rot at step {t}")
        for i in range(5):
            close(obs[i], d[f"obs_{i}"][t], 10 * atol, f"obs[{i}] at step {t}")
            close(rews[i], d["rewards"][t, i], 10 * atol, f"reward[{i}] at step {t}")
        np.testing.assert_array_equal(dones.numpy(), d["done"][t], err_msg=f"done at step {t}")
