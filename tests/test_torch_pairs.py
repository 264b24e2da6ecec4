"""All six contact pair types of the port (vmas_tpu_torch/core/physics.py
and the plain twin of the fused step in core/fused.py) against the JAX
package, on a world that holds every type.

The all-pairs world (vmas_tpu_torch/testing.py, chip_smoke.py's too): 6
sphere agents, 2 line agents and 3 box agents (one hollow), all movable and
rotatable, substeps 1, so E = 11
with ss 15, ls 12, ll 1, bs 18, bl 6 and bb 3 pairs. It is built once with
vmas_tpu's classes and once with the port's, and both step the same packed
state, made from a seed with numpy, in which every type touches.

Tolerances: state rows atol 1e-5 rtol 1e-5 (f32 reorder noise, as
tests/test_fused.py). The JAX kernel runs here in interpret mode with every
pair type in its lane-tile form (``VMAS_TPU_FUSED_LANE_MIN=1``): the JAX
package holds the tile form to its unrolled form within an ulp, and the
unrolled ll/bl/bb chains take about a minute to compile in interpret mode.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vmas_tpu.core as JC
import vmas_tpu_torch.core as TC
from vmas_tpu.core import fused as JF
from vmas_tpu.core import physics as JP
from vmas_tpu_torch.core import fused as TF
from vmas_tpu_torch.core import physics as TP
from vmas_tpu_torch.interop import state_from_numpy
from vmas_tpu_torch.testing import all_pairs_state, all_pairs_world

torch.set_num_threads(1)

B = 8
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("pos", "vel", "rot", "ang_vel", "force", "torque")
PAIR_COUNTS = {"ss": 15, "ls": 12, "ll": 1, "bs": 18, "bl": 6, "bb": 3}
# each type's first index field in the spec
FIRST = {"ss": "ss_a", "ls": "ls_line", "ll": "ll_a", "bs": "bs_box", "bl": "bl_box", "bb": "bb_a"}


@pytest.fixture(scope="module")
def pair():
    jw, tw = all_pairs_world(JC, B), all_pairs_world(TC, B, "cpu")
    arrays = all_pairs_state(np.random.default_rng(0), B)
    js = jw.spawn_state().replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state_from_numpy(tw, arrays)
    return jw, tw, js, ts


def test_all_pairs_world_tables_match_jax(pair):
    jw, tw, _, _ = pair
    js, ts = jw.spec, tw.spec
    assert {t: len(getattr(ts, f)) for t, f in FIRST.items()} == PAIR_COUNTS
    for name in ("ss_a", "ss_b", "ss_ra", "ss_rb", "ls_line", "ls_sphere", "ls_len", "ls_rad",
                 "ll_a", "ll_b", "ll_la", "ll_lb", "bs_box", "bs_sphere", "bs_len", "bs_wid", "bs_not_hollow",
                 "bs_rad", "bl_box", "bl_line", "bl_blen", "bl_bwid", "bl_not_hollow", "bl_llen",
                 "bb_a", "bb_b", "bb_la", "bb_wa", "bb_nha", "bb_lb", "bb_wb", "bb_nhb"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)
    assert TF.supports(tw) and JF.supports(jw)


def test_packed_state_touches_every_type(pair):
    _, tw, _, ts = pair
    counts = TF.contact_counts(tw, TF.state_rows(ts))
    assert all(v > 0 for v in counts.values()), f"vacuous state: {counts}"


def test_all_pairs_physics_matches_jax(pair):
    jw, tw, js, ts = pair
    j_state = jax.jit(lambda s: JP.physics_step(jw, s))(js)
    t_state = TP.physics_step(tw, ts)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
                                   **STATE_TOL, err_msg=name)


def test_all_pairs_twin_matches_pallas(pair, monkeypatch):
    """The plain twin of the fused kernel against the JAX package's Pallas
    kernel (interpret mode, every type in its lane-tile form), 2 steps,
    the port re-synced to the JAX state before each."""
    jw, tw, js, _ = pair
    monkeypatch.setenv("VMAS_TPU_FUSED_LANE_MIN", "1")
    jstep = jax.jit(lambda s: JF.fused_physics_step(jw, s))
    for t in range(2):
        ts = state_from_numpy(tw, {k: np.asarray(getattr(js, k)) for k in FIELDS})
        js, ts = jstep(js), TF.fused_physics_step(tw, ts)
        for name in FIELDS:
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       **STATE_TOL, err_msg=f"{name} at step {t}")


def test_twin_matches_plain_physics(pair):
    """The twin and the port's plain physics agree on every type."""
    _, tw, _, ts = pair
    a, b = TF.fused_physics_step(tw, ts), TP.physics_step(tw, ts)
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), **STATE_TOL)


def _spec_world(substeps, ss=0, ls=0, ll=0, bs=0, bl=0, bb=0, joints=0, entities=10):
    z = lambda n: np.zeros(n, np.int32)
    spec = SimpleNamespace(
        ss_a=z(ss), ls_line=z(ls), ll_a=z(ll), bs_box=z(bs), bl_box=z(bl), bb_a=z(bb),
        joint_idx_a=z(joints), movable=np.ones(entities, bool),
    )
    return SimpleNamespace(spec=spec, substeps=substeps)


@pytest.mark.parametrize(
    "substeps,counts",
    [
        (1, dict(ss=6, ls=4, bs=4, bl=1, entities=7)),  # balance
        (1, dict(ss=15, ls=12, ll=1, bs=18, bl=6, bb=3, entities=11)),  # the all-pairs world
        (1, dict(ss=21, ls=70, entities=19)),  # football
        (1, dict(bs=95, entities=22)),
        (10, dict(bb=1, entities=3)),  # kinematic_bicycle
        (1, dict(bb=7)), (1, dict(bb=8)), (1, dict(bb=100)), (1, dict(bb=101)), (1, dict(bb=120)),
        (5, dict(bl=7)), (5, dict(bl=8)), (10, dict(bl=40)),
        (10, dict(ss=7, ls=7, ll=7, bs=7, bl=7, bb=7)),
        (20, dict(ss=60, entities=40)),
        (1, dict(entities=4000)), (1, dict(entities=4001)),
        (4, dict(ll=64, bs=64, joints=10)),
    ],
)
def test_supports_matches_jax(substeps, counts):
    """The port's cost rule picks the same worlds as the JAX package's,
    below, at and above the lane-tile threshold and the unroll limit."""
    w = _spec_world(substeps, **counts)
    assert TF.supports(w) == JF.supports(w)


def test_more_pairs_than_the_old_caps():
    """A world with more than 64 sphere-sphere and 16 box-sphere pairs
    fuses: the pair tables have no cap."""
    w = TC.World(4, "cpu")
    for i in range(12):
        w.add_agent(TC.Agent(name=f"s{i}", shape=TC.Sphere(0.05)))
    for i in range(2):
        w.add_landmark(TC.Landmark(name=f"b{i}", shape=TC.Box(0.3, 0.2), collide=True))
    w.finalize()
    assert len(w.spec.ss_a) == 66 and len(w.spec.bs_box) == 24
    TF.check_fusable(w)
    assert TF.supports(w)
    rng = np.random.default_rng(3)
    s = state_from_numpy(w, {"pos": rng.uniform(-0.2, 0.2, (4, 14, 2)), "vel": rng.normal(0, 0.1, (4, 14, 2))})
    counts = TF.contact_counts(w, TF.state_rows(s))
    assert counts["ss"] > 0 and counts["bs"] > 0
    a, b = TF.fused_physics_step(w, s), TP.physics_step(w, s)
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), **STATE_TOL)
    # the pair records, then the lane lists: 8 words per entity and each
    # agent's 11 sphere-sphere and 2 box-sphere entries (the boxes are
    # fixed), then the per-entity constants: 16 words per entity
    ks = TF.KernelSpec(w)
    assert ks.table_offsets[-1] == 3 * 66 + 6 * 24
    assert ks.ent_offset == 3 * 66 + 6 * 24 + 8 * 14 + 12 * 13
    assert len(ks.table) == 3 * 66 + 6 * 24 + 8 * 14 + 12 * 13 + 16 * 14
