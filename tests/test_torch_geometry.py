"""The port's closest-point geometry (vmas_tpu_torch/core/geometry.py)
against the recorded reference oracle (tests/golden/data/geometry.npz) and
against the JAX package's geometry on the same inputs.

Against JAX the tolerance is atol 1e-6: both run the same f32 arithmetic in
the same order, so they differ by a few ulps at most. Where a function picks
the closest of several candidates, an ulp of difference in cos/sin can flip
a near tie to the other candidate; there the pair distance must agree to
1e-6 instead of the points. Against the oracle the
tolerances are the JAX package's own (tests/test_geometry.py): the oracle
was recorded from another implementation, and near ties (box corners,
parallel edges) either candidate pair is valid as long as the pair distance
agrees.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmas_tpu.core import geometry as JG
from vmas_tpu_torch.core import geometry as TG

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "golden", "data", "geometry.npz")
ATOL = 1e-6

# function -> (input keys of the oracle, output keys); rotations are
# trailing [..., 1] in the oracle and trailing-scalar here
CASES = {
    "closest_point_line": (
        ["cpl_line_pos", "cpl_line_rot", "cpl_line_len", "cpl_point"], ["cpl_out"]),
    "closest_points_line_line": (
        ["cpl_line_pos", "cpl_line_rot", "cpl_line_len", "cll_l2_pos", "cll_l2_rot", "cll_l2_len"],
        ["cll_out1", "cll_out2"]),
    "closest_point_box": (
        ["cpb_box_pos", "cpb_box_rot", "cpb_box_w", "cpb_box_l", "cpl_point"], ["cpb_out"]),
    "closest_line_box": (
        ["cpb_box_pos", "cpb_box_rot", "cpb_box_w", "cpb_box_l", "cpl_line_pos", "cpl_line_rot", "cpl_line_len"],
        ["clb_out1", "clb_out2"]),
    "closest_box_box": (
        ["cpb_box_pos", "cpb_box_rot", "cpb_box_w", "cpb_box_l", "cbb_b2_pos", "cbb_b2_rot", "cbb_b2_w", "cbb_b2_l"],
        ["cbb_out1", "cbb_out2"]),
    "inner_point_box": (["ipb_outside", "ipb_surface", "ipb_box_pos"], ["ipb_out", "ipb_dist"]),
}


@pytest.fixture(scope="module")
def gold():
    return np.load(DATA)


def _inputs(gold, keys):
    return [gold[k][..., 0] if k.endswith("_rot") else gold[k] for k in keys]


def _random_inputs(keys, n, seed):
    """Inputs of the same kinds as the oracle's: positions, rotations and
    sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for k in keys:
        if k.endswith("_rot"):
            a = rng.uniform(-np.pi, np.pi, n)
        elif k.endswith(("_len", "_w", "_l")):
            a = rng.uniform(0.05, 1.0, n)
        else:
            a = rng.normal(0.0, 0.5, (n, 2))
        out.append(a.astype(np.float32))
    return out


def _run_torch(name, args):
    out = getattr(TG, name)(*[torch.as_tensor(a) for a in args])
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _run_jax(name, args):
    out = jax.jit(getattr(JG, name))(*[jnp.asarray(a) for a in args])
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _assert_pair_close(p1, p2, g1, g2, atol=2e-4):
    """Closest-point pairs, tolerating tie-broken candidate swaps (the pair
    distance must still agree)."""
    ok = np.isclose(p1, g1, atol=atol).all(-1) & np.isclose(p2, g2, atol=atol).all(-1)
    if not ok.all():
        bad = ~ok & ~np.isclose(np.linalg.norm(p1 - p2, axis=-1), np.linalg.norm(g1 - g2, axis=-1), atol=atol)
        assert not bad.any(), f"{bad.sum()} lanes disagree beyond tie-breaks"


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_oracle(gold, name):
    in_keys, out_keys = CASES[name]
    args = _inputs(gold, in_keys)
    got = _run_torch(name, args)
    want = [gold[k] for k in out_keys]
    if name == "closest_point_line":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    elif name == "closest_point_box":
        _assert_pair_close(got[0], args[-1], want[0], args[-1])
    elif name == "inner_point_box":
        np.testing.assert_allclose(got[0], want[0], atol=2e-4)
        np.testing.assert_allclose(got[1], want[1], atol=2e-4)
    else:
        _assert_pair_close(got[0], got[1], want[0], want[1])


@pytest.mark.parametrize("inputs", ["oracle", "random"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_jax(gold, name, inputs):
    in_keys, _ = CASES[name]
    args = _inputs(gold, in_keys) if inputs == "oracle" else _random_inputs(in_keys, 2048, seed=len(name))
    got, want = _run_torch(name, args), _run_jax(name, args)
    if name == "closest_point_box":
        _assert_pair_close(got[0], args[-1], want[0], args[-1], atol=ATOL)
    elif name in ("closest_points_line_line", "closest_line_box", "closest_box_box"):
        _assert_pair_close(got[0], got[1], want[0], want[1], atol=ATOL)
    else:
        for t, j in zip(got, want):
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_geometry_is_differentiable(gold):
    """Guarded divisions keep the gradients finite, as in the JAX package."""
    args = [torch.as_tensor(a[:64]) for a in _inputs(gold, CASES["closest_points_line_line"][0])]
    pos = args[0].clone().requires_grad_(True)
    o1, o2 = TG.closest_points_line_line(pos, *args[1:])
    ((o1 - o2) ** 2).sum().backward()
    assert torch.isfinite(pos.grad).all()
