"""The scenarios' render hooks (``extra_render``, ``top_layer_render``) of
the port against the JAX package's, for the first half of the hook worlds;
tests/test_torch_render_worlds.py holds the second half.

For each world, both packages' envs at ``num_envs=2`` with the config of
tests/test_render.py's ``EXTRA_RENDER_SCENARIOS`` hold one state (the JAX
env's, its positions, rotations, forces and comm states moved by a seeded
draw, carried into the port through interop; no JAX ``env.step`` is
compiled):

* the frame, ``mode="rgb_array"`` under Agg, is bitwise the JAX package's
  where it is drawn from the state alone. Frames that draw values the two
  packages compute in floating point (cast rays, sampling's density) may
  differ in at most ``FLOAT_DRAWN_SHARE`` of their pixels, at any level;
  measured on this CPU: no pixel differs (largest level difference 0,
  share 0);
* each hook is the scenario's own (not the base no-op) and adds as many
  artists to a fresh Axes as the JAX hook does on the same state, reading
  the frame's host copy (``viewer.host_state``) as the viewer hands it;
* what each hook asks of matplotlib, recorded without it
  (``testing.hook_calls``, what chip_smoke.py runs on the card), adds as
  many artists as the hook draws, and is bitwise the same for a twin env
  of one env and another seed that reads the same host copy: the hook
  reads the frame's copy, not the env it was built in.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402
from test_render import EXTRA_RENDER_SCENARIOS, _artist_count  # noqa: E402
from test_torch_render import FLOAT_DRAWN_SHARE, assert_frames, make_pair  # noqa: E402

from vmas_tpu_torch import make_env, testing  # noqa: E402
from vmas_tpu_torch.render.viewer import FrameEnv, host_state  # noqa: E402
from vmas_tpu_torch.scenario import BaseScenario  # noqa: E402

# the worlds whose frames draw cast rays or sampling's density
FLOAT_DRAWN = ("discovery", "navigation", "sampling")
assert FLOAT_DRAWN_SHARE < 1e-3
WORLDS = ("road_traffic", "football", "painting", "passage", "ball_passage", "ball_trajectory", "joint_passage",
          "joint_passage_size", "asym_joint")

_PAIRS = {}


def hook_pair(name):
    """Each world's pair, built once per file."""
    if name not in _PAIRS:
        _PAIRS[name] = make_pair(name, **EXTRA_RENDER_SCENARIOS[name][0])
    return _PAIRS[name]


def check_frame(name):
    jenv, tenv = hook_pair(name)
    jf = jenv.render(mode="rgb_array")
    tf = tenv.render(mode="rgb_array")
    assert tf.ndim == 3 and tf.max() > 0
    assert_frames(jf, tf, name in FLOAT_DRAWN)


def check_artists(name, hook):
    jenv, tenv = hook_pair(name)
    assert getattr(type(tenv.scenario), hook) is not getattr(BaseScenario, hook), f"{name}.{hook} not overridden"
    counts = []
    for scenario, env in ((jenv.scenario, jenv), (tenv.scenario, FrameEnv(tenv, host_state(tenv.state, 0)[1]))):
        fig, ax = plt.subplots()
        try:
            getattr(scenario, hook)(env, ax, 0)
            counts.append(_artist_count(ax))
        finally:
            plt.close(fig)
    assert counts[1] == counts[0] > 0, counts


def check_recorded_calls(name, hook):
    _, tenv = hook_pair(name)
    view = host_state(tenv.state, 1)[1]
    calls = testing.hook_calls(tenv, view, 1)
    twin = make_env(name, 1, device="cpu", seed=1, **EXTRA_RENDER_SCENARIOS[name][0])
    assert testing.hook_calls(twin, view, 1) == calls
    fig, ax = plt.subplots()
    try:
        getattr(tenv.scenario, hook)(FrameEnv(tenv, view), ax, 1)
        assert testing.hook_artists(calls[hook]) == _artist_count(ax) > 0
    finally:
        plt.close(fig)


def hooks_of(worlds):
    return [(w, h) for w in worlds for h in EXTRA_RENDER_SCENARIOS[w][1]]


def teardown_module():
    plt.close("all")


@pytest.mark.parametrize("name", WORLDS)
def test_hook_frame_equals_jax(name):
    check_frame(name)


@pytest.mark.parametrize("name,hook", hooks_of(WORLDS))
def test_hook_artists_match_jax(name, hook):
    check_artists(name, hook)


@pytest.mark.parametrize("name,hook", hooks_of(WORLDS))
def test_hook_calls_recorded_without_matplotlib(name, hook):
    check_recorded_calls(name, hook)
