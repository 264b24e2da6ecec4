"""The scenarios' render hooks of the port against the JAX package's, the
second half of the hook worlds (the first, and what is checked:
tests/test_torch_render_hooks.py); and that the two halves cover every
world of tests/test_render.py's ``EXTRA_RENDER_SCENARIOS``, the table of
``testing.RENDER_HOOK_WORLDS``."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402
from test_render import EXTRA_RENDER_SCENARIOS  # noqa: E402
from test_torch_render_hooks import WORLDS as FIRST_HALF  # noqa: E402
from test_torch_render_hooks import check_artists, check_frame, check_recorded_calls, hooks_of  # noqa: E402

from vmas_tpu_torch import testing  # noqa: E402

WORLDS = ("discovery", "navigation", "sampling", "circle_trajectory", "diff_drive", "drone", "kinematic_bicycle",
          "line_trajectory", "multi_give_way", "simple_tag", "wind_flocking")


def teardown_module():
    plt.close("all")


def test_halves_cover_every_hook_world():
    """The two files' worlds are tests/test_render.py's, as is the table
    that chip_smoke.py draws them from (``testing.RENDER_HOOK_WORLDS``)."""
    assert not set(WORLDS) & set(FIRST_HALF)
    assert set(WORLDS) | set(FIRST_HALF) == set(EXTRA_RENDER_SCENARIOS)
    assert len(hooks_of(WORLDS) + hooks_of(FIRST_HALF)) == 21
    assert {k: (kw, list(h)) for k, (kw, h) in testing.RENDER_HOOK_WORLDS.items()} == EXTRA_RENDER_SCENARIOS


@pytest.mark.parametrize("name", WORLDS)
def test_hook_frame_equals_jax(name):
    check_frame(name)


@pytest.mark.parametrize("name,hook", hooks_of(WORLDS))
def test_hook_artists_match_jax(name, hook):
    check_artists(name, hook)


@pytest.mark.parametrize("name,hook", hooks_of(WORLDS))
def test_hook_calls_recorded_without_matplotlib(name, hook):
    check_recorded_calls(name, hook)
