"""The port's rendering (vmas_tpu_torch/render/, ``Environment.render``)
against the JAX package's.

* Frames: both packages' envs at ``num_envs=2``, the JAX env's state
  carried into the port through ``interop.state_from_numpy`` after a seeded
  perturbation of the positions, rotations, forces and comm states (the
  same numbers on both sides; no JAX ``env.step`` is compiled), rendered
  ``mode="rgb_array"`` under Agg: transport, the box-visibility case, the
  camera's agent focus on env 1, the comm text (continuous and discrete),
  the legacy one-argument hook, and flocking with the Lidar fans, the
  force arrows and a ``plot_position_function``. Each frame drawn from the
  state alone must be bitwise the JAX package's. The fans (cast rays) and
  the position function draw values that the two packages compute in
  floating point; their frames may differ in at most ``FLOAT_DRAWN_SHARE``
  of the pixels, at any level. Measured on this CPU: no pixel differs
  (largest level difference 0, share 0).
* The Lidar's render API (``set_render``, ``render``, ``render_color``)
  against the JAX Lidar's; ``set_render(False)`` raised AttributeError in
  the port before.
* The viewer settings (``viewer_size``, ``viewer_zoom``, ``render_origin``,
  ``visualize_semidims``, ``plot_grid``, the JAX viewer's defaults where
  unset) after each package's ``make_world``, for all 43 names (no JAX
  Environment).
* The frame's host copy (``viewer.host_state``): every leaf of env k's row
  bitwise the interop copy, the view broadcasting it to the batch.
* The wrappers' ``render`` and rllib's ``try_render_at``, ``save_video``,
  ``InteractiveEnv``'s headless loop and the module alias,
  ``x_to_rgb_colormap`` and ``extract_nested_with_index``.
"""

import sys

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import vmas_tpu  # noqa: E402
from vmas_tpu_torch import make_env as torch_make_env  # noqa: E402
from vmas_tpu_torch.interop import FIELDS, KEY_SCRATCH, state_from_numpy, state_to_numpy  # noqa: E402

torch.set_num_threads(1)

B = 2
# the share of pixels that may differ in a frame that draws cast rays or a
# position function (measured: 0)
FLOAT_DRAWN_SHARE = 5e-4


def jax_arrays(js):
    """The JAX state as interop's dict of numpy arrays (its random keys
    left out)."""
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    a = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    a["u"] = [np.asarray(x) for x in js.u]
    a["scenario"] = to_np({k: v for k, v in js.scenario.items() if k not in KEY_SCRATCH})
    if getattr(js, "dyn_gravity", None) is not None:
        a["dyn_gravity"] = np.asarray(js.dyn_gravity)
    if any(hasattr(d, "shape") for d in js.dyn):
        a["dyn"] = [np.asarray(d) if hasattr(d, "shape") else () for d in js.dyn]
    return a


def make_pair(name, seed=0, **kw):
    """(JAX env, port env) of ``name`` at B envs holding one state: the JAX
    env's after make_env, its positions, rotations, forces and comm states
    moved by a seeded draw."""
    jenv = vmas_tpu.make_env(name, B, seed=0, **kw)
    arrays = jax_arrays(jenv.state)
    rng = np.random.default_rng(seed)
    moved = {
        "pos": arrays["pos"] + rng.uniform(-0.2, 0.2, arrays["pos"].shape),
        "rot": arrays["rot"] + rng.uniform(-1.0, 1.0, arrays["rot"].shape),
        "force": rng.uniform(-1.0, 1.0, arrays["force"].shape),
        "c": rng.uniform(0.0, 1.0, arrays["c"].shape),
    }
    moved = {k: v.astype(np.float32) for k, v in moved.items()}
    arrays.update(moved)
    jenv.state = jenv.state.replace(**{k: jnp.asarray(v) for k, v in moved.items()})
    tenv = torch_make_env(name, B, device="cpu", seed=0, **kw)
    tenv.state = state_from_numpy(tenv.world, arrays)
    return jenv, tenv


def frame_diff(a, b):
    """(largest level difference, share of pixels that differ)."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, (a.shape, b.shape)
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
    return int(d.max()), float((d > 0).mean())


def assert_frames(jf, tf, float_drawn=False):
    level, share = frame_diff(jf, tf)
    if float_drawn:
        assert share <= FLOAT_DRAWN_SHARE, (level, share)
    else:
        assert level == 0, (level, share)


_PAIRS = {}


def pair(name, **kw):
    """Each (name, config) built once per file."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        _PAIRS[key] = make_pair(name, **kw)
    return _PAIRS[key]


def teardown_module():
    plt.close("all")


def _focus(jenv, tenv):
    return dict(env_index=1, agent_index_focus=0)


def _box(jenv, tenv):
    """transport's package moved to (0.5, 0.5), turned by 0.3, in env 0 of
    both states."""
    pkg = tenv.scenario.packages[0].index
    pos, rot = np.asarray(jenv.state.pos).copy(), np.asarray(jenv.state.rot).copy()
    pos[0, pkg], rot[0, pkg] = (0.5, 0.5), 0.3
    jenv.state = jenv.state.replace(pos=jnp.asarray(pos), rot=jnp.asarray(rot))
    tenv.state = tenv.state.replace(pos=torch.as_tensor(pos), rot=torch.as_tensor(rot))
    return {}


def _discrete(jenv, tenv):
    jenv.continuous_actions = tenv.continuous_actions = False
    return {}


def _overlays(jenv, tenv):
    return dict(plot_position_function=lambda p: (p ** 2).sum(-1), plot_position_function_range=1.5,
                plot_position_function_precision=0.1)


# case -> (scenario, make_env kwargs, setup returning the render kwargs,
# whether floating-point values are drawn)
CASES = {
    "transport": ("transport", {}, None, False),
    "transport_box": ("transport", {}, _box, False),
    "dispersion_focus": ("dispersion", {}, _focus, False),
    "comm_continuous": ("simple_reference", {}, None, False),
    "comm_discrete": ("simple_reference", {}, _discrete, False),
    "flocking_overlays": ("flocking", {"n_agents": 3}, _overlays, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_frame_equals_jax(case):
    name, kw, setup, float_drawn = CASES[case]
    jenv, tenv = pair(name, **kw)
    continuous = jenv.continuous_actions
    try:
        rkw = setup(jenv, tenv) if setup is not None else {}
        jf = jenv.render(mode="rgb_array", **rkw)
        tf = tenv.render(mode="rgb_array", **rkw)
    finally:
        jenv.continuous_actions = tenv.continuous_actions = continuous
    assert tf.ndim == 3 and tf.shape[-1] == 3 and tf.max() > 0
    assert_frames(jf, tf, float_drawn)
    if case == "transport_box":
        h, w, _ = tf.shape
        region = tf[int(h * 0.15):int(h * 0.45), int(w * 0.55):int(w * 0.9)]
        assert (region < 240).any(-1).mean() > 0.01, "box not visible in its region"
    if name == "simple_reference":
        senders = [t.get_text() for t in tenv._render_fig.texts if " sends " in t.get_text()]
        want = [t.get_text() for t in jenv._render_fig.texts if " sends " in t.get_text()]
        assert senders == want and len(senders) == 2


def test_legacy_hook_signature_renders():
    """A hook of the older ``extra_render(env_index=0) -> list`` form is
    called by arity in both viewers, and the frames agree."""
    jenv, tenv = pair("dispersion")
    calls = []

    def legacy_hook(env_index=0):
        calls.append(env_index)
        return []

    jenv.scenario.extra_render = tenv.scenario.extra_render = legacy_hook
    try:
        jf = jenv.render(mode="rgb_array", env_index=1)
        tf = tenv.render(mode="rgb_array", env_index=1)
    finally:
        del jenv.scenario.extra_render, tenv.scenario.extra_render
    assert calls == [1, 1]
    assert_frames(jf, tf)


def test_lidar_render_api_matches_jax():
    """The port's Lidar had ``render`` as a flag, no
    ``set_render`` (``lidar.set_render(False)`` raised AttributeError) and
    ``render_color`` as the raw Color. Now each behaves as the JAX
    Lidar's, and a frame with the fans switched off equals the JAX one."""
    from vmas_tpu.sensors import Lidar as JLidar
    from vmas_tpu.core.utils import Color as JColor

    from vmas_tpu_torch.core.utils import Color
    from vmas_tpu_torch.sensors import Lidar

    for jc, tc in ((JColor.BLUE, Color.BLUE), ((0.1, 0.2, 0.3), (0.1, 0.2, 0.3)), (JColor.GRAY, Color.GRAY)):
        jl, tl = JLidar(None, render_color=jc), Lidar(None, render_color=tc)
        assert tl.render_color == jl.render_color and not isinstance(tl.render_color, Color)
        assert tl.render(0) == jl.render(0) == []
        assert tl._render is jl._render is True and tl.alpha == jl.alpha
        tl.set_render(False)
        jl.set_render(False)
        assert tl._render is jl._render is False
    assert Lidar(None, render=False)._render is False

    jenv, tenv = pair("flocking", n_agents=3)
    sensors = [(js, ts) for ja, ta in zip(jenv.world.agents, tenv.world.agents)
               for js, ts in zip(ja.sensors, ta.sensors)]
    assert sensors
    try:
        for js, ts in sensors:
            assert ts.render_color == js.render_color
            js.set_render(False)
            ts.set_render(False)
        jf, tf = jenv.render(mode="rgb_array"), tenv.render(mode="rgb_array")
    finally:
        for js, ts in sensors:
            js.set_render(True)
            ts.set_render(True)
    assert_frames(jf, tf)
    assert frame_diff(tf, tenv.render(mode="rgb_array"))[1] > 0, "the fans drew nothing"


# -- the viewer settings, for every name -----------------------------------

VIEWER_DEFAULTS = {"viewer_size": (700, 700), "viewer_zoom": 1.2, "render_origin": (0.0, 0.0),
                   "visualize_semidims": True, "plot_grid": False}


def _names():
    return sorted(sys.modules["vmas_tpu.scenarios"]._names())


@pytest.mark.parametrize("name", _names())
def test_viewer_settings_match_jax(name):
    jsc = sys.modules["vmas_tpu.scenarios"].load(name).Scenario()
    jsc.env_make_world(B, None)
    tsc = sys.modules["vmas_tpu_torch.scenarios"].load(name).Scenario()
    tsc.env_make_world(B, "cpu")
    norm = lambda v: list(v) if isinstance(v, (list, tuple)) else v
    for attr, default in VIEWER_DEFAULTS.items():
        assert norm(getattr(tsc, attr, default)) == norm(getattr(jsc, attr, default)), attr


def test_every_name_has_its_settings_test():
    assert len(_names()) == 43


# -- the frame's host copy --------------------------------------------------

@pytest.mark.parametrize("name,kw", [("football", {"ai_red_agents": True}), ("drone", {}),
                                     ("wind_flocking", {}), ("painting", {})])
def test_host_state_is_the_row(name, kw):
    """Every leaf of ``host_state``'s row is env k's row of the interop copy,
    bitwise and in its dtype (nested scratch, the drone's ``dyn``, dynamic
    gravity, booleans, integers), and the view is that row at every env."""
    from vmas_tpu_torch.render.viewer import host_state

    env = torch_make_env(name, 3, device="cpu", seed=0, **kw)
    env.step(env.get_random_actions())
    ref = state_to_numpy(env.state)
    for k in range(3):
        row, view = host_state(env.state, k)
        got = state_to_numpy(row)
        assert set(got) == set(ref)

        def same(a, b, path):
            if isinstance(b, dict):
                assert set(a) == set(b), path
                for key in b:
                    same(a[key], b[key], f"{path}.{key}")
            elif isinstance(b, (list, tuple)):
                for i, (x, y) in enumerate(zip(a, b)):
                    same(x, y, f"{path}[{i}]")
            else:
                want = b[k:k + 1] if b.ndim and b.shape[0] == 3 else b
                assert a.dtype == want.dtype and np.array_equal(a, want), path

        for f in ref:
            same(got[f], ref[f], f)
        assert view.pos.shape == env.state.pos.shape and not view.pos.is_cuda
        for j in range(3):
            assert torch.equal(view.pos[j], env.state.pos[k]) and torch.equal(view.rendering[j],
                                                                                env.state.rendering[k])


def test_hook_calls_refuse_a_tensor_off_the_cpu():
    """A hook that hands matplotlib a tensor off the CPU fails under the
    recorder (as it would with matplotlib), and the recorder puts the real
    matplotlib modules back."""
    from vmas_tpu_torch import testing
    from vmas_tpu_torch.render import draw
    from vmas_tpu_torch.render.viewer import host_state

    env = torch_make_env("transport", 2, device="cpu", seed=0)
    env.scenario.extra_render = lambda e, ax, k: ax.plot(torch.zeros(2, device="meta"), [0.0, 1.0])
    with pytest.raises(AssertionError, match="meta"):
        testing.hook_calls(env, host_state(env.state, 0)[1], 0)
    env.scenario.extra_render = lambda e, ax, k: draw.draw_circle(ax, e.state.pos[k, 0], 0.1, (1, 0, 0))
    calls = testing.hook_calls(env, host_state(env.state, 0)[1], 0)["extra_render"]
    assert [c[0] for c in calls] == ["matplotlib.patches.Circle", "ax.add_patch"]
    assert sys.modules["matplotlib.patches"].__name__ == "matplotlib.patches" and sys.modules["matplotlib"] is matplotlib


# -- wrappers, video, interactive play, utilities ----------------------------

@pytest.mark.parametrize("wrapper", ["gym", "gymnasium", "gymnasium_vec", "rllib"])
def test_wrapper_render(wrapper):
    """Each wrapper's render is the env's frame of env 0 (rllib's
    ``try_render_at`` of the env it is given)."""
    n = 1 if wrapper in ("gym", "gymnasium") else 2
    kw = {"terminated_truncated": True, "wrapper_kwargs": {"render_mode": "rgb_array"}} if "gymnasium" in wrapper \
        else {}
    env = torch_make_env("transport", n, device="cpu", seed=0, wrapper=wrapper, **kw)
    base = env.env
    base.step(base.get_random_actions())
    index = n - 1
    if wrapper == "gym":
        frame = env.render(mode="rgb_array")
    elif wrapper == "rllib":
        frame = env.try_render_at(index=index, mode="rgb_array")
        assert np.array_equal(env.try_render_at(mode="rgb_array"), base.render(mode="rgb_array", env_index=0))
    else:
        frame = env.render()
    want = base.render(mode="rgb_array", env_index=index if wrapper == "rllib" else 0)
    assert frame.ndim == 3 and np.array_equal(frame, want)


@pytest.mark.parametrize("encoders", ["installed", "none"])
def test_save_video_round_trip(tmp_path, monkeypatch, encoders):
    """save_video picks the file the JAX package's picks on the same
    frames; an .npz round-trips bitwise and an .mp4 holds every frame."""
    from vmas_tpu.render.video import save_video as jax_save_video

    from vmas_tpu_torch.render.video import save_video

    env = torch_make_env("transport", B, device="cpu", seed=0)
    frames = []
    for _ in range(3):
        env.step(env.get_random_actions())
        frames.append(env.render(mode="rgb_array"))
    if encoders == "none":
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "imageio", None)
    path = save_video(str(tmp_path / "port"), frames, fps=10)
    jpath = jax_save_video(str(tmp_path / "jax"), frames, fps=10)
    assert path[len(str(tmp_path / "port")):] == jpath[len(str(tmp_path / "jax")):]
    if path.endswith(".npz"):
        assert np.array_equal(np.load(path)["frames"], np.stack(frames))
    else:
        cv2 = pytest.importorskip("cv2")
        cap = cv2.VideoCapture(path)
        shapes = []
        ok, img = cap.read()
        while ok:
            shapes.append(img.shape)
            ok, img = cap.read()
        cap.release()
        assert shapes == [frames[0].shape] * 3
    with pytest.raises(ValueError):
        save_video(str(tmp_path / "empty"), [], fps=10)


def test_interactive_env_headless_loop():
    """InteractiveEnv's loop runs headless (Agg) on a CPU env: it steps,
    draws the readout, resets on done, and its key handlers change the
    control state."""
    from vmas_tpu_torch.render.interactive import InteractiveEnv

    env = torch_make_env("dispersion", 1, device="cpu", seed=0, n_agents=2, max_steps=2)
    ie = InteractiveEnv(env, control_two_agents=True, display_info=True)
    ie.run(max_steps=3)  # crosses the max_steps=2 done, then the reset
    assert ie.total_rew == [0.0, 0.0]
    assert "Obs:" in env._render_fig._suptitle.get_text()

    class _Ev:
        def __init__(self, key):
            self.key = key

    ie.on_key_press(_Ev("tab"))
    assert ie.agent_index == 0 and ie.agent2_index == 1
    ie.on_key_press(_Ev("3"))
    assert ie.comm_value == 3
    ie.on_key_press(_Ev("up"))
    assert "up" in ie.keys
    ie.on_key_release(_Ev("up"))
    assert "up" not in ie.keys
    from vmas_tpu.render.interactive import InteractiveEnv as JaxInteractiveEnv

    assert InteractiveEnv.format_obs(torch.tensor([0.123, 1.0])) == JaxInteractiveEnv.format_obs(
        np.array([0.123, 1.0]))


def test_interactive_rendering_module_alias(monkeypatch):
    """The module alias carries the class, the entry point and the
    command line, which takes ``--device``; ``render_interactively`` hands
    the device to make_env."""
    import vmas_tpu_torch
    from vmas_tpu_torch.interactive_rendering import InteractiveEnv, parse_args, render_interactively
    from vmas_tpu_torch.render import interactive

    assert callable(render_interactively) and callable(InteractiveEnv.format_obs)
    args = parse_args(["--scenario", "balance", "--save_render", "--device", "cpu"])
    assert args.scenario == "balance" and args.save_render and args.device == "cpu"
    assert parse_args([]).device is None
    seen = []
    monkeypatch.setattr(interactive.InteractiveEnv, "run", lambda self: seen.append(self.env.device))
    vmas_tpu_torch.render_interactively("dispersion.py", device="cpu", n_agents=2)
    assert seen == [torch.device("cpu")]


def test_x_to_rgb_colormap_matches_jax():
    from vmas_tpu.utils import x_to_rgb_colormap as jax_cmap

    from vmas_tpu_torch.utils import x_to_rgb_colormap

    x = np.random.default_rng(0).normal(size=50).astype(np.float32)
    for kw in ({}, {"low": -1.0, "high": 0.5, "alpha": 0.3}, {"cmap_name": "plasma", "cmap_res": 7}):
        assert np.array_equal(x_to_rgb_colormap(x, **kw), jax_cmap(x, **kw))
    assert np.array_equal(x_to_rgb_colormap(torch.as_tensor(x)), jax_cmap(x))
    assert np.array_equal(x_to_rgb_colormap(np.ones(4)), jax_cmap(np.ones(4)))


def test_extract_nested_with_index_matches_jax():
    from vmas_tpu.utils import extract_nested_with_index as jax_extract

    from vmas_tpu_torch.utils import extract_nested_with_index

    data = {"a": np.arange(6).reshape(3, 2), "b": {"c": np.arange(3) * 2.0}}
    tdata = {"a": torch.arange(6).reshape(3, 2), "b": {"c": torch.arange(3) * 2.0}}
    for i in range(3):
        got, want = extract_nested_with_index(tdata, i), jax_extract(data, i)
        assert np.array_equal(got["a"].numpy(), want["a"]) and float(got["b"]["c"]) == float(want["b"]["c"])
    assert torch.equal(extract_nested_with_index(torch.arange(4), 2), torch.tensor(2))


def test_rllib_wrapper_renders_without_gymnasium():
    """Where gymnasium is not installed (as on a GPU machine without it),
    the rllib wrapper builds, steps and renders; its spaces, which need
    gymnasium, are built on first access."""
    import pathlib
    import subprocess

    code = ("import sys; sys.modules['gymnasium'] = None\n"
            "import matplotlib; matplotlib.use('Agg')\n"
            "from vmas_tpu_torch import make_env\n"
            "env = make_env('transport', 2, device='cpu', seed=0, wrapper='rllib')\n"
            "obs = env.vector_reset()\n"
            "env.vector_step([[a[j] for a in env.env.get_random_actions()] for j in range(2)])\n"
            "frame = env.try_render_at(1, mode='rgb_array')\n"
            "try:\n"
            "    env.observation_space\n"
            "except ImportError:\n"
            "    print(len(obs), frame.shape, 'spaces need gymnasium')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(pathlib.Path(__file__).resolve().parent.parent))
    assert out.stdout.strip() == "2 (700, 700, 3) spaces need gymnasium", out.stdout + out.stderr
