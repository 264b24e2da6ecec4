"""Host-side rendering.

Counterpart of vmas_tpu/render/viewer.py: one env of a live Environment
drawn with matplotlib, on its Agg canvas (``rgb_array``) or in a window
(``human``), with the same camera (auto-zoom to fit the agents, agent
focus), semidim lines, grid, Lidar fans, force arrows, comm text and
scenario hooks, so that the same state gives the same frame.

A frame copies the state off the device once (``host_state``): env
``env_index``'s row of every per-env leaf, and every other leaf whole, packed
into one byte buffer on the state's device and brought to the host in one
copy, however many entities and leaves the state has. Everything the frame
draws reads that copy: the viewer, the Lidar (measured on the copied row,
on the host), the force arrows and the scenario's hooks. A hook is called
as ``hook(env, ax, env_index)`` with a view of the env whose ``state`` is
the copy (``FrameEnv``), each per-env leaf broadcast back to the batch, so
``env.state.<leaf>[env_index]`` reads env ``env_index`` as it does on the
live state. matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vmas_tpu_torch.core.shapes import Box, Line, Sphere
from vmas_tpu_torch.core.state import WorldState
from vmas_tpu_torch.core.utils import VIEWER_DEFAULT_ZOOM


def _leaves(x, out):
    """``x`` with each tensor in it replaced by its index in ``out``, to
    which the tensor is appended (dicts, tuples and lists are walked)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
        return _Leaf(len(out) - 1)
    if isinstance(x, dict):
        return {k: _leaves(v, out) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_leaves(v, out) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class _Leaf:
    i: int


def _fill(x, tensors):
    if isinstance(x, _Leaf):
        return tensors[x.i]
    if isinstance(x, dict):
        return {k: _fill(v, tensors) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_fill(v, tensors) for v in x)
    return x


def host_state(state: WorldState, env_index: int):
    """The frame's host copy of ``state``: ``(row, view)``, two
    :class:`WorldState` on the CPU that share their tensors. ``row`` has a
    batch of one, env ``env_index``'s; ``view`` broadcasts each per-env leaf
    of ``row`` back to the batch (a view, no copy). A leaf is per env where
    its leading axis is the batch, the rule of ``state.blend``; any other
    leaf is copied whole.

    The copy is ONE device-to-host transfer: each leaf's bytes go into one
    buffer on the state's device, widest element first, so that every leaf
    starts at a multiple of its own element size, and the buffer crosses
    once. (One ``.cpu()`` a leaf would make as many copies as leaves, and
    the leaves grow with the agents: their actions, scratch and dynamics
    state.)"""
    B = state.batch_dim
    tensors = []
    tree = _leaves({f.name: getattr(state, f.name) for f in dataclasses.fields(state)}, tensors)
    parts = [t.detach()[env_index:env_index + 1] if t.ndim and t.shape[0] == B else t.detach() for t in tensors]
    order = sorted(range(len(parts)), key=lambda i: -parts[i].element_size())
    buf = torch.cat([_bytes(parts[i]) for i in order]).cpu()
    rows, views, o = [None] * len(parts), [None] * len(parts), 0
    for i in order:
        p = parts[i]
        n = p.numel() * p.element_size()
        rows[i] = buf[o:o + n].view(p.dtype).reshape(p.shape)
        o += n
        per_env = tensors[i].ndim and tensors[i].shape[0] == B
        views[i] = rows[i].expand(B, *p.shape[1:]) if per_env else rows[i]
    return WorldState(**_fill(tree, rows)), WorldState(**_fill(tree, views))


def _bytes(t):
    """``t``'s elements as a flat uint8 view (a copy where ``t`` is not
    contiguous)."""
    flat = t.contiguous().reshape(-1)
    if flat.numel() <= 1:  # a tensor of one element may keep any stride
        flat = flat.as_strided((flat.numel(),), (1,))
    return flat.view(torch.uint8)


class FrameEnv:
    """The environment as a frame's hooks see it: every attribute is the
    env's own, but ``state``, which is the frame's host copy."""

    def __init__(self, env, state: WorldState):
        self._env = env
        self.state = state

    def __getattr__(self, name):
        return getattr(self._env, name)


def _entity_patches(env, row, env_index, ax):
    """Matplotlib patches for every entity, from the frame's row."""
    import matplotlib.patches as mpatches
    import matplotlib.transforms as mtransforms

    patches = []
    pos = row.pos[0].numpy()
    rot = row.rot[0].numpy()
    rendering = row.rendering[0].numpy()
    for e in env.world.entities:
        if not rendering[e.index]:
            continue
        p = pos[e.index]
        r = rot[e.index]
        color = e.color
        if hasattr(color, "__len__") and len(np.asarray(color).shape) > 1:
            color = np.asarray(color)[env_index]
        alpha = getattr(e, "alpha", 1.0)
        if isinstance(e.shape, Sphere):
            patches.append(mpatches.Circle(p, e.shape.radius, color=color, alpha=alpha))
        elif isinstance(e.shape, Box):
            rect = mpatches.Rectangle(
                (-e.shape.length / 2, -e.shape.width / 2), e.shape.length, e.shape.width,
                color=color, alpha=alpha,
            )
            # composed with transData: a bare Affine2D would leave the patch
            # in display (pixel) coordinates
            rect.set_transform(mtransforms.Affine2D().rotate(r).translate(*p) + ax.transData)
            patches.append(rect)
        elif isinstance(e.shape, Line):
            half = e.shape.length / 2
            d = np.array([np.cos(r), np.sin(r)]) * half
            patches.append(
                mpatches.FancyArrow(*(p - d), *(2 * d), width=0.005, head_width=0, color=color, alpha=alpha)
            )
    return patches


def _draw_sensors(ax, env, row):
    """Each rendered Lidar's ray fan and hit dots, measured once a frame on
    the frame's row, on the host."""
    import matplotlib.patches as mpatches

    for agent in env.world.agents:
        for sensor in getattr(agent, "sensors", []):
            if not getattr(sensor, "_render", True):
                continue
            meas = sensor.measure(row)[0].numpy()
            p = agent.pos(row)[0].numpy()
            rot = float(agent.rot(row)[0].reshape(-1)[0])
            angles = np.asarray(sensor._angles) + rot
            color = getattr(sensor, "render_color", (0.0, 0.0, 0.0))
            if hasattr(color, "value"):
                color = color.value
            for ang, dist in zip(angles, meas):
                end = p + dist * np.array([np.cos(ang), np.sin(ang)])
                ax.plot([p[0], end[0]], [p[1], end[1]], color=color, lw=0.5, alpha=0.3)
                if dist < sensor.max_range - 1e-6:
                    ax.add_patch(mpatches.Circle(end, 0.01, color=color, alpha=0.6))


def _draw_actions(ax, env, row):
    """Force arrows on the agents with ``render_action``."""
    for agent in env.world.agents:
        if not getattr(agent, "render_action", False):
            continue
        f = row.force[0, agent.index].numpy()
        if np.linalg.norm(f) < 1e-6:
            continue
        p = row.pos[0, agent.index].numpy()
        scale = 0.1 / max(np.linalg.norm(f), 1e-6) * min(np.linalg.norm(f), 1.0)
        ax.annotate("", xy=p + f * scale, xytext=p, arrowprops=dict(arrowstyle="->", color="black", lw=1.0))


def render_function_util(f, plot_range, ax, cmap_range=None, cmap_alpha=0.5, precision=0.01, cmap_name="viridis"):
    """Evaluate ``f`` over a meshgrid and draw it as an image overlay.
    ``f`` maps ``[N, 2]`` float32 host positions to ``[N]`` values or
    ``[N, 4]`` RGBA rows, as a numpy array or a CPU tensor."""
    if isinstance(plot_range, (int, float)):
        x_min, x_max = -plot_range, plot_range
        y_min, y_max = -plot_range, plot_range
    else:
        xr, yr = plot_range
        x_min, x_max = (-xr, xr) if isinstance(xr, (int, float)) else xr
        y_min, y_max = (-yr, yr) if isinstance(yr, (int, float)) else yr
    xs = np.arange(x_min, x_max, precision, dtype=np.float32)
    ys = np.arange(y_min, y_max, precision, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    vals = np.asarray(f(pts))
    if vals.ndim == 2 and vals.shape[-1] == 4:
        img = vals.reshape(len(ys), len(xs), 4)
    else:
        vals = vals.reshape(len(ys), len(xs)).astype(np.float32)
        lo, hi = cmap_range if cmap_range is not None else (vals.min(), vals.max())
        import matplotlib

        norm = (vals - lo) / max(hi - lo, 1e-9)
        img = matplotlib.colormaps[cmap_name](np.clip(norm, 0, 1))
        img[..., 3] = cmap_alpha
    ax.imshow(img, extent=(x_min, x_max, y_min, y_max), origin="lower", zorder=-1)


def _call_render_hook(hook, env, ax, env_index):
    """Invoke a scenario render hook. The contract is
    ``hook(env, ax, env_index)``; a hook written against the older
    signature ``hook(env_index=0) -> list`` is detected by arity and called
    that way, its return value ignored."""
    import inspect

    try:
        n_params = len(inspect.signature(hook).parameters)
    except (TypeError, ValueError):
        n_params = 3
    if n_params >= 3:
        hook(env, ax, env_index)
    else:
        hook(env_index)


def render_env(
    env,
    mode: str = "human",
    env_index: int = 0,
    agent_index_focus: int = None,
    visualize_when_rgb: bool = False,
    plot_position_function=None,
    plot_position_function_precision: float = 0.01,
    plot_position_function_range=None,
    plot_position_function_cmap_range=None,
    plot_position_function_cmap_alpha: float = 1.0,
    plot_position_function_cmap_name: str = "viridis",
    **kwargs,
):
    """Render env ``env_index`` of a live Environment. Returns an RGB array
    ``[H, W, 3]`` uint8 for ``mode="rgb_array"``, None for ``"human"``."""
    import matplotlib.pyplot as plt

    row, view = host_state(env.state, env_index)
    frame_env = FrameEnv(env, view)
    scenario = env.scenario
    viewer_size = getattr(scenario, "viewer_size", (700, 700))
    zoom = getattr(scenario, "viewer_zoom", VIEWER_DEFAULT_ZOOM)

    # one cached figure per Environment, cleared for each frame; the backend
    # is never switched (a GUI canvas also has buffer_rgba, and switching to
    # Agg mid-session would close open windows)
    fig = getattr(env, "_render_fig", None)
    if fig is None or not plt.fignum_exists(fig.number):
        fig, _ = plt.subplots(figsize=(viewer_size[0] / 100, viewer_size[1] / 100), dpi=100)
        env._render_fig = fig
    fig.clf()
    ax = fig.add_subplot(111)

    # the camera, first, so that a heat map with range None spans the
    # visible bounds
    pos = row.pos[0].numpy()
    if agent_index_focus is not None:
        c = pos[env.agents[agent_index_focus].index]
        xlim = (c[0] - zoom, c[0] + zoom)
        ylim = (c[1] - zoom, c[1] + zoom)
    else:
        agent_pos = pos[[a.index for a in env.world.agents]] if env.world.agents else pos
        cx, cy = getattr(scenario, "render_origin", (0.0, 0.0))
        # fit all agents plus a 2 * max agent radius margin, never tighter
        # than zoom
        max_radius = max((a.shape.radius for a in env.world.agents if isinstance(a.shape, Sphere)), default=0.05)
        fit = max(
            float(np.abs(agent_pos[:, 0] - cx).max(initial=0.0)),
            float(np.abs(agent_pos[:, 1] - cy).max(initial=0.0)),
        )
        extent = max(fit + 2 * max_radius, zoom * 1.0)
        xlim = (cx - extent, cx + extent)
        ylim = (cy - extent, cy + extent)

    if plot_position_function is not None:
        rng = plot_position_function_range
        if rng is None:
            rng = (xlim, ylim)
        render_function_util(
            plot_position_function, rng, ax,
            cmap_range=plot_position_function_cmap_range,
            cmap_alpha=plot_position_function_cmap_alpha,
            precision=plot_position_function_precision,
            cmap_name=plot_position_function_cmap_name,
        )
    _call_render_hook(scenario.extra_render, frame_env, ax, env_index)
    for patch in _entity_patches(env, row, env_index, ax):
        ax.add_patch(patch)
    _draw_sensors(ax, env, row)
    _draw_actions(ax, env, row)
    _call_render_hook(scenario.top_layer_render, frame_env, ax, env_index)

    # after all drawing, so that no artist's autoscale wins
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)

    if getattr(scenario, "visualize_semidims", True):
        if env.world.x_semidim is not None:
            ax.axvline(-env.world.x_semidim, color="k", lw=0.8)
            ax.axvline(env.world.x_semidim, color="k", lw=0.8)
        if env.world.y_semidim is not None:
            ax.axhline(-env.world.y_semidim, color="k", lw=0.8)
            ax.axhline(env.world.y_semidim, color="k", lw=0.8)
    if getattr(scenario, "plot_grid", False):
        ax.grid(True, alpha=0.3)

    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])

    # one "<name> sends <word>" line per non-silent agent, 40 px apart: the
    # comm vector for continuous actions, the ALPHABET letter of its argmax
    # for discrete ones
    if env.world.dim_c > 0:
        from vmas_tpu_torch.core.utils import ALPHABET

        c_all = row.c[0].numpy()
        idx = 0
        for a_i, agent in enumerate(env.world.agents):
            if agent.silent:
                continue
            c = c_all[a_i]
            if env.continuous_actions:
                word = "[" + ",".join(f"{v:.2f}" for v in c) + "]"
            else:
                word = ALPHABET[int(np.argmax(c))]
            fig.text(0.01, (10 + idx * 40) / viewer_size[1], f"{agent.name} sends {word}   ", fontsize=9)
            idx += 1

    if mode == "rgb_array":
        if visualize_when_rgb:
            # show the live window while also returning the frame (what
            # interactive play relies on)
            plt.show(block=False)
            plt.pause(0.001)
        fig.canvas.draw()
        return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.show(block=False)
    plt.pause(0.001)
    return None
