"""Matplotlib drawing primitives for the scenarios' ``extra_render`` and
``top_layer_render`` hooks.

Counterpart of vmas_tpu/render/draw.py, with the same signatures. A hook
receives ``(env, ax, env_index)``, where ``env.state`` is the frame's host
copy of the state (``viewer.render_env``), and calls these helpers, which
read positions from that copy as numpy arrays.
"""

from __future__ import annotations

import numpy as np


def _color(c):
    """Normalize Color enums / arrays to a matplotlib color tuple."""
    if hasattr(c, "value"):
        c = c.value
    c = np.asarray(c, dtype=float).reshape(-1)
    return tuple(c[:4] if len(c) >= 4 else c[:3])


def draw_circle(ax, center, radius, color, filled=False, alpha=1.0, zorder=3):
    """A circle outline, or a disc with ``filled``."""
    import matplotlib.patches as mpatches

    ax.add_patch(
        mpatches.Circle(
            np.asarray(center, dtype=float).reshape(2),
            float(radius),
            fill=filled,
            facecolor=_color(color) if filled else "none",
            edgecolor=_color(color),
            alpha=alpha,
            zorder=zorder,
        )
    )


def draw_line(ax, p0, p1, color, width=1.0, alpha=1.0, zorder=3):
    """A segment from ``p0`` to ``p1``."""
    p0 = np.asarray(p0, dtype=float).reshape(2)
    p1 = np.asarray(p1, dtype=float).reshape(2)
    ax.plot([p0[0], p1[0]], [p0[1], p1[1]], color=_color(color), lw=width, alpha=alpha, zorder=zorder)


def draw_polyline(ax, pts, color, width=1.0, close=False, alpha=1.0, zorder=3):
    """A polyline through ``pts`` ``[N, 2]``, closed with ``close``."""
    pts = np.asarray(pts, dtype=float)
    if close and len(pts):
        pts = np.concatenate([pts, pts[:1]], axis=0)
    ax.plot(pts[:, 0], pts[:, 1], color=_color(color), lw=width, alpha=alpha, zorder=zorder)


def draw_wedge(ax, center, radius, theta0, theta1, color, alpha=1.0, zorder=3):
    """Filled circular sector. Angles in radians."""
    import matplotlib.patches as mpatches

    ax.add_patch(
        mpatches.Wedge(
            np.asarray(center, dtype=float).reshape(2),
            float(radius),
            np.degrees(theta0),
            np.degrees(theta1),
            facecolor=_color(color),
            edgecolor="none",
            alpha=alpha,
            zorder=zorder,
        )
    )


def draw_rect(ax, center, length, width, rot, color, alpha=1.0, zorder=3, filled=True):
    """Rotated rectangle centered at ``center``."""
    import matplotlib.patches as mpatches
    import matplotlib.transforms as mtransforms

    rect = mpatches.Rectangle(
        (-length / 2, -width / 2), length, width,
        facecolor=_color(color) if filled else "none",
        edgecolor=_color(color), alpha=alpha, zorder=zorder,
    )
    c = np.asarray(center, dtype=float).reshape(2)
    rect.set_transform(mtransforms.Affine2D().rotate(float(rot)).translate(*c) + ax.transData)
    ax.add_patch(rect)


def draw_comm_lines(ax, env, state, env_index, comms_range, color=(0, 0, 0), agents=None):
    """Lines between the agent pairs within ``comms_range`` of each other
    (navigation's, discovery's, sampling's and multi_give_way's hooks)."""
    agents = agents if agents is not None else env.world.agents
    pos = np.asarray(state.pos[env_index])
    for i, a in enumerate(agents):
        for j in range(i + 1, len(agents)):
            b = agents[j]
            pa, pb = pos[a.index], pos[b.index]
            if np.linalg.norm(pa - pb) <= comms_range:
                draw_line(ax, pa, pb, color, width=1.0)


def plot_entity_rotation(ax, entity, state, env_index, length=0.1, color=(0, 0, 0)):
    """Heading tick from the entity's center."""
    p = np.asarray(state.pos[env_index, entity.index])
    r = float(np.asarray(state.rot[env_index, entity.index]).reshape(-1)[0])
    draw_line(ax, p, p + length * np.array([np.cos(r), np.sin(r)]), color, width=1.5, zorder=5)


def draw_perimeter(ax, half_x, half_y=None, pad=0.0, color=(0, 0, 0), width=1.0):
    """Rectangular boundary of 4 lines at ±(half + pad): the passage,
    ball_passage, sampling and simple_tag arenas."""
    half_y = half_x if half_y is None else half_y
    x, y = half_x + pad, half_y + pad
    draw_polyline(ax, [(-x, -y), (x, -y), (x, y), (-x, y)], color, width=width, close=True)


def draw_agent_indices(ax, env, state, env_index, start_from=0, exclude=()):
    """Numeric labels on the agents."""
    pos = np.asarray(state.pos[env_index])
    i = start_from
    for a in env.world.agents:
        if a in exclude or a.name in {getattr(e, "name", e) for e in exclude}:
            continue
        p = pos[a.index]
        ax.text(p[0], p[1], str(i), fontsize=7, ha="center", va="center", zorder=6)
        i += 1
