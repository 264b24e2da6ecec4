"""The fused physics step: one hand-written CUDA kernel per env step.

Counterpart of vmas_tpu/core/fused.py. The state is packed as
component rows ``[9E, B]`` (px, py, vx, vy, rot, w, fx, fy, tq per entity),
one column per env. One kernel (``csrc/fused_step.cu``: each env on a group of
``KernelSpec.lanes`` lanes, its items spread over them, its rows in shared
memory) runs every substep of the physics and then the scenario's output
rows (``FusedOutputs.emit``), in two forms:

* ``fused_physics_step``: rows ``[9E + J (+ 2E) + K_in, B]`` in (the 2E
  rows of a world with dynamic gravity: each entity's x, then y), ``[9E +
  K_out, B]`` out; reached from ``World.step`` / ``World.step_with_outputs``.
* ``make_rows_step``: the rows-carried rollout step; the carry is the
  kernel's own row buffer, the per-step action rows override the agents'
  force rows, the scenario's in-kernel ``process_action`` (the PID velocity
  controller, ``PidActRows``) turns them into forces, and the emit rows go to
  a caller-given slice. One launch runs ``k_steps`` whole env steps.

Each form has a plain PyTorch version here (``fused_step_plain``,
``rows_step_plain``) that repeats the kernel's arithmetic in the kernel's
order; both forms share one function (``_step_rows``), as both kernel forms
share one device function. A wrapper runs the plain version for a tensor on
the CPU and the kernel for a tensor on a GPU, and counts each kernel
launch in ``fused_step_launches`` / ``rows_step_launches``.

Covered: joint constraints (attractive and repulsive anchor forces, and the
rotation torque of ``rotate=False`` constraints against the fixed
rotations the carry holds), all six shape-pair contact types
(sphere-sphere, line-sphere, line-line, box-sphere, box-line, box-box, in
that order), action clamps, friction, static gravity, per-env dynamic
gravity (the fused form only, as in the JAX package), drag, speed clamps,
semidim clamps, any substeps, the PID velocity controller in the rows form,
several env steps per rows launch, and the emits of transport, balance,
joint_passage, waterfall, give_way, multi_give_way, the MPE worlds simple,
simple_spread, simple_push, simple_adversary, simple_tag, simple_reference,
simple_speaker_listener and simple_world_comm, the holonomic worlds
reverse_transport, wheel, passage, dispersion, dropout and het_mass (the
fused form only), the joint worlds buzz_wire, ball_trajectory,
ball_passage and joint_passage_size, and the sensor worlds navigation,
flocking and discovery (discovery's in the fused form only). The world's
joint and pair tables, lane lists and per-entity constants live in one
device buffer (``KernelSpec.pair_table``), so a world may have any number
of joints and pairs; ``check_fusable`` holds it to the kernel's caps on
entities, agents and scratch rows.
Forward only: ``Environment`` refuses ``grad_enabled`` with
``fused_physics``.

The kernel adds each item's contributions to an entity in the plain
version's order by walking the entity's list (``KernelSpec.lists``, in the
table buffer), so the two agree bitwise; ``lanes_for`` is the rule that
picks the lanes per env from the world's spec.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmas_tpu_torch import _kernels as K
from vmas_tpu_torch.core.utils import LINE_MIN_DIST

_MIN_DIST = 1e-6

# kernel launches per form; only the GPU wrappers add to them
fused_step_launches = 0
rows_step_launches = 0


# ---------------------------------------------------------------------------
# helpers on [B] rows; a "vec" is an (x, y) pair of rows
# ---------------------------------------------------------------------------

def _norm(x, y):
    sq = x * x + y * y
    is_zero = sq == 0.0
    return torch.where(is_zero, 0.0, torch.sqrt(torch.where(is_zero, 1.0, sq)))


def _div(num, den: float):
    """``num / den`` for a Python float ``den`` as one IEEE division, as the
    kernel divides. (PyTorch turns ``cuda_tensor / python_float`` into a
    multiplication by the reciprocal, and ``python_float / tensor`` into
    ``tensor.reciprocal() * python_float`` on every device; either can
    differ from the division in the last bit.)"""
    return num / num.new_tensor(den)


def _rdiv(num: float, den):
    """``num / den`` for a Python float ``num`` as one IEEE division."""
    return den.new_tensor(num) / den


# pi rounded once to f32, as jnp.mod(x, jnp.pi) takes it and the kernel's
# PI_F holds it
PI_F = float(np.float32(math.pi))


def _mod_pi(x):
    """``jnp.mod(x, jnp.pi)`` as the JAX package computes it and the kernel's
    ``mod_pi``: C ``fmod`` (exact), then the divisor's sign where the
    remainder is non-zero and of the other sign."""
    r = torch.fmod(x, PI_F)
    return torch.where((r != 0.0) & (r < 0.0), r + PI_F, r)


def _one_hot_select(idx_row, rows):
    """The row ``rows[idx]`` per env, for a float index row ``idx_row`` (a
    scratch row): ``sum((idx == k) * rows[k])`` from 0, as the JAX package
    and the kernel compute it (the one exact term is the gathered value)."""
    return sum((idx_row == float(k)).to(torch.float32) * r for k, r in enumerate(rows))


def _logaddexp0(x):
    # logaddexp(0, x) = max(x, 0) + log1p(exp(-|x|))
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _constraint_force(cm, ax, ay, bx, by, dist_min, mult, attractive=False):
    """Penalty force on a (negate for b): repulsive inside ``dist_min``, or
    attractive beyond it. The attractive form applies the sign before the
    division by ``cm`` and drops the force inside ``dist_min``."""
    dx, dy = ax - bx, ay - by
    dist = _norm(dx, dy)
    if attractive:
        penetration = _logaddexp0(_div((dist_min - dist) * -1.0, cm)) * cm
        scale = -mult * penetration / torch.where(dist > 0, dist, 1e-8)
        drop = (dist < _MIN_DIST) | (dist < dist_min)
    else:
        penetration = _logaddexp0(_div(dist_min - dist, cm)) * cm
        scale = mult * penetration / torch.where(dist > 0, dist, 1e-8)
        drop = (dist < _MIN_DIST) | (dist > dist_min)
    fx, fy = dx * scale, dy * scale
    return torch.where(drop, 0.0, fx), torch.where(drop, 0.0, fy)


def _closest_point_line(lx, ly, cos, sin, half_len, px, py):
    dot = (lx - px) * cos + (ly - py) * sin
    sign = torch.sign(dot)
    dist = torch.clamp(torch.abs(dot), max=half_len)
    return lx - sign * dist * cos, ly - sign * dist * sin


def _pick_closest(cands):
    """First-min-wins selection over [(p1x, p1y, p2x, p2y), ...]."""
    bx1, by1, bx2, by2 = cands[0]
    bd = _norm(bx1 - bx2, by1 - by2)
    for cx1, cy1, cx2, cy2 in cands[1:]:
        d = _norm(cx1 - cx2, cy1 - cy2)
        better = d < bd
        bx1 = torch.where(better, cx1, bx1)
        by1 = torch.where(better, cy1, by1)
        bx2 = torch.where(better, cx2, bx2)
        by2 = torch.where(better, cy2, by2)
        bd = torch.where(better, d, bd)
    return bx1, by1, bx2, by2


def _box_edges(px, py, cos, sin, half_w, half_l):
    """The 4 box edges as (pos, cos, sin, half_len), in the order +length,
    -length, +width, -width."""
    wx, wy = -sin, cos
    return [
        (px + cos * half_l, py + sin * half_l, wx, wy, half_w),
        (px - cos * half_l, py - sin * half_l, wx, wy, half_w),
        (px + wx * half_w, py + wy * half_w, cos, sin, half_l),
        (px - wx * half_w, py - wy * half_w, cos, sin, half_l),
    ]


def _closest_point_box(px, py, cos, sin, half_w, half_l, tx, ty):
    cands = []
    for ex, ey, ecos, esin, ehalf in _box_edges(px, py, cos, sin, half_w, half_l):
        cx, cy = _closest_point_line(ex, ey, ecos, esin, ehalf, tx, ty)
        cands.append((cx, cy, tx, ty))
    bx, by, _, _ = _pick_closest(cands)
    return bx, by


def _line_extrema(lx, ly, cos, sin, half):
    return (lx + cos * half, ly + sin * half, lx - cos * half, ly - sin * half)


def _intersection(a1x, a1y, a2x, a2y, b1x, b1y, b2x, b2y):
    """geometry.intersection_point_line_line on rows -> (ix, iy, hit); a
    parallel pair (cross_r_s == 0) divides by 1 and never hits."""
    rx, ry = a2x - a1x, a2y - a1y
    sx, sy = b2x - b1x, b2y - b1y
    qpx, qpy = b1x - a1x, b1y - a1y
    cross_qp_r = qpx * ry - qpy * rx
    cross_qp_s = qpx * sy - qpy * sx
    cross_r_s = rx * sy - ry * sx
    den = torch.where(cross_r_s == 0.0, 1.0, cross_r_s)
    u = cross_qp_r / den
    t = cross_qp_s / den
    cond = (cross_r_s != 0.0) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return a1x + t * rx, a1y + t * ry, cond


def _closest_points_line_line(ax, ay, acos, asin, ahalf, bx, by, bcos, bsin, bhalf):
    """(point on a, point on b): the intersection where the segments cross,
    else the first closest of (a1, a1 on b), (a2, a2 on b), (b1 on a, b1),
    (b2 on a, b2)."""
    a1x, a1y, a2x, a2y = _line_extrema(ax, ay, acos, asin, ahalf)
    b1x, b1y, b2x, b2y = _line_extrema(bx, by, bcos, bsin, bhalf)
    ix, iy, hit = _intersection(a1x, a1y, a2x, a2y, b1x, b1y, b2x, b2y)

    a1bx, a1by = _closest_point_line(bx, by, bcos, bsin, bhalf, a1x, a1y)
    a2bx, a2by = _closest_point_line(bx, by, bcos, bsin, bhalf, a2x, a2y)
    b1ax, b1ay = _closest_point_line(ax, ay, acos, asin, ahalf, b1x, b1y)
    b2ax, b2ay = _closest_point_line(ax, ay, acos, asin, ahalf, b2x, b2y)

    p1x, p1y, p2x, p2y = _pick_closest([
        (a1x, a1y, a1bx, a1by),
        (a2x, a2y, a2bx, a2by),
        (b1ax, b1ay, b1x, b1y),
        (b2ax, b2ay, b2x, b2y),
    ])
    return (torch.where(hit, ix, p1x), torch.where(hit, iy, p1y),
            torch.where(hit, ix, p2x), torch.where(hit, iy, p2y))


def _closest_line_box(px, py, cos, sin, half_w, half_l, lx, ly, lcos, lsin, lhalf):
    """(point on the box, point on the line), over the box's edges in
    _box_edges order."""
    cands = []
    for ex, ey, ecos, esin, ehalf in _box_edges(px, py, cos, sin, half_w, half_l):
        cands.append(_closest_points_line_line(ex, ey, ecos, esin, ehalf, lx, ly, lcos, lsin, lhalf))
    return _pick_closest(cands)


def _bb_closest(ax, ay, ca, sa, hwa, hla, bx, by, cb, sb, hwb, hlb):
    """(point on a, point on b) of two boxes: a's edges against b's
    perimeter first, then b's edges against a's; first minimum wins."""
    cands = []
    for ex, ey, ecos, esin, ehalf in _box_edges(ax, ay, ca, sa, hwa, hla):
        onb_x, onb_y, ona_x, ona_y = _closest_line_box(bx, by, cb, sb, hwb, hlb, ex, ey, ecos, esin, ehalf)
        cands.append((ona_x, ona_y, onb_x, onb_y))
    for ex, ey, ecos, esin, ehalf in _box_edges(bx, by, cb, sb, hwb, hlb):
        cands.append(_closest_line_box(ax, ay, ca, sa, hwa, hla, ex, ey, ecos, esin, ehalf))
    return _pick_closest(cands)


def _inner_point_box(ox, oy, sx, sy, bx, by):
    """geometry.inner_point_box on rows -> (ix, iy, dist)."""
    vx, vy = sx - ox, sy - oy
    ux, uy = bx - sx, by - sy
    vn = _norm(vx, vy)
    den = torch.where(vn == 0.0, 1.0, vn)
    mag = (vx * ux + vy * uy) / den
    xx, xy_ = vx / den * mag, vy / den * mag
    degenerate = vn == 0.0
    # the degenerate lane substitutes the SURFACE POINT for the offset
    # (inner = 2 * surface), as geometry.inner_point_box does
    ix = sx + torch.where(degenerate, sx, xx)
    iy = sy + torch.where(degenerate, sy, xy_)
    d = torch.where(degenerate, 0.0, torch.abs(mag))
    return ix, iy, d


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

# the JAX package's cost rule, exactly: rough per-pair instruction weights
# (bb expands to 8 line-box candidates of 4 line-line tests each), and a
# type with at least _LANE_MIN pairs costs one vectorized computation per 8
# pairs plus its scatter (the JAX kernel's lane-tile form)
_PAIR_WEIGHT = {"ss": 1, "ls": 2, "ll": 5, "bs": 5, "bl": 20, "bb": 40}
_MAX_UNROLL = 4000
_LANE_MIN = 8


def _pair_cost(n, weight, substeps):
    if n >= _LANE_MIN:
        return (-(-n // 8) + n // 4) * weight * substeps
    return n * weight * substeps


def supports(world) -> bool:
    """The JAX package's rule (vmas_tpu/core/fused.py supports): very
    contact-saturated worlds take the plain physics path instead of the
    fused step, so both packages fuse the same worlds."""
    spec = world.spec
    substeps = int(world.substeps)
    cost = (
        _pair_cost(len(spec.ss_a), _PAIR_WEIGHT["ss"], substeps)
        + _pair_cost(len(spec.ls_line), _PAIR_WEIGHT["ls"], substeps)
        + _pair_cost(len(spec.ll_a), _PAIR_WEIGHT["ll"], substeps)
        + _pair_cost(len(spec.bs_box), _PAIR_WEIGHT["bs"], substeps)
        + _pair_cost(len(spec.bl_box), _PAIR_WEIGHT["bl"], substeps)
        + _pair_cost(len(spec.bb_a), _PAIR_WEIGHT["bb"], substeps)
        + len(spec.joint_idx_a) * 2 * substeps
        + len(spec.movable) * substeps
    )
    return cost <= _MAX_UNROLL


def check_fusable(world, outputs=None) -> None:
    """Raise ``NotImplementedError`` for a world the port's kernel cannot
    step although the JAX package fuses it (``supports``): more than
    ``MAX_E`` entities; with fused ``outputs``, more than ``MAX_K`` scratch
    rows or ``MAX_A`` policy agents (the rows form's action slots), or an
    emit or in-kernel process_action beyond its own caps (``kernel_emit``,
    ``kernel_params``: ``MAX_A``, ``MAX_P``, ``MAX_RC``, ``MAX_PID``).
    ``Environment`` calls it when it is built, so that no cap first shows
    at a launch on the card."""
    E = len(world.spec.mass)
    if E > K.MAX_E:
        raise NotImplementedError(f"the fused kernel takes at most {K.MAX_E} entities (MAX_E), this world has {E}")
    if outputs is None:
        return
    if int(outputs.n_scratch_in) > K.MAX_K:
        raise NotImplementedError(f"the fused kernel takes at most {K.MAX_K} scratch rows (MAX_K), these outputs "
                                  f"have {int(outputs.n_scratch_in)}")
    A = len(world.policy_agents)
    if A > K.MAX_A:
        raise NotImplementedError(f"the fused kernel takes at most {K.MAX_A} policy agents (MAX_A), this world has "
                                  f"{A}")
    outputs.kernel_emit()
    if int(outputs.n_ctrl):
        outputs.process_act_rows.kernel_params()
    # the rows form's action slots: the policy agents, then the scripted
    # agents whose actions ride the action rows
    fit_lanes(world, outputs, A + len(getattr(outputs, "script_slots", ())))


class FusedOutputs:
    """Protocol for emitting a scenario's observations, rewards and
    termination as extra rows of the fused step (opt-in per scenario via
    ``Scenario.make_fused_outputs(world)``; see transport's).

    Required members:
      n_scratch_in: int -- extra input rows after the state rows
      n_out: int -- extra output rows after the 9E state rows
      scratch_rows(state) -> [n_scratch_in, B] tensor
      emit(ctx) -> list of n_out [B] rows, the plain version; ctx holds the
          post-integration per-entity rows px/py/vx/vy/rot/w/fx/fy and the
          scratch rows under "scratch"
      unpack(extra [..., n_out, B], state) -> (obs_tuple, rews_tuple,
          terminated bool, scratch_updates dict); leading axes (a rollout's
          T) pass through
      kernel_emit() -> (emit kind, _kernels.EmitParams): the device
          realization of emit compiled into the kernel

    Optional:
      carry_extra_idx: one entry per scratch row -- the emit row holding
          its next value (None: carried unchanged); opts into the
          rows-carried rollout, which holds unpack to reading no
          step-varying state but the emit rows.
      process_action_noop: True where the scenario overrides
          process_action but the override does nothing in this config
          (joint_passage with its velocity controller off), so the rows
          step may stand in for it.
      unpack_reads: step-varying inputs unpack reads besides the emit
          rows: the comm state ("c"), the decoded actions ("u"), the
          observation-noise streams ("obs_key": the noisy configs), the
          entities' state ("state": a Lidar's rays); the rows rollouts hand
          unpack each step's (parallel/rollout.py), the state rebuilt from
          each step's carry rows by the random-action rows rollout only.
      finish_obs(obs, state) -> obs: the observations completed after the
          scratch updates are merged and post_rewards has run, as the hook
          pipeline orders them (discovery's Lidar, which must see the
          targets where post_rewards respawned them). Default: identity.
          The rows rollouts refuse outputs that override it.
      script_slots / script_us(state, horizon): scripted agents whose
          actions the rows rollout can compute for the whole horizon up
          front (flocking's circling target): ``script_slots`` their entity
          indices, ``script_us`` one [T, B, 2] u per slot, the values the
          agent's action_script would give at each step. They ride the
          action rows after the policy agents'.
      step_count_keys: scratch keys that are pure step counters, read by
          nothing the kernel emits (joint_passage_size's "t"); unpack
          adds one to the value it is given, and the rows rollouts set
          them to their start value plus the horizon at their end.
      n_ctrl / n_ctrl_out / ctrl_rows(state) / ctrl_updates(rows, scratch)
      / process_act_rows(ctx) / ctrl_u_idx: an in-kernel realization of
          the scenario's process_action override for the rows path (the PID
          velocity controller of give_way, multi_give_way and joint_passage
          with ``use_controller=True``). ``n_ctrl`` controller rows ride the
          rows carry after the scratch rows (packed by ``ctrl_rows``); the
          rows step calls ``process_act_rows`` after the action-row override
          and before the physics substeps: it rewrites the ``fx``/``fy``
          rows of ctx (decoded u in, the force out) and the ``ctrl`` rows in
          place, and returns ``n_ctrl_out`` rows (the controller's raw
          output), which follow each step's emit rows.
          ``process_act_rows.kernel_params()`` gives its device realization
          (``_kernels.ActParams``). ``ctrl_updates`` maps the final carried
          rows back to scenario scratch, and ``ctrl_u_idx`` names, per
          policy agent, the (x, y) rows of a step's output block that hold
          its u, so the final state's ``u`` is the hook pipeline's (the
          controller's output, not the decoded action).
          ``attach_pid(pid)`` sets them all from a ``PidActRows``.
    """

    n_scratch_in = 0
    n_ctrl = 0
    n_ctrl_out = 0

    @staticmethod
    def scratch_rows(state):
        """Default: no scratch rows (override with n_scratch_in)."""
        return torch.zeros((0, state.batch_dim), dtype=torch.float32, device=state.device)

    @staticmethod
    def finish_obs(obs, state):
        return obs

    def attach_pid(self, pid: "PidActRows"):
        """Run ``pid`` as this config's in-kernel process_action: its carry
        rows, hook and output rows (after the ``n_out`` emit rows)."""
        self.process_act_rows = pid
        self.ctrl_rows, self.ctrl_updates = pid.ctrl_rows, pid.ctrl_updates
        self.n_ctrl, self.n_ctrl_out = pid.n_ctrl, pid.n_ctrl_out
        self.ctrl_u_idx = tuple((self.n_out + 2 * i, self.n_out + 2 * i + 1) for i in range(len(pid.slots)))


# ---------------------------------------------------------------------------
# the constants both versions read
# ---------------------------------------------------------------------------

# the item types in the order both versions accumulate them, and per type
# the record positions of its side-0 (+f) and side-1 (-f) entities and
# whether it has a torque on each side (the plain version's yields)
ITEM_TYPES = ("joints", "ss", "ls", "ll", "bs", "bl", "bb")
ITEM_SIDES = {
    "joints": (0, 1, True, True),
    "ss": (0, 1, False, False),
    "ls": (1, 0, False, True),
    "ll": (0, 1, True, True),
    "bs": (1, 0, False, True),
    "bl": (0, 1, True, True),
    "bb": (0, 1, True, True),
}

# the lane counts the kernel's source takes: 1, one thread per env; 4 to
# 32, a group of lanes per env. The package's build holds the two the rule
# picks (LANES_BUILT); the others are built with
# _kernels.build_variant("fused_step", ["VMAS_FUSED_ALL_LANES"]), as
# tools/time_fused_step.py builds them
LANES = (1, 4, 8, 16, 32)
LANES_BUILT = (1, 8)


# the most items of one type (joints or a pair type) a world may have and
# still run one thread per env
FEW_ITEMS = 3


# the shared memory one block may opt in to on an NVIDIA H100 (and H200):
# cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB
SMEM_OPTIN = 232448


def group_smem_bytes(ks, rows_mode, k_in, n_ctrl, n_rows_out, n_act, lanes) -> int:
    """The dynamic shared memory of one block of the group form at ``lanes``
    lanes per env, as ``smem_layout`` in csrc/fused_step.cu lays it out: the
    groups' item buffers, their env records (input rows, then 5E), the
    output rows, the rows form's action rows, and the table."""
    G = 128 // lanes
    n_max = max(len(getattr(ks, t)) for t in ITEM_TYPES)
    R_x = 9 * ks.E + ks.J + (k_in + n_ctrl if rows_mode else 2 * ks.E * ks.dyn_gravity + k_in)
    rec = R_x + 5 * ks.E
    stride = rec + ((lanes - rec % 32) % 32 + 32) % 32
    words = 4 * G * n_max + G * stride + n_rows_out * G + (2 * n_act * G if rows_mode else 0) + ks.table.size
    return 4 * words


def fit_lanes(world, outputs, n_act) -> None:
    """Where a block of the group form would need more shared memory than
    ``SMEM_OPTIN`` in either form (a world of many emit rows: simple_spread
    with 30 agents emits 3661), mark the world to run one thread per env
    (``world.fused_lanes``, which ``KernelSpec`` takes), which keeps an
    env's rows in per-thread memory. The spec is built here and not kept:
    the world's kernel spec is built at its first step."""
    ks = KernelSpec(world)
    if ks.lanes == 1 or outputs is None:
        return
    k_in, n_out = int(outputs.n_scratch_in), int(outputs.n_out)
    n_ctrl, n_ctrl_out = int(outputs.n_ctrl), int(outputs.n_ctrl_out)
    need = max(group_smem_bytes(ks, False, k_in, 0, n_out, 0, ks.lanes),
               group_smem_bytes(ks, True, k_in, n_ctrl, n_out + n_ctrl_out, n_act, ks.lanes))
    if need > SMEM_OPTIN:
        world.fused_lanes = 1


def lanes_for(ks) -> int:
    """Lanes per env of the kernel for this world, from its spec alone: 1
    (one thread per env) where no item type has more than ``FEW_ITEMS``
    items, else 8.

    Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6,
    tools/time_fused_step.py): at 4096 envs 8 lanes were the fastest count
    or within 24% of it in every world with more items, and 3.6-4.9x
    faster than one thread per env in the item-heavy ones (joint_passage,
    multi_give_way, waterfall); 32 lanes were never the fastest. A world of
    a few items spends its step in the serial emit, which a group runs on
    one of its lanes: one thread per env was 2.1-8.8x faster than any group
    at 30000 envs (simple_spread) and as fast at 4096 (wind_flocking).
    (``fit_lanes`` then takes one thread per env where a group's block
    would not fit the card's shared memory.)
    """
    n = max(len(getattr(ks, t)) for t in ITEM_TYPES)
    return 1 if n <= FEW_ITEMS else 8


class KernelSpec:
    """Every constant of one world's step, computed on the host exactly as
    vmas_tpu/core/fused.py computes its Python constants (double precision,
    rounded once to f32 where an op meets a tensor). The plain version reads
    these floats; ``to_ctypes`` rounds the same floats once into the
    kernel's ``FusedSpec``."""

    def __init__(self, world):
        spec = world.spec
        E = len(spec.mass)
        self.E = E
        self.J = len(spec.joint_idx_a)
        self.substeps = int(world.substeps)
        self.sub_dt = float(world.sub_dt)
        self.cm = float(world.contact_margin)
        self.cf = float(world.collision_force)
        self.x_semidim = None if world.x_semidim is None else float(world.x_semidim)
        self.y_semidim = None if world.y_semidim is None else float(world.y_semidim)
        gx, gy = float(world.gravity[0]), float(world.gravity[1])

        self.movable = [bool(m) for m in spec.movable]
        self.rotatable = [bool(r) for r in spec.rotatable]
        agent = [bool(a) for a in spec.is_agent]
        finite = lambda v: v if math.isfinite(v) else None
        mv_agent = [agent[e] and self.movable[e] for e in range(E)]
        ro_agent = [agent[e] and self.rotatable[e] for e in range(E)]
        # a bound of None means the clamp does not apply to that entity
        self.max_f = [finite(float(spec.max_f[e])) if mv_agent[e] else None for e in range(E)]
        self.f_range = [finite(float(spec.f_range[e])) if mv_agent[e] else None for e in range(E)]
        self.max_t = [finite(float(spec.max_t[e])) if ro_agent[e] else None for e in range(E)]
        self.t_range = [finite(float(spec.t_range[e])) if ro_agent[e] else None for e in range(E)]
        self.max_speed = [finite(float(spec.max_speed[e])) if self.movable[e] else None for e in range(E)]
        self.v_range = [finite(float(spec.v_range[e])) if self.movable[e] else None for e in range(E)]
        self.inv_mass = [float(v) for v in spec.inv_mass]
        self.inv_moi = [float(v) for v in spec.inv_moi]
        self.drag_fac = [1 - float(d) if float(d) != 0.0 else None for d in spec.drag]
        # gravity: with dynamic gravity every movable entity takes m * (dg +
        # eg), eg the world's plus its own static gravity (``dyn_g``, entries
        # (m, egx, egy)); else m * eg where eg is not zero (``gravity``,
        # entries (m * egx, m * egy))
        self.dyn_gravity = bool(world.dynamic_gravity)
        self.mass = [float(v) for v in spec.mass]
        self.lin_fric, self.ang_fric, self.gravity, self.dyn_g = [], [], [], []
        for e in range(E):
            lf, af, m = float(spec.lin_fric[e]), float(spec.ang_fric[e]), self.mass[e]
            moi = float(spec.moi[e])
            self.lin_fric.append((lf * m, m) if lf != 0.0 and self.movable[e] else None)
            self.ang_fric.append((af * moi, moi) if af != 0.0 and self.rotatable[e] else None)
            egx, egy = gx + float(spec.ent_gravity[e, 0]), gy + float(spec.ent_gravity[e, 1])
            on = self.movable[e] and (egx != 0.0 or egy != 0.0) and not self.dyn_gravity
            self.gravity.append((m * egx, m * egy) if on else None)
            self.dyn_g.append((m, egx, egy) if self.movable[e] and self.dyn_gravity else None)
        # the pair tables, one tuple per pair in spec order. A constant is
        # computed as vmas_tpu/core/fused.py computes it for that type: a
        # type with at least _LANE_MIN pairs from its f32 tile expression,
        # else from the unrolled one's Python float
        ls_dmin = spec.ls_rad + LINE_MIN_DIST  # f32 in both forms
        if len(spec.bs_box) >= _LANE_MIN:
            bs_dmin0 = [float(v) for v in spec.bs_rad + LINE_MIN_DIST]
        else:
            bs_dmin0 = [float(v) + LINE_MIN_DIST for v in spec.bs_rad]
        # the joint table: (a, b, anchor a, anchor b, dist, rotate), in
        # spec order; its constants are f32 values read as Python floats,
        # as vmas_tpu/core/fused.py reads them
        self.jf = float(world.joint_force)
        self.tcf = float(world.torque_constraint_force)
        self.joints = [
            (
                int(spec.joint_idx_a[j]), int(spec.joint_idx_b[j]),
                float(spec.joint_anchor_a[j, 0]), float(spec.joint_anchor_a[j, 1]),
                float(spec.joint_anchor_b[j, 0]), float(spec.joint_anchor_b[j, 1]),
                float(spec.joint_dist[j]), bool(spec.joint_rotate[j]),
            )
            for j in range(self.J)
        ]
        self.ss = [
            (int(spec.ss_a[k]), int(spec.ss_b[k]), float(spec.ss_ra[k] + spec.ss_rb[k]))
            for k in range(len(spec.ss_a))
        ]
        self.ls = [
            (int(spec.ls_line[k]), int(spec.ls_sphere[k]), float(spec.ls_len[k]) / 2, float(ls_dmin[k]))
            for k in range(len(spec.ls_line))
        ]
        self.ll = [
            (int(spec.ll_a[k]), int(spec.ll_b[k]), float(spec.ll_la[k]) / 2, float(spec.ll_lb[k]) / 2)
            for k in range(len(spec.ll_a))
        ]
        self.bs = [
            (
                int(spec.bs_box[k]), int(spec.bs_sphere[k]),
                float(spec.bs_wid[k]) / 2, float(spec.bs_len[k]) / 2,
                bs_dmin0[k], bool(spec.bs_not_hollow[k]),
            )
            for k in range(len(spec.bs_box))
        ]
        self.bl = [
            (
                int(spec.bl_box[k]), int(spec.bl_line[k]),
                float(spec.bl_bwid[k]) / 2, float(spec.bl_blen[k]) / 2,
                float(spec.bl_llen[k]) / 2, bool(spec.bl_not_hollow[k]),
            )
            for k in range(len(spec.bl_box))
        ]
        self.bb = [
            (
                int(spec.bb_a[k]), int(spec.bb_b[k]),
                float(spec.bb_wa[k]) / 2, float(spec.bb_la[k]) / 2,
                float(spec.bb_wb[k]) / 2, float(spec.bb_lb[k]) / 2,
                bool(spec.bb_nha[k]), bool(spec.bb_nhb[k]),
            )
            for k in range(len(spec.bb_a))
        ]
        # the entities whose rotation a joint or a pair reads (joint ends,
        # lines and boxes): their cos and sin are taken once per substep
        self.trig = sorted(
            {e for r in self.joints for e in r[:2]}
            | {r[0] for r in self.ls} | {e for r in self.ll for e in r[:2]} | {r[0] for r in self.bs}
            | {e for t in (self.bl, self.bb) for r in t for e in r[:2]}
        )
        self.lists = self._lane_lists()
        self.table, self.table_offsets, self.ent_offset = self._table()
        self.lanes = world.fused_lanes or lanes_for(self)
        self._dev_tables = {}

    def _lane_lists(self):
        """Per entity, the items whose contributions the kernel's lane that
        owns the entity adds to its accumulators, as ``(type, item, side)``
        in the plain version's order (``_accumulate``): the joints in table
        order, then the pair types ss, ls, ll, bs, bl, bb, each in spec
        order. ``type`` indexes ``ITEM_TYPES``; side 0 is the item's +f
        entity, side 1 its -f entity. An entry is listed where it adds to an
        accumulator that is read: the entity is movable, or it is rotatable
        and the item has a torque on its side. An entity whose accumulators
        are never read has an empty list."""
        lists = [[] for _ in range(self.E)]
        for t, name in enumerate(ITEM_TYPES):
            pos0, pos1, torque0, torque1 = ITEM_SIDES[name]
            for k, rec in enumerate(getattr(self, name)):
                for side, e, torque in ((0, rec[pos0], torque0), (1, rec[pos1], torque1)):
                    if self.movable[e] or (torque and self.rotatable[e]):
                        lists[e].append((t, k, side))
        return lists

    def _entity_fields(self, e):
        """Entity ``e``'s constants in ``K.ENT_FIELDS`` order: its flags,
        then the floats (0 where a term does not apply)."""
        flags = 0
        for bit, on in (
            (K.F_MOVABLE, self.movable[e]), (K.F_ROTATABLE, self.rotatable[e]),
            (K.F_MAX_F, self.max_f[e] is not None), (K.F_F_RANGE, self.f_range[e] is not None),
            (K.F_MAX_T, self.max_t[e] is not None), (K.F_T_RANGE, self.t_range[e] is not None),
            (K.F_LIN_FRIC, self.lin_fric[e] is not None), (K.F_ANG_FRIC, self.ang_fric[e] is not None),
            (K.F_GRAVITY, self.gravity[e] is not None), (K.F_DRAG, self.drag_fac[e] is not None),
            (K.F_MAX_SPEED, self.max_speed[e] is not None), (K.F_V_RANGE, self.v_range[e] is not None),
            (K.F_TRIG, e in self.trig),
        ):
            flags |= bit if on else 0
        afm, moi = self.ang_fric[e] or (0.0, 0.0)
        # with dynamic gravity gsx/gsy hold the unscaled eg, which the
        # kernel adds to dg before it multiplies by the mass
        gsx, gsy = self.dyn_g[e][1:] if self.dyn_g[e] else self.gravity[e] or (0.0, 0.0)
        return (flags, self.inv_mass[e], self.inv_moi[e], self.drag_fac[e] or 0.0,
                self.max_f[e] or 0.0, self.f_range[e] or 0.0, self.max_t[e] or 0.0, self.t_range[e] or 0.0,
                self.max_speed[e] or 0.0, self.v_range[e] or 0.0, (self.lin_fric[e] or (0.0,))[0], self.mass[e],
                afm, moi, gsx, gsy)

    def _table(self):
        """The joint table, all pair tables, the lane lists and the
        per-entity constants as one int32 array (floats stored by their
        bits, rounded once to f32), in kernel order joints, ss, ls, ll, bs,
        bl, bb, the lists, the constants; the offsets of the joint table,
        the pair tables and the lists, and the constants' offset. One record per joint: (a, b, anchor_a x, y,
        anchor_b x, y, dist, rotate); per pair: ss (a, b, dmin), ls (line,
        sphere, half, dmin), ll (a, b, half_a, half_b), bs (box, sphere,
        half_w, half_l, dmin0, not_hollow), bl (box, line, half_w, half_l,
        line_half, not_hollow), bb (a, b, half_wa, half_la, half_wb,
        half_lb, not_hollow_a, not_hollow_b). The lists: 8 words per entity,
        the offsets in the array of its entries of each of the seven types
        and of their end, then the entries, ``item << 1 | side``. The
        constants: one block of E words per field of ``K.ENT_FIELDS``."""
        words, offsets = [], []
        f = lambda v: int(np.float32(v).view(np.int32))
        for pairs, kinds in (
            (self.joints, "iifffffi"),
            (self.ss, "iif"), (self.ls, "iiff"), (self.ll, "iiff"),
            (self.bs, "iifffi"), (self.bl, "iifffi"), (self.bb, "iiffffii"),
        ):
            offsets.append(len(words))
            for rec in pairs:
                words += [f(v) if k == "f" else int(v) for v, k in zip(rec, kinds)]
        o_lst = len(words)
        offsets.append(o_lst)
        seg, entries = [], []
        at = o_lst + 8 * self.E
        for lst in self.lists:
            for t in range(len(ITEM_TYPES)):
                seg.append(at + len(entries))
                entries += [k << 1 | side for tt, k, side in lst if tt == t]
            seg.append(at + len(entries))
        words += seg + entries
        o_ent = len(words)
        fields = [self._entity_fields(e) for e in range(self.E)]
        for k in range(len(K.ENT_FIELDS)):
            words += [int(fields[e][k]) if k == 0 else f(fields[e][k]) for e in range(self.E)]
        return np.asarray(words, np.int32), offsets, o_ent

    def pair_table(self, device) -> torch.Tensor:
        """The pair table on ``device``: uploaded once per device, then the
        kernel reads it by pointer."""
        key = str(device)
        t = self._dev_tables.get(key)
        if t is None:
            t = self._dev_tables[key] = torch.as_tensor(self.table, device=device)
        return t

    def to_ctypes(self, k_in: int, act_slots=()) -> K.FusedSpec:
        """The kernel's by-value spec for ``k_in`` scratch rows and the rows
        form's action slots (built once per pair)."""
        key = (k_in, tuple(int(e) for e in act_slots))
        cache = self.__dict__.setdefault("_ctypes", {})
        if key not in cache:
            cache[key] = self._build_ctypes(*key)
        return cache[key]

    def _build_ctypes(self, k_in: int, act_slots) -> K.FusedSpec:
        if len(act_slots) > K.MAX_A:
            raise NotImplementedError(f"the rows kernel takes at most {K.MAX_A} action slots (MAX_A)")
        s = K.FusedSpec()
        s.E, s.J, s.K_in, s.substeps = self.E, self.J, k_in, self.substeps
        s.n_act = len(act_slots)
        s.dyn_g = self.dyn_gravity
        s.o_j = self.table_offsets[0]
        for name, off in zip(PAIR_TYPES, self.table_offsets[1:]):
            setattr(s, f"n_{name}", len(getattr(self, name)))
            setattr(s, f"o_{name}", off)
        s.o_lst, s.o_ent, s.n_tab = self.table_offsets[-1], self.ent_offset, self.table.size
        s.has_x, s.has_y = self.x_semidim is not None, self.y_semidim is not None
        s.sub_dt, s.cm, s.cf = self.sub_dt, self.cm, self.cf
        s.jf, s.tcf = self.jf, self.tcf
        s.x_semidim = self.x_semidim or 0.0
        s.y_semidim = self.y_semidim or 0.0
        for i, e in enumerate(act_slots):
            s.act_slot[i] = e
        return s


def _kernel_spec(world) -> KernelSpec:
    ks = getattr(world, "_kernel_spec", None)
    if ks is None:
        check_fusable(world)
        ks = world._kernel_spec = KernelSpec(world)
    return ks


def _rows_kernel_spec(world) -> KernelSpec:
    """The spec of a world the rows form can step: as the JAX package's rows
    kernel, it has no dynamic gravity (no rows carry it)."""
    ks = _kernel_spec(world)
    if ks.dyn_gravity:
        raise NotImplementedError("the rows step does not take dynamic gravity; step such a world with env.step")
    return ks


# ---------------------------------------------------------------------------
# the plain version: one env step on [B] rows, in the kernel's order
# ---------------------------------------------------------------------------

def _trig_cache(rot):
    """``cs(e)``: cos and sin of entity e's rotation, taken once (per
    substep: a fresh cache per substep)."""
    trig = {}

    def cs(e):
        if e not in trig:
            trig[e] = (torch.cos(rot[e]), torch.sin(rot[e]))
        return trig[e]

    return cs


def _joint_forces(ks, px, py, rot, jfr, cs):
    """Every joint constraint's force and torques, in table order, as ``(a,
    b, fx, fy, torque_a, torque_b)``: +f on a, -f on b. The force is the
    attractive plus the repulsive penalty between the two anchor points;
    a ``rotate=False`` constraint adds the exponential torque that holds
    rot_a - rot_b at its fixed rotation (``jfr``, one row per constraint)."""
    cm, jf, tcf = ks.cm, ks.jf, ks.tcf
    for j, (a, b, aax, aay, abx, aby, dist, rotate) in enumerate(ks.joints):
        ca, sa = cs(a)
        cb, sb = cs(b)
        pjax = px[a] + aax * ca - aay * sa
        pjay = py[a] + aax * sa + aay * ca
        pjbx = px[b] + abx * cb - aby * sb
        pjby = py[b] + abx * sb + aby * cb
        fax_att, fay_att = _constraint_force(cm, pjax, pjay, pjbx, pjby, dist, jf, attractive=True)
        fax_rep, fay_rep = _constraint_force(cm, pjax, pjay, pjbx, pjby, dist, jf)
        fax, fay = fax_att + fax_rep, fay_att + fay_rep
        ta = (pjax - px[a]) * fay - (pjay - py[a]) * fax
        tb = (pjbx - px[b]) * (-fay) - (pjby - py[b]) * (-fax)
        if not rotate:
            delta = rot[a] - (rot[b] + jfr[j])
            pen = torch.exp(torch.abs(delta)) - 1.0
            tqc = tcf * torch.sign(delta) * pen
            tqc = torch.where(torch.abs(delta) < 1e-9, 0.0, tqc)
            ta, tb = ta + (-tqc), tb + tqc
        yield a, b, fax, fay, ta, tb


def _pair_forces(ks, px, py, rot, cs=None):
    """Every pair's contact force, in the kernel's order (ss, ls, ll, bs,
    bl, bb, each in spec order), as ``(i, j, fx, fy, torque_i,
    torque_j)``: +f acts on entity i, -f on entity j, and a torque is None
    where the type has none. Per type: ss +f on a; ls +f on the sphere, -f
    and a torque on the line; ll +f on a, torque on both; bs +f on the
    sphere, -f and a torque on the box; bl +f on the box, -f on the line,
    torque on both; bb +f on a, torque on both.

    Each type is computed at once on [P, B] rows (pair constants as [P, 1]
    f32 columns): every element sees the ops the kernel runs for its pair;
    a hollow box takes its surface point by a per-pair select."""
    cm, cf = ks.cm, ks.cf
    cs = cs or _trig_cache(rot)
    dev = px[0].device
    rows = lambda vals, idx: torch.stack([vals[i] for i in idx])
    cos_sin = lambda idx: (torch.stack([cs(e)[0] for e in idx]), torch.stack([cs(e)[1] for e in idx]))
    col = lambda recs, k, dt=torch.float32: torch.tensor([r[k] for r in recs], dtype=dt, device=dev)[:, None]

    def per_pair(recs, i, j, fx, fy, ti, tj):
        for k, r in enumerate(recs):
            yield r[i], r[j], fx[k], fy[k], None if ti is None else ti[k], None if tj is None else tj[k]

    if ks.ss:
        a, b = [r[0] for r in ks.ss], [r[1] for r in ks.ss]
        fx, fy = _constraint_force(cm, rows(px, a), rows(py, a), rows(px, b), rows(py, b), col(ks.ss, 2), cf)
        yield from per_pair(ks.ss, 0, 1, fx, fy, None, None)

    if ks.ls:
        ln, s = [r[0] for r in ks.ls], [r[1] for r in ks.ls]
        lx, ly, sx, sy = rows(px, ln), rows(py, ln), rows(px, s), rows(py, s)
        cos, sin = cos_sin(ln)
        cx, cy = _closest_point_line(lx, ly, cos, sin, col(ks.ls, 2), sx, sy)
        sfx, sfy = _constraint_force(cm, sx, sy, cx, cy, col(ks.ls, 3), cf)
        yield from per_pair(ks.ls, 1, 0, sfx, sfy, None, (cx - lx) * (-sfy) - (cy - ly) * (-sfx))

    if ks.ll:
        a, b = [r[0] for r in ks.ll], [r[1] for r in ks.ll]
        ax, ay, bx, by = rows(px, a), rows(py, a), rows(px, b), rows(py, b)
        (ca, sa), (cb, sb) = cos_sin(a), cos_sin(b)
        pax, pay, pbx, pby = _closest_points_line_line(ax, ay, ca, sa, col(ks.ll, 2), bx, by, cb, sb, col(ks.ll, 3))
        afx, afy = _constraint_force(cm, pax, pay, pbx, pby, LINE_MIN_DIST, cf)
        yield from per_pair(ks.ll, 0, 1, afx, afy, (pax - ax) * afy - (pay - ay) * afx,
                            (pbx - bx) * (-afy) - (pby - by) * (-afx))

    if ks.bs:
        b, s = [r[0] for r in ks.bs], [r[1] for r in ks.bs]
        bx, by, sx, sy = rows(px, b), rows(py, b), rows(px, s), rows(py, s)
        cos, sin = cos_sin(b)
        cx, cy = _closest_point_box(bx, by, cos, sin, col(ks.bs, 2), col(ks.bs, 3), sx, sy)
        nh, dmin0 = col(ks.bs, 5, torch.bool), col(ks.bs, 4)
        ix, iy, d = _inner_point_box(sx, sy, cx, cy, bx, by)
        ix, iy = torch.where(nh, ix, cx), torch.where(nh, iy, cy)
        sfx, sfy = _constraint_force(cm, sx, sy, ix, iy, torch.where(nh, dmin0 + d, dmin0), cf)
        yield from per_pair(ks.bs, 1, 0, sfx, sfy, None, (cx - bx) * (-sfy) - (cy - by) * (-sfx))

    if ks.bl:
        b, ln = [r[0] for r in ks.bl], [r[1] for r in ks.bl]
        bx, by, lx, ly = rows(px, b), rows(py, b), rows(px, ln), rows(py, ln)
        (cos, sin), (lcos, lsin) = cos_sin(b), cos_sin(ln)
        qbx, qby, qlx, qly = _closest_line_box(bx, by, cos, sin, col(ks.bl, 2), col(ks.bl, 3),
                                               lx, ly, lcos, lsin, col(ks.bl, 4))
        nh = col(ks.bl, 5, torch.bool)
        ix, iy, d = _inner_point_box(qlx, qly, qbx, qby, bx, by)
        ix, iy = torch.where(nh, ix, qbx), torch.where(nh, iy, qby)
        dmin = torch.where(nh, LINE_MIN_DIST + d, torch.full_like(d, LINE_MIN_DIST))
        bfx, bfy = _constraint_force(cm, ix, iy, qlx, qly, dmin, cf)
        yield from per_pair(ks.bl, 0, 1, bfx, bfy, (qbx - bx) * bfy - (qby - by) * bfx,
                            (qlx - lx) * (-bfy) - (qly - ly) * (-bfx))

    if ks.bb:
        a, b = [r[0] for r in ks.bb], [r[1] for r in ks.bb]
        ax, ay, bx, by = rows(px, a), rows(py, a), rows(px, b), rows(py, b)
        (ca, sa), (cb, sb) = cos_sin(a), cos_sin(b)
        qax, qay, qbx, qby = _bb_closest(ax, ay, ca, sa, col(ks.bb, 2), col(ks.bb, 3),
                                         bx, by, cb, sb, col(ks.bb, 4), col(ks.bb, 5))
        nha, nhb = col(ks.bb, 6, torch.bool), col(ks.bb, 7, torch.bool)
        iax, iay, da = _inner_point_box(qbx, qby, qax, qay, ax, ay)
        ibx, iby, db = _inner_point_box(qax, qay, qbx, qby, bx, by)
        iax, iay, da = torch.where(nha, iax, qax), torch.where(nha, iay, qay), torch.where(nha, da, 0.0)
        ibx, iby, db = torch.where(nhb, ibx, qbx), torch.where(nhb, iby, qby), torch.where(nhb, db, 0.0)
        afx, afy = _constraint_force(cm, iax, iay, ibx, iby, da + db + LINE_MIN_DIST, cf)
        yield from per_pair(ks.bb, 0, 1, afx, afy, (qax - ax) * afy - (qay - ay) * afx,
                            (qbx - bx) * (-afy) - (qby - by) * (-afx))


PAIR_TYPES = ("ss", "ls", "ll", "bs", "bl", "bb")


def joint_counts(world, x) -> dict:
    """Over the joint constraints and envs of the state rows ``x`` [9E + J
    + ..., B], how many carry a non-zero anchor force (``force``) and how
    many a rotation torque, |delta| >= 1e-9 on a ``rotate=False``
    constraint (``torque``), in the plain version's first substep, so a
    comparison can show that it exercised the joint code."""
    ks = _kernel_spec(world)
    E = ks.E
    px, py, rot = list(x[:E]), list(x[E:2 * E]), list(x[4 * E:5 * E])
    jfr = list(x[9 * E:9 * E + ks.J])
    counts = {"force": 0, "torque": 0}
    for j, (a, _, fx, fy, _, _) in enumerate(_joint_forces(ks, px, py, rot, jfr, _trig_cache(rot))):
        counts["force"] += int(((fx != 0) | (fy != 0)).sum())
        if not ks.joints[j][7]:
            b = ks.joints[j][1]
            counts["torque"] += int((torch.abs(rot[a] - (rot[b] + jfr[j])) >= 1e-9).sum())
    return counts


def contact_counts(world, x) -> dict:
    """Per pair type, how many (pair, env) contacts of the state rows ``x``
    [9E + ..., B] carry a non-zero penalty force (the plain version's), so
    a comparison can show that it exercised each type."""
    ks = _kernel_spec(world)
    E = ks.E
    px, py, rot = list(x[:E]), list(x[E:2 * E]), list(x[4 * E:5 * E])
    kinds = [t for t in PAIR_TYPES for _ in getattr(ks, t)]
    counts = dict.fromkeys(PAIR_TYPES, 0)
    for kind, (_, _, fx, fy, _, _) in zip(kinds, _pair_forces(ks, px, py, rot)):
        counts[kind] += int(((fx != 0) | (fy != 0)).sum())
    return counts


def _accumulate(ks, forces, Fx, Fy, Tq):
    """Add every item's contributions, in item order, to the accumulators
    that are read (those of movable entities, and the torques of rotatable
    ones): +f on i, -f on j, a torque on either where the type has one."""
    mv, ro = ks.movable, ks.rotatable
    for i, j, fx_, fy_, ti, tj in forces:
        if mv[i]:
            Fx[i], Fy[i] = Fx[i] + fx_, Fy[i] + fy_
        if ti is not None and ro[i]:
            Tq[i] = Tq[i] + ti
        if mv[j]:
            Fx[j], Fy[j] = Fx[j] + (-fx_), Fy[j] + (-fy_)
        if tj is not None and ro[j]:
            Tq[j] = Tq[j] + tj


def _physics_rows(ks, px, py, vx, vy, rot, w, fx, fy, tq, jfr, dg=()):
    """All substeps of one physics step on per-entity row lists (rebound
    in place); ``jfr``: the joints' fixed-rotation rows; ``dg``: with
    dynamic gravity its 2E rows (each entity's x, then y). Per entity the
    forces accumulate as the kernel accumulates them: action, friction,
    gravity, then the joints in table order, then the pair types in the
    order ss, ls, ll, bs, bl, bb, each in spec order (the JAX package's
    plain path takes the same terms, in the same order per entity)."""
    E, sub_dt = ks.E, ks.sub_dt
    mv, ro = ks.movable, ks.rotatable
    for substep in range(ks.substeps):
        # action clamps, re-applied every substep on the persistent rows
        # (divide-then-multiply, as clamp_with_norm rounds)
        for e in range(E):
            mf = ks.max_f[e]
            if mf is not None:
                n = torch.sqrt(fx[e] * fx[e] + fy[e] * fy[e])
                over = n > mf
                den = torch.where(over, n, 1.0)
                fx[e] = torch.where(over, fx[e] / den * mf, fx[e])
                fy[e] = torch.where(over, fy[e] / den * mf, fy[e])
            fr = ks.f_range[e]
            if fr is not None:
                fx[e] = torch.clamp(fx[e], -fr, fr)
                fy[e] = torch.clamp(fy[e], -fr, fr)
            mt = ks.max_t[e]
            if mt is not None:
                tq[e] = torch.clamp(tq[e], -mt, mt)
            tr = ks.t_range[e]
            if tr is not None:
                tq[e] = torch.clamp(tq[e], -tr, tr)

        # action forces open each movable entity's accumulator
        Fx = [fx[e] if mv[e] else None for e in range(E)]
        Fy = [fy[e] if mv[e] else None for e in range(E)]
        Tq = [tq[e] if ro[e] else None for e in range(E)]

        # coulomb friction
        for e in range(E):
            if ks.lin_fric[e] is not None:
                lfm, m = ks.lin_fric[e]
                speed = _norm(vx[e], vy[e])
                zero = speed == 0.0
                den = torch.where(zero, 1.0, speed)
                fcx = torch.clamp(_div(torch.abs(vx[e]), sub_dt) * m, max=lfm)
                fcy = torch.clamp(_div(torch.abs(vy[e]), sub_dt) * m, max=lfm)
                Fx[e] = Fx[e] + torch.where(zero, 0.0, -(vx[e] / den) * fcx)
                Fy[e] = Fy[e] + torch.where(zero, 0.0, -(vy[e] / den) * fcy)
            if ks.ang_fric[e] is not None:
                afm, moi = ks.ang_fric[e]
                sp = torch.abs(w[e])
                den = torch.where(sp == 0.0, 1.0, sp)
                fc = torch.clamp(_div(sp, sub_dt) * moi, max=afm)
                Tq[e] = Tq[e] + torch.where(sp == 0.0, 0.0, -(w[e] / den) * fc)

        # gravity: per-env dynamic, m * (dg + eg), in place of the static
        # m * eg (world + per entity)
        for e in range(E):
            if ks.dyn_g[e] is not None:
                m, egx, egy = ks.dyn_g[e]
                Fx[e] = Fx[e] + m * (dg[e] + egx)
                Fy[e] = Fy[e] + m * (dg[E + e] + egy)
            elif ks.gravity[e] is not None:
                Fx[e] = Fx[e] + ks.gravity[e][0]
                Fy[e] = Fy[e] + ks.gravity[e][1]

        cs = _trig_cache(rot)
        forces = list(_joint_forces(ks, px, py, rot, jfr, cs)) + list(_pair_forces(ks, px, py, rot, cs))
        _accumulate(ks, forces, Fx, Fy, Tq)

        # integrate (semi-implicit Euler; drag on the first substep only)
        for e in range(E):
            if mv[e]:
                if substep == 0 and ks.drag_fac[e] is not None:
                    vx[e] = vx[e] * ks.drag_fac[e]
                    vy[e] = vy[e] * ks.drag_fac[e]
                inv_m = ks.inv_mass[e]
                vx[e] = vx[e] + Fx[e] * inv_m * sub_dt
                vy[e] = vy[e] + Fy[e] * inv_m * sub_dt
                ms = ks.max_speed[e]
                if ms is not None:
                    n = torch.sqrt(vx[e] * vx[e] + vy[e] * vy[e])
                    over = n > ms
                    s = torch.where(over, _rdiv(ms, torch.where(over, n, 1.0)), 1.0)
                    vx[e] = vx[e] * s
                    vy[e] = vy[e] * s
                vr = ks.v_range[e]
                if vr is not None:
                    vx[e] = torch.clamp(vx[e], -vr, vr)
                    vy[e] = torch.clamp(vy[e], -vr, vr)
                px[e] = px[e] + vx[e] * sub_dt
                py[e] = py[e] + vy[e] * sub_dt
                if ks.x_semidim is not None:
                    px[e] = torch.clamp(px[e], -ks.x_semidim, ks.x_semidim)
                if ks.y_semidim is not None:
                    py[e] = torch.clamp(py[e], -ks.y_semidim, ks.y_semidim)
            if ro[e]:
                if substep == 0 and ks.drag_fac[e] is not None:
                    w[e] = w[e] * ks.drag_fac[e]
                w[e] = w[e] + Tq[e] * ks.inv_moi[e] * sub_dt
                rot[e] = rot[e] + w[e] * sub_dt


def _step_rows(ks, comps, jfr, scratch, outputs, act_slots=(), act=None, ctrl=None, dg=()):
    """One env step on the per-entity row lists ``comps`` (px, py, vx, vy,
    rot, w, fx, fy, tq; rebound in place) and the dynamic-gravity rows
    ``dg`` (the fused form), with ``act`` [2A, B] overriding
    the force rows of the ``act_slots`` entities and then, where ``ctrl``
    (the controller rows, a list rebound in place) is given, the scenario's
    ``process_act_rows`` (the rows form). Returns ``(emit_rows [n_out],
    hook_rows [n_ctrl_out])``."""
    px, py, vx, vy, rot, w, fx, fy, tq = comps
    A = len(act_slots)
    for i, e in enumerate(act_slots):
        fx[e] = act[i]
        fy[e] = act[A + i]
    hook_rows = []
    if ctrl is not None:
        hook_rows = outputs.process_act_rows({"fx": fx, "fy": fy, "vx": vx, "vy": vy, "px": px, "py": py,
                                              "rot": rot, "w": w, "ctrl": ctrl})
        assert len(hook_rows) == outputs.n_ctrl_out, (
            f"process_act_rows produced {len(hook_rows)} rows, n_ctrl_out={outputs.n_ctrl_out}"
        )
    _physics_rows(ks, px, py, vx, vy, rot, w, fx, fy, tq, jfr, dg)
    extra = []
    if outputs is not None:
        ctx = {"px": px, "py": py, "vx": vx, "vy": vy, "rot": rot, "w": w,
               "fx": fx, "fy": fy, "scratch": scratch}
        extra = [r.to(torch.float32) for r in outputs.emit(ctx)]
        assert len(extra) == int(outputs.n_out), (
            f"emit produced {len(extra)} rows, n_out={outputs.n_out}"
        )
    return extra, hook_rows


def _split_rows(ks, x, k_in, n_ctrl=0, n_dyn=0):
    """A row buffer [9E + J + n_dyn + k_in + n_ctrl, B] as (per-entity
    component lists, joint fixed-rotation rows, dynamic-gravity rows,
    scratch rows, controller rows)."""
    E, J = ks.E, ks.J
    comps = [[x[c * E + e] for e in range(E)] for c in range(9)]
    jfr = [x[9 * E + j] for j in range(J)]
    dg = [x[9 * E + J + k] for k in range(n_dyn)]
    base = 9 * E + J + n_dyn
    scratch = [x[base + k] for k in range(k_in)]
    ctrl = [x[base + k_in + k] for k in range(n_ctrl)]
    return comps, jfr, dg, scratch, ctrl


def fused_step_plain(world, x, outputs=None):
    """Plain version of the fused step: rows [9E + J (+ 2E) + K_in, B] ->
    [9E + K_out, B]. The scenario's in-kernel process_action never runs
    here: ``env.step`` ran its process_action before."""
    ks = _kernel_spec(world)
    k_in = int(outputs.n_scratch_in) if outputs is not None else 0
    comps, jfr, dg, scratch, _ = _split_rows(ks, x, k_in, n_dyn=2 * ks.E if ks.dyn_gravity else 0)
    extra, _ = _step_rows(ks, comps, jfr, scratch, outputs, dg=dg)
    return torch.stack([r for comp in comps for r in comp] + extra)


def rows_step_plain(world, outputs, act_slots, carry, act, k_steps=1):
    """Plain version of the rows step: (carry [R_in, B], act [K*2A, B]) ->
    (carry', extra [K*(n_out + n_ctrl_out), B]) for K = ``k_steps`` whole env
    steps. Step k reads its actions from rows [k*2A, (k+1)*2A) and writes its
    emit rows, then its hook rows, to block k of ``extra``; between the
    steps the scratch rows take the emit rows ``carry_extra_idx`` names."""
    ks = _rows_kernel_spec(world)
    k_in, n_ctrl = int(outputs.n_scratch_in), int(outputs.n_ctrl)
    comps, jfr, _, scratch, ctrl = _split_rows(ks, carry, k_in, n_ctrl)
    A2 = 2 * len(act_slots)
    blocks = []
    for k in range(k_steps):
        extra, hook_rows = _step_rows(ks, comps, jfr, scratch, outputs, act_slots, act[k * A2:(k + 1) * A2],
                                      ctrl if n_ctrl else None)
        scratch = [scratch[i] if ei is None else extra[int(ei)] for i, ei in enumerate(outputs.carry_extra_idx)]
        blocks += extra + hook_rows
    return torch.stack([r for comp in comps for r in comp] + jfr + scratch + ctrl), torch.stack(blocks)


def clamp_rows(ux, uy, max_norm):
    """The vectors ``(ux, uy)`` clamped to norm ``max_norm`` on the unguarded
    norm ``sqrt(ux * ux + uy * uy)``, in the op order of the kernel's
    ``pid_act`` (and the JAX package's process_act_rows); returns ``(ux, uy,
    over)``, ``over`` marking the clamped lanes."""
    n = torch.sqrt(ux * ux + uy * uy)
    over = n > max_norm
    den = torch.where(over, n, 1.0)
    return torch.where(over, ux / den * max_norm, ux), torch.where(over, uy / den * max_norm, uy), over


def clamp_with_row_norm(u, max_norm):
    """``TorchUtils.clamp_with_norm`` of ``[B, 2]`` vectors through
    ``clamp_rows``: ``torch.linalg.vector_norm`` rounds differently from
    ``sqrt(x * x + y * y)`` in some 9% of vectors on the CPU. The
    velocity-controlled scenarios clamp their inputs with it, so that
    ``env.step`` and the rows step clamp alike."""
    ux, uy, _ = clamp_rows(u[:, 0], u[:, 1], max_norm)
    return torch.stack([ux, uy], dim=-1)


class PidActRows:
    """``process_act_rows`` of a scenario whose policy agents take velocity
    commands through a ``VelocityController`` each (give_way, multi_give_way,
    joint_passage with ``use_controller=True``). Per agent, in the op order
    of the scenarios' process_action (vmas_tpu/scenarios/give_way.py
    GiveWayOutputs.process_act_rows): where ``u_range`` is given, the clamp
    of u to it on the unguarded norm ``sqrt(ux*ux + uy*uy)`` (as
    clamp_with_norm); where ``min_input_norm`` is given, u zeroed where its
    guarded norm is below it; the reset of the controller's memory where
    that norm is below 1e-3; then the PID update
    (``VelocityController.rows_step``). Each agent's memory rides 4 carry
    rows (accum x, y, prev x, y); the controller's output, the agent's
    force, comes back as 2 rows per agent. ``kernel_params`` gives the same
    constants to the kernel's ``pid_act``."""

    def __init__(self, agents, controllers, u_range=None, min_input_norm=None):
        vcs = [controllers[a.name] for a in agents]
        self.slots = [a.index for a in agents]
        self.keys = [vc.key for vc in vcs]
        self.u_range = None if u_range is None else float(u_range)
        self.min_in = None if min_input_norm is None else float(min_input_norm)
        self.params = [vc.rows_params() for vc in vcs]
        self.steps = [vc.rows_step() for vc in vcs]
        self.n_ctrl = 4 * len(vcs)
        self.n_ctrl_out = 2 * len(vcs)
        self._kernel_params = None

    def ctrl_rows(self, state):
        rows = []
        for key in self.keys:
            cs = state.scenario[key]
            rows += [cs["accum_errs"][:, 0], cs["accum_errs"][:, 1], cs["prev_err"][:, 0], cs["prev_err"][:, 1]]
        return torch.stack(rows)

    def ctrl_updates(self, rows, scratch=None):
        return {
            key: {"accum_errs": torch.stack([rows[4 * i], rows[4 * i + 1]], dim=-1),
                  "prev_err": torch.stack([rows[4 * i + 2], rows[4 * i + 3]], dim=-1)}
            for i, key in enumerate(self.keys)
        }

    def __call__(self, ctx):
        fx, fy, vx, vy, ctrl = ctx["fx"], ctx["fy"], ctx["vx"], ctx["vy"], ctx["ctrl"]
        out = []
        for i, e in enumerate(self.slots):
            ux, uy = fx[e], fy[e]
            if self.u_range is not None:
                ux, uy, _ = clamp_rows(ux, uy, self.u_range)
            if self.min_in is not None:
                small = _norm(ux, uy) < self.min_in
                ux = torch.where(small, 0.0, ux)
                uy = torch.where(small, 0.0, uy)
            reset = _norm(ux, uy) < 1e-3
            r = self.steps[i](ux, uy, vx[e], vy[e], *ctrl[4 * i:4 * i + 4], reset)
            fx[e], fy[e] = r[0], r[1]
            ctrl[4 * i:4 * i + 4] = r[2:]
            out += [r[0], r[1]]
        return out

    def kernel_params(self) -> K.ActParams:
        if self._kernel_params is None:
            if len(self.slots) > K.MAX_PID:
                raise NotImplementedError(f"the fused kernel's PID takes at most {K.MAX_PID} agents")
            ap = K.ActParams()
            ap.n_pid = len(self.slots)
            for i, e in enumerate(self.slots):
                dt, gain, mass, use_i, inv_ti, cutoff, td = self.params[i]
                ap.slot[i] = e
                ap.clamp[i] = self.u_range is not None
                ap.u_rng[i] = self.u_range or 0.0
                # a min_input_norm of 0 zeroes nothing: a norm is never below 0
                ap.min_in[i] = self.min_in or 0.0
                ap.dt[i], ap.gain[i], ap.mass[i] = dt, gain, mass
                ap.use_i[i], ap.inv_ti[i] = use_i, inv_ti
                ap.has_cutoff[i], ap.cutoff[i] = cutoff is not None, cutoff or 0.0
                ap.td[i] = td
            self._kernel_params = ap
        return self._kernel_params


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, t, shape):
    K.check_tensor(name, t, torch.float32, shape)


def _emit_params(outputs):
    if outputs is None:
        return K.EMIT_NONE, K.EmitParams()
    return outputs.kernel_emit()


_NO_ACT = K.ActParams()  # n_pid = 0: no in-kernel process_action


def _check_smem(lib, ks, spec_c, rows_mode, n_ctrl, n_tot):
    """Raise ``ValueError`` where a block of the kernel at ``ks.lanes`` lanes
    per env needs more shared memory than the device gives one block
    (checked once per world, form and lane count)."""
    key = (ks.lanes, bool(rows_mode), n_ctrl, n_tot, int(spec_c.K_in), int(spec_c.n_act))
    checked = ks.__dict__.setdefault("_smem_checked", set())
    if key in checked:
        return
    need = lib.vmas_fused_smem(spec_c, ks.lanes, int(rows_mode), n_ctrl, n_tot)
    limit = lib.vmas_max_smem()
    if need > limit:
        raise ValueError(f"the fused kernel at {ks.lanes} lanes per env needs {need} bytes of shared memory "
                         f"per block for this world, the device gives {limit}")
    checked.add(key)


def _launch(ks, spec_c, outputs, x, act, out, extra, rows_mode, k_steps=1, act_params=_NO_ACT, n_tot=0):
    """One launch of the kernel at ``ks.lanes`` lanes per env; ``n_tot``: the
    output rows per step after the state rows (the fused form's emit rows;
    the rows form's emit and hook rows)."""
    kind, ep = _emit_params(outputs)
    lib = K.library("fused_step")
    B = x.shape[1]
    table = ks.pair_table(x.device)
    with torch.cuda.device(x.device):
        _check_smem(lib, ks, spec_c, rows_mode, 4 * int(act_params.n_pid), int(n_tot))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vmas_fused_step(
            spec_c, ep, act_params, kind, ks.lanes, table.data_ptr(), x.data_ptr(),
            None if act is None else act.data_ptr(),
            out.data_ptr(), None if extra is None else extra.data_ptr(),
            B, int(rows_mode), int(k_steps), int(n_tot), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_step kernel launch failed: {lib.vmas_cuda_error_string(err).decode()}"
        )


def fused_step(world, x, outputs=None):
    """The fused step on rows [9E + J (+ 2E) + K_in, B] -> [9E + K_out, B]:
    the CUDA kernel for a GPU tensor, the plain version for a CPU tensor."""
    global fused_step_launches
    ks = _kernel_spec(world)
    if x.device.type == "cpu":
        return fused_step_plain(world, x, outputs)
    k_in = int(outputs.n_scratch_in) if outputs is not None else 0
    k_out = int(outputs.n_out) if outputs is not None else 0
    B = x.shape[1]
    n_dyn = 2 * ks.E if ks.dyn_gravity else 0
    _check_rows("x", x, (9 * ks.E + ks.J + n_dyn + k_in, B))
    out = torch.empty((9 * ks.E + k_out, B), dtype=torch.float32, device=x.device)
    _launch(ks, ks.to_ctypes(k_in), outputs, x, None, out, None, rows_mode=False, n_tot=k_out)
    fused_step_launches += 1
    return out


def state_rows(state):
    """The state's 9E component rows [9E, B]: px, py, vx, vy, rot, w, fx, fy,
    tq, each a block of E rows."""
    return torch.cat([
        state.pos[..., 0].T, state.pos[..., 1].T,
        state.vel[..., 0].T, state.vel[..., 1].T,
        state.rot.T, state.ang_vel.T,
        state.force[..., 0].T, state.force[..., 1].T,
        state.torque.T,
    ], dim=0)


def fused_physics_step(world, state, outputs=None):
    """Drop-in for physics.physics_step on fusable worlds. With ``outputs``
    (a :class:`FusedOutputs`) it also returns the scenario's output rows:
    ``(state, extra [n_out, B])``."""
    spec = world.spec
    E = len(spec.mass)
    parts = [state_rows(state), state.joint_fixed_rot.T]
    if world.dynamic_gravity:
        parts += [state.dyn_gravity[..., 0].T, state.dyn_gravity[..., 1].T]
    if outputs is not None:
        parts.append(torch.as_tensor(outputs.scratch_rows(state), dtype=torch.float32, device=state.device))
    x = torch.cat(parts, dim=0).contiguous()  # [R, B]
    y = fused_step(world, x, outputs)
    state = state.replace(
        pos=torch.stack([y[0:E].T, y[E:2 * E].T], dim=-1),
        vel=torch.stack([y[2 * E:3 * E].T, y[3 * E:4 * E].T], dim=-1),
        rot=y[4 * E:5 * E].T,
        ang_vel=y[5 * E:6 * E].T,
        force=torch.stack([y[6 * E:7 * E].T, y[7 * E:8 * E].T], dim=-1),
        torque=y[8 * E:9 * E].T,
    )
    if world.dim_c > 0 and len(world.agents):
        silent = torch.as_tensor(spec.silent, device=state.device)
        state = state.replace(c=torch.where(silent[None, :, None], state.c, state.uc))
    if outputs is not None:
        return state, y[9 * E:]
    return state


# ---------------------------------------------------------------------------
# rows-carried rollout (parallel/rollout.py rows_rollout_fn)
# ---------------------------------------------------------------------------

def rows_step_supported(world, outputs, agents) -> bool:
    """Static eligibility for the rows-carried rollout: a fused-outputs
    scenario declaring its scratch carry, no dynamic gravity, and pure
    holonomic agents with no action script (their process_action is
    exactly "force = u", realized in the kernel by the action rows).
    Scripted agents run their scripts outside the kernel at each step, so
    a world with any is eligible only where the outputs declare every
    script computable over the horizon up front (``script_slots`` and
    ``script_us``: flocking's circling target, a function of its step
    counter alone), for holonomic, noise-free scripted agents; their
    actions then ride the action rows as the policy agents' do. Scripts
    that run inside the kernel (``kernel_script_slots``) are not taken."""
    from vmas_tpu_torch.dynamics.holonomic import Holonomic

    if outputs is None or not supports(world):
        return False
    if getattr(outputs, "carry_extra_idx", None) is None:
        return False
    if len(outputs.carry_extra_idx) != int(outputs.n_scratch_in):
        return False
    if world.dynamic_gravity:
        return False
    for a in agents:
        if type(a.dynamics) is not Holonomic or a.action_script is not None:
            return False
        if a.action_size != 2:
            return False
    scripted = world.scripted_agents
    if scripted:
        if getattr(outputs, "kernel_script_slots", ()):
            return False
        if {a.index for a in scripted} != set(getattr(outputs, "script_slots", ())):
            return False
        if not callable(getattr(outputs, "script_us", None)):
            return False
        for a in scripted:
            if type(a.dynamics) is not Holonomic or np.any(a.u_noise_array > 0):
                return False
    return True


def rows_layout(world, outputs):
    """R_in: carried rows (9E state + J joint fixed rotations + K scratch +
    n_ctrl controller rows)."""
    E = len(world.spec.mass)
    J = len(world.spec.joint_idx_a)
    return 9 * E + J + int(outputs.n_scratch_in) + int(outputs.n_ctrl)


def pack_carry(world, state, outputs):
    """State + joint fixed rotations + scratch (+ controller rows) as one
    [R_in, B] buffer."""
    dev = state.device
    parts = [
        state_rows(state),
        state.joint_fixed_rot.T.to(torch.float32),
        torch.as_tensor(outputs.scratch_rows(state), dtype=torch.float32, device=dev),
    ]
    if outputs.n_ctrl:
        parts.append(torch.as_tensor(outputs.ctrl_rows(state), dtype=torch.float32, device=dev))
    return torch.cat(parts, dim=0).contiguous()


def unpack_carry(world, carry, state):
    """Final carry rows -> state tensors (scratch rows are the caller's)."""
    E = len(world.spec.mass)
    y = carry
    return state.replace(
        pos=torch.stack([y[0:E].T, y[E:2 * E].T], dim=-1),
        vel=torch.stack([y[2 * E:3 * E].T, y[3 * E:4 * E].T], dim=-1),
        rot=y[4 * E:5 * E].T,
        ang_vel=y[5 * E:6 * E].T,
        force=torch.stack([y[6 * E:7 * E].T, y[7 * E:8 * E].T], dim=-1),
        torque=y[8 * E:9 * E].T,
    )


def make_rows_step(world, outputs, act_slots, k_steps=1):
    """Build ``step(carry [R_in, B], act [K*2A, B], extra_out=None,
    carry_out=None) -> (carry', extra [K*n_tot, B])`` for K = ``k_steps``
    whole env steps per call, n_tot = n_out + n_ctrl_out: one kernel launch
    on the GPU, the plain version on the CPU. ``extra_out`` (a contiguous
    [K*n_tot, B] slice, e.g. a rollout's ``extras[t:t+K]``) receives the
    output rows in place, and ``carry_out`` (a contiguous [R_in, B] slice
    apart from ``carry``) the new carry."""
    R_in = rows_layout(world, outputs)
    n_tot = int(outputs.n_out) + int(outputs.n_ctrl_out)
    A = len(act_slots)
    Ks = int(k_steps)
    if Ks < 1:
        raise ValueError(f"k_steps must be at least 1, got {k_steps}")
    ks = _rows_kernel_spec(world)
    spec_c = ks.to_ctypes(int(outputs.n_scratch_in), act_slots)
    act_params = outputs.process_act_rows.kernel_params() if outputs.n_ctrl else _NO_ACT

    def step(carry, act, extra_out=None, carry_out=None):
        global rows_step_launches
        if carry.device.type == "cpu":
            new, extra = rows_step_plain(world, outputs, act_slots, carry, act, Ks)
            if extra_out is not None:
                extra_out.copy_(extra)
                extra = extra_out
            if carry_out is not None:
                carry_out.copy_(new)
                new = carry_out
            return new, extra
        B = carry.shape[1]
        _check_rows("carry", carry, (R_in, B))
        _check_rows("act", act, (Ks * 2 * A, B))
        if carry_out is None:
            out = torch.empty((R_in, B), dtype=torch.float32, device=carry.device)
        else:
            _check_rows("carry_out", carry_out, (R_in, B))
            out = carry_out
        if extra_out is None:
            extra_out = torch.empty((Ks * n_tot, B), dtype=torch.float32, device=carry.device)
        _check_rows("extra_out", extra_out, (Ks * n_tot, B))
        _launch(ks, spec_c, outputs, carry, act, out, extra_out, rows_mode=True, k_steps=Ks,
                act_params=act_params, n_tot=n_tot)
        rows_step_launches += 1
        return out, extra_out

    return step
