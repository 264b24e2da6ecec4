"""The fused physics step: one hand-written CUDA kernel per env step.

Counterpart of vmas_tpu/core/fused.py. The state is packed as
component rows ``[9E, B]`` (px, py, vx, vy, rot, w, fx, fy, tq per entity),
one column per env. One kernel (``csrc/fused_step.cu``, one thread per env)
runs every substep of the physics and then the scenario's output rows
(``FusedOutputs.emit``), in two forms:

* ``fused_physics_step``: rows ``[9E + J + K_in, B]`` in, ``[9E + K_out, B]``
  out; reached from ``World.step`` / ``World.step_with_outputs``.
* ``make_rows_step``: the rows-carried rollout step; the carry is the
  kernel's own row buffer, the per-step action rows override the agents'
  force rows, and the emit rows go to a caller-given slice.

Each form has a plain PyTorch version here (``fused_step_plain``,
``rows_step_plain``) that repeats the kernel's arithmetic in the kernel's
order; both forms share one function (``_step_rows``), as both kernel forms
share one device function. A wrapper runs the plain version for a tensor on
the CPU and the kernel for a tensor on a GPU, and counts each kernel
launch in ``fused_step_launches`` / ``rows_step_launches``.

Covered: sphere-sphere and box-sphere contacts, action clamps, friction,
static gravity, drag, speed clamps, semidim clamps, any substeps, and
transport's emit. Not ported yet: the other pair types, joints, dynamic
gravity, ``process_act_rows`` and ``k_steps > 1``; worlds that need them
raise ``NotImplementedError``. Forward only: ``Environment`` refuses
``grad_enabled`` with ``fused_physics``.
"""

from __future__ import annotations

import math

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


def _logaddexp0(x):
    # logaddexp(0, x) = max(x, 0) + log1p(exp(-|x|))
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _constraint_force(cm, ax, ay, bx, by, dist_min, mult):
    """Repulsive penalty force on a (negate for b)."""
    dx, dy = ax - bx, ay - by
    dist = _norm(dx, dy)
    penetration = _logaddexp0((dist_min - dist) / cm) * cm
    scale = mult * penetration / torch.where(dist > 0, dist, 1e-8)
    fx, fy = dx * scale, dy * scale
    drop = (dist < _MIN_DIST) | (dist > dist_min)
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

# rough per-pair instruction weights (the JAX package's cost rule)
_PAIR_WEIGHT = {"ss": 1, "bs": 5}
_MAX_UNROLL = 4000


def supports(world) -> bool:
    """The JAX package's cost rule: very contact-saturated worlds take the
    plain physics path instead of the fused step."""
    spec = world.spec
    substeps = int(world.substeps)
    cost = (
        len(spec.ss_a) * _PAIR_WEIGHT["ss"] * substeps
        + len(spec.bs_box) * _PAIR_WEIGHT["bs"] * substeps
        + len(spec.movable) * substeps
    )
    return cost <= _MAX_UNROLL


def check_fusable(world) -> None:
    """Raise ``NotImplementedError`` for a world the port's kernel cannot
    step (pair types and joints already raise in ``build_spec``)."""
    if world.dynamic_gravity:
        raise NotImplementedError("dynamic gravity is not ported to the fused kernel yet")
    spec = world.spec
    for what, n, cap in (
        ("entities", len(spec.mass), K.MAX_E),
        ("sphere-sphere pairs", len(spec.ss_a), K.MAX_SS),
        ("box-sphere pairs", len(spec.bs_box), K.MAX_BS),
    ):
        if n > cap:
            raise NotImplementedError(f"the fused kernel takes at most {cap} {what}, this world has {n}")


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
    """

    n_scratch_in = 0


# ---------------------------------------------------------------------------
# the constants both versions read
# ---------------------------------------------------------------------------

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
        self.lin_fric, self.ang_fric, self.gravity = [], [], []
        for e in range(E):
            lf, af, m = float(spec.lin_fric[e]), float(spec.ang_fric[e]), float(spec.mass[e])
            moi = float(spec.moi[e])
            self.lin_fric.append((lf * m, m) if lf != 0.0 and self.movable[e] else None)
            self.ang_fric.append((af * moi, moi) if af != 0.0 and self.rotatable[e] else None)
            egx, egy = gx + float(spec.ent_gravity[e, 0]), gy + float(spec.ent_gravity[e, 1])
            on = self.movable[e] and (egx != 0.0 or egy != 0.0)
            self.gravity.append((m * egx, m * egy) if on else None)
        self.ss = [
            (int(spec.ss_a[k]), int(spec.ss_b[k]), float(spec.ss_ra[k] + spec.ss_rb[k]))
            for k in range(len(spec.ss_a))
        ]
        self.bs = [
            (
                int(spec.bs_box[k]), int(spec.bs_sphere[k]),
                float(spec.bs_wid[k]) / 2, float(spec.bs_len[k]) / 2,
                float(spec.bs_rad[k]) + LINE_MIN_DIST, bool(spec.bs_not_hollow[k]),
            )
            for k in range(len(spec.bs_box))
        ]

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
            raise NotImplementedError(f"the rows kernel takes at most {K.MAX_A} action slots")
        s = K.FusedSpec()
        s.E, s.J, s.K_in, s.substeps = self.E, self.J, k_in, self.substeps
        s.n_ss, s.n_bs, s.n_act = len(self.ss), len(self.bs), len(act_slots)
        s.has_x, s.has_y = self.x_semidim is not None, self.y_semidim is not None
        s.sub_dt, s.cm, s.cf = self.sub_dt, self.cm, self.cf
        s.x_semidim = self.x_semidim or 0.0
        s.y_semidim = self.y_semidim or 0.0
        for e in range(self.E):
            flags = 0
            for bit, on in (
                (K.F_MOVABLE, self.movable[e]), (K.F_ROTATABLE, self.rotatable[e]),
                (K.F_MAX_F, self.max_f[e] is not None), (K.F_F_RANGE, self.f_range[e] is not None),
                (K.F_MAX_T, self.max_t[e] is not None), (K.F_T_RANGE, self.t_range[e] is not None),
                (K.F_LIN_FRIC, self.lin_fric[e] is not None), (K.F_ANG_FRIC, self.ang_fric[e] is not None),
                (K.F_GRAVITY, self.gravity[e] is not None), (K.F_DRAG, self.drag_fac[e] is not None),
                (K.F_MAX_SPEED, self.max_speed[e] is not None), (K.F_V_RANGE, self.v_range[e] is not None),
            ):
                flags |= bit if on else 0
            s.flags[e] = flags
            s.inv_mass[e], s.inv_moi[e] = self.inv_mass[e], self.inv_moi[e]
            s.drag_fac[e] = self.drag_fac[e] or 0.0
            s.max_f[e], s.f_range[e] = self.max_f[e] or 0.0, self.f_range[e] or 0.0
            s.max_t[e], s.t_range[e] = self.max_t[e] or 0.0, self.t_range[e] or 0.0
            s.max_speed[e], s.v_range[e] = self.max_speed[e] or 0.0, self.v_range[e] or 0.0
            s.lfm[e], s.mass[e] = self.lin_fric[e] or (0.0, 0.0)
            s.afm[e], s.moi[e] = self.ang_fric[e] or (0.0, 0.0)
            s.gsx[e], s.gsy[e] = self.gravity[e] or (0.0, 0.0)
        for k, (a, b, dmin) in enumerate(self.ss):
            s.ss_a[k], s.ss_b[k], s.ss_dmin[k] = a, b, dmin
        for k, (box, sph, hw, hl, dmin0, nh) in enumerate(self.bs):
            s.bs_box[k], s.bs_sph[k], s.bs_nh[k] = box, sph, int(nh)
            s.bs_hw[k], s.bs_hl[k], s.bs_dmin0[k] = hw, hl, dmin0
        for i, e in enumerate(act_slots):
            s.act_slot[i] = e
        return s


def _kernel_spec(world) -> KernelSpec:
    ks = getattr(world, "_kernel_spec", None)
    if ks is None:
        check_fusable(world)
        ks = world._kernel_spec = KernelSpec(world)
    return ks


# ---------------------------------------------------------------------------
# the plain version: one env step on [B] rows, in the kernel's order
# ---------------------------------------------------------------------------

def _physics_rows(ks, px, py, vx, vy, rot, w, fx, fy, tq):
    """All substeps of one physics step on per-entity row lists (rebound
    in place). Per entity the forces accumulate as the kernel accumulates
    them: action, friction, gravity, then the ss pairs and the bs pairs in
    spec order (+f on a, -f on b)."""
    E, cm, cf, sub_dt = ks.E, ks.cm, ks.cf, ks.sub_dt
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
                fcx = torch.clamp(torch.abs(vx[e]) / sub_dt * m, max=lfm)
                fcy = torch.clamp(torch.abs(vy[e]) / sub_dt * m, max=lfm)
                Fx[e] = Fx[e] + torch.where(zero, 0.0, -(vx[e] / den) * fcx)
                Fy[e] = Fy[e] + torch.where(zero, 0.0, -(vy[e] / den) * fcy)
            if ks.ang_fric[e] is not None:
                afm, moi = ks.ang_fric[e]
                sp = torch.abs(w[e])
                den = torch.where(sp == 0.0, 1.0, sp)
                fc = torch.clamp(sp / sub_dt * moi, max=afm)
                Tq[e] = Tq[e] + torch.where(sp == 0.0, 0.0, -(w[e] / den) * fc)

        # static gravity (world + per entity)
        for e in range(E):
            if ks.gravity[e] is not None:
                Fx[e] = Fx[e] + ks.gravity[e][0]
                Fy[e] = Fy[e] + ks.gravity[e][1]

        trig = {}

        def cs(e):
            if e not in trig:
                trig[e] = (torch.cos(rot[e]), torch.sin(rot[e]))
            return trig[e]

        for a, b, dmin in ks.ss:
            cfx, cfy = _constraint_force(cm, px[a], py[a], px[b], py[b], dmin, cf)
            if mv[a]:
                Fx[a], Fy[a] = Fx[a] + cfx, Fy[a] + cfy
            if mv[b]:
                Fx[b], Fy[b] = Fx[b] + (-cfx), Fy[b] + (-cfy)

        for b, s, hw, hl, dmin0, not_hollow in ks.bs:
            cos, sin = cs(b)
            cx, cy = _closest_point_box(px[b], py[b], cos, sin, hw, hl, px[s], py[s])
            if not_hollow:
                ix, iy, d = _inner_point_box(px[s], py[s], cx, cy, px[b], py[b])
                dmin = dmin0 + d
            else:
                ix, iy, dmin = cx, cy, dmin0
            sfx, sfy = _constraint_force(cm, px[s], py[s], ix, iy, dmin, cf)
            if mv[s]:
                Fx[s], Fy[s] = Fx[s] + sfx, Fy[s] + sfy
            if mv[b]:
                Fx[b], Fy[b] = Fx[b] + (-sfx), Fy[b] + (-sfy)
            if ro[b]:
                Tq[b] = Tq[b] + ((cx - px[b]) * (-sfy) - (cy - py[b]) * (-sfx))

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
                    s = torch.where(over, ms / torch.where(over, n, 1.0), 1.0)
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


def _step_rows(ks, x, outputs, act_slots=(), act=None):
    """One env step on a row buffer ``x`` [R, B] (with ``act`` [2A, B]
    overriding the force rows of the ``act_slots`` entities in the rows
    form). Returns ``(state_rows [9E], emit_rows [n_out], scratch_in
    [K_in])``."""
    E, J = ks.E, ks.J
    comps = [[x[c * E + e] for e in range(E)] for c in range(9)]
    px, py, vx, vy, rot, w, fx, fy, tq = comps
    A = len(act_slots)
    for i, e in enumerate(act_slots):
        fx[e] = act[i]
        fy[e] = act[A + i]
    k_in = int(outputs.n_scratch_in) if outputs is not None else 0
    scratch = [x[9 * E + J + k] for k in range(k_in)]
    _physics_rows(ks, px, py, vx, vy, rot, w, fx, fy, tq)
    extra = []
    if outputs is not None:
        ctx = {"px": px, "py": py, "vx": vx, "vy": vy, "rot": rot, "w": w,
               "fx": fx, "fy": fy, "scratch": scratch}
        extra = [r.to(torch.float32) for r in outputs.emit(ctx)]
        assert len(extra) == int(outputs.n_out), (
            f"emit produced {len(extra)} rows, n_out={outputs.n_out}"
        )
    return [r for comp in comps for r in comp], extra, scratch


def fused_step_plain(world, x, outputs=None):
    """Plain version of the fused step: rows [9E + J + K_in, B] ->
    [9E + K_out, B]."""
    rows, extra, _ = _step_rows(_kernel_spec(world), x, outputs)
    return torch.stack(rows + extra)


def rows_step_plain(world, outputs, act_slots, carry, act):
    """Plain version of the rows step: (carry [R_in, B], act [2A, B]) ->
    (carry', extra [n_out, B])."""
    ks = _kernel_spec(world)
    rows, extra, scratch = _step_rows(ks, carry, outputs, act_slots, act)
    E, J = ks.E, ks.J
    jfr = [carry[9 * E + j] for j in range(J)]
    new_scratch = [
        scratch[k] if ei is None else extra[int(ei)]
        for k, ei in enumerate(outputs.carry_extra_idx)
    ]
    return torch.stack(rows + jfr + new_scratch), torch.stack(extra)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _emit_params(outputs):
    if outputs is None:
        return K.EMIT_NONE, K.EmitParams()
    return outputs.kernel_emit()


def _launch(spec_c, outputs, x, act, out, extra, rows_mode):
    kind, ep = _emit_params(outputs)
    lib = K.library("fused_step")
    B = x.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vmas_fused_step(
            spec_c, ep, kind, x.data_ptr(),
            None if act is None else act.data_ptr(),
            out.data_ptr(), None if extra is None else extra.data_ptr(),
            B, int(rows_mode), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_step kernel launch failed: {lib.vmas_cuda_error_string(err).decode()}"
        )


def fused_step(world, x, outputs=None):
    """The fused step on rows [9E + J + K_in, B] -> [9E + K_out, B]: the
    CUDA kernel for a GPU tensor, the plain version for a CPU tensor."""
    global fused_step_launches
    ks = _kernel_spec(world)
    if x.device.type == "cpu":
        return fused_step_plain(world, x, outputs)
    k_in = int(outputs.n_scratch_in) if outputs is not None else 0
    k_out = int(outputs.n_out) if outputs is not None else 0
    B = x.shape[1]
    _check_rows("x", x, (9 * ks.E + ks.J + k_in, B))
    out = torch.empty((9 * ks.E + k_out, B), dtype=torch.float32, device=x.device)
    _launch(ks.to_ctypes(k_in), outputs, x, None, out, None, rows_mode=False)
    fused_step_launches += 1
    return out


def fused_physics_step(world, state, outputs=None):
    """Drop-in for physics.physics_step on fusable worlds. With ``outputs``
    (a :class:`FusedOutputs`) it also returns the scenario's output rows:
    ``(state, extra [n_out, B])``."""
    spec = world.spec
    E = len(spec.mass)
    parts = [
        state.pos[..., 0].T, state.pos[..., 1].T,
        state.vel[..., 0].T, state.vel[..., 1].T,
        state.rot.T, state.ang_vel.T,
        state.force[..., 0].T, state.force[..., 1].T,
        state.torque.T,
        state.joint_fixed_rot.T,
    ]
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
    exactly "force = u", realized in the kernel by the action rows)."""
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
    # scripted agents would run outside the kernel each step
    return not world.scripted_agents


def rows_layout(world, outputs):
    """R_in: carried rows (9E state + J joint fixed rotations + K scratch)."""
    E = len(world.spec.mass)
    J = len(world.spec.joint_idx_a)
    return 9 * E + J + int(outputs.n_scratch_in)


def pack_carry(world, state, outputs):
    """State + joint fixed rotations + scratch as one [R_in, B] buffer."""
    parts = [
        state.pos[..., 0].T, state.pos[..., 1].T,
        state.vel[..., 0].T, state.vel[..., 1].T,
        state.rot.T, state.ang_vel.T,
        state.force[..., 0].T, state.force[..., 1].T,
        state.torque.T,
        state.joint_fixed_rot.T.to(torch.float32),
        torch.as_tensor(outputs.scratch_rows(state), dtype=torch.float32, device=state.device),
    ]
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


def make_rows_step(world, outputs, act_slots):
    """Build ``step(carry [R_in, B], act [2A, B], extra_out=None) ->
    (carry', extra [n_out, B])``: one kernel launch on the GPU, the plain
    version on the CPU. ``extra_out`` (a contiguous [n_out, B] slice, e.g.
    a rollout's ``extras[t]``) receives the emit rows in place."""
    R_in = rows_layout(world, outputs)
    n_out = int(outputs.n_out)
    A = len(act_slots)
    spec_c = _kernel_spec(world).to_ctypes(int(outputs.n_scratch_in), act_slots)

    def step(carry, act, extra_out=None):
        global rows_step_launches
        if carry.device.type == "cpu":
            new, extra = rows_step_plain(world, outputs, act_slots, carry, act)
            if extra_out is not None:
                extra_out.copy_(extra)
                extra = extra_out
            return new, extra
        B = carry.shape[1]
        _check_rows("carry", carry, (R_in, B))
        _check_rows("act", act, (2 * A, B))
        out = torch.empty((R_in, B), dtype=torch.float32, device=carry.device)
        if extra_out is None:
            extra_out = torch.empty((n_out, B), dtype=torch.float32, device=carry.device)
        _check_rows("extra_out", extra_out, (n_out, B))
        _launch(spec_c, outputs, carry, act, out, extra_out, rows_mode=True)
        rows_step_launches += 1
        return out, extra_out

    return step
