"""The plain reference of the fused physics step: one env step on ``[B]``
rows per entity component, in plain PyTorch.

A frozen copy of the port's plain rows step (its geometry helpers, joint and
contact forces, their accumulation and the semi-implicit integration), kept
here so that the benchmark's comparison does not move when the port does.
It imports nothing of the port: the world's constants come from
:func:`build_spec`, which derives them from a configuration's entity table
(``portbench/configs/<name>.py``) by the simulator's published rules
(VMAS's ``World`` and shapes), with every constant rounded to float32 where
the simulator keeps it in float32.

``Spec.dtype`` is the type the rows are computed in: float32 for the
reference, bfloat16 for its lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LINE_MIN_DIST = 4 / 6e2
_MIN_DIST = 1e-6
# a contact type with at least this many pairs takes its minimum distance
# from the float32 sum (the simulator's vectorized form), else from the
# Python sum
_LANE_MIN = 8
PAIR_TYPES = ("ss", "ls", "ll", "bs", "bl", "bb")


def moment_of_inertia(shape, mass):
    """VMAS's moments of inertia: a sphere's m r^2 / 2, a box's m (l^2 +
    w^2) / 12, a line's m l^2 / 12."""
    kind = shape[0]
    if kind == "sphere":
        return (1 / 2) * mass * shape[1] ** 2
    if kind == "box":
        return (1 / 12) * mass * (shape[1] ** 2 + shape[2] ** 2)
    return (1 / 12) * mass * (shape[1] ** 2)


def anchor_delta(shape, anchor):
    """The body-frame offset of a joint anchor in [-1, 1]^2 (VMAS's
    ``get_delta_from_anchor``); the anchors used here lie inside a sphere."""
    kind = shape[0]
    if kind == "box":
        return anchor[0] * shape[1] / 2, anchor[1] * shape[2] / 2
    if kind == "line":
        return anchor[0] * shape[1] / 2, 0.0
    return anchor[0] * shape[1], anchor[1] * shape[1]


def _collides(a, b):
    """VMAS's static collidability: both collide with the other (flags and
    filters), and one of them can move or turn."""
    def accepts(e, other):
        f = e.get("filter")
        if f is None:
            return True
        if "names" in f:
            return other["name"] in f["names"]
        return other["shape"][0] != f["not_shape"]

    if not (a["collide"] and b["collide"] and accepts(a, b) and accepts(b, a)):
        return False
    return a["movable"] or a["rotatable"] or b["movable"] or b["rotatable"]


class Spec:
    """Every constant of one world's step, from the world table ``world``
    (see ``portbench/configs/transport.py``): per-entity flags and limits,
    the joint table and the contact pairs of each type in the simulator's
    order (entity pairs a < b, a joint first, a rigid joint taking its pair
    out of collision)."""

    def __init__(self, world, dtype=torch.float32):
        self.dtype = dtype
        ents = world["entities"]
        E = self.E = len(ents)
        idx = {e["name"]: i for i, e in enumerate(ents)}
        f32 = lambda vals: np.asarray(vals, np.float32)
        self.substeps = int(world["substeps"])
        self.sub_dt = float(world["dt"]) / self.substeps
        self.cm = float(world.get("contact_margin", 1e-3))
        self.cf = float(world["collision_force"])
        self.jf = float(world["joint_force"])
        self.tcf = float(world.get("torque_constraint_force", 1.0))
        self.x_semidim = world.get("x_semidim")
        self.y_semidim = world.get("y_semidim")
        self.movable = [bool(e["movable"]) for e in ents]
        self.rotatable = [bool(e["rotatable"]) for e in ents]
        mass = f32([e["mass"] for e in ents])
        inv_mass = 1.0 / mass
        moi = f32([moment_of_inertia(e["shape"], e["mass"]) for e in ents])
        inv_moi = np.where(moi > 0, 1.0 / np.where(moi > 0, moi, 1.0), 0.0).astype(np.float32)
        drag = f32([world["drag"] if e.get("drag") is None else e["drag"] for e in ents])
        self.inv_mass = [float(v) for v in inv_mass]
        self.inv_moi = [float(v) for v in inv_moi]
        self.drag_fac = [1 - float(d) if float(d) != 0.0 else None for d in drag]
        agent_limit = lambda key: [
            float(np.float32(e[key])) if e.get("agent") and e["movable"] and e.get(key) is not None else None
            for e in ents
        ]
        self.max_f, self.f_range = agent_limit("max_f"), agent_limit("f_range")
        self.max_t, self.t_range = [None] * E, [None] * E
        self.max_speed, self.v_range = [None] * E, [None] * E
        self.lin_fric, self.ang_fric = [None] * E, [None] * E
        self.gravity, self.dyn_g = [None] * E, [None] * E

        rigid = set()
        self.joints = []
        for ai in range(E):
            for bi in range(ai + 1, E):
                for j in world.get("joints", ()):
                    if {j["a"], j["b"]} == {ents[ai]["name"], ents[bi]["name"]}:
                        ea, eb = ents[idx[j["a"]]], ents[idx[j["b"]]]
                        da = np.asarray(anchor_delta(ea["shape"], j["anchor_a"]), np.float32)
                        db = np.asarray(anchor_delta(eb["shape"], j["anchor_b"]), np.float32)
                        self.joints.append((idx[j["a"]], idx[j["b"]], float(da[0]), float(da[1]),
                                            float(db[0]), float(db[1]), float(np.float32(j["dist"])), True))
                        if j["dist"] == 0:
                            rigid.add((ai, bi))
        self.J = len(self.joints)

        buckets = {t: [] for t in PAIR_TYPES}
        for ai in range(E):
            for bi in range(ai + 1, E):
                a, b = ents[ai], ents[bi]
                if (ai, bi) in rigid or not _collides(a, b):
                    continue
                ka, kb = a["shape"][0], b["shape"][0]
                kinds = {ka, kb}
                if kinds == {"sphere"}:
                    buckets["ss"].append((ai, bi))
                elif kinds == {"line", "sphere"}:
                    buckets["ls"].append((ai, bi) if kb == "sphere" else (bi, ai))
                elif kinds == {"line"}:
                    buckets["ll"].append((ai, bi))
                elif kinds == {"box", "sphere"}:
                    buckets["bs"].append((ai, bi) if kb == "sphere" else (bi, ai))
                elif kinds == {"box", "line"}:
                    buckets["bl"].append((ai, bi) if kb == "line" else (bi, ai))
                else:
                    buckets["bb"].append((ai, bi))
        shape = lambda i, k: float(np.float32(ents[i]["shape"][k]))
        not_hollow = lambda i: not ents[i].get("hollow", False)
        self.ss = [(a, b, float(np.float32(shape(a, 1)) + np.float32(shape(b, 1)))) for a, b in buckets["ss"]]
        self.ls = [(ln, s, shape(ln, 1) / 2, float(np.float32(shape(s, 1)) + np.float32(LINE_MIN_DIST)))
                   for ln, s in buckets["ls"]]
        self.ll = [(a, b, shape(a, 1) / 2, shape(b, 1) / 2) for a, b in buckets["ll"]]
        if len(buckets["bs"]) >= _LANE_MIN:
            bs_dmin0 = [float(np.float32(shape(s, 1)) + np.float32(LINE_MIN_DIST)) for _, s in buckets["bs"]]
        else:
            bs_dmin0 = [shape(s, 1) + LINE_MIN_DIST for _, s in buckets["bs"]]
        # a box's shape is ("box", length, width)
        self.bs = [(b, s, shape(b, 2) / 2, shape(b, 1) / 2, d, not_hollow(b))
                   for (b, s), d in zip(buckets["bs"], bs_dmin0)]
        self.bl = [(b, ln, shape(b, 2) / 2, shape(b, 1) / 2, shape(ln, 1) / 2, not_hollow(b))
                   for b, ln in buckets["bl"]]
        self.bb = [(a, b, shape(a, 2) / 2, shape(a, 1) / 2, shape(b, 2) / 2, shape(b, 1) / 2,
                    not_hollow(a), not_hollow(b)) for a, b in buckets["bb"]]
        self._columns = {}
        self.trig = sorted(
            {e for r in self.joints for e in r[:2]}
            | {r[0] for r in self.ls} | {e for r in self.ll for e in r[:2]} | {r[0] for r in self.bs}
            | {e for t in (self.bl, self.bb) for r in t for e in r[:2]}
        )

    def column(self, recs, k, dtype, device):
        """Field ``k`` of the pair records ``recs`` as a [P, 1] column, made
        once per type and device."""
        key = (id(recs), k, dtype, str(device))
        t = self._columns.get(key)
        if t is None:
            t = self._columns[key] = torch.tensor([r[k] for r in recs], dtype=dtype, device=device)[:, None]
        return t


def rows_step(spec, emit, carry_extra_idx, act_slots, carry, act):
    """One env step of the rows layout: ``carry`` [9E + J + K, B] (the
    entities' px, py, vx, vy, rot, w, fx, fy, tq, the joints' fixed
    rotations, the scenario's K scratch rows) and ``act`` [2A, B] (every
    acting agent's x force, then every y) -> (carry', emit rows [n_out,
    B]). The action rows override the agents' force rows; ``emit(ctx)`` is
    the configuration's plain observation, reward and flag rows; the next
    scratch rows are the emit rows ``carry_extra_idx`` names."""
    E, J = spec.E, spec.J
    comps = [[carry[c * E + e] for e in range(E)] for c in range(9)]
    jfr = [carry[9 * E + j] for j in range(J)]
    scratch = [carry[9 * E + J + k] for k in range(len(carry_extra_idx))]
    px, py, vx, vy, rot, w, fx, fy, tq = comps
    A = len(act_slots)
    for i, e in enumerate(act_slots):
        fx[e] = act[i]
        fy[e] = act[A + i]
    _physics_rows(spec, px, py, vx, vy, rot, w, fx, fy, tq, jfr)
    ctx = {"px": px, "py": py, "vx": vx, "vy": vy, "rot": rot, "w": w, "fx": fx, "fy": fy, "scratch": scratch}
    extra = [r.to(spec.dtype) for r in emit(ctx)]
    scratch = [extra[int(i)] for i in carry_extra_idx]
    return torch.stack([r for comp in comps for r in comp] + jfr + scratch), torch.stack(extra)


# ---------------------------------------------------------------------------
# the frozen copy: helpers on [B] rows; a "vec" is an (x, y) pair of rows
# ---------------------------------------------------------------------------

def _norm(x, y):
    sq = x * x + y * y
    is_zero = sq == 0.0
    return torch.where(is_zero, 0.0, torch.sqrt(torch.where(is_zero, 1.0, sq)))


_CONSTS = {}


def const(ref, value):
    """``value`` as a 0-d tensor of ``ref``'s type on its device, made once:
    a step then creates no tensor from the host, so it can be captured in a
    CUDA graph."""
    key = (float(value), ref.dtype, str(ref.device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(float(value), dtype=ref.dtype, device=ref.device)
    return t


def _div(num, den: float):
    """``num / den`` for a Python float ``den`` as one IEEE division, as the
    kernel divides (a division by a Python float would be a multiplication
    by its reciprocal)."""
    return num / const(num, den)


def _rdiv(num: float, den):
    """``num / den`` for a Python float ``num`` as one IEEE division."""
    return const(den, num) / den


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
    col = lambda recs, k, dt=None: ks.column(recs, k, dt or ks.dtype, dev)

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


