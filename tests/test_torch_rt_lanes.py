"""road_traffic's two kernel schedules (vmas_tpu_torch/csrc/road_traffic.cu),
held on the CPU to the plain versions they must match bitwise.

A CUDA kernel has no CPU mode, so these schedules are emulated in torch
float32 (each operation as the kernel takes it; in torch, as the plain
versions compute, since torch's CPU sqrt and numpy's differ in the last
bit on some inputs):

* the path sweeps' group form: one lane on a group of L threads, thread l
  on segments l, l + L, ..., each with a running first-min (k == 0 or a
  strict <), then an xor-shuffle tree over the group that takes the other
  (d, k) where it is smaller, equal at a lower k, or NaN; straddle flags
  OR; the 4 corners keep the least squared distance and take its root
  after the tree. For L in 1, 2, 4, 8, 16 and 32 the emulation equals
  ``sweep_all_plain`` bitwise in every output, on map 1's tables (lanes on
  centre-line and boundary vertices, exact ties, padded tails, straddling
  lanes) and on a hand-made table of 1-, 2- and 3-point paths (shorter than
  most groups);
* the tree's tie and NaN rules against the one-thread walk on hand-made
  rows, and the root of the least square against the least root on
  squares whose roots tie, 0, +inf and NaN;
* the observations' tile form: the distance matrix built once per unordered
  pair equals the per-ego one bitwise; the K rounds scanning the staged row
  (a chosen agent marked +inf) and the tile's coalesced stores (a ragged
  last tile, float4 runs and scalar runs) give ``obs_all_plain``'s output
  bitwise, its lowest-index tie included;
* the wrappers refuse a lane count or tile the kernel is not built for,
  and the observation tile's rule shrinks the tile to what a block holds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vmas_tpu_torch import testing
from vmas_tpu_torch.core.fused import _norm
from vmas_tpu_torch.scenarios import road_traffic as trt
from vmas_tpu_torch.scenarios import road_traffic_kernel as rtk
from vmas_tpu_torch.scenarios import road_traffic_map as rtm

torch.set_num_threads(1)

SWEEP_KW = dict(lh=0.08, wh=0.04, S=3, interval=2, shift=1)
INT_MAX = 2**31 - 1


# -- the path sweeps' group form ---------------------------------------------

def root(sq):
    """sqrt guarded as _norm: 0 at 0."""
    return torch.where(sq == 0, 0.0, torch.sqrt(torch.where(sq == 0, 1.0, sq)))


def seg_sq(sx, sy, vx, vy, qx, qy):
    """Squared distance from (qx, qy) to the segments (sx, sy) + t (vx, vy),
    as the kernel computes it."""
    ll = vx * vx + vy * vy + 1e-8
    pvx = qx - sx
    pvy = qy - sy
    t = torch.clamp((pvx * vx + pvy * vy) / ll, 0.0, 1.0)
    dx = (sx + vx * t) - qx
    dy = (sy + vy * t) - qy
    return dx * dx + dy * dy


def n_segments(n, M):
    return torch.clamp(torch.clamp(n - 1, max=M - 1), min=1)


def group_scan(d, nseg, L):
    """Per thread l of a group of L: the running first-min over segments
    l, l + L, ... below nseg (k == 0 or a strict <), from (+inf, INT_MAX).
    d [N, P, M-1] -> (best, k) [N, P, L]."""
    N, P, M1 = d.shape
    best = torch.full((N, P, L), torch.inf)
    bk = torch.full((N, P, L), INT_MAX, dtype=torch.int64)
    for it in range(-(-M1 // L)):
        k = it * L + torch.arange(L)
        kk = torch.clamp(k, max=M1 - 1)
        dk = d[:, :, kk]
        take = (k < nseg[:, None, None]) & ((k == 0) | (dk < best))
        best = torch.where(take, dk, best)
        bk = torch.where(take, k, bk)
    return best, bk


def group_reduce(d, k, L, index=True):
    """The xor-shuffle tree: each thread takes its partner's (d, k) where it
    is smaller, equal at a lower k (``index``: rows without an index reduce
    by value alone), or NaN; every thread ends with the group's result
    (checked) -> [N, P]."""
    off = L // 2
    while off:
        partner = torch.arange(L) ^ off
        d2, k2 = d[..., partner], k[..., partner]
        take = (d2 < d) | (index & (d2 == d) & (k2 < k)) | torch.isnan(d2)
        d, k = torch.where(take, d2, d), torch.where(take, k2, k)
        off //= 2
    assert torch.equal(d.isnan(), d[..., :1].isnan().expand_as(d))
    assert torch.equal(torch.nan_to_num(d), torch.nan_to_num(d[..., :1]).expand_as(d))
    assert not index or torch.equal(k, k[..., :1].expand_as(k))
    return d[..., 0], k[..., 0]


def straddles(vx5, vy5, bx, by):
    """Per segment [N, M-1]: does any rectangle edge cross it (the kernel's
    two strict straddle tests, v1a recomputed from the segment's own first
    point)?"""
    ax, ay, bx1, by1 = bx[:, :-1], by[:, :-1], bx[:, 1:], by[:, 1:]
    svx, svy = bx1 - ax, by1 - ay
    S2 = svx * ay - svy * ax
    hit = torch.zeros_like(ax, dtype=torch.bool)
    for e in range(4):
        dx1 = vx5[:, e + 1:e + 2] - vx5[:, e:e + 1]
        dy1 = vy5[:, e + 1:e + 2] - vy5[:, e:e + 1]
        S1 = dx1 * vy5[:, e:e + 1] - dy1 * vx5[:, e:e + 1]
        c1 = ((dx1 * ay - dy1 * ax) - S1) * ((dx1 * by1 - dy1 * bx1) - S1) < 0
        v2i = vy5[:, e:e + 1] * svx - vx5[:, e:e + 1] * svy
        v2n = vy5[:, e + 1:e + 2] * svx - vx5[:, e + 1:e + 2] * svy
        hit = hit | (c1 & ((v2i - S2) * (v2n - S2) < 0))
    return hit


def sweep_group(tables, pid, pos, rot, L, *, lh, wh, S, interval, shift):
    """The group form's outputs, in sweep_all_plain's dict."""
    B, A = pid.shape
    p = pid.reshape(-1)
    px, py, yaw = pos[..., 0].reshape(-1), pos[..., 1].reshape(-1), rot.reshape(-1)
    Mc, Mb = tables.center.shape[1], tables.left.shape[1]
    c, lb, rb = tables.center[p], tables.left[p], tables.right[p]
    meta = tables.meta[p].long()
    vxs, vys = rtk.rect_vertices_xy(px, py, yaw, lh, wh)
    qx = torch.stack([px] + vxs[:4], -1)
    qy = torch.stack([py] + vys[:4], -1)

    def sweep(poly, n, M, qx, qy):
        """Point 0 by distance with its first-min index; the others (the
        corners) by squared distance, one root after the tree."""
        sx, sy = poly[:, None, :-1, 0], poly[:, None, :-1, 1]
        sq = seg_sq(sx, sy, poly[:, None, 1:, 0] - sx, poly[:, None, 1:, 1] - sy, qx[..., None], qy[..., None])
        val = torch.cat([root(sq[:, :1]), sq[:, 1:]], 1)
        best, bk = group_scan(val, n_segments(n, M), L)
        d0, k0 = group_reduce(best[:, :1], bk[:, :1], L)
        rest, _ = group_reduce(best[:, 1:], bk[:, 1:], L, index=False)
        return torch.cat([d0, root(rest)], 1), k0

    d_ref, i_ref = sweep(c, meta[:, 0], Mc, px[:, None], py[:, None])
    dl5, il = sweep(lb, meta[:, 1], Mb, qx, qy)
    dr5, ir = sweep(rb, meta[:, 2], Mb, qx, qy)
    vx5, vy5 = torch.stack(vxs, -1), torch.stack(vys, -1)
    coll = []
    for poly, n in ((lb, meta[:, 1]), (rb, meta[:, 2])):
        h = straddles(vx5, vy5, poly[..., 0], poly[..., 1])
        k = torch.arange(h.shape[1])
        h = h & (k < n_segments(n, Mb)[:, None])
        per_thread = torch.stack([h[:, l::L].any(-1) for l in range(L)], -1)
        coll.append(per_thread.any(-1))  # the shuffle OR

    idx = i_ref[:, 0] + 1
    n_pts, is_loop = meta[:, 0:1], meta[:, 3:4] != 0
    fut = torch.arange(S) * interval + idx[:, None] + shift
    fut = torch.where(is_loop & (fut >= n_pts - 1) & (n_pts > 0), torch.remainder(fut + 1, n_pts), fut)
    fut = torch.where(fut < 0, Mc + fut, fut)
    fut = torch.clamp(fut, 0, Mc - 1)
    st = torch.gather(c, 1, fut[..., None].expand(-1, -1, 2))

    ba = lambda x: x.reshape((B, A) + tuple(x.shape[1:]))
    return dict(
        d_ref=ba(d_ref[:, 0]), idx_ref=ba(idx), dl5=ba(dl5), dr5=ba(dr5),
        idx_l=ba(il[:, 0] + 1), idx_r=ba(ir[:, 0] + 1), coll_l=ba(coll[0]), coll_r=ba(coll[1]),
        short_term=ba(st),
    )


def map_lanes(seed=0, B=8, A=20):
    """Map 1's tables and lanes: on centre-line vertices (ties; padded tails
    too), on left-boundary vertices, and scattered around the paths (some
    straddle a boundary); then chip_smoke.py's vertex lanes."""
    p = rtm.pad_paths(rtm.build_reference_paths(rtm.parse_map())[0], 6)
    tables = rtk.build_tables(p, "cpu")
    rng = np.random.default_rng(seed)
    NP, Mc, Mb = p.center.shape[0], p.center.shape[1], p.left_b.shape[1]
    pid = rng.integers(0, NP, (B, A))
    kind = rng.integers(0, 3, (B, A))
    on_c = p.center[pid, rng.integers(0, Mc, (B, A))]
    on_l = p.left_b[pid, rng.integers(0, Mb, (B, A))]
    near = p.center[pid, rng.integers(0, Mc, (B, A))] + rng.normal(0, 0.06, (B, A, 2))
    pos = np.where((kind == 0)[..., None], on_c, np.where((kind == 1)[..., None], on_l, near))
    rot = np.where(kind == 0, p.yaw[pid, rng.integers(0, Mc, (B, A))], rng.uniform(-np.pi, np.pi, (B, A)))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    cases = [(torch.as_tensor(pid), f(pos), f(rot))]
    vpid, vc, vl, vrot = testing.rt_vertex_lanes(tables, B, A, "cpu")
    cases += [(vpid, vc, vrot), (vpid, vl, vrot)]
    return tables, cases


def short_tables():
    """Paths of 1, 2 and 3 points (a loop among them), padded to 4 by
    repeating the last point, as pad_paths does."""
    pts = [np.array([[0.3, -0.2]]), np.array([[0.0, 0.0], [1.0, 0.5]]),
           np.array([[0.0, 1.0], [0.5, 1.2], [1.0, 1.0]])]

    def pad(a, M=4):
        return np.concatenate([a, np.repeat(a[-1:], M - len(a), 0)])

    f = lambda a: torch.as_tensor(np.stack(a).astype(np.float32))
    n = np.array([len(a) for a in pts])
    return SimpleNamespace(
        center=f([pad(a) for a in pts]), left=f([pad(a + [0.0, 0.1]) for a in pts]),
        right=f([pad(a - [0.0, 0.1]) for a in pts]),
        meta=torch.as_tensor(np.stack([n, n, n, [0, 0, 1]], 1).astype(np.int32)),
    )


@pytest.fixture(scope="module")
def sweep_cases():
    tables, cases = map_lanes()
    want = [rtk.sweep_all_plain(tables, *c, **SWEEP_KW) for c in cases]
    # the inputs hold what they are meant to: exact vertex ties, padded
    # tails, straddles
    assert bool((want[0]["d_ref"] == 0).any()) and bool(want[0]["coll_l"].any())
    assert bool((want[1]["idx_ref"] >= tables.meta[cases[1][0], 0].long() - 1).any())
    short = short_tables()
    rng = np.random.default_rng(1)
    pid = torch.as_tensor(rng.integers(0, 3, (4, 6)))
    pos = torch.as_tensor(rng.uniform(-0.5, 1.5, (4, 6, 2)).astype(np.float32))
    pos[0, :3] = short.center[pid[0, :3], 0]  # on a first vertex
    rot = torch.as_tensor(rng.uniform(-np.pi, np.pi, (4, 6)).astype(np.float32))
    return [(tables, c, w) for c, w in zip(cases, want)] + [
        (short, (pid, pos, rot), rtk.sweep_all_plain(short, pid, pos, rot, **SWEEP_KW))]


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_sweep_group_schedule_bitwise_plain(sweep_cases, L):
    for i, (tables, case, want) in enumerate(sweep_cases):
        got = sweep_group(tables, *case, L, **SWEEP_KW)
        for k, v in want.items():
            assert torch.equal(got[k], v), (i, k)


def test_root_of_least_square_is_least_root():
    """The corners' rule: the root of the least square (by the walk and the
    tree, value alone) equals the least root (by the one-thread walk),
    bitwise, on squares a few ulps apart whose roots tie, 0, +inf, NaN at
    segment 0 (kept) and later (skipped), and map 1's segments."""
    base = torch.tensor(2.0).nextafter(torch.tensor(3.0))
    ulps = [base]
    for _ in range(6):
        ulps.append(ulps[-1].nextafter(torch.tensor(3.0)))
    ties = torch.stack(ulps[::-1])
    assert int(torch.unique(root(ties)).numel()) < int(ties.numel())  # some roots tie
    inf, nan = float("inf"), float("nan")
    rows = [ties.tolist(), [0.5, 0.0, 0.0, 0.25], [inf, inf, 4.0], [nan, 1.0, 0.5], [1.0, nan, 0.5, nan],
            [inf, nan, inf], [9.0]]
    M1 = max(map(len, rows))
    sq = torch.full((len(rows), 1, M1), 99.0)
    for i, r in enumerate(rows):
        sq[i, 0, :len(r)] = torch.tensor(r)
    nseg = torch.tensor([len(r) for r in rows])
    for L in (1, 2, 4, 8, 16, 32):
        by_root, _ = group_reduce(*group_scan(root(sq), nseg, 1), 1)
        by_square, _ = group_reduce(*group_scan(sq, nseg, L), L, index=False)
        assert torch.equal(root(by_square).view(torch.int32), by_root.view(torch.int32)), L

    tables, cases = map_lanes(seed=2)
    pid, pos, _ = cases[0]
    poly = tables.left[pid.reshape(-1)]
    sx, sy = poly[:, None, :-1, 0], poly[:, None, :-1, 1]
    sq = seg_sq(sx, sy, poly[:, None, 1:, 0] - sx, poly[:, None, 1:, 1] - sy, pos[..., 0].reshape(-1, 1, 1),
                pos[..., 1].reshape(-1, 1, 1))
    assert torch.equal(root(sq.min(-1).values), root(sq).min(-1).values)


def test_group_reduce_keeps_the_serial_walks_nan_and_ties():
    """The tree's tie and NaN rules reproduce the one-thread walk (k == 0 or
    a strict <) on hand-made rows: exact ties at several k, a NaN at k = 0
    (kept), NaNs elsewhere (skipped), all +inf, idle threads."""
    inf, nan = float("inf"), float("nan")
    rows = [[0.5, 0.2, 0.2, 0.9, 0.2], [nan, 0.1, 0.0], [0.3, nan, 0.1, nan, 0.1], [inf, inf, inf],
            [0.7], [0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.3]]
    M1 = max(map(len, rows))
    d = torch.full((len(rows), 1, M1), 9.0)
    for i, r in enumerate(rows):
        d[i, 0, :len(r)] = torch.tensor(r)
    nseg = torch.tensor([len(r) for r in rows])

    def serial(r):
        best, k = None, None
        for j, x in enumerate(r):
            if j == 0 or x < best:
                best, k = x, j
        return best, k

    for L in (1, 2, 4, 8, 16, 32):
        dm, km = group_reduce(*group_scan(d, nseg, L), L)
        for i, r in enumerate(rows):
            b, k = serial(r)
            assert (np.isnan(b) and bool(dm[i, 0].isnan())) or float(dm[i, 0]) == np.float32(b), (L, i)
            assert int(km[i, 0]) == k, (L, i)


# -- the observations' tile form ----------------------------------------------

def obs_inputs(seed=0, B=8, A=6, S=3):
    """Random egos, with exact distance ties in env 0 (agents 1 and 2 mirror
    each other about ego 0, test_torch_road_traffic's tie case) and agents
    beyond the mask threshold."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.5, 2.5, (B, A, 2))
    pos[0, 0], pos[0, 1], pos[0, 2] = (0.0, 0.0), (0.3, 0.4), (-0.3, 0.4)
    pos[0, 3:] = rng.uniform(1.0, 2.5, (A - 3, 2))
    rot = rng.uniform(-np.pi, np.pi, (B, A))
    vel = rng.uniform(-1, 1, (B, A, 2))
    st = pos[:, :, None] + rng.uniform(-0.3, 0.3, (B, A, S, 2))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    verts = trt.rectangle_vertices(f(pos), f(rot), 0.08, 0.16)
    d = rng.uniform(0, 0.2, (3, B, A))
    return [f(pos), f(rot), f(vel), f(st), verts.contiguous(), f(d[0]), f(d[1]), f(d[2])]


def pair_matrix(pos):
    """Each env's distance matrix from unordered pairs, as the tile form
    builds it: thread i takes j = i + m (mod A), m = 1 .. A/2, the opposite
    pair of an even A from the lower index only; the diagonal +inf."""
    B, A, _ = pos.shape
    D = torch.full((B, A, A), torch.nan)
    for i in range(A):
        D[:, i, i] = torch.inf
        for m in range(1, A // 2 + 1):
            if 2 * m == A and i >= m:
                break
            j = (i + m) % A
            ddx = pos[:, j, 0] - pos[:, i, 0]
            ddy = pos[:, j, 1] - pos[:, i, 1]
            d = torch.sqrt(ddx * ddx + ddy * ddy + 1e-12)
            D[:, i, j] = d
            D[:, j, i] = d
    assert not bool(D.isnan().any())  # every pair written
    return D


@pytest.mark.parametrize("A", [5, 6])
def test_pair_matrix_bitwise_per_ego(A):
    pos = obs_inputs(B=16, A=A)[0]
    ddx = pos[:, None, :, 0] - pos[:, :, None, 0]  # [B, ego, other], as obs_all_plain
    ddy = pos[:, None, :, 1] - pos[:, :, None, 1]
    per_ego = torch.sqrt(ddx * ddx + ddy * ddy + 1e-12)
    per_ego = torch.where(torch.eye(A, dtype=torch.bool), torch.inf, per_ego)
    assert torch.equal(pair_matrix(pos).view(torch.int32), per_ego.view(torch.int32))


def obs_tile(xs, tile, *, K, apply_mask, norm_pos, norm_v, norm_dist, thresh):
    """The tile form's output [A, B, W]: per tile the pair matrix, each
    ego's K rounds over its staged row (strict <, a chosen agent marked
    +inf), its row built at stride Wp = W | 1, then the block's stores:
    ego i's Eb*W floats at out + (i*B + b0)*W, in float4 runs where
    W % 4 == 0."""
    pos, rot, vel, st, verts, d_ref, d_l, d_r = xs
    B, A = rot.shape
    S = st.shape[2]
    W = 1 + 2 * S + 3 + 11 * K
    Wp = W | 1
    out = torch.full((A * B * W,), torch.nan)
    for b0 in range(0, B, tile):
        Eb = min(tile, B - b0)
        sl = slice(b0, b0 + Eb)
        row = pair_matrix(pos[sl])  # [Eb, A, A]
        px, py = pos[sl, :, 0], pos[sl, :, 1]
        ci, si = torch.cos(rot[sl]), torch.sin(rot[sl])
        smem = torch.full((Eb * A, Wp), torch.nan)
        o = smem.view(Eb, A, Wp)
        o[..., 0] = _norm(vel[sl, :, 0], vel[sl, :, 1]) / norm_v
        for q in range(S):
            dx, dy = st[sl, :, q, 0] - px, st[sl, :, q, 1] - py
            o[..., 1 + 2 * q] = (dx * ci + dy * si) / norm_pos
            o[..., 2 + 2 * q] = (dy * ci - dx * si) / norm_pos
        w = 1 + 2 * S
        o[..., w], o[..., w + 1], o[..., w + 2] = d_ref[sl] / norm_dist, d_l[sl] / norm_dist, d_r[sl] / norm_dist
        w += 3
        take = lambda x, idx: torch.gather(x, 1, idx)
        for _ in range(K):
            mdist = torch.full((Eb, A), torch.inf)
            idx = torch.full((Eb, A), -1)
            for j in range(A):
                better = row[:, :, j] < mdist
                mdist = torch.where(better, row[:, :, j], mdist)
                idx = torch.where(better, j, idx)
            assert bool((idx >= 0).all())
            row.scatter_(2, idx[..., None], torch.inf)
            far = (mdist >= thresh) if apply_mask else torch.zeros_like(mdist, dtype=torch.bool)
            for c in range(4):
                dx = take(verts[sl, :, c, 0], idx) - px
                dy = take(verts[sl, :, c, 1], idx) - py
                o[..., w] = torch.where(far, 1.0, (dx * ci + dy * si) / norm_pos)
                o[..., w + 1] = torch.where(far, 1.0, (dy * ci - dx * si) / norm_pos)
                w += 2
            vel_abs = _norm(take(vel[sl, :, 0], idx), take(vel[sl, :, 1], idx))
            rot_rel = take(rot[sl], idx) - rot[sl]
            o[..., w] = torch.where(far, 0.0, vel_abs * torch.cos(rot_rel) / norm_v)
            o[..., w + 1] = torch.where(far, 0.0, vel_abs * torch.sin(rot_rel) / norm_v)
            o[..., w + 2] = torch.where(far, 1.0, mdist / norm_dist)
            w += 3
        # the block's stores, thread x of the flattened loop
        run = Eb * W
        vec = 4 if W % 4 == 0 else 1
        x = torch.arange(A * run // vec)
        ie = x // (run // vec)
        r = vec * (x - ie * (run // vec))
        ee, ww = r // W, r % W
        for c in range(vec):
            out[(ie * B + b0) * W + r + c] = smem.view(-1)[(ee * A + ie) * Wp + ww + c]
    return out.view(A, B, W)


@pytest.mark.parametrize("tile", [1, 3, 8, 16])
@pytest.mark.parametrize("S,K,apply_mask", [(3, 2, True), (2, 2, True), (3, 3, False)],
                         ids=["W32_float4", "W30_scalar", "K3_no_mask"])
def test_obs_tile_schedule_bitwise_plain(tile, S, K, apply_mask):
    """At B = 8 a tile of 3 leaves a ragged last tile and one of 16 a
    single partial one."""
    xs = obs_inputs(S=S)
    kw = dict(K=K, apply_mask=apply_mask, norm_pos=float(np.float32(1.6)), norm_v=1.0, norm_dist=0.45,
              thresh=float(np.float32(1.6)))
    want = rtk.obs_all_plain(*xs, **kw)
    got = obs_tile(xs, tile, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the tie: ego 0's nearest is agent 1, the lower index of the mirrored
    # pair, at the same distance as its second nearest
    d_col = 1 + 2 * S + 3 + 10
    assert float(got[0, 0, d_col]) == float(got[0, 0, d_col + 11])
    ci, si = np.cos(float(xs[1][0, 0])), np.sin(float(xs[1][0, 0]))
    vx, vy = xs[4][0, 1, 0].numpy()
    w = 1 + 2 * S + 3
    np.testing.assert_allclose(got[0, 0, w:w + 2].numpy(), [(vx * ci + vy * si) / 1.6, (vy * ci - vx * si) / 1.6],
                               atol=1e-6)
    if apply_mask:
        far = got[..., [1 + 2 * S + 3 + 11 * k + 10 for k in range(K)]] == 1.0
        assert bool(far.any()) and not bool(far.all())


# -- the wrappers' checks -------------------------------------------------------

def test_wrappers_refuse_forms_not_built():
    tables, cases = map_lanes(B=2)
    pid, pos, rot = cases[0]
    assert rtk.SWEEP_LANES in rtk.SWEEP_LANES_BUILT and rtk.SWEEP_LANES > 1 and rtk.OBS_TILE > 0
    for bad in (0, 2, 3, 4, 16, 32, 64):
        with pytest.raises(ValueError, match="built for lanes"):
            rtk.sweep_all(tables, pid, pos, rot, lanes=bad, **SWEEP_KW)
    xs = obs_inputs(B=2, A=20)
    kw = dict(K=2, apply_mask=True, norm_pos=1.6, norm_v=1.0, norm_dist=0.45, thresh=1.6)
    for bad in (-1, 52, 2.0):
        with pytest.raises(ValueError, match="tile must be"):
            rtk.obs_all(*xs, tile=bad, **kw)
    # the CPU takes the plain version whatever the form
    assert torch.equal(rtk.obs_all(*xs, tile=0, **kw), rtk.obs_all_plain(*xs, **kw))


@pytest.mark.parametrize("A,limit,tile", [
    (20, 232448, 8),    # the main path on the H100: 48,640 bytes a block
    (20, 49152, 8),     # no opt-in beyond 48 KB: it still fits
    (20, 40000, 4),
    (64, 232448, 4),    # 8 envs: 245,760 bytes
    (130, 232448, 2),   # 8 envs: 1,040 threads; 4 envs: 386,880 bytes
    (300, 232448, 0),   # one env: 427,200 bytes
    (1025, 10 ** 9, 0),  # one env: more than 1024 threads
])
def test_obs_tile_rule(A, limit, tile):
    """The largest of 8, 4, 2, 1 envs whose block fits 1024 threads and the
    shared-memory limit; 0 (one thread per (env, ego)) where none does."""
    S, K = 3, 2
    assert rtk.obs_tile_for(A, S, K, limit) == tile
    if tile:
        assert tile * A <= 1024 and rtk.obs_tile_bytes(tile, A, S, K) <= limit
        if tile < rtk.OBS_TILE:
            assert 2 * tile * A > 1024 or rtk.obs_tile_bytes(2 * tile, A, S, K) > limit
    assert rtk.obs_tile_bytes(8, 20, S, K) == 48640
