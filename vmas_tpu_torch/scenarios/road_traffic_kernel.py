"""road_traffic's two kernels: the path sweeps (K3) and the all-ego
observations (K4), hand-written in CUDA (``csrc/road_traffic.cu``).

Counterpart of vmas_tpu/scenarios/road_traffic_kernel.py.

* ``sweep_all`` (replaces the Pallas ``sweep_all``): per (env, agent) lane,
  the centre-line distance and first-min segment index, the CG and the 4
  rectangle corners against the left and right boundaries, the
  rectangle-vs-boundary straddle flags, and the S-point short-term path.
* ``obs_all`` (replaces the Pallas ``obs_all``): per (env, ego), the
  default-config observation row: own speed, short-term path in the ego
  frame, d_ref/d_l/d_r, and the K nearest other agents by a masked minimum
  taken K times (ties to the lowest index), masked beyond ``thresh``.

Each has a plain PyTorch version here (``sweep_all_plain``,
``obs_all_plain``) with the kernel's arithmetic in the kernel's order. A
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors (or raises), and counts each launch in ``sweep_launches`` /
``obs_launches``. Both kernels are forward-only: ``Environment`` turns
``pallas_sweeps``/``pallas_obs`` off under ``grad_enabled``.

The TPU kernel gathered each lane's path rows as a one-hot matmul (TPU
gathers are slow); here the tables are path-major (``[NP, M, 2]``) and the
kernel reads its path's rows with indexed loads.

Each kernel has two forms on the card, bitwise equal: the path sweeps run
one (env, agent) lane on a group of ``SWEEP_LANES`` threads (``lanes=1``:
one thread per lane), the observations one tile of envs per block with
coalesced stores (``tile=0``: one thread per (env, ego)); the tile is the
largest of ``OBS_TILE``, ``OBS_TILE / 2``, ..., 1 envs whose block fits
1024 threads and the device's shared memory (:func:`obs_tile_for`), and 0
where none does. The scenario runs the defaults; the ``lanes``/``tile``
keywords are for the tests and chip_smoke.py, which hold the forms against
each other.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from vmas_tpu_torch import _kernels
from vmas_tpu_torch.core.fused import _norm  # guarded |(x, y)|: 0 at 0, not sqrt(0)

# output row layout of the sweep kernel ([16 + 2S, B*A])
R_D_REF = 0
R_IDX_REF = 1
R_DL = 2          # 5 rows
R_IDX_L = 7
R_DR = 8          # 5 rows
R_IDX_R = 13
R_COLL_L = 14
R_COLL_R = 15
R_ST = 16         # 2S rows (x then y)

# the largest K the observation kernel's selection array holds
# (csrc/road_traffic.cu, K_MAX)
K_MAX_OBS = 8

# threads per lane the sweep kernel is built for (1: one thread per lane),
# and the count it runs at, chosen by measurement of 4, 8, 16 and 32
# (PERF.md; tools/time_rt_kernels.py)
SWEEP_LANES_BUILT = (1, 8)
SWEEP_LANES = 8
# the most envs per block of the observation kernel's tile form, chosen by
# measurement (PERF.md); fewer where a block of them does not fit
OBS_TILE = 8

# kernel launches; only the CUDA wrappers add to them
sweep_launches = 0
obs_launches = 0


def build_tables(paths, device) -> SimpleNamespace:
    """The padded path arrays (road_traffic_map.pad_paths) as path-major
    tensors on ``device``: ``center`` [NP, Mc, 2], ``left``/``right``
    [NP, Mb, 2] f32, and ``meta`` [NP, 4] int32 (n_points, n_left, n_right,
    is_loop)."""
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device).contiguous()
    meta = np.stack(
        [paths.n_points, paths.n_left, paths.n_right, paths.is_loop.astype(np.int32)], axis=1
    ).astype(np.int32)
    return SimpleNamespace(
        center=f(paths.center), left=f(paths.left_b), right=f(paths.right_b),
        meta=torch.tensor(meta, device=device).contiguous(),
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _sweep(bx, by, n, qx, qy):
    """Min distance from points (qx, qy) [N, P] to the padded polylines
    (bx, by) [N, M] with n [N] real points; segments at or after n-1 take
    segment n-2's distance. Returns (dmin [N, P], first-min index + 1)."""
    sx, sy = bx[:, None, :-1], by[:, None, :-1]
    vx = bx[:, None, 1:] - sx
    vy = by[:, None, 1:] - sy
    ll = vx * vx + vy * vy + 1e-8
    pvx = qx[..., None] - sx
    pvy = qy[..., None] - sy
    t = torch.clamp((pvx * vx + pvy * vy) / ll, 0.0, 1.0)
    dx = (sx + vx * t) - qx[..., None]
    dy = (sy + vy * t) - qy[..., None]
    d = _norm(dx, dy)  # [N, P, M-1]
    seg = torch.arange(d.shape[-1], device=d.device)
    end_seg = torch.clamp(n - 2, min=0)[:, None, None]
    end_d = torch.gather(d, 2, end_seg.expand(d.shape[0], d.shape[1], 1))
    d = torch.where(seg >= (n - 1)[:, None, None], end_d, d)
    dmin = d.min(-1).values
    idx = torch.where(d == dmin[..., None], seg, d.shape[-1]).min(-1).values
    return dmin, idx + 1


def _straddle(vxs, vys, bx, by):
    """Does any of the 4 rectangle edges (vertices vxs/vys [N, 5]) cross
    the polylines (bx, by) [N, M]? Strict ``< 0`` on both straddle tests,
    so zero-length padding segments never hit."""
    dx2 = bx[:, 1:] - bx[:, :-1]
    dy2 = by[:, 1:] - by[:, :-1]
    S2 = dx2 * by[:, :-1] - dy2 * bx[:, :-1]
    hit = torch.zeros(bx.shape[0], dtype=torch.bool, device=bx.device)
    for i in range(4):
        x1i, y1i = vxs[:, i:i + 1], vys[:, i:i + 1]
        x1n, y1n = vxs[:, i + 1:i + 2], vys[:, i + 1:i + 2]
        dx1 = x1n - x1i
        dy1 = y1n - y1i
        S1 = dx1 * y1i - dy1 * x1i
        v1 = dx1 * by - dy1 * bx
        C1 = (v1[:, :-1] - S1) * (v1[:, 1:] - S1) < 0
        v2i = y1i * dx2 - x1i * dy2
        v2n = y1n * dx2 - x1n * dy2
        C2 = (v2i - S2) * (v2n - S2) < 0
        hit = hit | (C1 & C2).any(-1)
    return hit


def rect_vertices_xy(px, py, yaw, lh, wh):
    """The closed rectangle's 5 vertices as (x, y) lists of rows:
    ``cos*bx - sin*by + px``, ``sin*bx + cos*by + py``."""
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    base = [(lh, wh), (lh, -wh), (-lh, -wh), (-lh, wh), (lh, wh)]
    return ([cos * bx - sin * by + px for bx, by in base],
            [sin * bx + cos * by + py for bx, by in base])


def sweep_all_plain(tables, pid, pos, rot, *, lh, wh, S, interval, shift):
    """The sweep kernel's plain version: same inputs and outputs as
    :func:`sweep_all`."""
    B, A = pid.shape
    p = pid.reshape(-1)
    px, py, yaw = pos[..., 0].reshape(-1), pos[..., 1].reshape(-1), rot.reshape(-1)
    Mc = tables.center.shape[1]
    c, l, r = tables.center[p], tables.left[p], tables.right[p]
    meta = tables.meta[p].long()
    n_pts, n_l, n_r, is_loop = meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3] > 0

    vxs, vys = rect_vertices_xy(px, py, yaw, lh, wh)
    qx = torch.stack([px] + vxs[:4], dim=-1)  # [N, 5]
    qy = torch.stack([py] + vys[:4], dim=-1)
    d_ref, idx_ref = _sweep(c[..., 0], c[..., 1], n_pts, px[:, None], py[:, None])
    dl5, il = _sweep(l[..., 0], l[..., 1], n_l, qx, qy)
    dr5, ir = _sweep(r[..., 0], r[..., 1], n_r, qx, qy)
    vx5, vy5 = torch.stack(vxs, -1), torch.stack(vys, -1)
    coll_l = _straddle(vx5, vy5, l[..., 0], l[..., 1])
    coll_r = _straddle(vx5, vy5, r[..., 0], r[..., 1])

    idx = idx_ref[:, 0]
    fut = idx[:, None] + torch.arange(S, device=pid.device) * interval + shift  # [N, S]
    n = n_pts[:, None]
    fut = torch.where(is_loop[:, None] & (fut >= n - 1), torch.remainder(fut + 1, n), fut)
    fut = torch.where(fut < 0, Mc + fut, fut)
    fut = torch.clamp(fut, 0, Mc - 1)
    st = torch.gather(c, 1, fut[..., None].expand(-1, -1, 2))  # [N, S, 2]

    ba = lambda x: x.reshape((B, A) + tuple(x.shape[1:]))
    return dict(
        d_ref=ba(d_ref[:, 0]), idx_ref=ba(idx), dl5=ba(dl5), dr5=ba(dr5),
        idx_l=ba(il[:, 0]), idx_r=ba(ir[:, 0]), coll_l=ba(coll_l), coll_r=ba(coll_r),
        short_term=ba(st),
    )


def obs_all_plain(pos, rot, vel, short_term, verts, d_ref, d_left_min, d_right_min,
                  *, K, apply_mask, norm_pos, norm_v, norm_dist, thresh):
    """The observation kernel's plain version: same inputs and output as
    :func:`obs_all`."""
    B, A = rot.shape
    px, py = pos[..., 0], pos[..., 1]
    ci, si = torch.cos(rot), torch.sin(rot)

    def to_local(qx, qy):
        """Points [B, A(ego), ...] into each ego's frame (rotation form)."""
        sh = (B, A) + (1,) * (qx.ndim - 2)
        dx, dy = qx - px.reshape(sh), qy - py.reshape(sh)
        c, s = ci.reshape(sh), si.reshape(sh)
        return dx * c + dy * s, dy * c - dx * s

    cols = [(_norm(vel[..., 0], vel[..., 1]) / norm_v)[..., None]]
    sx, sy = to_local(short_term[..., 0], short_term[..., 1])  # [B, A, S]
    cols.append(torch.stack([sx / norm_pos, sy / norm_pos], -1).reshape(B, A, -1))
    cols += [(d_ref / norm_dist)[..., None], (d_left_min / norm_dist)[..., None],
             (d_right_min / norm_dist)[..., None]]

    ddx = px[:, None, :] - px[:, :, None]  # [B, ego, other]
    ddy = py[:, None, :] - py[:, :, None]
    d_cur = torch.sqrt(ddx * ddx + ddy * ddy + 1e-12)
    iota = torch.arange(A, device=pos.device)
    d_cur = torch.where(iota[:, None] == iota[None, :], torch.inf, d_cur)
    take = lambda x, idx: torch.gather(x, 1, idx)  # x [B, A] by idx [B, A(ego)]
    for _ in range(K):
        m = d_cur.min(-1).values
        idx = torch.where(d_cur == m[..., None], iota, A).min(-1).values
        d_cur = torch.where(iota == idx[..., None], torch.inf, d_cur)
        far = m >= thresh if apply_mask else torch.zeros_like(m, dtype=torch.bool)
        for c in range(4):
            cx, cy = to_local(take(verts[:, :, c, 0], idx), take(verts[:, :, c, 1], idx))
            cols.append(torch.where(far, 1.0, cx / norm_pos)[..., None])
            cols.append(torch.where(far, 1.0, cy / norm_pos)[..., None])
        vel_abs = _norm(take(vel[..., 0], idx), take(vel[..., 1], idx))
        rot_rel = take(rot, idx) - rot
        cols.append(torch.where(far, 0.0, vel_abs * torch.cos(rot_rel) / norm_v)[..., None])
        cols.append(torch.where(far, 0.0, vel_abs * torch.sin(rot_rel) / norm_v)[..., None])
        cols.append(torch.where(far, 1.0, m / norm_dist)[..., None])
    return torch.cat(cols, -1).permute(1, 0, 2)  # [A, B, W]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.vmas_rt_error_string(err).decode()}")


def _check_lanes(lanes):
    lanes = SWEEP_LANES if lanes is None else lanes
    if lanes not in SWEEP_LANES_BUILT:
        raise ValueError(f"the sweep kernel is built for lanes in {SWEEP_LANES_BUILT}, got {lanes}")
    return lanes


def _check_tile(tile, A):
    if tile is not None and not (isinstance(tile, int) and 0 <= tile and tile * A <= 1024):
        raise ValueError(f"tile must be an int in [0, 1024 / A] envs per block (A={A}), got {tile}")


def obs_tile_bytes(tile, A, S, K):
    """Shared memory of one block of the observation kernel's tile form, in
    bytes (csrc/road_traffic.cu, obs_tile_floats)."""
    W = 1 + 2 * S + 3 + 11 * K
    return 4 * tile * A * ((16 + 2 * S) + (A | 1) + (W | 1))


def obs_tile_for(A, S, K, smem_limit):
    """The tile the observation kernel runs at: the largest of OBS_TILE,
    OBS_TILE / 2, ..., 1 envs whose block holds at most 1024 threads and
    ``smem_limit`` bytes of shared memory, or 0 (one thread per (env, ego))
    where none does."""
    tile = OBS_TILE
    while tile >= 1:
        if tile * A <= 1024 and obs_tile_bytes(tile, A, S, K) <= smem_limit:
            return tile
        tile //= 2
    return 0


_smem_limit = {}  # device index -> bytes a block may opt in to


def obs_tile(A, S, K, device):
    """:func:`obs_tile_for` at the shared-memory limit of CUDA ``device``."""
    device = torch.device(device)
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            _smem_limit[idx] = _kernels.library("road_traffic").vmas_rt_max_smem()
    return obs_tile_for(A, S, K, _smem_limit[idx])


def sweep_all(tables, pid, pos, rot, *, lh, wh, S, interval, shift, lanes=None):
    """Run the path sweeps for every (env, agent) lane.

    tables: :func:`build_tables`; pid [B, A] int64; pos [B, A, 2]; rot
    [B, A]. Returns a dict: d_ref, idx_ref, idx_l, idx_r [B, A]; dl5/dr5
    [B, A, 5]; coll_l, coll_r [B, A] bool; short_term [B, A, S, 2]. The
    CUDA kernel for GPU tensors (``lanes`` threads per lane, default
    ``SWEEP_LANES``), the plain version for CPU tensors."""
    kw = dict(lh=lh, wh=wh, S=S, interval=interval, shift=shift)
    lanes = _check_lanes(lanes)
    if pid.device.type == "cpu":
        return sweep_all_plain(tables, pid, pos, rot, **kw)
    B, A = pid.shape
    out = sweep_rows(tables, pid, pos, rot, lanes=lanes, **kw)
    ba = lambda r: out[r].view(B, A)
    return dict(
        d_ref=ba(R_D_REF), idx_ref=ba(R_IDX_REF).long(),
        dl5=out[R_DL:R_DL + 5].view(5, B, A).permute(1, 2, 0),
        dr5=out[R_DR:R_DR + 5].view(5, B, A).permute(1, 2, 0),
        idx_l=ba(R_IDX_L).long(), idx_r=ba(R_IDX_R).long(),
        coll_l=ba(R_COLL_L) > 0.0, coll_r=ba(R_COLL_R) > 0.0,
        short_term=out[R_ST:R_ST + 2 * S].view(2, S, B, A).permute(2, 3, 1, 0),
    )


def sweep_rows(tables, pid, pos, rot, *, lh, wh, S, interval, shift, lanes=None):
    """The sweep kernel's raw output rows [16 + 2S, B*A] (``R_*``) for CUDA
    tensors; :func:`sweep_all` reads its dict from them."""
    global sweep_launches
    lanes = _check_lanes(lanes)
    B, A = pid.shape
    N = B * A
    NP, Mc, _ = tables.center.shape
    Mb = tables.left.shape[1]
    _kernels.check_tensor("pid", pid, torch.int64, (B, A))
    _kernels.check_tensor("pos", pos, torch.float32, (B, A, 2))
    _kernels.check_tensor("rot", rot, torch.float32, (B, A))
    _kernels.check_tensor("center", tables.center, torch.float32, (NP, Mc, 2))
    _kernels.check_tensor("left", tables.left, torch.float32, (NP, Mb, 2))
    _kernels.check_tensor("right", tables.right, torch.float32, (NP, Mb, 2))
    _kernels.check_tensor("meta", tables.meta, torch.int32, (NP, 4))
    if Mc < 2 or Mb < 2:
        raise ValueError("path tables need at least 2 points per polyline")
    out = torch.empty((R_ST + 2 * S, N), dtype=torch.float32, device=pid.device)
    lib = _kernels.library("road_traffic")
    with torch.cuda.device(pid.device):
        err = lib.vmas_rt_sweep(
            tables.center.data_ptr(), tables.left.data_ptr(), tables.right.data_ptr(),
            tables.meta.data_ptr(), NP, Mc, Mb,
            pid.data_ptr(), pos.data_ptr(), rot.data_ptr(), N,
            ctypes.c_float(lh), ctypes.c_float(wh), S, interval, shift, lanes,
            out.data_ptr(), torch.cuda.current_stream(pid.device).cuda_stream,
        )
    _raise_on(lib, err, "road_traffic sweep")
    sweep_launches += 1
    return out


def obs_all(pos, rot, vel, short_term, verts, d_ref, d_left_min, d_right_min,
            *, K, apply_mask, norm_pos, norm_v, norm_dist, thresh, tile=None):
    """All-ego default-config observations.

    pos/vel [B, A, 2]; rot [B, A]; short_term [B, A, S, 2]; verts
    [B, A, V, 2] with V >= 4 (the first 4 corners are used);
    d_ref/d_left_min/d_right_min [B, A]. Returns [A, B, W] with
    W = 1 + 2S + 3 + 11K, noise-free. The CUDA kernel for GPU tensors
    (``tile`` envs per block, default :func:`obs_tile`'s; 0: one thread
    per (env, ego)), the plain version for CPU tensors."""
    global obs_launches
    kw = dict(K=K, apply_mask=apply_mask, norm_pos=norm_pos, norm_v=norm_v,
              norm_dist=norm_dist, thresh=thresh)
    B, A = rot.shape
    _check_tile(tile, A)
    if pos.device.type == "cpu":
        return obs_all_plain(pos, rot, vel, short_term, verts, d_ref, d_left_min, d_right_min, **kw)
    S, V = short_term.shape[2], verts.shape[2]
    if V < 4:
        raise ValueError(f"verts needs at least 4 corners, got {V}")
    if not 0 < K < A:
        raise ValueError(f"K must be in [1, A), got K={K} with A={A}")
    if K > K_MAX_OBS:
        raise ValueError(f"K must be at most {K_MAX_OBS}, got {K}")
    f32 = torch.float32
    _kernels.check_tensor("pos", pos, f32, (B, A, 2))
    _kernels.check_tensor("rot", rot, f32, (B, A))
    _kernels.check_tensor("vel", vel, f32, (B, A, 2))
    _kernels.check_tensor("short_term", short_term, f32, (B, A, S, 2))
    _kernels.check_tensor("verts", verts, f32, (B, A, V, 2))
    for name, t in (("d_ref", d_ref), ("d_left_min", d_left_min), ("d_right_min", d_right_min)):
        _kernels.check_tensor(name, t, f32, (B, A))
    if tile is None:
        tile = obs_tile(A, S, K, pos.device)
    W = 1 + 2 * S + 3 + 11 * K
    out = torch.empty((A, B, W), dtype=f32, device=pos.device)
    lib = _kernels.library("road_traffic")
    with torch.cuda.device(pos.device):
        err = lib.vmas_rt_obs(
            pos.data_ptr(), rot.data_ptr(), vel.data_ptr(), short_term.data_ptr(), verts.data_ptr(),
            d_ref.data_ptr(), d_left_min.data_ptr(), d_right_min.data_ptr(),
            B, A, S, V, K, int(apply_mask),
            ctypes.c_float(norm_pos), ctypes.c_float(norm_v), ctypes.c_float(norm_dist),
            ctypes.c_float(thresh), tile, out.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream,
        )
    _raise_on(lib, err, "road_traffic obs")
    obs_launches += 1
    return out
