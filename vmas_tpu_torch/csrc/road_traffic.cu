// road_traffic's two kernels, by hand for Hopper (sm_90a).
//
// rt_sweep_kernel / rt_sweep_group_kernel replace the Pallas kernel of
// vmas_tpu/scenarios/road_traffic_kernel.py::sweep_all (body _make_kernel):
// per (env, agent) lane, the centre-line distance and first-min segment
// index; the CG and the 4 rectangle corners against the left and right
// boundaries (distance each, index of the CG's row); the rectangle-vs-
// boundary straddle flags; the S-point short-term reference path.
//
// rt_obs_kernel / rt_obs_tile_kernel replace the Pallas kernel of
// road_traffic_kernel.py::obs_all (body _make_obs_kernel): per (env, ego),
// the default-config observation row: own speed, short-term path in the ego
// frame, d_ref/d_l/d_r, and the K nearest other agents by a masked minimum
// taken K times (ties to the lowest index), each as 4 vertices in the ego
// frame, relative velocity and distance, masked beyond `thresh`.
//
// The arithmetic repeats the plain versions in
// vmas_tpu_torch/scenarios/road_traffic_kernel.py op for op and in their
// order; it is built with --fmad=false and without fast math, and division
// and sqrt are IEEE, so segment indices, straddle flags and short-term
// points agree bitwise with the plain version on the card.
//
// Path sweeps, two forms (the wrapper's `lanes`):
// * rt_sweep_kernel, L = 1: one thread per lane, blocks of 128; each thread
//   walks its own path in sequence. 32 lanes of a warp sit on up to 32
//   paths of 123-177 segments, so each load is 32 scattered addresses and
//   the warp runs its longest path; 19 warps per SM at 4096 x 20.
// * rt_sweep_group_kernel<L>, built for L = 8 (the group size measured
//   fastest at 4096 x 20 of L = 4, 8, 16, 32: PERF.md; tools/time_rt_kernels.py
//   builds the others as text variants): a group of L threads per lane,
//   128 / L lanes per block of 128. Thread l takes segments l, l + L,
//   l + 2L, ..., so a group's loads are neighbouring float2s of one path.
//   Every result is a minimum or an OR, so the split changes no bit: each
//   thread keeps a running first-min (d, k) with the one-thread form's rule
//   (k == 0 or a strict <), then the group combines them with xor shuffles,
//   taking the other (d, k) where it is smaller, or equal at a lower k, or
//   NaN (only segment 0 can hold a NaN, as in the serial walk); straddle
//   flags OR. Each segment's distance takes the same operations as in the
//   one-thread form. The 4 corners' rows hold no index, so for them each
//   thread keeps the least squared distance and the group takes one root
//   after its reduction: sqrt is correctly rounded, hence monotone, so the
//   root of the least square is the least root (NaN and +inf alike); that
//   drops 8 of the 11 square roots per boundary segment pair. (Skipping the
//   division where the clamp to [0, 1] decides t, which is bitwise too, was
//   slower on the H100: the compares cost more than the division's fast
//   path.) Shuffles come after the segment loops, whose trip counts differ
//   between the groups of a warp, with the full mask: a group beyond N
//   computes on lane N - 1 and stores nothing. The tables are path-major
//   ([NP, M] float2) and read through the read-only cache: map 1's 173 KB
//   stays in L2 and its hot rows in L1 (staging them in shared memory would
//   copy 173 KB into every block).
//   The TPU kernel's one-hot matmul gather and its sweep over every padded
//   row are not needed: a segment at or after n-1 inherits segment n-2's
//   distance, so it never wins a strict `<` minimum, and the zero-length
//   padding segments never straddle; the loops stop at the path's own n-1
//   segments.
//
// Bound: operations. 26 per centre-line segment and 181 per boundary
// segment (the CG's distance with its root, 4 corners' squared distances,
// 4 straddle tests), plus per lane the 8 corners' roots after the
// minimum, about 54 k per lane on map 1, 4.4 G per launch at 4096 x 20:
// 66 us at the H100's 67 TFLOP/s f32, a rate that counts an FMA as two
// operations; built with --fmad=false, adds and multiplies run at half
// that, so ~132 us is this arithmetic's ceiling.
// The bytes (20 B in and 88 B out per lane, 9 MB) take 2.7 us at 3.35 TB/s.
// chip_smoke.py counts both from the run's own paths (rt_sweep_work).
//
// Observations, two forms (the wrapper's `tile`):
// * rt_obs_kernel, tile 0: one thread per (env, ego), blocks of 128. Its
//   row lies at out + (i*B + b)*W, so neighbouring threads (neighbouring
//   egos) store B*W*4 bytes apart; each K round recomputes A - 1 distances.
// * rt_obs_tile_kernel: one block per tile of T envs (T*A threads, rounded
//   up to whole warps; the wrapper takes the largest T of 8, 4, 2, 1 whose
//   block fits 1024 threads and the device's shared memory, and the
//   one-thread form where none does). The block copies the tile's inputs (contiguous
//   ranges of [B, A, ...]) into shared memory, computes each env's A x A
//   distance matrix once per unordered pair (thread i takes j = i + 1 ..
//   i + A/2 around the ring; sqrtf((pj-pi)^2 + ...) equals sqrtf((pi-pj)^2
//   + ...) bitwise, since IEEE subtraction is exactly antisymmetric), then
//   each ego's K rounds scan its staged row with a strict <, marking a
//   chosen agent +inf (the one-thread form skips it; neither ever picks an
//   +inf or NaN distance). Each ego builds its W-float row in shared memory
//   (rows at an odd stride, so a warp's writes miss no bank), and the block
//   writes them out: for ego i the tile's rows are one contiguous run of
//   T*W floats in out[A, B, W], stored as float4s where W % 4 == 0. A
//   ragged last tile masks its missing envs; every thread reaches every
//   barrier. Every value keeps the one-thread form's arithmetic.
//   Bound: bytes (22 floats in and W = 32 out per (env, agent), 17.7 MB at
//   4096 x 20: 5.3 us at 3.35 TB/s; chip_smoke.py's rt_obs_work).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define K_MAX 8  // the largest K of rt_obs_kernel (road_traffic_kernel.K_MAX_OBS)

namespace {

constexpr int kBlock = 128;

// output rows of the sweep kernel, [16 + 2S, N] (road_traffic_kernel.R_*)
enum { R_D_REF = 0, R_IDX_REF = 1, R_DL = 2, R_IDX_L = 7, R_DR = 8, R_IDX_R = 13,
       R_COLL_L = 14, R_COLL_R = 15, R_ST = 16 };

// sqrt(sq) guarded as the plain version's _norm: 0 at 0
__device__ __forceinline__ float root(float sq) {
  return sq == 0.0f ? 0.0f : sqrtf(sq);
}

__device__ __forceinline__ float norm2(float x, float y) {
  return root(x * x + y * y);
}

// torch.clamp(t, 0, 1), NaN passed through
__device__ __forceinline__ float clamp01(float t) {
  return t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
}

// squared distance from (qx, qy) to segment a -> b, with the plain
// version's ll = |v|^2 + 1e-8 and t = clamp(((q - a) . v) / ll, 0, 1)
__device__ __forceinline__ float seg_sq(float sx, float sy, float vx, float vy, float ll,
                                        float qx, float qy) {
  float pvx = qx - sx;
  float pvy = qy - sy;
  float t = clamp01((pvx * vx + pvy * vy) / ll);
  float dx = (sx + vx * t) - qx;
  float dy = (sy + vy * t) - qy;
  return dx * dx + dy * dy;
}

__device__ __forceinline__ float seg_dist(float sx, float sy, float vx, float vy, float ll,
                                          float qx, float qy) {
  return root(seg_sq(sx, sy, vx, vy, ll, qx, qy));
}

// The group's first-min (d, k) over its L threads, every thread left with
// it: the other's where it is smaller, equal at a lower k, or NaN (held
// only by segment 0, which the serial walk keeps).
template <int L>
__device__ __forceinline__ void group_first_min(float& d, int& k) {
  #pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    float d2 = __shfl_xor_sync(0xffffffffu, d, off);
    int k2 = __shfl_xor_sync(0xffffffffu, k, off);
    if (d2 < d || (d2 == d && k2 < k) || d2 != d2) {
      d = d2;
      k = k2;
    }
  }
}

// the group's least value (a squared distance), as group_first_min
// without the index
template <int L>
__device__ __forceinline__ void group_min(float& d) {
  #pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    float d2 = __shfl_xor_sync(0xffffffffu, d, off);
    if (d2 < d || d2 != d2) d = d2;
  }
}

template <int L>
__device__ __forceinline__ bool group_any(bool h) {
  int v = h ? 1 : 0;
  #pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v != 0;
}

// floor-mod, as torch.remainder for n > 0
__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return (r != 0 && r < 0) ? r + n : r;
}

// The segments a polyline with n real points sweeps: 0 .. n-2, and at
// least segment 0 (a one-point path inherits segment 0 everywhere).
__device__ __forceinline__ int n_segments(int n, int M) {
  int s = min(n - 1, M - 1);
  return s < 1 ? 1 : s;
}

// The 5 query points (CG + 4 corners) against one boundary polyline:
// running first-min distance per point and the straddle flag of the
// rectangle's 4 edges. vx/vy hold the closed rectangle's 5 vertices.
__device__ __forceinline__ void boundary_sweep(const float2* __restrict__ poly, int n, int M,
                               const float* qx, const float* qy,
                               const float* vx, const float* vy,
                               float* best, int* bidx, bool* hit) {
  float dx1[4], dy1[4], S1[4], v1a[4];
  float2 a = __ldg(&poly[0]);
  #pragma unroll
  for (int e = 0; e < 4; ++e) {
    dx1[e] = vx[e + 1] - vx[e];
    dy1[e] = vy[e + 1] - vy[e];
    S1[e] = dx1[e] * vy[e] - dy1[e] * vx[e];
    v1a[e] = dx1[e] * a.y - dy1[e] * a.x;
  }
  bool h = false;
  int nseg = n_segments(n, M);
  for (int k = 0; k < nseg; ++k) {
    float2 b = __ldg(&poly[k + 1]);
    float svx = b.x - a.x;
    float svy = b.y - a.y;
    float ll = svx * svx + svy * svy + 1e-8f;
    #pragma unroll
    for (int q = 0; q < 5; ++q) {
      float d = seg_dist(a.x, a.y, svx, svy, ll, qx[q], qy[q]);
      if (k == 0 || d < best[q]) {
        best[q] = d;
        bidx[q] = k;
      }
    }
    // straddle tests of interX_any, strict < 0 on both
    float S2 = svx * a.y - svy * a.x;
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v1b = dx1[e] * b.y - dy1[e] * b.x;
      bool c1 = (v1a[e] - S1[e]) * (v1b - S1[e]) < 0.0f;
      float v2i = vy[e] * svx - vx[e] * svy;
      float v2n = vy[e + 1] * svx - vx[e + 1] * svy;
      bool c2 = (v2i - S2) * (v2n - S2) < 0.0f;
      h = h || (c1 && c2);
      v1a[e] = v1b;
    }
    a = b;
  }
  *hit = h;
}

__global__ void __launch_bounds__(kBlock)
rt_sweep_kernel(const float2* __restrict__ center, const float2* __restrict__ left,
                const float2* __restrict__ right, const int4* __restrict__ meta,
                int NP, int Mc, int Mb,
                const long long* __restrict__ pid, const float* __restrict__ pos,
                const float* __restrict__ rot, int N,
                float lh, float wh, int S, int interval, int shift,
                float* __restrict__ out) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  long long p = pid[n];
  if (p < 0 || p >= NP) {  // an invalid path id gives NaN rows
    for (int r = 0; r < R_ST + 2 * S; ++r) out[(size_t)r * N + n] = NAN;
    return;
  }
  int4 m = __ldg(&meta[p]);  // n_points, n_left, n_right, is_loop
  float px = pos[2 * n], py = pos[2 * n + 1], yaw = rot[n];

  // closed rectangle: cos*bx - sin*by + px, sin*bx + cos*by + py
  float c = cosf(yaw), s = sinf(yaw);
  const float bxs[5] = {lh, lh, -lh, -lh, lh};
  const float bys[5] = {wh, -wh, -wh, wh, wh};
  float vx[5], vy[5];
  #pragma unroll
  for (int k = 0; k < 5; ++k) {
    vx[k] = c * bxs[k] - s * bys[k] + px;
    vy[k] = s * bxs[k] + c * bys[k] + py;
  }

  // centre line: one point
  const float2* cl = center + (size_t)p * Mc;
  float d_ref = 0.0f;
  int i_ref = 0;
  {
    float2 a = __ldg(&cl[0]);
    int nseg = n_segments(m.x, Mc);
    for (int k = 0; k < nseg; ++k) {
      float2 b = __ldg(&cl[k + 1]);
      float svx = b.x - a.x;
      float svy = b.y - a.y;
      float ll = svx * svx + svy * svy + 1e-8f;
      float d = seg_dist(a.x, a.y, svx, svy, ll, px, py);
      if (k == 0 || d < d_ref) {
        d_ref = d;
        i_ref = k;
      }
      a = b;
    }
  }

  // boundaries: CG + 4 corners
  float qx[5] = {px, vx[0], vx[1], vx[2], vx[3]};
  float qy[5] = {py, vy[0], vy[1], vy[2], vy[3]};
  float dl[5], dr[5];
  int il[5], ir[5];
  bool coll_l, coll_r;
  boundary_sweep(left + (size_t)p * Mb, m.y, Mb, qx, qy, vx, vy, dl, il, &coll_l);
  boundary_sweep(right + (size_t)p * Mb, m.z, Mb, qx, qy, vx, vy, dr, ir, &coll_r);

  out[(size_t)R_D_REF * N + n] = d_ref;
  out[(size_t)R_IDX_REF * N + n] = (float)(i_ref + 1);
  #pragma unroll
  for (int q = 0; q < 5; ++q) {
    out[(size_t)(R_DL + q) * N + n] = dl[q];
    out[(size_t)(R_DR + q) * N + n] = dr[q];
  }
  out[(size_t)R_IDX_L * N + n] = (float)(il[0] + 1);
  out[(size_t)R_IDX_R * N + n] = (float)(ir[0] + 1);
  out[(size_t)R_COLL_L * N + n] = coll_l ? 1.0f : 0.0f;
  out[(size_t)R_COLL_R * N + n] = coll_r ? 1.0f : 0.0f;

  // short-term path: S centre-line points from idx_ref + 1
  int npts = m.x;
  for (int j = 0; j < S; ++j) {
    int fut = j * interval + (i_ref + 1) + shift;
    if (m.w != 0 && fut >= npts - 1 && npts > 0) fut = floor_mod(fut + 1, npts);
    if (fut < 0) fut = Mc + fut;
    fut = fut < 0 ? 0 : (fut > Mc - 1 ? Mc - 1 : fut);
    float2 q = __ldg(&cl[fut]);
    out[(size_t)(R_ST + j) * N + n] = q.x;
    out[(size_t)(R_ST + S + j) * N + n] = q.y;
  }
}

// One boundary polyline on a group: thread l's segments l, l + L, ...,
// then the group's reduction. Each segment repeats boundary_sweep's
// operations (its v1a recomputed from the segment's own first point, the
// value boundary_sweep carried over), save that the 4 corners, whose rows
// hold no index, keep the least squared distance and take its root once,
// after the reduction: sqrt is correctly rounded, so monotone, and the
// root of the least square is the least root, NaN and +inf alike.
template <int L>
__device__ __forceinline__ void boundary_sweep_group(const float2* __restrict__ poly, int n, int M, int l,
                                                     const float* qx, const float* qy,
                                                     const float* vx, const float* vy,
                                                     float* best, int* bidx0, bool* hit) {
  float dx1[4], dy1[4], S1[4];
  #pragma unroll
  for (int e = 0; e < 4; ++e) {
    dx1[e] = vx[e + 1] - vx[e];
    dy1[e] = vy[e + 1] - vy[e];
    S1[e] = dx1[e] * vy[e] - dy1[e] * vx[e];
  }
  #pragma unroll
  for (int q = 0; q < 5; ++q) best[q] = INFINITY;  // the CG's distance, the corners' squares
  int bi = INT_MAX;
  bool h = false;
  int nseg = n_segments(n, M);
  for (int k = l; k < nseg; k += L) {
    float2 a = __ldg(&poly[k]);
    float2 b = __ldg(&poly[k + 1]);
    float svx = b.x - a.x;
    float svy = b.y - a.y;
    float ll = svx * svx + svy * svy + 1e-8f;
    float d = seg_dist(a.x, a.y, svx, svy, ll, qx[0], qy[0]);
    if (k == 0 || d < best[0]) {
      best[0] = d;
      bi = k;
    }
    #pragma unroll
    for (int q = 1; q < 5; ++q) {
      float sq = seg_sq(a.x, a.y, svx, svy, ll, qx[q], qy[q]);
      if (k == 0 || sq < best[q]) best[q] = sq;
    }
    float S2 = svx * a.y - svy * a.x;
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v1a = dx1[e] * a.y - dy1[e] * a.x;
      float v1b = dx1[e] * b.y - dy1[e] * b.x;
      bool c1 = (v1a - S1[e]) * (v1b - S1[e]) < 0.0f;
      float v2i = vy[e] * svx - vx[e] * svy;
      float v2n = vy[e + 1] * svx - vx[e + 1] * svy;
      bool c2 = (v2i - S2) * (v2n - S2) < 0.0f;
      h = h || (c1 && c2);
    }
  }
  group_first_min<L>(best[0], bi);
  #pragma unroll
  for (int q = 1; q < 5; ++q) {
    group_min<L>(best[q]);
    best[q] = root(best[q]);
  }
  *bidx0 = bi;
  *hit = group_any<L>(h);
}

template <int L>
__global__ void __launch_bounds__(kBlock)
rt_sweep_group_kernel(const float2* __restrict__ center, const float2* __restrict__ left,
                      const float2* __restrict__ right, const int4* __restrict__ meta,
                      int NP, int Mc, int Mb,
                      const long long* __restrict__ pid, const float* __restrict__ pos,
                      const float* __restrict__ rot, int N,
                      float lh, float wh, int S, int interval, int shift,
                      float* __restrict__ out) {
  constexpr int G = kBlock / L;
  const int l = threadIdx.x % L;
  const int n_grp = blockIdx.x * G + threadIdx.x / L;
  const bool live = n_grp < N;  // a group beyond N computes on lane N - 1 and stores nothing
  const int n = live ? n_grp : N - 1;
  long long p = pid[n];
  const bool valid = p >= 0 && p < NP;  // an invalid path id gives NaN rows
  if (!valid) p = 0;
  int4 m = __ldg(&meta[p]);  // n_points, n_left, n_right, is_loop
  float px = pos[2 * n], py = pos[2 * n + 1], yaw = rot[n];

  float c = cosf(yaw), s = sinf(yaw);
  const float bxs[5] = {lh, lh, -lh, -lh, lh};
  const float bys[5] = {wh, -wh, -wh, wh, wh};
  float vx[5], vy[5];
  #pragma unroll
  for (int k = 0; k < 5; ++k) {
    vx[k] = c * bxs[k] - s * bys[k] + px;
    vy[k] = s * bxs[k] + c * bys[k] + py;
  }

  // centre line: one point
  const float2* cl = center + (size_t)p * Mc;
  float d_ref = INFINITY;
  int i_ref = INT_MAX;
  {
    int nseg = n_segments(m.x, Mc);
    for (int k = l; k < nseg; k += L) {
      float2 a = __ldg(&cl[k]);
      float2 b = __ldg(&cl[k + 1]);
      float svx = b.x - a.x;
      float svy = b.y - a.y;
      float ll = svx * svx + svy * svy + 1e-8f;
      float d = seg_dist(a.x, a.y, svx, svy, ll, px, py);
      if (k == 0 || d < d_ref) {
        d_ref = d;
        i_ref = k;
      }
    }
  }
  group_first_min<L>(d_ref, i_ref);

  // boundaries: CG + 4 corners
  float qx[5] = {px, vx[0], vx[1], vx[2], vx[3]};
  float qy[5] = {py, vy[0], vy[1], vy[2], vy[3]};
  float dl[5], dr[5];
  int il, ir;
  bool coll_l, coll_r;
  boundary_sweep_group<L>(left + (size_t)p * Mb, m.y, Mb, l, qx, qy, vx, vy, dl, &il, &coll_l);
  boundary_sweep_group<L>(right + (size_t)p * Mb, m.z, Mb, l, qx, qy, vx, vy, dr, &ir, &coll_r);
  if (!live) return;  // after the last shuffle

  // every thread of the group holds every result: row r goes from thread r % L
  auto put = [&](int r, float v) {
    if (r % L == l) out[(size_t)r * N + n] = valid ? v : NAN;
  };
  put(R_D_REF, d_ref);
  put(R_IDX_REF, (float)(i_ref + 1));
  #pragma unroll
  for (int q = 0; q < 5; ++q) {
    put(R_DL + q, dl[q]);
    put(R_DR + q, dr[q]);
  }
  put(R_IDX_L, (float)(il + 1));
  put(R_IDX_R, (float)(ir + 1));
  put(R_COLL_L, coll_l ? 1.0f : 0.0f);
  put(R_COLL_R, coll_r ? 1.0f : 0.0f);

  // short-term path: S centre-line points from idx_ref + 1, point j on thread j % L
  int npts = m.x;
  for (int j = l; j < S; j += L) {
    float2 q = make_float2(NAN, NAN);
    if (valid) {
      int fut = j * interval + (i_ref + 1) + shift;
      if (m.w != 0 && fut >= npts - 1 && npts > 0) fut = floor_mod(fut + 1, npts);
      if (fut < 0) fut = Mc + fut;
      fut = fut < 0 ? 0 : (fut > Mc - 1 ? Mc - 1 : fut);
      q = __ldg(&cl[fut]);
    }
    out[(size_t)(R_ST + j) * N + n] = q.x;
    out[(size_t)(R_ST + S + j) * N + n] = q.y;
  }
}

__global__ void __launch_bounds__(kBlock)
rt_obs_kernel(const float* __restrict__ pos, const float* __restrict__ rot,
              const float* __restrict__ vel, const float* __restrict__ st,
              const float* __restrict__ verts, const float* __restrict__ d_ref,
              const float* __restrict__ d_l, const float* __restrict__ d_r,
              int B, int A, int S, int V, int K, int apply_mask,
              float norm_pos, float norm_v, float norm_dist, float thresh,
              float* __restrict__ out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * A) return;
  int b = t / A, i = t % A;
  int base = b * A;
  int W = 1 + 2 * S + 3 + 11 * K;
  float* o = out + ((size_t)i * B + b) * W;

  float pxi = pos[2 * (base + i)], pyi = pos[2 * (base + i) + 1];
  float roti = rot[base + i];
  float ci = cosf(roti), si = sinf(roti);

  // self rows
  o[0] = norm2(vel[2 * (base + i)], vel[2 * (base + i) + 1]) / norm_v;
  for (int s = 0; s < S; ++s) {
    const float* q = st + ((size_t)(base + i) * S + s) * 2;
    float dx = q[0] - pxi, dy = q[1] - pyi;
    o[1 + 2 * s] = (dx * ci + dy * si) / norm_pos;
    o[2 + 2 * s] = (dy * ci - dx * si) / norm_pos;
  }
  int w = 1 + 2 * S;
  o[w] = d_ref[base + i] / norm_dist;
  o[w + 1] = d_l[base + i] / norm_dist;
  o[w + 2] = d_r[base + i] / norm_dist;
  w += 3;

  // K nearest others: a strict-< running minimum over the not yet chosen
  // agents keeps the lowest index among equal distances
  int chosen[K_MAX];
  for (int k = 0; k < K; ++k) {
    float mdist = INFINITY;
    int idx = -1;
    for (int j = 0; j < A; ++j) {
      bool skip = j == i;
      for (int c = 0; c < k; ++c) skip = skip || chosen[c] == j;
      if (skip) continue;
      float ddx = pos[2 * (base + j)] - pxi;
      float ddy = pos[2 * (base + j) + 1] - pyi;
      float d = sqrtf(ddx * ddx + ddy * ddy + 1e-12f);
      if (d < mdist) {
        mdist = d;
        idx = j;
      }
    }
    chosen[k] = idx;
    if (idx < 0) {  // no finite distance: NaN rows
      for (int r = 0; r < 11; ++r) o[w + r] = NAN;
      w += 11;
      continue;
    }
    bool far = apply_mask && mdist >= thresh;
    for (int c = 0; c < 4; ++c) {
      const float* q = verts + ((size_t)(base + idx) * V + c) * 2;
      float dx = q[0] - pxi, dy = q[1] - pyi;
      o[w] = far ? 1.0f : (dx * ci + dy * si) / norm_pos;
      o[w + 1] = far ? 1.0f : (dy * ci - dx * si) / norm_pos;
      w += 2;
    }
    float vel_abs = norm2(vel[2 * (base + idx)], vel[2 * (base + idx) + 1]);
    float rot_rel = rot[base + idx] - roti;
    o[w] = far ? 0.0f : vel_abs * cosf(rot_rel) / norm_v;
    o[w + 1] = far ? 0.0f : vel_abs * sinf(rot_rel) / norm_v;
    o[w + 2] = far ? 1.0f : mdist / norm_dist;
    w += 3;
  }
}

// The tile form's shared memory in floats, for T envs of A agents: pos 2,
// rot 1, vel 2, short-term 2S, 4 corners 8 and 3 distances per agent; each
// agent's row of the distance matrix at stride A | 1 and its output row at
// stride W | 1 (odd strides: a warp's threads, one row each, hit distinct
// banks). road_traffic_kernel.obs_tile_bytes repeats it to choose the tile.
__host__ __device__ inline size_t obs_tile_floats(int T, int A, int S, int W) {
  return (size_t)T * A * ((16 + 2 * S) + (A | 1) + (W | 1));
}

__global__ void __launch_bounds__(1024)
rt_obs_tile_kernel(const float* __restrict__ pos, const float* __restrict__ rot,
                   const float* __restrict__ vel, const float* __restrict__ st,
                   const float* __restrict__ verts, const float* __restrict__ d_ref,
                   const float* __restrict__ d_l, const float* __restrict__ d_r,
                   int B, int A, int S, int V, int K, int apply_mask,
                   float norm_pos, float norm_v, float norm_dist, float thresh, int T,
                   float* __restrict__ out) {
  extern __shared__ float sm[];
  const int W = 1 + 2 * S + 3 + 11 * K;
  const int Ap = A | 1, Wp = W | 1;
  const int TA = T * A;
  float* s_pos = sm;                 // [TA, 2]
  float* s_rot = s_pos + 2 * TA;     // [TA]
  float* s_vel = s_rot + TA;         // [TA, 2]
  float* s_st = s_vel + 2 * TA;      // [TA, S, 2]
  float* s_vt = s_st + 2 * S * TA;   // [TA, 4, 2]
  float* s_d3 = s_vt + 8 * TA;       // [3, TA]
  float* s_dm = s_d3 + 3 * TA;       // [TA, Ap]
  float* s_out = s_dm + (size_t)TA * Ap;  // [TA, Wp]

  const int b0 = blockIdx.x * T;
  const int Eb = min(T, B - b0);  // envs of this tile (the last one may be ragged)
  const int n_ag = Eb * A;
  const size_t g0 = (size_t)b0 * A;  // the tile's first agent in [B, A]
  const int tid = threadIdx.x, nt = blockDim.x;

  // stage the tile's inputs: contiguous runs of [B, A, ...]
  for (int x = tid; x < 2 * n_ag; x += nt) {
    s_pos[x] = pos[2 * g0 + x];
    s_vel[x] = vel[2 * g0 + x];
  }
  for (int x = tid; x < n_ag; x += nt) {
    s_rot[x] = rot[g0 + x];
    s_d3[x] = d_ref[g0 + x];
    s_d3[TA + x] = d_l[g0 + x];
    s_d3[2 * TA + x] = d_r[g0 + x];
  }
  for (int x = tid; x < 2 * S * n_ag; x += nt) s_st[x] = st[2 * S * g0 + x];
  for (int x = tid; x < 8 * n_ag; x += nt) s_vt[x] = verts[(g0 + x / 8) * 2 * V + x % 8];
  __syncthreads();

  // each env's distance matrix, once per unordered pair: thread i takes
  // j = i + m (mod A) for m = 1 .. A/2, the opposite pair (m = A/2, A even)
  // from the lower index only
  const int e = tid / A, i = tid % A;
  const bool act = tid < n_ag;
  const int ag = e * A + i;  // this thread's agent in the tile
  if (act) {
    float pxi = s_pos[2 * ag], pyi = s_pos[2 * ag + 1];
    s_dm[(size_t)ag * Ap + i] = INFINITY;
    for (int m = 1; 2 * m <= A; ++m) {
      if (2 * m == A && i >= m) break;
      int j = i + m < A ? i + m : i + m - A;
      int aj = e * A + j;
      float ddx = s_pos[2 * aj] - pxi;
      float ddy = s_pos[2 * aj + 1] - pyi;
      float d = sqrtf(ddx * ddx + ddy * ddy + 1e-12f);
      s_dm[(size_t)ag * Ap + j] = d;
      s_dm[(size_t)aj * Ap + i] = d;
    }
  }
  __syncthreads();

  if (act) {
    float pxi = s_pos[2 * ag], pyi = s_pos[2 * ag + 1];
    float roti = s_rot[ag];
    float ci = cosf(roti), si = sinf(roti);
    float* o = s_out + (size_t)ag * Wp;
    float* row = s_dm + (size_t)ag * Ap;

    // self rows
    o[0] = norm2(s_vel[2 * ag], s_vel[2 * ag + 1]) / norm_v;
    for (int q = 0; q < S; ++q) {
      const float* sp = s_st + ((size_t)ag * S + q) * 2;
      float dx = sp[0] - pxi, dy = sp[1] - pyi;
      o[1 + 2 * q] = (dx * ci + dy * si) / norm_pos;
      o[2 + 2 * q] = (dy * ci - dx * si) / norm_pos;
    }
    int w = 1 + 2 * S;
    o[w] = s_d3[ag] / norm_dist;
    o[w + 1] = s_d3[TA + ag] / norm_dist;
    o[w + 2] = s_d3[2 * TA + ag] / norm_dist;
    w += 3;

    // K nearest others: a strict-< scan of the row, a chosen agent marked
    // +inf (ties to the lowest index)
    for (int k = 0; k < K; ++k) {
      float mdist = INFINITY;
      int idx = -1;
      for (int j = 0; j < A; ++j) {
        float d = row[j];
        if (d < mdist) {
          mdist = d;
          idx = j;
        }
      }
      if (idx < 0) {  // no finite distance: NaN rows
        for (int r = 0; r < 11; ++r) o[w + r] = NAN;
        w += 11;
        continue;
      }
      row[idx] = INFINITY;
      int aj = e * A + idx;
      bool far = apply_mask && mdist >= thresh;
      for (int c = 0; c < 4; ++c) {
        const float* q = s_vt + ((size_t)aj * 4 + c) * 2;
        float dx = q[0] - pxi, dy = q[1] - pyi;
        o[w] = far ? 1.0f : (dx * ci + dy * si) / norm_pos;
        o[w + 1] = far ? 1.0f : (dy * ci - dx * si) / norm_pos;
        w += 2;
      }
      float vel_abs = norm2(s_vel[2 * aj], s_vel[2 * aj + 1]);
      float rot_rel = s_rot[aj] - roti;
      o[w] = far ? 0.0f : vel_abs * cosf(rot_rel) / norm_v;
      o[w + 1] = far ? 0.0f : vel_abs * sinf(rot_rel) / norm_v;
      o[w + 2] = far ? 1.0f : mdist / norm_dist;
      w += 3;
    }
  }
  __syncthreads();

  // ego i's rows of the tile are one run of Eb*W floats at out + (i*B + b0)*W
  const int run = Eb * W;
  if ((W & 3) == 0) {
    const int run4 = run / 4;
    for (int x = tid; x < A * run4; x += nt) {
      int ie = x / run4, r = 4 * (x - ie * run4);
      int ee = r / W, ww = r - ee * W;
      const float* src = s_out + (size_t)(ee * A + ie) * Wp + ww;
      reinterpret_cast<float4*>(out + ((size_t)ie * B + b0) * W)[r / 4] =
          make_float4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int x = tid; x < A * run; x += nt) {
      int ie = x / run, r = x - ie * run;
      int ee = r / W, ww = r - ee * W;
      out[((size_t)ie * B + b0) * W + r] = s_out[(size_t)(ee * A + ie) * Wp + ww];
    }
  }
}

template <int L>
int launch_group(const float* center, const float* left, const float* right, const int* meta, int NP, int Mc,
                 int Mb, const long long* pid, const float* pos, const float* rot, int N, float lh, float wh, int S,
                 int interval, int shift, float* out, cudaStream_t s) {
  constexpr int G = kBlock / L;
  rt_sweep_group_kernel<L><<<(N + G - 1) / G, kBlock, 0, s>>>(
      reinterpret_cast<const float2*>(center), reinterpret_cast<const float2*>(left),
      reinterpret_cast<const float2*>(right), reinterpret_cast<const int4*>(meta),
      NP, Mc, Mb, pid, pos, rot, N, lh, wh, S, interval, shift, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Path sweeps for N = B*A lanes on `stream`: tables center [NP, Mc, 2],
// left/right [NP, Mb, 2] f32, meta [NP, 4] int32; pid [N] int64, pos
// [N, 2], rot [N] f32 -> out [16 + 2S, N] f32; `lanes` threads per lane
// (1: rt_sweep_kernel; 8: rt_sweep_group_kernel). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another lane count.
int vmas_rt_sweep(const float* center, const float* left, const float* right, const int* meta,
                  int NP, int Mc, int Mb, const long long* pid, const float* pos, const float* rot,
                  int N, float lh, float wh, int S, int interval, int shift, int lanes, float* out,
                  void* stream) {
  if (N <= 0) return 0;
  if (Mc < 2 || Mb < 2 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 1) {
    int grid = (N + kBlock - 1) / kBlock;
    rt_sweep_kernel<<<grid, kBlock, 0, st>>>(
        reinterpret_cast<const float2*>(center), reinterpret_cast<const float2*>(left),
        reinterpret_cast<const float2*>(right), reinterpret_cast<const int4*>(meta),
        NP, Mc, Mb, pid, pos, rot, N, lh, wh, S, interval, shift, out);
    return static_cast<int>(cudaGetLastError());
  }
#define GROUP(L) launch_group<L>(center, left, right, meta, NP, Mc, Mb, pid, pos, rot, N, lh, wh, S, interval, \
                                 shift, out, st)
  if (lanes == 8) return GROUP(8);
#undef GROUP
  return static_cast<int>(cudaErrorInvalidValue);
}

// All-ego observations on `stream`: pos/vel [B, A, 2], rot [B, A],
// st [B, A, S, 2], verts [B, A, V, 2] (first 4 used), d_ref/d_l/d_r [B, A]
// -> out [A, B, 1 + 2S + 3 + 11K] f32; `tile` envs per block
// (rt_obs_tile_kernel), or 0: one thread per (env, ego) (rt_obs_kernel).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a tile of more
// than 1024 threads or more shared memory than the device gives a block.
int vmas_rt_obs(const float* pos, const float* rot, const float* vel, const float* st,
                const float* verts, const float* d_ref, const float* d_l, const float* d_r,
                int B, int A, int S, int V, int K, int apply_mask,
                float norm_pos, float norm_v, float norm_dist, float thresh, int tile, float* out,
                void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (K < 1 || K > K_MAX || K >= A || V < 4 || tile < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    int grid = (B * A + kBlock - 1) / kBlock;
    rt_obs_kernel<<<grid, kBlock, 0, s>>>(
        pos, rot, vel, st, verts, d_ref, d_l, d_r, B, A, S, V, K, apply_mask,
        norm_pos, norm_v, norm_dist, thresh, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = (tile * A + 31) / 32 * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = obs_tile_floats(tile, A, S, 1 + 2 * S + 3 + 11 * K) * sizeof(float);
  // above 48 KB a block's dynamic shared memory needs the kernel's opt-in,
  // set to the largest size asked so far
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(rt_obs_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  rt_obs_tile_kernel<<<(B + tile - 1) / tile, threads, smem, s>>>(
      pos, rot, vel, st, verts, d_ref, d_l, d_r, B, A, S, V, K, apply_mask,
      norm_pos, norm_v, norm_dist, thresh, tile, out);
  return static_cast<int>(cudaGetLastError());
}

// The largest dynamic shared memory a block may opt in to on the current
// device, in bytes (the observation tile's limit).
int vmas_rt_max_smem() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return limit;
}

const char* vmas_rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
