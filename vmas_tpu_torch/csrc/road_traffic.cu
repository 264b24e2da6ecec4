// road_traffic's two kernels, by hand for Hopper (sm_90a).
//
// rt_sweep_kernel replaces the Pallas kernel of
// vmas_tpu/scenarios/road_traffic_kernel.py::sweep_all (body _make_kernel):
// per (env, agent) lane, the centre-line distance and first-min segment
// index; the CG and the 4 rectangle corners against the left and right
// boundaries (distance each, index of the CG's row); the rectangle-vs-
// boundary straddle flags; the S-point short-term reference path.
//
// rt_obs_kernel replaces the Pallas kernel of road_traffic_kernel.py::obs_all
// (body _make_obs_kernel): per (env, ego), the default-config observation
// row: own speed, short-term path in the ego frame, d_ref/d_l/d_r, and the
// K nearest other agents by a masked minimum taken K times (ties to the
// lowest index), each as 4 vertices in the ego frame, relative velocity
// and distance, masked beyond `thresh`.
//
// The arithmetic repeats the plain versions in
// vmas_tpu_torch/scenarios/road_traffic_kernel.py op for op and in their
// order; it is built with --fmad=false and without fast math, and division
// and sqrt are IEEE, so segment indices, straddle flags and short-term
// points agree bitwise with the plain version on the card.
//
// rt_sweep_kernel design: one thread per lane, blocks of 128 (4096 envs x
// 20 agents = 81,920 lanes = 640 blocks). Each thread walks its own path in
// sequence: the tables are path-major ([NP, M] float2), read through the
// read-only data cache with __ldg. The whole table (map 1: 40 paths,
// [2x185 + 4x177] floats each, 173 KB) stays in the 50 MB L2 and its hot
// rows in each SM's L1; staging it in shared memory instead would copy
// 173 KB into every block (110 MB of L2 traffic per launch at 640 blocks)
// and allow one block per SM. The TPU kernel's one-hot matmul gather and
// its sweep over every padded row are not needed: a segment at or after
// n-1 inherits segment n-2's distance, so it never wins a strict `<`
// running minimum, and the zero-length padding segments never straddle;
// the loops stop at the path's own n-1 segments.
//
// Bound: operations. 26 per centre-line segment and 185 per boundary
// segment (5 points plus 4 straddle tests), about 55 k per lane on map 1,
// 4.5 G per launch at 4096 x 20: 68 us at the H100's 67 TFLOP/s f32. The
// bytes (20 B in and 88 B out per lane, 9 MB) take 2.7 us at 3.35 TB/s.
// chip_smoke.py counts both from the run's own paths (rt_sweep_work).
//
// rt_obs_kernel design: one thread per (env, ego), blocks of 128; the
// threads of one env are neighbours and read the same env's rows. Bound:
// bytes (22 floats in and W = 32 out per (env, agent), 17.7 MB at
// 4096 x 20: 5.3 us at 3.35 TB/s; chip_smoke.py's rt_obs_work).

#include <cuda_runtime.h>
#include <math.h>

#define K_MAX 8  // the largest K of rt_obs_kernel (road_traffic_kernel.K_MAX_OBS)

namespace {

constexpr int kBlock = 128;

// output rows of the sweep kernel, [16 + 2S, N] (road_traffic_kernel.R_*)
enum { R_D_REF = 0, R_IDX_REF = 1, R_DL = 2, R_IDX_L = 7, R_DR = 8, R_IDX_R = 13,
       R_COLL_L = 14, R_COLL_R = 15, R_ST = 16 };

__device__ __forceinline__ float norm2(float x, float y) {
  float sq = x * x + y * y;
  return sq == 0.0f ? 0.0f : sqrtf(sq);
}

// torch.clamp(t, 0, 1), NaN passed through
__device__ __forceinline__ float clamp01(float t) {
  return t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
}

// distance from (qx, qy) to segment a -> b, with the plain version's
// ll = |v|^2 + 1e-8 and t = clamp(((q - a) . v) / ll, 0, 1)
__device__ __forceinline__ float seg_dist(float sx, float sy, float vx, float vy, float ll,
                                          float qx, float qy) {
  float pvx = qx - sx;
  float pvy = qy - sy;
  float t = clamp01((pvx * vx + pvy * vy) / ll);
  float dx = (sx + vx * t) - qx;
  float dy = (sy + vy * t) - qy;
  return norm2(dx, dy);
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

}  // namespace

extern "C" {

// Path sweeps for N = B*A lanes on `stream`: tables center [NP, Mc, 2],
// left/right [NP, Mb, 2] f32, meta [NP, 4] int32; pid [N] int64, pos
// [N, 2], rot [N] f32 -> out [16 + 2S, N] f32. Returns cudaGetLastError().
int vmas_rt_sweep(const float* center, const float* left, const float* right, const int* meta,
                  int NP, int Mc, int Mb, const long long* pid, const float* pos, const float* rot,
                  int N, float lh, float wh, int S, int interval, int shift, float* out,
                  void* stream) {
  if (N <= 0) return 0;
  if (Mc < 2 || Mb < 2 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = (N + kBlock - 1) / kBlock;
  rt_sweep_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(center), reinterpret_cast<const float2*>(left),
      reinterpret_cast<const float2*>(right), reinterpret_cast<const int4*>(meta),
      NP, Mc, Mb, pid, pos, rot, N, lh, wh, S, interval, shift, out);
  return static_cast<int>(cudaGetLastError());
}

// All-ego observations on `stream`: pos/vel [B, A, 2], rot [B, A],
// st [B, A, S, 2], verts [B, A, V, 2] (first 4 used), d_ref/d_l/d_r [B, A]
// -> out [A, B, 1 + 2S + 3 + 11K] f32. Returns cudaGetLastError().
int vmas_rt_obs(const float* pos, const float* rot, const float* vel, const float* st,
                const float* verts, const float* d_ref, const float* d_l, const float* d_r,
                int B, int A, int S, int V, int K, int apply_mask,
                float norm_pos, float norm_v, float norm_dist, float thresh, float* out,
                void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (K < 1 || K > K_MAX || K >= A || V < 4) return static_cast<int>(cudaErrorInvalidValue);
  int grid = (B * A + kBlock - 1) / kBlock;
  rt_obs_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, rot, vel, st, verts, d_ref, d_l, d_r, B, A, S, V, K, apply_mask,
      norm_pos, norm_v, norm_dist, thresh, out);
  return static_cast<int>(cudaGetLastError());
}

const char* vmas_rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
