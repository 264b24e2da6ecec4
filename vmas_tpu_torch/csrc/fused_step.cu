// The fused physics step of vmas_tpu_torch, by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel generated by vmas_tpu/core/fused.py::_make_kernel
// in both of its launch forms:
//   * fused_physics_step (fused.py, pallas_call in its body): one env step,
//     rows [9E + J + K_in, B] -> [9E + K_out, B];
//   * make_rows_step (fused.py, rows_mode=True): the rows-carried rollout
//     step, carry [R_in, B] + action rows [2A, B] -> carry' + emit [n_out, B].
//
// Design: one thread per env, blocks of 128, grid ceil(B / 128). The row
// buffers keep the JAX layout [R, B], row-major and contiguous over envs:
// thread b reads x[r * B + b], so neighbouring threads read neighbouring
// addresses. The world's structure is data (FusedSpec, passed by value),
// not generated code; each env's state lives in per-thread arrays across
// the substeps. The arithmetic repeats vmas_tpu_torch/core/fused.py's plain
// version op for op, in its order, so it is built with --fmad=false and
// without fast math.
//
// Bound: bytes. transport@4096 moves (55 + 8 + 55 + 47) rows x 4096 x 4 B
// = 2.70 MB per rows step and (55 + 101) rows x 4096 x 4 B = 2.56 MB per
// fused step: about 0.8 us at 3.35 TB/s. The arithmetic is about 1 kFLOP
// per env per step, negligible against the card's rate. But 4096 envs give
// only 32 blocks of 128 threads on 132 SMs, so launch latency and the
// serial per-thread chain, not bandwidth, set this kernel's time; filling
// the card is work for a later change.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_E 32
#define MAX_SS 64
#define MAX_BS 16
#define MAX_A 16
#define MAX_K 8
#define MAX_P 4

enum {
  F_MOVABLE = 1, F_ROTATABLE = 2, F_MAX_F = 4, F_F_RANGE = 8, F_MAX_T = 16,
  F_T_RANGE = 32, F_LIN_FRIC = 64, F_ANG_FRIC = 128, F_GRAVITY = 256,
  F_DRAG = 512, F_MAX_SPEED = 1024, F_V_RANGE = 2048,
};

enum { EMIT_NONE = 0, EMIT_TRANSPORT = 1 };

// Mirrored field for field by vmas_tpu_torch/_kernels.py (ctypes).
struct FusedSpec {
  int E, J, K_in, substeps;
  int n_ss, n_bs, n_act, has_x, has_y;
  float sub_dt, cm, cf, x_semidim, y_semidim;
  int flags[MAX_E];
  float inv_mass[MAX_E], inv_moi[MAX_E], drag_fac[MAX_E];
  float max_f[MAX_E], f_range[MAX_E];
  float max_t[MAX_E], t_range[MAX_E];
  float max_speed[MAX_E], v_range[MAX_E];
  float lfm[MAX_E], mass[MAX_E], afm[MAX_E], moi[MAX_E];
  float gsx[MAX_E], gsy[MAX_E];
  int ss_a[MAX_SS], ss_b[MAX_SS];
  float ss_dmin[MAX_SS];
  int bs_box[MAX_BS], bs_sph[MAX_BS], bs_nh[MAX_BS];
  float bs_hw[MAX_BS], bs_hl[MAX_BS], bs_dmin0[MAX_BS];
  int act_slot[MAX_A];
};

struct EmitParams {
  int carry_idx[MAX_K];  // emit row feeding scratch row k; -1 = unchanged
  int n_agents, n_pkgs, goal;
  int agent[MAX_A];
  int pkg[MAX_P];
  float hw[MAX_P], hl[MAX_P];
  float og_dmin;  // goal radius + LINE_MIN_DIST
  float factor;   // shaping factor
};

// ---------------------------------------------------------------------------
// helpers (fused.py: _norm, _logaddexp0, _constraint_force, ...)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nrm(float x, float y) {
  float sq = x * x + y * y;
  return sq == 0.f ? 0.f : sqrtf(sq);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float logaddexp0(float x) {
  return (x > 0.f ? x : 0.f) + log1pf(expf(-fabsf(x)));
}

// Repulsive penalty force on a (negate for b). The drop conditions keep the
// JAX package's order: too close to have a direction, or out of contact.
__device__ __forceinline__ void constraint_force(float cm, float cf, float ax, float ay,
                                                 float bx, float by, float dmin,
                                                 float& fx, float& fy) {
  float dx = ax - bx, dy = ay - by;
  float dist = nrm(dx, dy);
  float pen = logaddexp0((dmin - dist) / cm) * cm;
  float scale = cf * pen / (dist > 0.f ? dist : 1e-8f);
  fx = dx * scale;
  fy = dy * scale;
  if (dist < 1e-6f || dist > dmin) {
    fx = 0.f;
    fy = 0.f;
  }
}

__device__ __forceinline__ void closest_point_line(float lx, float ly, float c, float s,
                                                   float half, float px, float py,
                                                   float& ox, float& oy) {
  float dot = (lx - px) * c + (ly - py) * s;
  float sg = sgn(dot);
  float dist = fminf(fabsf(dot), half);
  ox = lx - sg * dist * c;
  oy = ly - sg * dist * s;
}

// Closest point on a box's perimeter to (tx, ty): the edges in the order
// +length, -length, +width, -width; the first strict minimum wins.
__device__ __forceinline__ void closest_point_box(float px, float py, float c, float s, float hw, float hl,
                                  float tx, float ty, float& bx, float& by) {
  float wx = -s, wy = c;
  float ex[4] = {px + c * hl, px - c * hl, px + wx * hw, px - wx * hw};
  float ey[4] = {py + s * hl, py - s * hl, py + wy * hw, py - wy * hw};
  float ec[4] = {wx, wx, c, c};
  float es[4] = {wy, wy, s, s};
  float eh[4] = {hw, hw, hl, hl};
  float bd = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cx, cy;
    closest_point_line(ex[k], ey[k], ec[k], es[k], eh[k], tx, ty, cx, cy);
    float d = nrm(cx - tx, cy - ty);
    if (k == 0 || d < bd) {
      bx = cx;
      by = cy;
      bd = d;
    }
  }
}

// geometry.inner_point_box on one lane; the degenerate lane substitutes the
// surface point for the offset (inner = 2 * surface), as the JAX package does.
__device__ __forceinline__ void inner_point_box(float ox, float oy, float sx, float sy,
                                                float bx, float by, float& ix, float& iy,
                                                float& d) {
  float vx = sx - ox, vy = sy - oy;
  float ux = bx - sx, uy = by - sy;
  float vn = nrm(vx, vy);
  float den = vn == 0.f ? 1.f : vn;
  float mag = (vx * ux + vy * uy) / den;
  float xx = vx / den * mag, xy = vy / den * mag;
  bool degenerate = vn == 0.f;
  ix = sx + (degenerate ? sx : xx);
  iy = sy + (degenerate ? sy : xy);
  d = degenerate ? 0.f : fabsf(mag);
}

// ---------------------------------------------------------------------------
// the physics: every substep of one env step (fused.py _physics_rows)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void physics(const FusedSpec& sp, float* px, float* py, float* vx, float* vy,
                        float* rot, float* w, float* fx, float* fy, float* tq) {
  const int E = sp.E;
  const float cm = sp.cm, cf = sp.cf, sub_dt = sp.sub_dt;
  float Fx[MAX_E], Fy[MAX_E], Tq[MAX_E];
  for (int substep = 0; substep < sp.substeps; ++substep) {
    // action clamps, re-applied every substep on the persistent rows
    for (int e = 0; e < E; ++e) {
      const int fl = sp.flags[e];
      if (fl & F_MAX_F) {
        float mf = sp.max_f[e];
        float n = sqrtf(fx[e] * fx[e] + fy[e] * fy[e]);
        if (n > mf) {
          fx[e] = fx[e] / n * mf;
          fy[e] = fy[e] / n * mf;
        }
      }
      if (fl & F_F_RANGE) {
        float fr = sp.f_range[e];
        fx[e] = fminf(fmaxf(fx[e], -fr), fr);
        fy[e] = fminf(fmaxf(fy[e], -fr), fr);
      }
      if (fl & F_MAX_T) tq[e] = fminf(fmaxf(tq[e], -sp.max_t[e]), sp.max_t[e]);
      if (fl & F_T_RANGE) tq[e] = fminf(fmaxf(tq[e], -sp.t_range[e]), sp.t_range[e]);
    }

    // action forces open the accumulators, then friction and gravity
    for (int e = 0; e < E; ++e) {
      const int fl = sp.flags[e];
      Fx[e] = fx[e];
      Fy[e] = fy[e];
      Tq[e] = tq[e];
      if (fl & F_LIN_FRIC) {
        float m = sp.mass[e], lfm = sp.lfm[e];
        float speed = nrm(vx[e], vy[e]);
        bool zero = speed == 0.f;
        float den = zero ? 1.f : speed;
        float fcx = fminf(fabsf(vx[e]) / sub_dt * m, lfm);
        float fcy = fminf(fabsf(vy[e]) / sub_dt * m, lfm);
        Fx[e] = Fx[e] + (zero ? 0.f : -(vx[e] / den) * fcx);
        Fy[e] = Fy[e] + (zero ? 0.f : -(vy[e] / den) * fcy);
      }
      if (fl & F_ANG_FRIC) {
        float moi = sp.moi[e], afm = sp.afm[e];
        float s = fabsf(w[e]);
        float den = s == 0.f ? 1.f : s;
        float fc = fminf(s / sub_dt * moi, afm);
        Tq[e] = Tq[e] + (s == 0.f ? 0.f : -(w[e] / den) * fc);
      }
      if (fl & F_GRAVITY) {
        Fx[e] = Fx[e] + sp.gsx[e];
        Fy[e] = Fy[e] + sp.gsy[e];
      }
    }

    // sphere-sphere pairs, in spec order: +f on a, -f on b
    for (int k = 0; k < sp.n_ss; ++k) {
      int a = sp.ss_a[k], b = sp.ss_b[k];
      float cfx, cfy;
      constraint_force(cm, cf, px[a], py[a], px[b], py[b], sp.ss_dmin[k], cfx, cfy);
      Fx[a] = Fx[a] + cfx;
      Fy[a] = Fy[a] + cfy;
      Fx[b] = Fx[b] + (-cfx);
      Fy[b] = Fy[b] + (-cfy);
    }

    // box-sphere pairs, in spec order: +f on the sphere, -f on the box
    for (int k = 0; k < sp.n_bs; ++k) {
      int b = sp.bs_box[k], s = sp.bs_sph[k];
      float c = cosf(rot[b]), sn = sinf(rot[b]);
      float cx, cy;
      closest_point_box(px[b], py[b], c, sn, sp.bs_hw[k], sp.bs_hl[k], px[s], py[s], cx, cy);
      float ix = cx, iy = cy, dmin = sp.bs_dmin0[k];
      if (sp.bs_nh[k]) {
        float d;
        inner_point_box(px[s], py[s], cx, cy, px[b], py[b], ix, iy, d);
        dmin = dmin + d;
      }
      float sfx, sfy;
      constraint_force(cm, cf, px[s], py[s], ix, iy, dmin, sfx, sfy);
      Fx[s] = Fx[s] + sfx;
      Fy[s] = Fy[s] + sfy;
      Fx[b] = Fx[b] + (-sfx);
      Fy[b] = Fy[b] + (-sfy);
      Tq[b] = Tq[b] + ((cx - px[b]) * (-sfy) - (cy - py[b]) * (-sfx));
    }

    // integrate (semi-implicit Euler; drag on the first substep only).
    // Accumulators of entities that are not movable (rotatable) are never
    // read, so the pair loops above need no masks.
    for (int e = 0; e < E; ++e) {
      const int fl = sp.flags[e];
      const bool drag = substep == 0 && (fl & F_DRAG);
      if (fl & F_MOVABLE) {
        if (drag) {
          vx[e] = vx[e] * sp.drag_fac[e];
          vy[e] = vy[e] * sp.drag_fac[e];
        }
        float inv_m = sp.inv_mass[e];
        vx[e] = vx[e] + Fx[e] * inv_m * sub_dt;
        vy[e] = vy[e] + Fy[e] * inv_m * sub_dt;
        if (fl & F_MAX_SPEED) {
          float ms = sp.max_speed[e];
          float n = sqrtf(vx[e] * vx[e] + vy[e] * vy[e]);
          float sc = n > ms ? ms / n : 1.f;
          vx[e] = vx[e] * sc;
          vy[e] = vy[e] * sc;
        }
        if (fl & F_V_RANGE) {
          float vr = sp.v_range[e];
          vx[e] = fminf(fmaxf(vx[e], -vr), vr);
          vy[e] = fminf(fmaxf(vy[e], -vr), vr);
        }
        px[e] = px[e] + vx[e] * sub_dt;
        py[e] = py[e] + vy[e] * sub_dt;
        if (sp.has_x) px[e] = fminf(fmaxf(px[e], -sp.x_semidim), sp.x_semidim);
        if (sp.has_y) py[e] = fminf(fmaxf(py[e], -sp.y_semidim), sp.y_semidim);
      }
      if (fl & F_ROTATABLE) {
        if (drag) w[e] = w[e] * sp.drag_fac[e];
        w[e] = w[e] + Tq[e] * sp.inv_moi[e] * sub_dt;
        rot[e] = rot[e] + w[e] * sub_dt;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// scenario emits (FusedOutputs.emit realized on the device)
// ---------------------------------------------------------------------------

struct NoEmit {
  __device__ __forceinline__ static void emit(const EmitParams&, const float*, const float*, const float*,
                              const float*, const float*, const float*, float*, int, int) {}
};

// vmas_tpu/scenarios/transport.py TransportOutputs.emit, row for row:
// per agent [px, py, vx, vy, then per package (pkg - goal, pkg - agent,
// pkg vel, on_goal)], then the reward row, the on_goal rows and the new
// shaping rows. n_out = A * (4 + 7P) + 1 + 2P.
struct TransportEmit {
  __device__ __forceinline__ static void emit(const EmitParams& ep, const float* px, const float* py,
                              const float* vx, const float* vy, const float* rot,
                              const float* scratch, float* o, int B, int b) {
    const int A = ep.n_agents, P = ep.n_pkgs;
    const float gx = px[ep.goal], gy = py[ep.goal];
    float og[MAX_P], shaping[MAX_P];
    float rew = 0.f;
    for (int k = 0; k < P; ++k) {
      int pi = ep.pkg[k];
      float dist = nrm(px[pi] - gx, py[pi] - gy);
      float c = cosf(rot[pi]), s = sinf(rot[pi]);
      float cx, cy;
      closest_point_box(px[pi], py[pi], c, s, ep.hw[k], ep.hl[k], gx, gy, cx, cy);
      float d_sphere_closest = nrm(gx - cx, gy - cy);
      float d_closest_box = nrm(px[pi] - cx, py[pi] - cy);
      bool on = (dist < d_closest_box) || (d_sphere_closest < ep.og_dmin);
      shaping[k] = dist * ep.factor;
      float contrib = on ? 0.f : scratch[k] - shaping[k];
      rew = k == 0 ? contrib : rew + contrib;
      og[k] = on ? 1.f : 0.f;
    }
    int r = 0;
    for (int i = 0; i < A; ++i) {
      int ai = ep.agent[i];
      o[(r++) * B + b] = px[ai];
      o[(r++) * B + b] = py[ai];
      o[(r++) * B + b] = vx[ai];
      o[(r++) * B + b] = vy[ai];
      for (int k = 0; k < P; ++k) {
        int pi = ep.pkg[k];
        o[(r++) * B + b] = px[pi] - gx;
        o[(r++) * B + b] = py[pi] - gy;
        o[(r++) * B + b] = px[pi] - px[ai];
        o[(r++) * B + b] = py[pi] - py[ai];
        o[(r++) * B + b] = vx[pi];
        o[(r++) * B + b] = vy[pi];
        o[(r++) * B + b] = og[k];
      }
    }
    o[(r++) * B + b] = rew;
    for (int k = 0; k < P; ++k) o[(r++) * B + b] = og[k];
    for (int k = 0; k < P; ++k) o[(r++) * B + b] = shaping[k];
  }
};

// ---------------------------------------------------------------------------
// the kernel, in both forms
// ---------------------------------------------------------------------------

template <bool ROWS, class Emit>
__global__ void __launch_bounds__(128)
fused_step_kernel(const FusedSpec sp, const EmitParams ep, const float* __restrict__ x,
                  const float* __restrict__ act, float* __restrict__ out,
                  float* __restrict__ extra, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int E = sp.E;
  float px[MAX_E], py[MAX_E], vx[MAX_E], vy[MAX_E], rot[MAX_E], w[MAX_E];
  float fx[MAX_E], fy[MAX_E], tq[MAX_E], scratch[MAX_K];
  for (int e = 0; e < E; ++e) {
    px[e] = x[(0 * E + e) * B + b];
    py[e] = x[(1 * E + e) * B + b];
    vx[e] = x[(2 * E + e) * B + b];
    vy[e] = x[(3 * E + e) * B + b];
    rot[e] = x[(4 * E + e) * B + b];
    w[e] = x[(5 * E + e) * B + b];
    fx[e] = x[(6 * E + e) * B + b];
    fy[e] = x[(7 * E + e) * B + b];
    tq[e] = x[(8 * E + e) * B + b];
  }
  if (ROWS) {
    // this step's decoded actions override the agents' force rows
    // (holonomic process_action: force = u)
    for (int i = 0; i < sp.n_act; ++i) {
      int e = sp.act_slot[i];
      fx[e] = act[i * B + b];
      fy[e] = act[(sp.n_act + i) * B + b];
    }
  }
  for (int k = 0; k < sp.K_in; ++k) scratch[k] = x[(9 * E + sp.J + k) * B + b];

  physics(sp, px, py, vx, vy, rot, w, fx, fy, tq);

  for (int e = 0; e < E; ++e) {
    out[(0 * E + e) * B + b] = px[e];
    out[(1 * E + e) * B + b] = py[e];
    out[(2 * E + e) * B + b] = vx[e];
    out[(3 * E + e) * B + b] = vy[e];
    out[(4 * E + e) * B + b] = rot[e];
    out[(5 * E + e) * B + b] = w[e];
    out[(6 * E + e) * B + b] = fx[e];
    out[(7 * E + e) * B + b] = fy[e];
    out[(8 * E + e) * B + b] = tq[e];
  }
  // the emit rows follow the state rows (fused step) or go to their own
  // buffer (rows step)
  float* emit_rows = ROWS ? extra : out + (size_t)9 * E * B;
  Emit::emit(ep, px, py, vx, vy, rot, scratch, emit_rows, B, b);
  if (ROWS) {
    // joint fixed rotations ride the carry unchanged; the scratch rows
    // carry the emit rows the scenario names (this thread wrote them)
    for (int j = 0; j < sp.J; ++j) out[(9 * E + j) * B + b] = x[(9 * E + j) * B + b];
    for (int k = 0; k < sp.K_in; ++k) {
      int ei = ep.carry_idx[k];
      out[(9 * E + sp.J + k) * B + b] = ei < 0 ? scratch[k] : extra[(size_t)ei * B + b];
    }
  }
}

extern "C" {

// Launch one fused step on `stream`. rows_mode = 0: x [9E + J + K_in, B]
// -> out [9E + K_out, B]. rows_mode = 1: x = carry [R_in, B], act [2A, B]
// -> out = carry' [R_in, B], extra [n_out, B]. Returns cudaGetLastError().
int vmas_fused_step(const FusedSpec* spec, const EmitParams* ep, int emit_kind,
                    const float* x, const float* act, float* out, float* extra, int B,
                    int rows_mode, void* stream) {
  if (B <= 0) return 0;
  dim3 block(128), grid((B + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_mode) {
    if (emit_kind != EMIT_TRANSPORT) return cudaErrorInvalidValue;
    fused_step_kernel<true, TransportEmit><<<grid, block, 0, s>>>(*spec, *ep, x, act, out, extra, B);
  } else if (emit_kind == EMIT_TRANSPORT) {
    fused_step_kernel<false, TransportEmit><<<grid, block, 0, s>>>(*spec, *ep, x, act, out, extra, B);
  } else if (emit_kind == EMIT_NONE) {
    fused_step_kernel<false, NoEmit><<<grid, block, 0, s>>>(*spec, *ep, x, act, out, extra, B);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vmas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
