// The op-cost probe, by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel of tests/golden/time_mosaic_opcost.py::make_kernel
// (its pallas_call in build()), at its (1, B) row shape: R rows [R, B] in;
// a chain of n_ops dependent elementwise operations into row 0, operation i
// reading row (i + 1) % R as its operand; row 0 out as the chain's result,
// rows 1 .. R-1 copied out. Two chains, as the JAX probe's:
//   ALU (trans = 0), by i % 3: acc * r + 0.5; where(acc > r, acc - r, acc);
//       max(acc, r * 0.25);
//   transcendental (trans = 1), by i % 4: sqrt(acc * acc + r * r);
//       acc / (|r| + 1.5); exp(-|acc|) + r; log1p(|acc|) + r * 0.25.
// One operation per i, as the JAX probe counts them.
//
// What it measures: the cost per operation of one thread's serial dependent
// chain, under the flags of the fused physics kernel (csrc/fused_step.cu:
// -O3, --fmad=false, IEEE division and square root), whose threads are such
// chains over per-thread arrays. So the design is that kernel's: one thread
// per env column b, blocks of `block` threads (a run-time argument, so a
// sweep can ask whether 4096 envs in 32 blocks of 128 leave the card idle),
// the R rows read once into a per-thread array and indexed by a run-time
// row number, as the fused kernel indexes its entity arrays. n_ops and trans
// are run-time arguments and the chain depends on the input data, so the
// compiler can neither fold it nor move it out of a launch.
//
// Bound: bytes, 2 x R x B x 4 B (1.77 MB, 0.53 us at 3.35 TB/s for R = 54,
// B = 4096), or operations, n_ops x B over the card's f32 rate; at 4096
// envs the serial chain of each thread, not either bound, sets the time.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_R 64

__global__ void opcost_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int B, int n_ops,
                              int trans) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float rows[MAX_R];
  for (int k = 0; k < R; ++k) rows[k] = x[(size_t)k * B + b];
  float acc = rows[0];
  // j = (i + 1) % R, carried from operation to operation; the loops step
  // by the chain's period, so each operation's kind is fixed at compile
  // time and only the chain itself is data dependent
  int j = R > 1 ? 1 : 0;
  float r;
  // the operand of the next operation: row j, then j moves on
#define NEXT_ROW        \
  r = rows[j];          \
  j = j + 1 == R ? 0 : j + 1;
  int i = 0;
  if (trans) {
    for (; i + 4 <= n_ops; i += 4) {
      NEXT_ROW acc = sqrtf(acc * acc + r * r);
      NEXT_ROW acc = acc / (fabsf(r) + 1.5f);
      NEXT_ROW acc = expf(-fabsf(acc)) + r;
      NEXT_ROW acc = log1pf(fabsf(acc)) + r * 0.25f;
    }
    if (i < n_ops) { NEXT_ROW acc = sqrtf(acc * acc + r * r); }
    if (i + 1 < n_ops) { NEXT_ROW acc = acc / (fabsf(r) + 1.5f); }
    if (i + 2 < n_ops) { NEXT_ROW acc = expf(-fabsf(acc)) + r; }
  } else {
    for (; i + 3 <= n_ops; i += 3) {
      NEXT_ROW acc = acc * r + 0.5f;
      NEXT_ROW acc = acc > r ? acc - r : acc;
      NEXT_ROW acc = fmaxf(acc, r * 0.25f);
    }
    if (i < n_ops) { NEXT_ROW acc = acc * r + 0.5f; }
    if (i + 1 < n_ops) { NEXT_ROW acc = acc > r ? acc - r : acc; }
  }
#undef NEXT_ROW
  out[b] = acc;
  for (int k = 1; k < R; ++k) out[(size_t)k * B + b] = rows[k];
}

extern "C" {

// Launch the probe on `stream`: x [R, B] -> out [R, B], ceil(B / block)
// blocks of `block` threads. R outside 1 .. MAX_R, a negative n_ops or a
// block that is not a multiple of 32 in 32 .. 1024 returns
// cudaErrorInvalidValue; else cudaGetLastError().
int vmas_opcost(const float* x, float* out, int R, int B, int n_ops, int trans, int block, void* stream) {
  if (R < 1 || R > MAX_R || n_ops < 0 || block < 32 || block > 1024 || block % 32) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  opcost_kernel<<<(B + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(x, out, R, B, n_ops,
                                                                                           trans);
  return static_cast<int>(cudaGetLastError());
}

const char* vmas_opcost_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
