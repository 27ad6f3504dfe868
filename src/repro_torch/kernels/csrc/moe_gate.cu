// MoE router gate for Hopper (sm_90a): softmax over E experts, then the top
// k by k rounds of max-extract, optionally renormalised over the picks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gate.py:54
// (moe_gate_topk, body _gate_kernel :28) and follows that body's order of
// operations for one token row x (E float32 logits):
//
//   m     = max_e x_e
//   denom = sum_e exp(x_e - m)                        (over ALL experts)
//   k rounds: top = max of the working row, arg = its lowest index among
//             equals; the pick is set to -1e30 in the working row
//   p_r   = exp(top_r - m) / denom;  renorm: p_r /= sum_r p_r
//
// Output: probs (T, k) float32, ids (T, k) int32, picks in round order
// (descending logit, ties to the lowest expert id).
//
// Bound on this card: bytes. One call reads T*E*4 bytes and writes
// T*k*8; its arithmetic (E exps and ~k*E compares per row) is far below the
// memory line at any T, and at the main path's shapes (T = 8192 or a few
// decode slots, E = 64) the bound is a microsecond or less, so one launch's
// fixed cost dominates. Design: one warp per row, 8 rows (warps) per
// 256-thread block. Lane l holds experts l, l + 32, ... in registers (EPL
// per lane, a template parameter: 1, 2, 4 or 8, so E <= 256; the loads of a
// warp are coalesced), the max and the sum are butterfly shuffles, and each
// round's argmax is a (value desc, index asc) butterfly, after which every
// lane knows the pick and its owner masks it. expf, not __expf, and no
// fast-math, so the probabilities stay within float32 rounding of the plain
// version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rows per block
constexpr float kNeg = -1e30f;     // the reference's NEG

template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
moe_gate_kernel(const float* __restrict__ logits, float* __restrict__ probs,
                int32_t* __restrict__ ids, long long rows, int e, int k,
                int renorm) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warps leave together
  const float* x = logits + row * e;

  float v[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int col = j * 32 + lane;
    v[j] = col < e ? x[col] : -CUDART_INF_F;   // padding: never a max or pick
  }

  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < EPL; ++j) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float z = 0.0f;
#pragma unroll
  for (int j = 0; j < EPL; ++j)
    if (j * 32 + lane < e) z += expf(v[j] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    z += __shfl_xor_sync(0xffffffffu, z, off);
  const float denom = z;

  float* out_p = probs + row * k;
  int32_t* out_i = ids + row * k;
  float picked = 0.0f;
  for (int r = 0; r < k; ++r) {
    // this lane's best: its experts in increasing id, strict > keeps the
    // lowest id among equals
    float best = v[0];
    int arg = lane;
#pragma unroll
    for (int j = 1; j < EPL; ++j)
      if (v[j] > best) { best = v[j]; arg = j * 32 + lane; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
    }
    if ((arg & 31) == lane) {
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (j == (arg >> 5)) v[j] = kNeg;
    }
    const float p = expf(best - m) / denom;
    picked += p;
    if (lane == 0) {
      out_p[r] = p;
      out_i[r] = arg;
    }
  }
  if (renorm && lane == 0) {
    for (int r = 0; r < k; ++r) out_p[r] = out_p[r] / picked;
  }
}

template <int EPL>
cudaError_t launch(const float* logits, float* probs, int32_t* ids,
                   long long rows, int e, int k, int renorm,
                   cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  moe_gate_kernel<EPL><<<blocks, kWarps * 32, 0, stream>>>(
      logits, probs, ids, rows, e, k, renorm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest E the kernel holds (8 logits per lane).
int moe_gate_max_experts() { return 8 * 32; }

// logits (rows, e) float32, contiguous; probs (rows, k) float32 and ids
// (rows, k) int32 written. 1 <= k <= e <= moe_gate_max_experts(), rows >= 1
// (the wrapper checks). Returns the CUDA error of the launch (0 on success).
int moe_gate_launch(const void* logits, void* probs, void* ids,
                    long long rows, int e, int k, int renorm, void* stream) {
  const float* x = static_cast<const float*>(logits);
  float* p = static_cast<float*>(probs);
  int32_t* i = static_cast<int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (e <= 32) err = launch<1>(x, p, i, rows, e, k, renorm, s);
  else if (e <= 64) err = launch<2>(x, p, i, rows, e, k, renorm, s);
  else if (e <= 128) err = launch<4>(x, p, i, rows, e, k, renorm, s);
  else if (e <= 256) err = launch<8>(x, p, i, rows, e, k, renorm, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* moe_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
