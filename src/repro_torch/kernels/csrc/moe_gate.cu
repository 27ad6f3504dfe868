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
// fixed cost and each row's serial chain are what a design can cut.
//
// Design: one warp per row, 8 rows (warps) per 256-thread block. Lane l
// holds experts l, l + 32, ... in registers (EPL per lane, a template
// parameter: 1, 2, 4 or 8, so E <= 256; the loads of a warp are coalesced).
// Each logit also becomes an order-preserving uint32 key (-0.0 taken as
// +0.0 first, as float comparison takes them as equal). A round's maximum
// is one warp reduction of the keys (redux.sync); its lowest id among
// equals is the first non-empty ballot of key == max over the lane's
// experts in increasing id, then ffs: no (value, index) shuffle chain. The
// row max m is round 0's maximum. The owner of a pick sets its key to that
// of -1e30, as the reference masks (a row whose logits lie below -1e30
// then picks a masked expert again, as the reference's kernel does);
// padding past E is -inf and never picked. The picks stay in registers:
// lane r % 32 keeps round r's key and id. Every per-slot update is a
// select, so no array is indexed at run time (an indexed update compiled
// to a chain of predicated moves across all of them). After the rounds
// each lane turns its picks into probabilities at once (no exp or divide
// inside the rounds), their sum is taken in round order by shuffles, the
// same in every lane, so the renormalisation is a register divide, and
// lanes < k store probs and ids once, coalesced. expf, not __expf, and no
// fast-math, so the probabilities stay within float32 rounding of the
// plain version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rows per block
constexpr float kNeg = -1e30f;     // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving key: key(a) < key(b) exactly when a < b, for every
// float but NaN; -0.0 and +0.0 share one key.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

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
  unsigned key[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int col = j * 32 + lane;
    v[j] = col < e ? x[col] : -CUDART_INF_F;   // padding: never a max or pick
    key[j] = order_key(v[j]);
  }

  unsigned top = key[0];
#pragma unroll
  for (int j = 1; j < EPL; ++j) top = max(top, key[j]);
  top = __reduce_max_sync(kFull, top);
  const float m = key_value(top);

  float z = 0.0f;
#pragma unroll
  for (int j = 0; j < EPL; ++j)
    if (j * 32 + lane < e) z += expf(v[j] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    z += __shfl_xor_sync(kFull, z, off);
  const float denom = z;
  const unsigned neg_key = order_key(kNeg);

  // round r's pick sits in lane r % 32, slot r / 32: its key, then its
  // probability once the rounds are done
  unsigned top_out[EPL];
  int id_out[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    top_out[j] = 0u;
    id_out[j] = 0;
  }
  for (int r = 0; r < k; ++r) {
    if (r > 0) {
      top = key[0];
#pragma unroll
      for (int j = 1; j < EPL; ++j) top = max(top, key[j]);
      top = __reduce_max_sync(kFull, top);
    }
    // the lowest id holding the maximum: the first slot with a hit (slots
    // in increasing id), its lowest lane
    unsigned hit[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      hit[j] = __ballot_sync(kFull, key[j] == top);
    int arg = 0;
#pragma unroll
    for (int j = EPL - 1; j >= 0; --j)
      if (hit[j]) arg = j * 32 + __ffs(hit[j]) - 1;
    // selects, not indexing: the arrays stay in registers
    const bool owner = (arg & 31) == lane, keeper = (r & 31) == lane;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      key[j] = owner && j == (arg >> 5) ? neg_key : key[j];
      top_out[j] = keeper && j == (r >> 5) ? top : top_out[j];
      id_out[j] = keeper && j == (r >> 5) ? arg : id_out[j];
    }
  }
  // the picks' probabilities in parallel, their sum in round order
  float p_out[EPL];
  float picked = 0.0f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    p_out[j] = 0.0f;
    if (j * 32 >= k) continue;             // warp-uniform
    p_out[j] = expf(key_value(top_out[j]) - m) / denom;
    for (int l = 0; l < 32 && j * 32 + l < k; ++l)
      picked += __shfl_sync(kFull, p_out[j], l);
  }
  float* out_p = probs + row * k;
  int32_t* out_i = ids + row * k;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int r = j * 32 + lane;
    if (r < k) {
      out_p[r] = renorm ? p_out[j] / picked : p_out[j];
      out_i[r] = id_out[j];
    }
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
