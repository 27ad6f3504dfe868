// Fused SRM0-RNL neuron bank for Hopper (sm_90a): the tick sweep of one
// gamma cycle for every (volley, neuron) pair.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rnl_neuron.py:
//   rnl_fire_times_layer   (_rnl_layer_kernel, _rnl_layer_clip_kernel)
//   rnl_fire_times         (_rnl_kernel, _rnl_clip_kernel) — the C = 1 case
//   rnl_fire_times_compact (_rnl_compact_kernel)
// all of which run the shared body _tick_sweep bounded by _sweep_bound.
//
// What it computes, per column c, volley b and neuron q:
//   for t in [0, t_hi):  raw = #{ i : 0 <= t - times[b,i] < w[q,i] }
//                        inc = k-clipped ? min(raw, k) : raw
//                        pot += inc;  first t with pot >= threshold fires
//   clip (optional) = #ticks with raw > k.
// t_hi is the pair's own last breakpoint, min(T, max(times + w)) over the
// lines with times < T, floored at 1 when threshold <= 0 (a zero potential
// already meets it). Ticks past a pair's last breakpoint carry no ramp bit,
// so a per-pair bound is exact and never longer than the reference's
// per-launch bound; T = 0 gives all NO_SPIKE; lines with times >= T or
// w <= 0 are inert.
//
// What bounds it on this card: integer operations. Each line-tick is a
// subtract, a compare and an add on the int32 ALUs (64 per SM on Hopper);
// the bytes are one read of times and weights and one write of the fire
// times, tiny next to the sweep. The design keeps the sweep's operands in
// shared memory: one block per (column, tile of volleys, tile of neurons),
// the tile's volley times and weight rows staged once (line-major, so the
// threads of a warp hit distinct banks), one thread per pair running the
// tick loop from shared memory. Without the clip output a thread stops at
// its first crossing. The ragged edge of B and Q is masked in the kernel,
// not padded. The compact variant's weights are per volley, read by exactly
// one thread each, so they stay in device memory (L1-cached) and only the
// compacted times are staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoSpike = 1 << 30;
constexpr int kThreadsPerBlock = 128;
constexpr int kMaxNeuronTile = 32;

// Pair-local sweep over staged times (stride bt) and a weight accessor.
// Unsigned arithmetic: (t - time) wraps exactly like the reference's int32
// subtraction, and (uint)rel < (uint)w with w clamped at >= 0 is the
// window test 0 <= rel < w.
template <bool kClip, bool kPerVolleyWeights>
__device__ __forceinline__ void sweep_pair(
    const int* __restrict__ s_times, int bt, int ty,
    const int* __restrict__ s_w, int qt, int tx,
    const int* __restrict__ w_row, int n, int t_steps, int threshold,
    int clip_on, int k, int* fire_out, int* clip_out) {
  long long last = 0;
  for (int i = 0; i < n; ++i) {
    const int ti = s_times[i * bt + ty];
    const int wi = kPerVolleyWeights ? max(w_row[i], 0) : s_w[i * qt + tx];
    if (ti < t_steps) {
      const long long end = (long long)ti + wi;
      last = end > last ? end : last;
    }
  }
  int t_hi = (int)(last < t_steps ? last : t_steps);
  if (threshold <= 0) {
    const int t_min = t_steps < 1 ? t_steps : 1;
    t_hi = t_hi > t_min ? t_hi : t_min;
  }
  int pot = 0, fired = kNoSpike, clips = 0;
  for (int t = 0; t < t_hi; ++t) {
    int raw = 0;
    for (int i = 0; i < n; ++i) {
      const unsigned rel = (unsigned)t - (unsigned)s_times[i * bt + ty];
      const int wi =
          kPerVolleyWeights ? max(w_row[i], 0) : s_w[i * qt + tx];
      raw += rel < (unsigned)wi;
    }
    int inc = raw;
    if (clip_on) {
      inc = raw < k ? raw : k;
      clips += raw > k;
    }
    pot += inc;
    if (fired == kNoSpike && pot >= threshold) {
      fired = t;
      if (!kClip) break;
    }
  }
  *fire_out = fired;
  if (kClip) *clip_out = clips;
}

// Dense weights: times (C, B, n), weights (C, Q, n) -> fire/clip (C, B, Q).
// Grid (Q tiles, B tiles, C); block (qt, bt). Dynamic shared memory:
// (bt + qt) * n ints.
template <bool kClip>
__global__ void rnl_layer_kernel(const int* __restrict__ times,
                                 const int* __restrict__ weights,
                                 int* __restrict__ fire,
                                 int* __restrict__ clip, int B, int Q, int n,
                                 int t_steps, int threshold, int clip_on,
                                 int k) {
  extern __shared__ int smem[];
  const int qt = blockDim.x, bt = blockDim.y;
  int* s_times = smem;          // [n][bt]
  int* s_w = smem + n * bt;     // [n][qt]
  const int c = blockIdx.z;
  const int q0 = blockIdx.x * qt, b0 = blockIdx.y * bt;
  const int tid = threadIdx.y * qt + threadIdx.x;
  const int nthreads = qt * bt;
  const int* tc = times + (size_t)c * B * n;
  const int* wc = weights + (size_t)c * Q * n;
  for (int idx = tid; idx < bt * n; idx += nthreads) {
    const int bb = idx / n, i = idx - bb * n;
    const int b = b0 + bb;
    s_times[i * bt + bb] = b < B ? tc[(size_t)b * n + i] : kNoSpike;
  }
  for (int idx = tid; idx < qt * n; idx += nthreads) {
    const int qq = idx / n, i = idx - qq * n;
    const int q = q0 + qq;
    s_w[i * qt + qq] = q < Q ? max(wc[(size_t)q * n + i], 0) : 0;
  }
  __syncthreads();
  const int b = b0 + threadIdx.y, q = q0 + threadIdx.x;
  if (b >= B || q >= Q) return;
  const size_t out = ((size_t)c * B + b) * Q + q;
  sweep_pair<kClip, false>(s_times, bt, threadIdx.y, s_w, qt, threadIdx.x,
                           nullptr, n, t_steps, threshold, clip_on, k,
                           fire + out, kClip ? clip + out : nullptr);
}

// Per-volley weights: times (B, s), weights (B, Q, s) -> fire (B, Q).
// Grid (Q tiles, B tiles); block (qt, bt). Shared memory: bt * s ints.
__global__ void rnl_compact_kernel(const int* __restrict__ times,
                                   const int* __restrict__ weights,
                                   int* __restrict__ fire, int B, int Q,
                                   int s, int t_steps, int threshold,
                                   int clip_on, int k) {
  extern __shared__ int smem[];
  const int qt = blockDim.x, bt = blockDim.y;
  int* s_times = smem;          // [s][bt]
  const int q0 = blockIdx.x * qt, b0 = blockIdx.y * bt;
  const int tid = threadIdx.y * qt + threadIdx.x;
  const int nthreads = qt * bt;
  for (int idx = tid; idx < bt * s; idx += nthreads) {
    const int bb = idx / s, i = idx - bb * s;
    const int b = b0 + bb;
    s_times[i * bt + bb] = b < B ? times[(size_t)b * s + i] : kNoSpike;
  }
  __syncthreads();
  const int b = b0 + threadIdx.y, q = q0 + threadIdx.x;
  if (b >= B || q >= Q) return;
  const int* w_row = weights + ((size_t)b * Q + q) * s;
  sweep_pair<false, true>(s_times, bt, threadIdx.y, nullptr, 1, 0, w_row, s,
                          t_steps, threshold, clip_on, k,
                          fire + (size_t)b * Q + q, nullptr);
}

// Tile shape: up to 32 neurons across x, volleys across y, ~128 threads.
void tile_shape(int B, int Q, int* qt, int* bt) {
  *qt = Q < kMaxNeuronTile ? Q : kMaxNeuronTile;
  int rows = kThreadsPerBlock / *qt;
  if (rows < 1) rows = 1;
  *bt = B < rows ? B : rows;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// C independent banks in one launch (rnl_fire_times_layer). clip may be
// null: then no clip output is written. Returns a cudaError_t code.
int rnl_fire_times_layer_launch(const void* times, const void* weights,
                                void* fire, void* clip, int C, int B, int Q,
                                int n, int t_steps, int threshold,
                                int clip_on, int k, void* stream) {
  if (C <= 0 || B <= 0 || Q <= 0) return 0;
  int qt, bt;
  tile_shape(B, Q, &qt, &bt);
  const dim3 grid((Q + qt - 1) / qt, (B + bt - 1) / bt, C);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(qt, bt);
  const size_t smem = (size_t)(bt + qt) * n * sizeof(int);
  const cudaStream_t st = (cudaStream_t)stream;
  if (clip != nullptr) {
    const int err = set_smem((const void*)rnl_layer_kernel<true>, smem);
    if (err) return err;
    rnl_layer_kernel<true><<<grid, block, smem, st>>>(
        (const int*)times, (const int*)weights, (int*)fire, (int*)clip, B,
        Q, n, t_steps, threshold, clip_on, k);
  } else {
    const int err = set_smem((const void*)rnl_layer_kernel<false>, smem);
    if (err) return err;
    rnl_layer_kernel<false><<<grid, block, smem, st>>>(
        (const int*)times, (const int*)weights, (int*)fire, nullptr, B, Q,
        n, t_steps, threshold, clip_on, k);
  }
  return (int)cudaGetLastError();
}

// One bank (rnl_fire_times): the C = 1 case of the layer kernel.
int rnl_fire_times_launch(const void* times, const void* weights, void* fire,
                          void* clip, int B, int Q, int n, int t_steps,
                          int threshold, int clip_on, int k, void* stream) {
  return rnl_fire_times_layer_launch(times, weights, fire, clip, 1, B, Q, n,
                                     t_steps, threshold, clip_on, k, stream);
}

// Spike-compacted volleys with per-volley weights (rnl_fire_times_compact).
int rnl_fire_times_compact_launch(const void* times, const void* weights,
                                  void* fire, int B, int Q, int s,
                                  int t_steps, int threshold, int clip_on,
                                  int k, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  int qt, bt;
  tile_shape(B, Q, &qt, &bt);
  const dim3 grid((Q + qt - 1) / qt, (B + bt - 1) / bt);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(qt, bt);
  const size_t smem = (size_t)bt * s * sizeof(int);
  const int err = set_smem((const void*)rnl_compact_kernel, smem);
  if (err) return err;
  rnl_compact_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)times, (const int*)weights, (int*)fire, B, Q, s, t_steps,
      threshold, clip_on, k);
  return (int)cudaGetLastError();
}

const char* rnl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
