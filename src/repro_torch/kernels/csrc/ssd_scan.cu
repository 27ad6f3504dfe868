// Mamba2 SSD chunked scan for Hopper (sm_90a): the forward of the
// state-space-duality mixer, in f32, one block per (row, tile of P).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan (_ssd_kernel, launched by _ssd_call over the grid
//   (rows, chunks), the chunk axis sequential with the state in VMEM).
//
// What it computes, per row r (one (batch, head) pair) and per chunk of
// `chunk` positions, with g = cumsum(log_decay) inside the chunk:
//   y[t]  = exp(g_t) * C_t S_in + sum_{s <= t} (C_t . B_s) exp(g_t - g_s) u_s
//   S_out = exp(g_last) S_in + sum_s B_s^T exp(g_last - g_s) u_s
// S is the (N, P) state, zero before the first chunk. B and C of row r are
// read at batch row r / heads: heads share them (Mamba2's single B/C
// group), so the caller never repeats them per head. A ragged last chunk
// behaves exactly as the reference's zero padding (log_decay 0, u = b =
// c = 0): padded positions add nothing and are not stored.
//
// What bounds it on this card: at the model's shapes (chunk 128, N 128,
// P 64) a chunk of one row costs ~3.9 M multiply-adds against ~40 KB of
// input, ~200 operations per byte. The bf16 tensor cores (989 TFLOP/s)
// would clear that faster than memory delivers the bytes, so the call's
// least time is set by bytes (~0.03 ms for a prefill layer). This kernel
// runs its products in f32 on the CUDA cores (67 TFLOP/s), which sets its
// own least time ~7x above that line.
// The design keeps every operand of a chunk in shared memory and runs four
// small products on the CUDA cores with register tiles:
//   * the chunk loop runs inside the block (blocks run in no order, so the
//     TPU's sequential grid axis becomes a loop), and the state stays in
//     shared memory for the whole row;
//   * columns of P are independent (y[:, p] and S[:, p] depend only on
//     u[:, p]), so P is split into tiles of 64 across blocks;
//   * C and B are kept transposed, (N, chunk), so that every product reads
//     float4s along its output axis; u, y and S keep P innermost;
//   * the (chunk x chunk) decay matrix is never held whole: it is built 32
//     source positions at a time (C B^T times exp(g_t - g_s), only for
//     s <= t, so a masked exponent can never overflow) and applied to u at
//     once; tiles wholly above the diagonal are skipped;
//   * the state update of the last chunk is skipped: its result is unused.
// At chunk = N = 128 the block uses 218 KB of shared memory (one block per
// SM, 8 warps). Using the tensor cores (wgmma) and TMA is a later PR's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // ssd_scan.MAX_CHUNK
constexpr int kMaxState = 128;  // ssd_scan.MAX_STATE
constexpr int kPTile = 64;      // columns of P per block
constexpr int kSBlock = 32;     // source positions per decay tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch and jnp
}

__host__ __device__ constexpr int padded_chunk(int chunk) {
  return (chunk + kSBlock - 1) / kSBlock * kSBlock;
}
__host__ __device__ constexpr int padded_state(int n) {
  return (n + 7) / 8 * 8;
}

// f32 words of shared memory for one block.
constexpr size_t smem_words(int chunk, int n) {
  const int tl = padded_chunk(chunk), nr = padded_state(n);
  return (size_t)2 * nr * (tl + 4) + (size_t)tl * kPTile +
         (size_t)nr * kPTile + (size_t)kSBlock * tl + 2 * (size_t)tl;
}
static_assert(smem_words(kMaxChunk, kMaxState) * 4 <= 232448,
              "one block's shared memory must fit in 227 KB");

#define F4(ptr) (*reinterpret_cast<float4*>(ptr))

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ u, const float* __restrict__ la,
                    const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ y, int L, int P, int N, int chunk,
                    int heads) {
  extern __shared__ __align__(16) float smem[];
  const int tl = padded_chunk(chunk);  // positions per chunk, padded
  const int nr = padded_state(N);      // state rows, padded
  const int ldt = tl + 4;              // row stride of ct / bt
  float* ct = smem;                    // (nr, ldt): C^T of the chunk
  float* bt = ct + nr * ldt;           // (nr, ldt): B^T of the chunk
  float* us = bt + nr * ldt;           // (tl, kPTile): u, then carry * u
  float* st = us + tl * kPTile;        // (nr, kPTile): the state
  float* ms = st + nr * kPTile;        // (kSBlock, tl): decay tile, s-major
  float* g = ms + kSBlock * tl;        // (tl): cumulative log decay
  float* w = g + tl;                   // (tl): carry weights

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int p0 = blockIdx.y * kPTile;
  const int pw = min(kPTile, P - p0);  // columns of this tile
  const T* u_row = u + row * L * P + p0;
  T* y_row = y + row * L * P + p0;
  const float* la_row = la + row * L;
  const long long brow = row / heads;
  const T* b_row = b + brow * L * N;
  const T* c_row = c + brow * L * N;

  // Thread tiles: y and the state in 8 x 4 tiles (rows yt.., columns yp..),
  // the decay tile in 4 x 4 (rows mt.., source positions sb + ms0..).
  const int yp = (tid % 16) * 4;
  const int yt = (tid / 16) * 8;
  const int ms0 = (tid % 8) * 4;
  const int mt = (tid / 8) * 4;

  for (int e = tid; e < nr * kPTile; e += kThreads) st[e] = 0.f;
  // padded state rows of B^T are read by the state tiles: keep them zero
  for (int e = N * ldt + tid; e < nr * ldt; e += kThreads) bt[e] = 0.f;

  const int nchunks = (L + chunk - 1) / chunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const long long t0 = (long long)ci * chunk;
    const int valid = (int)min((long long)chunk, L - t0);
    // Load the chunk; rows past `valid` (ragged tail, chunk padding) are 0.
    for (int e = tid; e < tl * kPTile; e += kThreads) {
      const int t = e / kPTile, p = e % kPTile;
      us[e] = (t < valid && p < pw) ? to_f32(u_row[(t0 + t) * P + p]) : 0.f;
    }
    for (int e = tid; e < tl * N; e += kThreads) {  // n fastest: coalesced
      const int t = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (t < valid) {
        const long long off = (t0 + t) * N + n;
        bv = to_f32(b_row[off]);
        cv = to_f32(c_row[off]);
      }
      bt[n * ldt + t] = bv;
      ct[n * ldt + t] = cv;
    }
    for (int t = tid; t < tl; t += kThreads)
      g[t] = t < valid ? la_row[t0 + t] : 0.f;
    __syncthreads();

    // g = inclusive cumsum of the log decays: one warp, tl / 32 per lane.
    if (tid < 32) {
      const int per = tl / 32;
      float loc[kMaxChunk / 32];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i)
        if (i < per) {
          run += g[tid * per + i];
          loc[i] = run;
        }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float base = incl - run;
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i)
        if (i < per) g[tid * per + i] = base + loc[i];
    }
    __syncthreads();

    // y = exp(g_t) * (C S_in): the inter-chunk part.
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (ci > 0 && yt < tl) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 a0 = F4(&ct[n * ldt + yt]);
        const float4 a1 = F4(&ct[n * ldt + yt + 4]);
        const float4 q = F4(&st[n * kPTile + yp]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], qv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float eg = expf(g[yt + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= eg;
      }
    }

    // y += ((C B^T) o D) u: the intra-chunk part, 32 source positions at a
    // time.
    for (int sb = 0; sb < tl; sb += kSBlock) {
      if (mt < tl) {
        float m[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
        const int s = sb + ms0;
        if (s <= mt + 3) {  // some (t, s) of the tile has s <= t
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 a = F4(&ct[n * ldt + mt]);
            const float4 q = F4(&bt[n * ldt + s]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) m[i][j] = fmaf(av[i], qv[j], m[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              m[i][j] = s + j <= mt + i ? m[i][j] * expf(g[mt + i] - g[s + j])
                                        : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          F4(&ms[(ms0 + j) * tl + mt]) =
              make_float4(m[0][j], m[1][j], m[2][j], m[3][j]);
      }
      __syncthreads();
      if (yt < tl && yt + 7 >= sb) {
#pragma unroll 4
        for (int s2 = 0; s2 < kSBlock; ++s2) {
          const float4 a0 = F4(&ms[s2 * tl + yt]);
          const float4 a1 = F4(&ms[s2 * tl + yt + 4]);
          const float4 q = F4(&us[(sb + s2) * kPTile + yp]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], qv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    if (yt < tl) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = yt + i;
        if (t < valid) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (yp + j < pw) put(&y_row[(t0 + t) * P + yp + j], acc[i][j]);
        }
      }
    }

    // S_out = exp(g_last) S_in + B^T diag(exp(g_last - g)) u; unused after
    // the last chunk.
    if (ci + 1 < nchunks) {
      const float g_last = g[tl - 1];  // padding adds log decay 0
      for (int t = tid; t < tl; t += kThreads) w[t] = expf(g_last - g[t]);
      __syncthreads();
      for (int e = tid; e < tl * kPTile; e += kThreads) us[e] *= w[e / kPTile];
      __syncthreads();
      if (yt < nr) {
        float sacc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
        for (int s = 0; s < tl; s += 4) {
          float4 a[8], q[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = F4(&bt[(yt + i) * ldt + s]);
#pragma unroll
          for (int k = 0; k < 4; ++k) q[k] = F4(&us[(s + k) * kPTile + yp]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float qv[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sacc[i][j] = fmaf(av[k], qv[j], sacc[i][j]);
            }
          }
        }
        const float decay = expf(g_last);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* sp = &st[(yt + i) * kPTile + yp + j];
            *sp = decay * *sp + sacc[i][j];
          }
      }
    }
    __syncthreads();  // the next chunk's loads overwrite us, ct, bt
  }
}

template <typename T>
int launch(const void* u, const void* la, const void* b, const void* c,
           void* y, long long rows, int L, int P, int N, int chunk, int heads,
           cudaStream_t stream) {
  const size_t smem = smem_words(chunk, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)rows, (unsigned)((P + kPTile - 1) / kPTile));
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(la),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      L, P, N, chunk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u (rows, L, P), y (rows, L, P) and b, c (rows / heads, L, N), all of one
// type (bf16 = 1: bfloat16, else float32); log_decay (rows, L) float32.
// Returns a cudaError_t code.
int ssd_scan_launch(const void* u, const void* log_decay, const void* b,
                    const void* c, void* y, long long rows, long long L,
                    int P, int N, int chunk, int heads, int bf16,
                    void* stream) {
  if (rows <= 0 || L <= 0) return 0;
  if (rows > INT_MAX || L > INT_MAX || P < 1 || P > 65535 * kPTile ||
      N < 1 || N > kMaxState || chunk < 1 || chunk > kMaxChunk ||
      heads < 1 || rows % heads != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(u, log_decay, b, c, y, rows, (int)L, P, N,
                                 chunk, heads, st);
  return launch<float>(u, log_decay, b, c, y, rows, (int)L, P, N, chunk,
                       heads, st);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
