// Mamba2 SSD chunked scan for Hopper (sm_90a) on the tensor cores: the
// forward of the state-space-duality mixer, one block per (row, 64 columns
// of P).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:68,
//   ssd_scan (_ssd_kernel, launched by _ssd_call, pallas_call at :123,
//   over the grid (rows, chunks), the chunk axis sequential with the state
//   in VMEM).
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
// What bounds it on this card. At the mamba2-780m prefill call (rows 4 x
// 48 heads, L 2,048, P 64, N 128, bf16) the call must move 56 MB (u and y,
// the f32 log decays, B and C once per batch row): 0.0318 ms at 3.35 TB/s.
// Its products, ~7.7 G multiply-adds at chunk 128, take 0.016 ms at the
// bf16 tensor-core rate, so bytes bound it. On the CUDA cores in f32 the
// products alone would take ~0.23 ms, so they run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 sums), per chunk:
//   G       = C B^T                       (t x s, over n)
//   y       = exp(g_t) (C S_in) + (G o D) U     (D_ts = exp(g_t - g_s), s <= t)
//   S_out^T = exp(g_last) S_in^T + (w o U)^T B  (w_s = exp(g_last - g_s))
// The chunked form is the same function for any chunk length, so the
// kernel takes chunks of min(chunk, 64) positions: the causal products
// shrink, and one chunk's tiles fit two blocks on an SM.
//
// The split, and what it costs in accuracy. bf16 u, B and C are exact as
// bf16 operands, so G = C B^T is one product. The f32 intermediates -- the
// decay-weighted M = G o D, the state S, and w o U -- are each split into
// bf16 hi + lo (x = hi + lo + e, |e| <= 2^-17 |x|), two products each: every
// product is then exact in f32 and summed in f32, and the result agrees
// with an f32 computation to a few 2^-17 of the sums' scale. float32 inputs
// are split into three bf16 terms (x = x0 + x1 + x2 to 2^-26 |x|), the
// intermediates too, and each product takes the six term pairs with
// i + j <= 2 (the dropped pairs are below 2^-24 of the product): f32
// accuracy at six bf16 products a product; what is left is the f32 cumsum
// of the log decays, as in the plain float32 form. The decays of M come
// from ex2.approx (relative error ~2^-22). The split is where accuracy can
// fail: a term dropped there, or an intermediate rounded once to bf16,
// gives ~2^-9 relative errors that the gates (tests/test_torch_ssd.py,
// chip_smoke.py) reject. ssd_scan.ssd_scan_split_model computes the same
// splits on the host (not this kernel's sum orders): it bounds the error
// the split adds, and its tests show that one term fails the gates.
//
// Grid, blocks and warps. Columns of P are independent (y[:, p] and
// S[:, p] depend only on u[:, p]), so a block takes one row and 64 columns
// of P (192 blocks at the prefill call) and walks the row's chunks in
// order: the TPU's sequential grid axis becomes the loop. Its 8 warps have
// two roles, each with its own chunk loop. Four y warps own 16 rows t
// each: y = C S_in from the state's hi/lo planes in shared memory, then
// for each 16-column block s at or below the diagonal G's block (two
// partial sums), M = G o D built in registers from G's accumulators (only
// s <= t is exponentiated, so a masked exponent never overflows) and used
// as the A operand of M U straight from them. Four state warps each keep
// 16 rows of S^T (f32, 64 registers) for the whole row, build the A operand
// w o U in registers, and write the next planes; the first one computes
// the next chunk's cumsum of g (one warp, shuffles) from global memory.
// The roles meet at barrier 0 when a chunk's tiles are in and again before
// the next chunk's are copied, and at barrier 1, where the y warps arrive
// after reading the planes and the state warps wait before overwriting
// them.
//
// Shared memory and copies. C, B and u keep their natural (t, n) and
// (t, p) layouts, padded by 16 bytes a row so that ldmatrix(.trans) reads
// them without bank conflicts; bf16 inputs are copied with cp.async (16
// bytes, zero-filled past the edges). A block holds one chunk's tiles, the
// state planes and the decays: 78.5 KB at N = 128, so two blocks share an
// SM and one block's copies overlap the other's products (a two-stage ring
// in one block of 214 KB measured slower). float32 inputs take 135.5 KB,
// one block an SM. The last chunk's state update is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxChunk = 128;  // ssd_scan.MAX_CHUNK
constexpr int kMaxState = 128;  // ssd_scan.MAX_STATE
constexpr int kSubChunk = 64;   // positions a block takes at a time
constexpr int kPTile = 64;      // columns of P per block
constexpr int kYWarps = kSubChunk / 16;  // y warps: 16 rows t each
constexpr int kSWarps = kPTile / 16;     // state warps: 16 rows of S^T each
constexpr int kWarps = kYWarps + kSWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kYTiles = kPTile / 8;     // 8-column tiles of y a warp
constexpr int kUnits = kMaxState / 16;  // 16-column units of S^T a warp

// Terms of a bf16 split: kX for the inputs u, B, C; kI for the f32
// intermediates (M, S, w o U). Blocks resident on an SM.
template <typename T> struct Split;
template <> struct Split<bf16> {
  static constexpr int kX = 1, kI = 2, kBlocks = 2;
};
template <> struct Split<float> {
  static constexpr int kX = 3, kI = 3, kBlocks = 1;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Byte offsets of one block's shared memory: the chunk's C, B (tl x ldx)
// and u (tl x ldu) tiles in the input type; the state's kI bf16 planes
// (S^T, kPTile x lds); two buffers (this chunk, the next) of g, exp(g) and
// the carry weights exp(g_last - g).
struct Smem {
  int tl, nr, ldx, ldu, lds;
  int c_off, b_off, u_off, sp_off, g_off, bytes;
};

template <typename T>
__host__ __device__ constexpr Smem smem_layout(int chunk, int n) {
  Smem s{};
  s.tl = round16(chunk < kSubChunk ? chunk : kSubChunk);
  s.nr = round16(n);
  s.ldx = s.nr + 16 / (int)sizeof(T);
  s.ldu = kPTile + 16 / (int)sizeof(T);
  s.lds = s.nr + 8;
  s.c_off = 0;
  s.b_off = s.tl * s.ldx * (int)sizeof(T);
  s.u_off = 2 * s.b_off;
  s.sp_off = s.u_off + s.tl * s.ldu * (int)sizeof(T);
  s.g_off = s.sp_off + Split<T>::kI * kPTile * s.lds * 2;
  s.bytes = s.g_off + 2 * 3 * 4 * s.tl;
  return s;
}
static_assert(smem_layout<bf16>(kMaxChunk, kMaxState).bytes <=
                      232448 / Split<bf16>::kBlocks - 1024 &&
                  smem_layout<float>(kMaxChunk, kMaxState).bytes <=
                      232448 / Split<float>::kBlocks - 1024,
              "the blocks of an SM must fit in its 228 KB of shared memory");

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The y warps and the state warps run their own chunk loops, so they meet
// at explicit barriers: 0 for the whole block, and 1, at which the y warps
// arrive once they have read the state planes and the state warps wait
// before they write the next ones.
__device__ __forceinline__ void bar_sync_all() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive_planes() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_sync_planes() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for one 16 x 8 tile, k = 16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += sum over term pairs (i, j), i + j <= 2, of a_i b_j.
template <int KA, int KB>
__device__ __forceinline__ void mma_terms(float (&c)[4],
                                          const uint32_t (&a)[KA][4],
                                          const uint32_t (&b)[KB][2]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < KA; ++i)
      if (s - i >= 0 && s - i < KB) mma(c, a[i], b[s - i]);
}

// e^x on the special-function unit (ex2.approx, relative error ~2^-22;
// results below 2^-126 flush to 0).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// M f32 values -> K bf16 terms, packed in pairs: v = sum_k term_k to
// 2^(-9K) |v| (each residual v - hi is exact in f32).
template <int K, int M>
__device__ __forceinline__ void split(const float (&v)[M],
                                      uint32_t (&out)[K][M / 2]) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    float r0 = v[2 * i], r1 = v[2 * i + 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
      out[k][i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 f = __bfloat1622float2(h);
      r0 -= f.x;
      r1 -= f.y;
    }
  }
}

// ------------------------------------------------------ operand fragments
//
// mma.m16n8k16 fragments, lane = 4 g + q: A (16 x 16) element e of a lane
// is at row g + 8 ((e >> 1) & 1), column 2 q + (e & 1) + 8 (e >> 2); B (16
// x 8) element e at row 2 q + (e & 1) + 8 (e >> 1), column g; the f32
// accumulator element e at row g + 8 (e >> 1), column 2 q + (e & 1).

// A at rows r0.., columns c0.. of X; kT = false: X[r][c] at x[r ld + c],
// true: at x[c ld + r].
template <bool kT>
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* x, int ld,
                                    int r0, int c0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, i = lane & 7;
  if (kT)
    ldsm_t(a, x + (c0 + i + 8 * (j >> 1)) * ld + r0 + 8 * (j & 1));
  else
    ldsm(a, x + (r0 + i + 8 * (j & 1)) * ld + c0 + 8 * (j >> 1));
}

// B for two 8-column tiles, rows k0.., columns n0.. and n0 + 8.. of X;
// kT = false: X[k][n] at x[n ld + k], true: at x[k ld + n].
template <bool kT>
__device__ __forceinline__ void ldb(uint32_t (&b)[2][2], const bf16* x,
                                    int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, i = lane & 7;
  uint32_t r[4];
  if (kT)
    ldsm_t(r, x + (k0 + i + 8 * (j & 1)) * ld + n0 + 8 * (j >> 1));
  else
    ldsm(r, x + (n0 + i + 8 * (j >> 1)) * ld + k0 + 8 * (j & 1));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The same fragments of an f32 matrix, as f32 values.
template <bool kT>
__device__ __forceinline__ void lda(float (&v)[8], const float* x, int ld,
                                    int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = r0 + g + 8 * ((e >> 1) & 1);
    const int c = c0 + 2 * q + (e & 1) + 8 * (e >> 2);
    v[e] = kT ? x[c * ld + r] : x[r * ld + c];
  }
}
template <bool kT>
__device__ __forceinline__ void ldb(float (&v)[2][4], const float* x, int ld,
                                    int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 2 * q + (e & 1) + 8 * (e >> 1);
      const int n = n0 + 8 * h + g;
      v[h][e] = kT ? x[k * ld + n] : x[n * ld + k];
    }
}

// Input tiles as split terms (bf16: one exact term; f32: three), and the
// A operand as f32 values, for either storage type.
template <bool kT>
__device__ __forceinline__ void frag_a(uint32_t (&a)[1][4], const bf16* x,
                                       int ld, int r0, int c0) {
  lda<kT>(a[0], x, ld, r0, c0);
}
template <bool kT>
__device__ __forceinline__ void frag_a(uint32_t (&a)[3][4], const float* x,
                                       int ld, int r0, int c0) {
  float v[8];
  lda<kT>(v, x, ld, r0, c0);
  split<3>(v, a);
}
template <bool kT>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2][1][2], const bf16* x,
                                       int ld, int k0, int n0) {
  uint32_t r[2][2];
  ldb<kT>(r, x, ld, k0, n0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h][0][0] = r[h][0];
    b[h][0][1] = r[h][1];
  }
}
template <bool kT>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2][3][2], const float* x,
                                       int ld, int k0, int n0) {
  float v[2][4];
  ldb<kT>(v, x, ld, k0, n0);
  split<3>(v[0], b[0]);
  split<3>(v[1], b[1]);
}
template <bool kT>
__device__ __forceinline__ void frag_a_values(float (&v)[8], const bf16* x,
                                              int ld, int r0, int c0) {
  uint32_t a[4];
  lda<kT>(a, x, ld, r0, c0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <bool kT>
__device__ __forceinline__ void frag_a_values(float (&v)[8], const float* x,
                                              int ld, int r0, int c0) {
  lda<kT>(v, x, ld, r0, c0);
}

// B fragments of the state's K bf16 planes: X[k = n][p] at sp[p lds + n].
template <int K>
__device__ __forceinline__ void frag_b_planes(uint32_t (&b)[2][K][2],
                                              const bf16* sp, int plane,
                                              int lds, int k0, int n0) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t r[2][2];
    ldb<false>(r, sp + k * plane, lds, k0, n0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b[h][k][0] = r[h][0];
      b[h][k][1] = r[h][1];
    }
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch and jnp
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// One chunk's C, B and u tiles into shared memory, by all threads.
// Positions past `valid`, columns past P (pw in this tile) or N, and the
// padding to 16-multiples are zero. vec: 16-byte copies with cp.async (rows
// of P and N are whole 16-byte segments, pointers 16-byte aligned); else
// element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* smem,
                                           const Smem& lay, const T* u_row,
                                           const T* b_row, const T* c_row,
                                           long long t0, int valid, int P,
                                           int N, int pw, bool vec) {
  T* cs = reinterpret_cast<T*>(smem + lay.c_off);
  T* bs = reinterpret_cast<T*>(smem + lay.b_off);
  T* us = reinterpret_cast<T*>(smem + lay.u_off);
  const int tid = threadIdx.x, tl = lay.tl, nr = lay.nr;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int kUSeg = kPTile / E, kNSeg = kMaxState / E;
    for (int e = tid; e < tl * kUSeg; e += kThreads) {
      const int t = e / kUSeg, p = (e % kUSeg) * E;
      const bool ok = t < valid && p < pw;
      cp_async16(us + t * lay.ldu + p, ok ? u_row + (t0 + t) * P + p : u_row,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < tl * kNSeg; e += kThreads) {
      const int t = e / kNSeg, n = (e % kNSeg) * E;
      if (n >= nr) continue;
      const bool ok = t < valid && n < N;
      const long long off = ok ? (t0 + t) * N + n : 0;
      cp_async16(bs + t * lay.ldx + n, b_row + off, ok ? 16 : 0);
      cp_async16(cs + t * lay.ldx + n, c_row + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < tl * kPTile; e += kThreads) {
      const int t = e / kPTile, p = e % kPTile;
      us[t * lay.ldu + p] =
          t < valid && p < pw ? u_row[(t0 + t) * P + p] : zero<T>();
    }
    for (int e = tid; e < tl * kMaxState; e += kThreads) {
      const int t = e / kMaxState, n = e % kMaxState;
      if (n >= nr) continue;
      const bool ok = t < valid && n < N;
      bs[t * lay.ldx + n] = ok ? b_row[(t0 + t) * N + n] : zero<T>();
      cs[t * lay.ldx + n] = ok ? c_row[(t0 + t) * N + n] : zero<T>();
    }
  }
}

// One warp: a chunk's g = inclusive cumsum of the log decays (positions
// past `valid` add 0), four positions a lane, read from global memory;
// then exp(g) and the carry weights exp(g_last - g), into gb[0..3 tl).
__device__ __forceinline__ void chunk_decays(const float* la, int valid,
                                             int tl, float* gb) {
  const int lane = threadIdx.x & 31;
  float x[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    run += t < valid ? la[t] : 0.f;
    x[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float last = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] += incl - run;
    if (i == ((tl - 1) & 3)) last = x[i];
  }
  last = __shfl_sync(0xffffffffu, last, (tl - 1) >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    if (t < tl) {
      gb[t] = x[i];
      gb[tl + t] = expf(x[i]);
      gb[2 * tl + t] = expf(last - x[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Split<T>::kBlocks)
    ssd_scan_kernel(const T* __restrict__ u, const float* __restrict__ la,
                    const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ y, int L, int P, int N, int chunk,
                    int heads, int flags) {
  constexpr int KX = Split<T>::kX, KI = Split<T>::kI;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout<T>(chunk, N);
  const int tl = lay.tl, nr = lay.nr;
  const T* cs = reinterpret_cast<const T*>(smem + lay.c_off);
  const T* bs = reinterpret_cast<const T*>(smem + lay.b_off);
  const T* us = reinterpret_cast<const T*>(smem + lay.u_off);
  bf16* sp = reinterpret_cast<bf16*>(smem + lay.sp_off);  // S^T planes
  const int plane = kPTile * lay.lds;
  float* gbuf = reinterpret_cast<float*>(smem + lay.g_off);
  const bool vec = flags & 1, pairs = flags & 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long row = blockIdx.x;
  const int p0 = blockIdx.y * kPTile;
  const int pw = min(kPTile, P - p0);  // columns of this tile
  const T* u_row = u + row * L * P + p0;
  T* y_row = y + row * L * P + p0;
  const float* la_row = la + row * L;
  const long long brow = row / heads;
  const T* b_row = b + brow * L * N;
  const T* c_row = c + brow * L * N;

  chunk = min(chunk, kSubChunk);  // the chunked form is the same for any
  const int nchunks = (L + chunk - 1) / chunk;
  load_chunk<T>(smem, lay, u_row, b_row, c_row, 0, min(chunk, L), P, N, pw,
                vec);
  cp_async_commit();
  if (warp == kYWarps) chunk_decays(la_row, min(chunk, L), tl, gbuf);

  // Every chunk: both roles wait for its tiles and decays at barrier 0; the
  // y warps read the state planes and arrive at barrier 1; the state warps
  // update the state and wait there before they overwrite the planes; then
  // all wait at barrier 0 again and copy the next chunk's tiles in.
  auto next_chunk = [&](long long t0, int next_valid) {
    bar_sync_all();  // every warp is done with the tiles
    load_chunk<T>(smem, lay, u_row, b_row, c_row, t0 + chunk, next_valid, P,
                  N, pw, vec);
    cp_async_commit();
  };
  if (warp < kYWarps) {
    // y rows 16 warp.. of each chunk
    const int tb = warp;
    for (int ci = 0; ci < nchunks; ++ci) {
      const long long t0 = (long long)ci * chunk;
      const int valid = (int)min((long long)chunk, L - t0);
      cp_async_wait_all();
      bar_sync_all();  // this chunk's tiles, decays and state planes are in
      const float* gs = gbuf + (ci & 1) * 3 * tl;  // g
      const float* eg = gs + tl;                   // exp(g)
      const bool live = 16 * tb < valid;  // y rows to compute
      float yacc[kYTiles][4];
#pragma unroll
      for (int i = 0; i < kYTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;
      if (live && ci > 0) {
        // y = C S_in, from the state planes the last chunk left
#pragma unroll
        for (int k = 0; k < kMaxState / 16; ++k)
          if (16 * k < nr) {
            uint32_t a[KX][4];
            frag_a<false>(a, cs, lay.ldx, 16 * tb, 16 * k);
#pragma unroll
            for (int jp = 0; jp < kPTile / 16; ++jp) {
              uint32_t bb[2][KI][2];
              frag_b_planes<KI>(bb, sp, plane, lay.lds, 16 * k, 16 * jp);
              mma_terms<KX, KI>(yacc[2 * jp], a, bb[0]);
              mma_terms<KX, KI>(yacc[2 * jp + 1], a, bb[1]);
            }
          }
      }
      bar_arrive_planes();  // the state warps may overwrite the planes
      if (live) {
        const int ta = 16 * tb + g;  // this lane's rows: ta, ta + 8
        const float ea = eg[ta], eb = eg[ta + 8];
        const float ga = gs[ta], gb = gs[ta + 8];
#pragma unroll
        for (int i = 0; i < kYTiles; ++i) {
          yacc[i][0] *= ea;
          yacc[i][1] *= ea;
          yacc[i][2] *= eb;
          yacc[i][3] *= eb;
        }
        // y += (G o D) U over the s blocks at or below the diagonal: G's
        // block by C B^T (two partial sums, for independent products),
        // then M = G o D as the A operand from G's accumulators; only
        // s <= t is exponentiated
#pragma unroll
        for (int j = 0; j < kSubChunk / 16; ++j)
          if (j <= tb) {
            float gacc[2][2][4] = {};
#pragma unroll
            for (int k = 0; k < kMaxState / 16; ++k)
              if (16 * k < nr) {
                uint32_t a[KX][4], bb[2][KX][2];
                frag_a<false>(a, cs, lay.ldx, 16 * tb, 16 * k);
                frag_b<false>(bb, bs, lay.ldx, 16 * k, 16 * j);
                mma_terms<KX, KX>(gacc[k & 1][0], a, bb[0]);
                mma_terms<KX, KX>(gacc[k & 1][1], a, bb[1]);
              }
            float m[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int hi = (e >> 1) & 1;
              const int t = ta + 8 * hi;
              const int s = 16 * j + 2 * q + (e & 1) + 8 * (e >> 2);
              const float v = gacc[0][e >> 2][e & 3] + gacc[1][e >> 2][e & 3];
              m[e] = s <= t ? v * exp_approx((hi ? gb : ga) - gs[s]) : 0.f;
            }
            uint32_t a[KI][4];
            split<KI>(m, a);
#pragma unroll
            for (int jp = 0; jp < kPTile / 16; ++jp) {
              uint32_t bb[2][KX][2];
              frag_b<true>(bb, us, lay.ldu, 16 * j, 16 * jp);
              mma_terms<KI, KX>(yacc[2 * jp], a, bb[0]);
              mma_terms<KI, KX>(yacc[2 * jp + 1], a, bb[1]);
            }
          }
#pragma unroll
        for (int i = 0; i < kYTiles; ++i) {
          const int p = 8 * i + 2 * q;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int t = ta + 8 * hi;
            if (t >= valid) continue;
            T* dst = y_row + (t0 + t) * P + p;
            if (pairs && p + 1 < pw) {
              put2(dst, yacc[i][2 * hi], yacc[i][2 * hi + 1]);
            } else {
              if (p < pw) put(dst, yacc[i][2 * hi]);
              if (p + 1 < pw) put(dst + 1, yacc[i][2 * hi + 1]);
            }
          }
        }
      }
      if (ci + 1 < nchunks)
        next_chunk(t0, (int)min((long long)chunk, L - t0 - chunk));
    }
  } else {
    // S^T rows 16 sb.., all N columns in kUnits units of 16; the first
    // state warp also computes the next chunk's decays
    const int sb = warp - kYWarps;
    float sacc[kUnits][2][4];  // S^T, f32, for the whole row
#pragma unroll
    for (int i = 0; i < kUnits; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) sacc[i][e >> 2][e & 3] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      const long long t0 = (long long)ci * chunk;
      const int valid = (int)min((long long)chunk, L - t0);
      const bool more = ci + 1 < nchunks;
      const int next_valid =
          more ? (int)min((long long)chunk, L - t0 - chunk) : 0;
      cp_async_wait_all();
      bar_sync_all();  // this chunk's tiles, decays and state planes are in
      const float* eg = gbuf + (ci & 1) * 3 * tl + tl;  // exp(g)
      const float* ws = eg + tl;                        // exp(g_last - g)
      if (warp == kYWarps && more)
        chunk_decays(la_row + t0 + chunk, next_valid, tl,
                     gbuf + ((ci + 1) & 1) * 3 * tl);
      // S^T = exp(g_last) S^T + (w o U)^T B, beside the y warps; unused
      // after the last chunk
      if (more) {
        const float decay = eg[tl - 1];
#pragma unroll
        for (int i = 0; i < kUnits; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) sacc[i][e >> 2][e & 3] *= decay;
        for (int ks = 0; ks < valid; ks += 16) {  // later rows hold u = 0
          float w[8];
          frag_a_values<true>(w, us, lay.ldu, 16 * sb, ks);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            w[e] *= ws[ks + 2 * q + (e & 1) + 8 * (e >> 2)];
          uint32_t a[KI][4];
          split<KI>(w, a);
#pragma unroll
          for (int i = 0; i < kUnits; ++i) {
            const int n0 = 16 * i;
            if (n0 >= nr) continue;
            uint32_t bb[2][KX][2];
            frag_b<true>(bb, bs, lay.ldx, ks, n0);
            mma_terms<KI, KX>(sacc[i][0], a, bb[0]);
            mma_terms<KI, KX>(sacc[i][1], a, bb[1]);
          }
        }
      }
      bar_sync_planes();  // the y warps have read the old planes
      if (more) {
        // the state's bf16 planes for the next chunk's C S_in
#pragma unroll
        for (int i = 0; i < kUnits; ++i) {
          if (16 * i >= nr) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // (tile, row half)
            const int n = 16 * i + 8 * (e >> 1) + 2 * q;
            const int p = 16 * sb + g + 8 * (e & 1);
            const float x[2] = {sacc[i][e >> 1][2 * (e & 1)],
                                sacc[i][e >> 1][2 * (e & 1) + 1]};
            uint32_t terms[KI][1];
            split<KI>(x, terms);
#pragma unroll
            for (int k = 0; k < KI; ++k)
              *reinterpret_cast<uint32_t*>(sp + k * plane + p * lay.lds +
                                           n) = terms[k][0];
          }
        }
        next_chunk(t0, next_valid);
      }
    }
  }
}

template <typename T>
int configure(int chunk, int N, Smem* lay) {
  *lay = smem_layout<T>(chunk, N);
  return (int)cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   lay->bytes);
}

template <typename T>
int launch(const void* u, const void* la, const void* b, const void* c,
           void* y, long long rows, int L, int P, int N, int chunk, int heads,
           cudaStream_t stream) {
  Smem lay;
  const int err = configure<T>(chunk, N, &lay);
  if (err != 0) return err;
  constexpr int E = 16 / sizeof(T);
  const bool vec = P % E == 0 && N % E == 0 && (uintptr_t)u % 16 == 0 &&
                   (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
  const bool pairs = P % 2 == 0 && (uintptr_t)y % (2 * sizeof(T)) == 0;
  const dim3 grid((unsigned)rows, (unsigned)((P + kPTile - 1) / kPTile));
  ssd_scan_kernel<T><<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(la),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      L, P, N, chunk, heads, (vec ? 1 : 0) | (pairs ? 2 : 0));
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

// Dynamic shared memory bytes a block and resident blocks an SM for
// (chunk, N, type). Returns a cudaError_t code.
int ssd_scan_occupancy(int chunk, int N, int bf16, int* smem_bytes,
                       int* blocks_per_sm) {
  if (N < 1 || N > kMaxState || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  Smem lay;
  int err = bf16 ? configure<__nv_bfloat16>(chunk, N, &lay)
                 : configure<float>(chunk, N, &lay);
  if (err != 0) return err;
  *smem_bytes = lay.bytes;
  return bf16 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, ssd_scan_kernel<__nv_bfloat16>, kThreads,
                    lay.bytes)
              : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, ssd_scan_kernel<float>, kThreads,
                    lay.bytes);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
