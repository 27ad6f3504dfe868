// Unary top-k for Hopper (sm_90a): a pruned CAS network applied gate by
// gate to every row of a bit-plane, keeping the bottom k wires; and the
// gate-level neuron, which makes its ramp bits on chip and runs the same
// network on them.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/unary_topk.py:
//   unary_topk_relocate (_topk_kernel, tables from pack_layers)
//   unary_topk_count    (its per-row sum)
// and, fused with the ramp bits, the potential and the clip count around
// it, the gate-level dendrite of src/repro/core/neuron.py (simulate_neuron
// with gate_level=True).
//
// What both compute on a row of n wires (non-zero = hot):
//   for each unit (i, j) in order:  x[i], x[j] = x[i] AND x[j], x[i] OR x[j]
//   and keep the bottom k wires x[n - k .. n - 1].
// Both bit-slice: 32 rows (or 32 ticks) share one 32-bit word per wire, so
// a unit is one AND and one OR for 32 rows. The network lives in constant
// memory (c_units, written once per network by unary_topk_put_units), one
// word i | j << 16 a unit, in layers of units on disjoint wires padded to
// 8 units (see run_network): every lane of a warp reads the same unit, a
// broadcast from the constant cache. The TPU kernel packs the units into
// layers too and applies each as a lane gather plus min / max / select.
//
// 1. unary_topk_kernel: bits (rows, n) bytes -> (rows, k) int8 or (rows,)
//    int32 counts. Bound by bytes: each input byte is read once and the
//    logic per 32 rows is two operations a unit. The design:
//    * a block of four warps owns tiles of 1,024 rows (32 groups of 32
//      rows), tiles dealt round-robin over a grid sized to the SMs. A tile
//      arrives in pieces of 32 G rows (at most 4 KB, at least four a tile)
//      through a ring of P pieces in shared memory, each filled by the
//      bulk asynchronous copy (cp.async.bulk, completion on one mbarrier a
//      piece). Warp w bit-slices pieces w, w + 4, ... and, as soon as it
//      has, refills the slot with the piece P ahead, so the next tile
//      loads while this one is sliced and run through the network. A
//      plane whose address is not 16-byte aligned is copied by the warps'
//      lanes instead (same layout, no overlap).
//    * bit-slicing from shared memory: lane l reads row l of a group (16,
//      4 or 1 bytes a load), squeezes it to a mask of its wires, and a
//      32 x 32 bit transpose across the warp (5 shuffle rounds, four
//      transposes interleaved) gives lane c the word of wire c. For
//      n <= 16 (n <= 8) two (four) groups share one transpose. The words
//      go to shared memory, wire-major, group g in column g, with a row
//      stride of 32 + pack words so that the transposes' stores and the
//      network's loads hit 32 banks.
//    * the network and the output: warp 0, lane g on group g's words. The
//      count is summed bit-sliced over the bottom k words and transposed
//      back, so lane l holds the count of row 32 g + l for every g: 32
//      coalesced stores a lane.
// 2. gate_level_kernel: times (C, B, n) and weights (C, Q, n) int32 ->
//    potential (C, B, Q, T) and clip count (C, B, Q) int32. Wire i of the
//    pair (c, b, q) is hot at tick t iff times[i] <= t < times[i] + w[i],
//    so a chunk of 32 ticks makes wire i's word as one shifted mask from
//    two numbers: the bit-plane is never written to memory. Bound by the
//    bytes of its output, the potential trace. The design:
//    * a block stages a tile of (column, volley, neuron) pairs' times and
//      weights in shared memory (cp.async, every load in flight at once);
//      one thread owns one pair and walks its ticks 32 at a time,
//      carrying the potential.
//    * per chunk: the n ramp words (into shared memory, wire-major, thread
//      fastest), a saturating bit-sliced counter over them for
//      "popcount > k" (the clip count), the network on the words (skipped
//      when no lane of the warp has a hot bit), a bit-sliced sum of the
//      bottom k words for the per-tick increment, and its running sum.
//    * the potential leaves through a per-warp shared tile, 32 pairs x 32
//      ticks, four rows of 128 contiguous bytes a store.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerTile = kLanes * 32;  // unary_topk.ROWS_PER_BLOCK
constexpr int kMaxWires = 256;             // unary_topk.MAX_WIRES
constexpr int kWarps = 4;                  // warps a block (bit-plane)
constexpr int kPieceBytes = 4096;          // most bytes a ring piece
constexpr int kRingBytes = 32768;          // target ring bytes a block
constexpr int kArenaUnits = 16000;         // constant words for networks
constexpr int kNoSpike = 1 << 30;          // coding.NO_SPIKE

__constant__ uint32_t c_units[kArenaUnits];

// ------------------------------------------------------------ bit helpers

// 4 bytes -> 4 bits, bit q set iff byte q is non-zero.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  const uint32_t hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (hi * 0x00204081u) >> 28;
}

// Wires [lo, lo + cnt) of one row in shared memory as a mask, cnt <= 32
// (bit b = wire lo + b). kVec is the bytes per load: 16 needs n % 16 ==
// 0, 4 needs n % 4 == 0 (rows then start on such a boundary).
template <int kVec>
__device__ __forceinline__ uint32_t row_mask(const uint8_t* row, int lo,
                                             int cnt) {
  uint32_t m = 0;
  if (kVec == 16) {
#pragma unroll
    for (int v = 0; v < 32; v += 16) {
      if (v < cnt) {
        const uint4 q = *reinterpret_cast<const uint4*>(row + lo + v);
        m |= (nibble(q.x) | nibble(q.y) << 4 |
              nibble(q.z) << 8 | nibble(q.w) << 12)
             << v;
      }
    }
  } else if (kVec == 4) {
#pragma unroll
    for (int v = 0; v < 32; v += 4)
      if (v < cnt)
        m |= nibble(*reinterpret_cast<const uint32_t*>(row + lo + v))
             << v;
  } else {
    for (int v = 0; v < cnt; ++v) m |= (uint32_t)(row[lo + v] != 0) << v;
  }
  return m;
}

// V independent 32 x 32 bit transposes across a warp, interleaved round by
// round: on entry lane r holds row r of each (bit c = element (r, c)), on
// exit lane c holds column c (bit r = element (r, c)). Round j swaps bit j
// of the lane index with bit j of the bit index.
template <int V>
__device__ __forceinline__ void transpose32(uint32_t (&x)[V], int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t m = j == 16  ? 0x0000ffffu
                       : j == 8 ? 0x00ff00ffu
                       : j == 4 ? 0x0f0f0f0fu
                       : j == 2 ? 0x33333333u
                                : 0x55555555u;  // bits c with bit j of c clear
    uint32_t y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = __shfl_xor_sync(0xffffffffu, x[v], j);
#pragma unroll
    for (int v = 0; v < V; ++v)
      x[v] = (lane & j) ? (x[v] & ~m) | ((y[v] >> j) & m)
                        : (x[v] & m) | ((y[v] << j) & ~m);
  }
}

// ----------------------------------------------------- mbarrier and copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Lane 0 of a warp: copy `bytes` from global `src` (16-byte aligned) to
// shared `dst` (16-byte aligned) and complete the copy on `bar`. The bulk
// copy moves a multiple of 16 bytes; the last few bytes of a ragged piece
// are stored by this lane before it arrives.
__device__ __forceinline__ void bulk_load(uint8_t* dst, const uint8_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b16 = bytes & ~15u;
  for (uint32_t b = b16; b < bytes; ++b) dst[b] = src[b];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(b16)
               : "memory");
  if (b16)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(b16), "r"(smem_addr(bar))
        : "memory");
}

// One 4-byte asynchronous copy from global to shared memory (cp.async;
// completed by cp.async.wait_all).
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// ---------------------------------------------------------- the network

// Applies the network at c_units[off, off + n_words) to the words at
// w[i * stride] (wire i). The host stores it in layers of units on
// disjoint wires (each unit at the earliest layer its wires allow, so
// every wire sees its units in order: the same function), each layer
// padded to a multiple of 8 with units that join the spare wire n to
// itself (a no-op). Eight units at a time: all their loads, then all
// their stores, so a layer costs one round trip to shared memory.
template <int kStride>
__device__ __forceinline__ void run_network(uint32_t* w, int off,
                                            int n_words) {
  uint32_t e[8];  // this chunk's units, read one chunk ahead
#pragma unroll
  for (int v = 0; v < 8; ++v) e[v] = n_words ? c_units[off + v] : 0u;
  for (int u = off; u < off + n_words; u += 8) {
    uint32_t next[8], a[8], b[8], oi[8], oj[8];
    const bool more = u + 8 < off + n_words;
#pragma unroll
    for (int v = 0; v < 8; ++v) next[v] = more ? c_units[u + 8 + v] : 0u;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      oi[v] = (e[v] & 0xffffu) * kStride;
      oj[v] = (e[v] >> 16) * kStride;
      a[v] = w[oi[v]];
      b[v] = w[oj[v]];
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      w[oi[v]] = a[v] & b[v];
      w[oj[v]] = a[v] | b[v];
      e[v] = next[v];
    }
  }
}

// Adds word x to the bit-sliced counter c (kL bits a tick) and keeps in
// ovf the ticks whose count passed 2^kL - 1.
template <int kL>
__device__ __forceinline__ void count_add(uint32_t (&c)[kL], uint32_t& ovf,
                                          uint32_t x) {
#pragma unroll
  for (int b = 0; b < kL; ++b) {
    const uint32_t carry = c[b] & x;
    c[b] ^= x;
    x = carry;
  }
  ovf |= x;
}

// Ticks whose bit-sliced count c is at least K (K < 2^kL).
template <int kL>
__device__ __forceinline__ uint32_t count_ge(const uint32_t (&c)[kL],
                                             int K) {
  uint32_t gt = 0, eq = 0xffffffffu;
#pragma unroll
  for (int b = kL - 1; b >= 0; --b) {
    if ((K >> b) & 1) {
      eq &= c[b];
    } else {
      gt |= eq & c[b];
      eq &= ~c[b];
    }
  }
  return gt | eq;
}

// ------------------------------------------------- 1. the bit-plane kernel

// Shared memory of one block: the ring's P mbarriers, the ring of P
// pieces, then the tile's words ((n + 1) wires x (32 + pack) words).
struct PlaneLayout {
  int groups;       // G: row groups a piece (a tile has 32 / G pieces)
  int ring;         // P: pieces in the block's ring, a multiple of kWarps
  int piece_bytes;  // 32 G n
  size_t rings, words, total;
};

__host__ __device__ inline int plane_pack(int n) {
  return n <= 8 ? 4 : n <= 16 ? 2 : 1;
}

__host__ __device__ inline PlaneLayout plane_layout(int n) {
  PlaneLayout L;
  int g = 32 / kWarps;  // at least kWarps pieces a tile
  while (g > 1 && g * 32 * n > kPieceBytes) g >>= 1;
  L.groups = g;
  L.piece_bytes = 32 * g * n;
  const int ring = kRingBytes / L.piece_bytes / kWarps * kWarps;
  L.ring = ring < kWarps ? kWarps : ring > 16 ? 16 : ring;
  L.rings = 128;  // the ring's mbarriers first (P <= 16)
  L.words = L.rings + (size_t)L.ring * L.piece_bytes;
  L.total = L.words +  // n wires and the spare one
            (size_t)(n + 1) * (kLanes + plane_pack(n)) * sizeof(uint32_t);
  return L;
}

template <int kVec, bool kCount, int kPack, int kL>
__global__ void __launch_bounds__(kWarps * kLanes)
    unary_topk_kernel(const uint8_t* __restrict__ bits, int units_off,
                      int n_words, void* __restrict__ out, long long rows,
                      int n, int k, long long tiles, int bulk) {
  constexpr int kStride = kLanes + kPack;  // words a wire
  constexpr int kWidth = kLanes / kPack;   // wire bits a group's mask
  extern __shared__ __align__(128) uint8_t smem[];
  const PlaneLayout L = plane_layout(n);
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + L.rings;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + L.words);
  const int pieces = kLanes / L.groups;  // pieces a tile: kWarps or more
  const int piece_rows = L.groups * kLanes;

  // piece s of this block's stream: piece s % pieces of tile blockIdx.x +
  // (s / pieces) * gridDim.x, in ring slot s % P; warp s % kWarps slices
  // it and refills its slot with piece s + P (P and pieces are multiples
  // of kWarps, so a slot always belongs to the same warp)
  auto fetch = [&](long long s) {
    const long long tile = blockIdx.x + s / pieces * (long long)gridDim.x;
    const long long r0 = tile * kRowsPerTile + s % pieces * piece_rows;
    if (tile >= tiles || r0 >= rows) return;
    const long long nr = rows - r0 < piece_rows ? rows - r0 : piece_rows;
    const int slot = (int)(s % L.ring);
    bulk_load(ring + (size_t)slot * L.piece_bytes, bits + r0 * n,
              (uint32_t)(nr * n), bars + slot);
  };
  if (bulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < L.ring; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (lane == 0)
      for (int s = warp; s < L.ring; s += kWarps) fetch(s);
  }

  long long s0 = 0;  // the stream number of this tile's first piece
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, s0 += pieces) {
    const long long base = tile * kRowsPerTile;
    for (int j = warp; j < pieces; j += kWarps) {
      const long long s = s0 + j;
      const long long r0 = base + (long long)j * piece_rows;
      const int valid =  // rows of the piece before the plane's end
          r0 >= rows ? 0 : rows - r0 < piece_rows ? (int)(rows - r0)
                                                  : piece_rows;
      const int slot = (int)(s % L.ring);
      uint8_t* piece = ring + (size_t)slot * L.piece_bytes;
      if (valid && bulk) {
        mbar_wait(bars + slot, (uint32_t)((s / L.ring) & 1));
      } else if (valid) {
        const uint8_t* src = bits + r0 * n;
        for (int b = lane; b < valid * n; b += kLanes) piece[b] = src[b];
        __syncwarp();
      }
      // bit-slice the piece: a job is kPack groups x 32 wires, one
      // transpose; four jobs at a time, their transposes interleaved
      int gg = 0, lo = 0;  // the next job
      while (gg < L.groups) {
        uint32_t x[4];
        int jg[4], jl[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          jg[v] = gg;
          jl[v] = lo;
          x[v] = 0;
          const int cnt = n - lo < kLanes ? n - lo : kLanes;
#pragma unroll
          for (int p = 0; p < kPack; ++p) {
            const int rl = (gg + p) * kLanes + lane;  // row in the piece
            if (gg < L.groups && rl < valid)
              x[v] |= row_mask<kVec>(piece + (size_t)rl * n, lo, cnt)
                      << (p * kWidth);
          }
          lo += kLanes;
          if (lo >= n) {
            lo = 0;
            gg += kPack;
          }
        }
        transpose32<4>(x, lane);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int wire = jl[v] + lane % kWidth;
          if (jg[v] < L.groups && wire < n)
            words[wire * kStride + j * L.groups + jg[v] + lane / kWidth] =
                x[v];
        }
      }
      __syncwarp();
      if (bulk && lane == 0) fetch(s + L.ring);
    }
    __syncthreads();

    if (warp == 0) {
      run_network<kStride>(words + lane, units_off, n_words);
      __syncwarp();
      // out: lane g sums its group's bottom k words bit-sliced (or takes
      // them one by one for relocate); a transpose hands lane l the bits
      // of row 32 g + l for every group g: 32 coalesced stores a lane
      if (kCount) {
        uint32_t c[kL] = {}, unused = 0;
        for (int q = n - k; q < n; ++q)
          count_add<kL>(c, unused, words[q * kStride + lane]);
        transpose32<kL>(c, lane);
#pragma unroll
        for (int g = 0; g < kLanes; ++g) {
          const long long r = base + (long long)g * kLanes + lane;
          int cnt = 0;
#pragma unroll
          for (int b = 0; b < kL; ++b) cnt |= ((c[b] >> g) & 1u) << b;
          if (r < rows) static_cast<int*>(out)[r] = cnt;
        }
      } else {
        for (int q = 0; q < k; ++q) {
          uint32_t t[1] = {words[(n - k + q) * kStride + lane]};
          transpose32<1>(t, lane);
#pragma unroll 8
          for (int g = 0; g < kLanes; ++g) {
            const long long r = base + (long long)g * kLanes + lane;
            if (r < rows)
              static_cast<int8_t*>(out)[r * k + q] =
                  (int8_t)((t[0] >> g) & 1u);
          }
        }
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------- 2. the gate-level neuron kernel

__host__ __device__ inline int gate_threads(int n) {
  return n <= 32 ? 128 : n <= 128 ? 64 : 32;
}

struct GateTile {
  int tc, tb, tq;  // columns, volleys, neurons a block
  long long nct, nbt, nqt, blocks;
  size_t smem;
};

__host__ inline GateTile gate_tile(long long C, long long B, long long Q,
                                   int n, int nt) {
  GateTile T;
  T.tq = (int)(Q < nt ? Q : nt);
  T.tb = (int)(B < nt / T.tq ? B : nt / T.tq);
  const long long tc = nt / (T.tq * T.tb);
  T.tc = (int)(C < tc ? C : tc);
  T.nct = (C + T.tc - 1) / T.tc;
  T.nbt = (B + T.tb - 1) / T.tb;
  T.nqt = (Q + T.tq - 1) / T.tq;
  T.blocks = T.nct * T.nbt * T.nqt;
  const int st = n | 1;
  T.smem = sizeof(int) * ((size_t)T.tc * (T.tb + T.tq) * st +
                          (size_t)(n + 1) * nt + (size_t)nt * 36);
  return T;
}

template <int kL, int kNT>
__global__ void __launch_bounds__(kNT)
    gate_level_kernel(const int* __restrict__ times,
                      const int* __restrict__ weights, int units_off,
                      int n_words, int* __restrict__ pot,
                      int* __restrict__ clip, long long C, long long B,
                      long long Q, int n, int k, int t_steps, int tc, int tb,
                      int tq, long long nbt, long long nqt) {
  extern __shared__ __align__(16) int gsmem[];
  const int st = n | 1;  // odd row stride: distinct rows, distinct banks
  int* s_out = gsmem;                                // [kNT][36] ticks
  int* s_t = s_out + kNT * 36;                       // [tc * tb][st]
  int* s_w = s_t + (size_t)tc * tb * st;             // [tc * tq][st]
  uint32_t* words =                                  // [n + 1][kNT]
      reinterpret_cast<uint32_t*>(s_w + (size_t)tc * tq * st);
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;

  const long long blk = blockIdx.x;
  const long long qt = blk % nqt, bt = (blk / nqt) % nbt,
                  ct = blk / (nqt * nbt);
  const long long c0 = ct * tc, b0 = bt * tb, q0 = qt * tq;
  // every staging load in flight at once: asynchronous 4-byte copies
  for (int i = tid; i < tc * tb * n; i += kNT) {
    const int r = i / n, wi = i % n;
    const long long c = c0 + r / tb, b = b0 + r % tb;
    if (c < C && b < B)
      copy_async4(s_t + r * st + wi, times + ((c * B) + b) * n + wi);
    else
      s_t[r * st + wi] = kNoSpike;
  }
  for (int i = tid; i < tc * tq * n; i += kNT) {
    const int r = i / n, wi = i % n;
    const long long c = c0 + r / tq, q = q0 + r % tq;
    if (c < C && q < Q)
      copy_async4(s_w + r * st + wi, weights + ((c * Q) + q) * n + wi);
    else
      s_w[r * st + wi] = 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int qq = tid % tq, bb = (tid / tq) % tb, cc = tid / (tq * tb);
  const long long c = c0 + cc, b = b0 + bb, q = q0 + qq;
  const bool active = cc < tc && c < C && b < B && q < Q;
  const long long row = active ? (c * B + b) * Q + q : 0;
  const int* trow = s_t + (active ? (cc * tb + bb) * st : 0);
  const int* wrow = s_w + (active ? (cc * tq + qq) * st : 0);
  uint32_t* w = words + tid;
  int* tile = s_out + warp * 32 * 36;  // the warp's 32 pairs x 32 ticks

  int p = 0, clipped = 0;
  for (int t0 = 0; t0 < t_steps; t0 += 32) {
    const int len = t_steps - t0 < 32 ? t_steps - t0 : 32;
    const int tend = t0 + len;
    uint32_t cnt[kL] = {}, ovf = 0, any = 0;
    for (int i = 0; i < n; ++i) {
      const int s = trow[i];
      const int e = (int)((unsigned)s + (unsigned)wrow[i]);  // int32 wrap
      const int lo = s > t0 ? s : t0, hi = e < tend ? e : tend;
      const uint32_t x = active && hi > lo
                             ? (0xffffffffu >> (32 - (hi - lo))) << (lo - t0)
                             : 0u;
      w[i * kNT] = x;
      any |= x;
      count_add<kL>(cnt, ovf, x);
    }
    clipped += __popc(ovf | count_ge<kL>(cnt, k + 1));

    uint32_t inc[kL] = {}, unused = 0;
    if (__any_sync(0xffffffffu, any != 0)) {
      run_network<kNT>(w, units_off, n_words);
      for (int i = n - k; i < n; ++i) count_add<kL>(inc, unused, w[i * kNT]);
    }
    // the running sum, tick by tick, into this pair's row of the tile
#pragma unroll
    for (int t4 = 0; t4 < 32; t4 += 4) {
      int v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int d = 0;
#pragma unroll
        for (int bit = 0; bit < kL; ++bit)
          d |= ((inc[bit] >> (t4 + t)) & 1u) << bit;
        p += d;
        v[t] = p;
      }
      *reinterpret_cast<int4*>(tile + lane * 36 + t4) =
          make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();
    // out: the tile row by row, each row's ticks contiguous in memory
    if (len == 32 && (t_steps & 3) == 0) {  // 16-byte aligned rows
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // four rows a store, eight lanes each
        const int r = 4 * i + lane / 8;
        const long long rr = __shfl_sync(0xffffffffu, row, r);
        const int ar = __shfl_sync(0xffffffffu, (int)active, r);
        const int4 val =
            *reinterpret_cast<const int4*>(tile + r * 36 + 4 * (lane % 8));
        if (ar)
          *reinterpret_cast<int4*>(pot + rr * t_steps + t0 + 4 * (lane % 8)) =
              val;
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const long long rr = __shfl_sync(0xffffffffu, row, r);
        const int ar = __shfl_sync(0xffffffffu, (int)active, r);
        if (ar && lane < len) pot[rr * t_steps + t0 + lane] = tile[r * 36 + lane];
      }
    }
    __syncwarp();
  }
  if (active) clip[row] = clipped;
}

// ------------------------------------------------------------ launchers

constexpr int kMaxDevices = 64;

// Per kernel and device, set once: the dynamic shared memory limit raised
// to the card's opt-in maximum, and the SM count.
struct KernelState {
  int ready[kMaxDevices] = {};
  int sms[kMaxDevices] = {};
  size_t occ_smem[kMaxDevices] = {};  // shared bytes of the cached per_sm
  int per_sm[kMaxDevices] = {};
};

template <typename K>
int prepare(KernelState& ks, K kernel, int threads, size_t smem, int& dev,
            int* per_sm) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ks.ready[dev]) {
    int optin = 0, sms = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    ks.sms[dev] = sms > 0 ? sms : 1;
    ks.ready[dev] = 1;
  }
  if (per_sm) {
    if (ks.occ_smem[dev] != smem || ks.per_sm[dev] < 1) {
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          threads, smem);
      if (err != cudaSuccess) return (int)err;
      if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
      ks.per_sm[dev] = blocks;
      ks.occ_smem[dev] = smem;
    }
    *per_sm = ks.per_sm[dev];
  }
  return 0;
}

template <int kVec, bool kCount, int kPack, int kL>
int launch_plane(const uint8_t* bits, int units_off, int n_units, void* out,
                 long long rows, int n, int k, long long tiles, int bulk,
                 cudaStream_t st) {
  static KernelState ks;
  auto kernel = unary_topk_kernel<kVec, kCount, kPack, kL>;
  const size_t smem = plane_layout(n).total;
  int dev = 0, per_sm = 0;
  const int code = prepare(ks, kernel, kWarps * kLanes, smem, dev, &per_sm);
  if (code) return code;
  const long long most = (long long)ks.sms[dev] * per_sm;
  const int grid = (int)(tiles < most ? tiles : most);
  kernel<<<grid, kWarps * kLanes, smem, st>>>(bits, units_off, n_units, out,
                                              rows, n, k, tiles, bulk);
  return (int)cudaGetLastError();
}

template <int kVec, int kPack>
int launch_out(const uint8_t* bits, int units_off, int n_units, void* out,
               long long rows, int n, int k, int count, long long tiles,
               int bulk, cudaStream_t st) {
  if (!count)
    return launch_plane<kVec, false, kPack, 1>(
        bits, units_off, n_units, out, rows, n, k, tiles, bulk, st);
  if (k <= 7)
    return launch_plane<kVec, true, kPack, 3>(
        bits, units_off, n_units, out, rows, n, k, tiles, bulk, st);
  return launch_plane<kVec, true, kPack, 9>(
      bits, units_off, n_units, out, rows, n, k, tiles, bulk, st);
}

template <int kVec>
int launch_pack(const uint8_t* bits, int units_off, int n_units, void* out,
                long long rows, int n, int k, int count, long long tiles,
                int bulk, cudaStream_t st) {
  const int pack = plane_pack(n);
  if constexpr (kVec != 16) {  // n % 16 == 0 means n >= 16: no pack of 4
    if (pack == 4)
      return launch_out<kVec, 4>(bits, units_off, n_units, out, rows,
                                        n, k, count, tiles, bulk, st);
  }
  if (pack == 2)
    return launch_out<kVec, 2>(bits, units_off, n_units, out, rows, n,
                                      k, count, tiles, bulk, st);
  return launch_out<kVec, 1>(bits, units_off, n_units, out, rows, n,
                                    k, count, tiles, bulk, st);
}

template <int kL, int kNT>
int launch_gate(const int* times, const int* weights, int units_off,
                int n_units, int* pot, int* clip, long long C, long long B,
                long long Q, int n, int k, int t_steps, cudaStream_t st) {
  static KernelState ks;
  const GateTile T = gate_tile(C, B, Q, n, kNT);
  if (T.blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gate_level_kernel<kL, kNT>;
  int dev = 0;
  const int code = prepare(ks, kernel, kNT, T.smem, dev, nullptr);
  if (code) return code;
  kernel<<<(unsigned)T.blocks, kNT, T.smem, st>>>(
      times, weights, units_off, n_units, pot, clip, C, B, Q, n, k, t_steps,
      T.tc, T.tb, T.tq, T.nbt, T.nqt);
  return (int)cudaGetLastError();
}

template <int kL>
int launch_gate_nt(const int* times, const int* weights, int units_off,
                   int n_units, int* pot, int* clip, long long C, long long B,
                   long long Q, int n, int k, int t_steps, cudaStream_t st) {
  switch (gate_threads(n)) {
    case 128:
      return launch_gate<kL, 128>(times, weights, units_off, n_units, pot,
                                  clip, C, B, Q, n, k, t_steps, st);
    case 64:
      return launch_gate<kL, 64>(times, weights, units_off, n_units, pot,
                                 clip, C, B, Q, n, k, t_steps, st);
    default:
      return launch_gate<kL, 32>(times, weights, units_off, n_units, pot,
                                 clip, C, B, Q, n, k, t_steps, st);
  }
}

bool units_ok(int units_off, int n_units) {
  return units_off >= 0 && n_units >= 0 && units_off + n_units <= kArenaUnits;
}

}  // namespace

extern "C" {

// Capacity of the constant-memory arena that holds the networks, in words.
int unary_topk_arena_units() { return kArenaUnits; }

// Writes a network of `count` words from host memory at word `offset` of
// the arena: its units (i | j << 16 each) in layers of units on disjoint
// wires, each layer padded to a multiple of 8 units with no-op units on the
// spare wire n (see run_network). The copy runs on the legacy default
// stream and, from pageable memory, may return before the words reach the
// card; the device synchronise after it makes every later launch, on any
// stream, see them (once per network and device). Returns a cudaError_t
// code.
int unary_topk_put_units(const uint32_t* host, int count, int offset) {
  if (count <= 0) return 0;
  if (!units_ok(offset, count)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemcpyToSymbol(c_units, host, sizeof(uint32_t) * count,
                         sizeof(uint32_t) * offset, cudaMemcpyHostToDevice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

// bits (rows, n) bytes; the network is words [units_off, units_off +
// n_units) of the arena; out (rows,) int32 when count, else (rows, k)
// int8. vec: bytes per load (16, 4 or 1) that n allows. tiles: ceil(rows
// / 1024). Returns a cudaError_t code.
int unary_topk_launch(const void* bits, int units_off, int n_units,
                      void* out, long long rows, int n, int k, int vec,
                      int count, long long tiles, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || n > kMaxWires || k < 1 || k > n ||
      !units_ok(units_off, n_units) || tiles <= 0 ||
      tiles > (long long)INT_MAX * kWarps || tiles * kRowsPerTile < rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bits;
  const int bulk = ((uintptr_t)bits % 16) == 0;
  if (vec == 16 && n % 16 == 0)
    return launch_pack<16>(b, units_off, n_units, out, rows, n, k, count,
                           tiles, bulk, st);
  if (vec == 4 && n % 4 == 0)
    return launch_pack<4>(b, units_off, n_units, out, rows, n, k, count,
                          tiles, bulk, st);
  if (vec == 1)
    return launch_pack<1>(b, units_off, n_units, out, rows, n, k, count,
                          tiles, bulk, st);
  return (int)cudaErrorInvalidValue;
}

// times (C, B, n) and weights (C, Q, n) int32, contiguous; the network is
// words [units_off, units_off + n_units) of the arena; pot (C, B, Q,
// t_steps) and clip (C, B, Q) int32. Returns a cudaError_t code.
int gate_level_launch(const int* times, const int* weights, int units_off,
                      int n_units, int* pot, int* clip, long long C,
                      long long B, long long Q, int n, int k, int t_steps,
                      void* stream) {
  if (C <= 0 || B <= 0 || Q <= 0 || t_steps <= 0) return 0;
  if (n < 1 || n > kMaxWires || k < 1 || k > n ||
      !units_ok(units_off, n_units))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 6)
    return launch_gate_nt<3>(times, weights, units_off, n_units, pot, clip,
                             C, B, Q, n, k, t_steps, st);
  return launch_gate_nt<9>(times, weights, units_off, n_units, pot, clip, C,
                           B, Q, n, k, t_steps, st);
}

const char* unary_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
