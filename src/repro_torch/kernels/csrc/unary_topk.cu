// Unary top-k for Hopper (sm_90a): a pruned CAS network applied gate by
// gate to every row of a bit-plane, keeping the bottom k wires.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/unary_topk.py:
//   unary_topk_relocate (_topk_kernel, tables from pack_layers)
//   unary_topk_count    (its per-row sum)
//
// What it computes, per row r of bits (rows, n), one byte per wire
// (non-zero = hot):
//   for each unit (i, j) in order:  x[i], x[j] = x[i] AND x[j], x[i] OR x[j]
//   relocate: out[r, q] = x[n - k + q]           (rows, k) int8
//   count:    out[r]    = sum_q x[n - k + q]     (rows,) int32
// The TPU kernel packs the units into layers of disjoint wire pairs and
// applies each layer as a lane gather plus min / max / select; greedy
// packing keeps the order, so applying the units one by one is the same
// function.
//
// What bounds it on this card: bytes. Every input byte is read once and
// the work per row is two logic operations per unit on a bit, so once 32
// rows share a 32-bit word (bit-slicing) the logic is ~30x below the
// memory time at the serving shapes. The design:
//   * one warp per block; lane g owns rows row0 + 32g .. row0 + 32g + 31,
//     bit-sliced: one 32-bit word per wire, bit l = row row0 + 32g + l,
//     kept in shared memory, wire-major with the lane fastest (the lanes
//     of a warp hit 32 distinct banks). Wire indices are runtime values,
//     so a register array indexed by them would go to local memory.
//   * transpose in: for each row group g the lanes load one row each
//     (coalesced, 16 bytes a lane where n and the pointer allow it),
//     squeeze its bytes to a bit mask, and one __ballot_sync per wire
//     yields group g's word, which lane g stores. Eight groups are loaded
//     ahead of the ballots to keep enough bytes in flight.
//   * the network: each lane walks the unit list (uniform reads from a
//     table in device memory, i | j << 16) and applies AND / OR to its own
//     words: 2 logic operations per unit per 32 rows.
//   * transpose out: per row group, every lane reads the group's k bottom
//     words (a shared-memory broadcast) and takes its own bit; the count
//     is one coalesced int32 store per row.
// Ragged last block: rows past the end load as silent and store nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = kLanes * 32;  // unary_topk.ROWS_PER_BLOCK
constexpr int kMaxWires = 256;              // unary_topk.MAX_WIRES
constexpr int kAhead = 8;                   // row groups loaded ahead

// 4 bytes -> 4 bits, bit q set iff byte q is non-zero.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// Wires [lo, lo + cnt) of one row as a mask, cnt <= 32 (bit b = wire
// lo + b). kVec is the bytes per load: 16 needs n % 16 == 0 and a 16-byte
// aligned plane, 4 needs n % 4 == 0 and 4-byte alignment.
template <int kVec>
__device__ __forceinline__ uint32_t row_bits(const uint8_t* __restrict__ row,
                                             int lo, int cnt) {
  uint32_t m = 0;
  if (kVec == 16) {
    for (int v = 0; v < cnt; v += 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + lo + v));
      m |= (nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 |
            nibble(q.w) << 12)
           << v;
    }
  } else if (kVec == 4) {
    for (int v = 0; v < cnt; v += 4)
      m |= nibble(__ldg(reinterpret_cast<const uint32_t*>(row + lo + v)))
           << v;
  } else {
    for (int v = 0; v < cnt; ++v) m |= (uint32_t)(row[lo + v] != 0) << v;
  }
  return m;
}

template <int kVec, bool kCount>
__global__ void __launch_bounds__(kLanes)
    unary_topk_kernel(const uint8_t* __restrict__ bits,
                      const int* __restrict__ units, int n_units,
                      void* __restrict__ out, long long rows, int n, int k) {
  extern __shared__ uint32_t s_words[];  // [n][kLanes]
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;

  // transpose in: row group g -> lane g's words
  for (int lo = 0; lo < n; lo += 32) {
    const int cnt = min(32, n - lo);
    for (int g0 = 0; g0 < 32; g0 += kAhead) {
      uint32_t m[kAhead];
#pragma unroll
      for (int p = 0; p < kAhead; ++p) {
        const long long r = row0 + (long long)(g0 + p) * kLanes + lane;
        m[p] = r < rows ? row_bits<kVec>(bits + r * n, lo, cnt) : 0u;
      }
#pragma unroll
      for (int p = 0; p < kAhead; ++p) {
        const bool mine = lane == g0 + p;
#pragma unroll 8
        for (int b = 0; b < cnt; ++b) {
          const uint32_t word = __ballot_sync(0xffffffffu, (m[p] >> b) & 1u);
          if (mine) s_words[(lo + b) * kLanes + lane] = word;
        }
      }
    }
  }

  // the network on this lane's 32 rows (its own words: no sync needed)
  uint32_t* w = s_words + lane;
  for (int u = 0; u < n_units; ++u) {
    const int ij = __ldg(units + u);
    const int i = (ij & 0xffff) * kLanes, j = (ij >> 16) * kLanes;
    const uint32_t a = w[i], c = w[j];
    w[i] = a & c;
    w[j] = a | c;
  }
  __syncwarp();

  // transpose out: the bottom k wires of row group g, one row per lane
  const uint32_t* bottom = s_words + (n - k) * kLanes;
  for (int g = 0; g < 32; ++g) {
    const long long r = row0 + (long long)g * kLanes + lane;
    if (r >= rows) break;
    if (kCount) {
      int cnt = 0;
      for (int q = 0; q < k; ++q) cnt += (bottom[q * kLanes + g] >> lane) & 1u;
      static_cast<int*>(out)[r] = cnt;
    } else {
      int8_t* o = static_cast<int8_t*>(out) + r * k;
      for (int q = 0; q < k; ++q)
        o[q] = (int8_t)((bottom[q * kLanes + g] >> lane) & 1u);
    }
  }
}

template <int kVec>
void launch(const void* bits, const void* units, int n_units, void* out,
            long long rows, int n, int k, int count, long long blocks,
            cudaStream_t st) {
  const size_t smem = (size_t)n * kLanes * sizeof(uint32_t);
  if (count)
    unary_topk_kernel<kVec, true><<<(unsigned)blocks, kLanes, smem, st>>>(
        (const uint8_t*)bits, (const int*)units, n_units, out, rows, n, k);
  else
    unary_topk_kernel<kVec, false><<<(unsigned)blocks, kLanes, smem, st>>>(
        (const uint8_t*)bits, (const int*)units, n_units, out, rows, n, k);
}

}  // namespace

extern "C" {

// bits (rows, n) bytes; units n_units ints (i | j << 16); out (rows,) int32
// when count, else (rows, k) int8. vec: bytes per load (16, 4 or 1) that
// n and the alignment of bits allow. blocks: ceil(rows / 1024). Returns a
// cudaError_t code.
int unary_topk_launch(const void* bits, const void* units, int n_units,
                      void* out, long long rows, int n, int k, int vec,
                      int count, long long blocks, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || n > kMaxWires || k < 1 || k > n || n_units < 0 ||
      blocks <= 0 || blocks > INT_MAX || blocks * kRowsPerBlock < rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec == 16 && n % 16 == 0)
    launch<16>(bits, units, n_units, out, rows, n, k, count, blocks, st);
  else if (vec == 4 && n % 4 == 0)
    launch<4>(bits, units, n_units, out, rows, n, k, count, blocks, st);
  else if (vec == 1)
    launch<1>(bits, units, n_units, out, rows, n, k, count, blocks, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* unary_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
