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
// What bounds it on this card: integer operations. Each live line-tick is
// a subtract, a compare and an add on the int32 ALUs (64 per SM on Hopper,
// so a warp-wide int32 instruction issues every other cycle); the bytes
// are one read of times and weights and one write of the fire times, tiny
// next to the sweep. At the TNN shapes (n = 16-28 lines, T = 32) the sweep
// is a few hundred operations a pair, so the fixed costs (launch, staging,
// the scan) weigh as much as the tests, and a design must avoid a long
// serial chain per thread.
//
// Two kernels; both keep the (unsigned) window test per line and tick,
// sums that wrap in 32 bits as the reference's int32 does, and the early
// stop at the first crossing when no clip output is wanted. The sweep
// bound is one pass over the lines, taken only when T > 32: below that
// there is one 32-tick step whatever the bound, and the ticks in
// [t_hi, T) count no ramp bit, so they change neither the fire time nor
// the clip count.
//
// Tile kernel, rows of at most 128 lines (every TNN shape). A block stages
// one column's tile of volleys and neurons in shared memory, every load in
// flight at once; compacts each volley's lines to those with time < T (the
// others count no tick, and the reference's bound counts only live lines);
// and gathers each pair's weights to them. A warp then sweeps 8 pairs at
// once, 4 lanes a pair and 8 ticks a lane: each lane keeps 8 raw counts in
// registers (8 independent chains), the potential is a prefix over the
// lane's own ticks plus a 2-step shuffle scan over the pair's 4 lanes, and
// the first crossing is the pair's first lane with one (a ballot) and that
// lane's first tick. Tiles shrink until there are enough of them to fill
// the card.
//
// Stream kernel, longer rows. One pair per warp, lanes over ticks; its
// lines are staged (time, weight) side by side in a fixed 128-line buffer
// of the warp's own and restaged 128 lines at a time. The prefix of the
// increments is one ballot per bit plane of the largest increment (the bit
// length of min(k, n), or of n without clipping) and a popcount of the
// lanes at or below, so the step's total comes with it for the carry.
//
// Neither kernel's shared memory grows past a fixed size with n, so no
// bank size is refused, and tiles and pairs are numbered flat in 64 bits
// with the grid striding over them, so no grid dimension limits B, Q or C.
// The compact variant stages its per-volley weight rows the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoSpike = 1 << 30;
constexpr int kWarps = 8;                 // warps per block
constexpr int kTileLines = 128;           // tile kernel: longest row
constexpr int kPairLanes = 4;             // tile kernel: lanes a pair
constexpr int kLaneTicks = 32 / kPairLanes;
constexpr int kWarpPairs = 32 / kPairLanes;
constexpr int kTilePairs = kWarps * kWarpPairs;   // most pairs a tile
constexpr int kTilesPerSm = 2;            // tile kernel: tiles wanted an SM
constexpr size_t kTileSmem = 48 * 1024;   // no opt-in needed below this
constexpr int kBufLines = 128;            // stream kernel: lines per warp
constexpr int kLinesPerLane = kBufLines / 32;
constexpr unsigned kFull = 0xffffffffu;

// a / b for a >= 0 and b > 0, in 32 bits where both fit: the 64-bit
// division is a long subroutine.
__device__ __forceinline__ long long div_ll(long long a, long long b) {
  if (a <= 0xffffffffLL && b <= 0xffffffffLL)
    return (long long)((unsigned)a / (unsigned)b);
  return a / b;
}

__device__ __forceinline__ int bound_term(int ti, int wi, int t_steps) {
  if (ti >= t_steps) return 0;
  const long long end = (long long)ti + wi;
  return (int)(end < t_steps ? end : t_steps);
}

// The pair's sweep bound from the largest min(time + w, T) over its lines
// (``last``, warp-uniform): ticks [0, t_hi).
__device__ __forceinline__ int sweep_bound(int last, int t_steps,
                                           int threshold) {
  int t_hi = last < t_steps ? last : t_steps;
  if (threshold <= 0) {
    const int t_min = t_steps < 1 ? t_steps : 1;
    t_hi = t_hi > t_min ? t_hi : t_min;
  }
  return t_hi;
}

// --------------------------------------------------------- tile kernel

// Dense weights: times (C, B, n), weights (C, Q, n) -> fire/clip (C, B, Q).
// Per-volley weights (kPerVolleyWeights, C = 1): times (B, s), weights
// (B, Q, s) -> fire (B, Q). A tile is (column, bt volleys, qt neurons).
// Dynamic shared memory holds, in rows ld ints apart (n rounded up to 4,
// then to an odd number of 16-byte words, so the 8 rows a warp reads at
// once sit in distinct banks): the tile's times [bt], compacted in place
// to each volley's live lines (time < T; the others count no tick), their
// line indices [bt], the max(w, 0) rows ([qt], or [bt * qt] per volley),
// each pair's weights gathered to its volley's live lines [bt * qt], and
// the live-line counts. Entries past a row's live lines are inert (w = 0).
// A warp sweeps 8 pairs at once, 4 lanes a pair and 8 ticks a lane, 32
// ticks a step: each lane keeps its 8 ticks' raw counts in registers, the
// potential is a prefix over its own ticks plus a 2-step shuffle scan over
// the pair's 4 lanes, and the first crossing is the pair's first lane (one
// ballot) and that lane's first tick. n <= kTileLines.
template <bool kClip, bool kPerVolleyWeights>
__global__ void __launch_bounds__(kWarps * 32)
rnl_tile_kernel(const int* __restrict__ times,
                const int* __restrict__ weights, int* __restrict__ fire,
                int* __restrict__ clip, int C, int B, int Q, int n, int ld,
                int bt, int qt, int t_steps, int threshold, int clip_on,
                int k) {
  extern __shared__ int4 smem4[];
  const int w_rows = kPerVolleyWeights ? bt * qt : qt;
  int* s_t = reinterpret_cast<int*>(smem4);    // [bt][ld] live times
  int* s_i = s_t + bt * ld;                    // [bt][ld] their lines
  int* s_w = s_i + bt * ld;                    // [w_rows][ld] max(w, 0)
  int* s_g = s_w + w_rows * ld;                // [bt * qt][ld] gathered
  int* s_live = s_g + bt * qt * ld;            // [bt] live lines
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (kPairLanes - 1), slot = lane / kPairLanes;
  const long long b_tiles = (B + bt - 1) / bt, q_tiles = (Q + qt - 1) / qt;
  const long long tiles = (long long)C * b_tiles * q_tiles;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long cb = div_ll(tile, q_tiles), c = div_ll(cb, b_tiles);
    const int b0 = (int)(cb - c * b_tiles) * bt;
    const int q0 = (int)(tile - cb * q_tiles) * qt;
    const int nb = min(bt, B - b0), nq = min(qt, Q - q0);
    __syncthreads();                       // the last tile's sweeps are done
#pragma unroll 2
    for (int idx = threadIdx.x; idx < (bt + w_rows) * ld;
         idx += blockDim.x) {
      const int r = idx / ld, i = idx - r * ld;
      const int* src = nullptr;            // times row r, else weight row
      if (i < n) {
        if (r < bt) {
          if (r < nb) src = times + ((c * B + b0 + r) * n + i);
        } else if (kPerVolleyWeights) {
          const int bb = (r - bt) / qt, qq = r - bt - bb * qt;
          if (bb < nb && qq < nq)
            src = weights + (((long long)(b0 + bb) * Q + q0 + qq) * n + i);
        } else if (r - bt < nq) {
          src = weights + ((c * Q + q0 + r - bt) * n + i);
        }
      }
      const int v = src != nullptr ? __ldg(src) : 0;
      if (r < bt) s_t[idx] = v;
      else s_w[idx - bt * ld] = max(v, 0);
    }
    __syncthreads();
    for (int bb = warp; bb < nb; bb += kWarps) {   // compact each volley
      int* tr = s_t + bb * ld;
      int* ir = s_i + bb * ld;
      int live_lines = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const int t = i < n ? tr[i] : 0;
        const bool live = i < n && t < t_steps;
        const unsigned mask = __ballot_sync(kFull, live);
        __syncwarp();                      // every lane has read its line
        if (live) {
          const int at = live_lines + __popc(mask & ((1u << lane) - 1));
          tr[at] = t;
          ir[at] = i;
        }
        live_lines += __popc(mask);
      }
      for (int j = live_lines + lane; j < ((live_lines + 3) & ~3); j += 32) {
        tr[j] = 0;
        ir[j] = -1;                        // gathers w = 0
      }
      if (lane == 0) s_live[bb] = live_lines;
    }
    __syncthreads();
    const int pairs = nb * nq;
    for (int p0 = warp * kWarpPairs; p0 < pairs; p0 += kWarps * kWarpPairs) {
      const int p = p0 + slot;
      const bool valid = p < pairs;
      const int bb = valid ? p / nq : 0, qq = valid ? p - bb * nq : 0;
      const int words = valid ? (s_live[bb] + 3) / 4 : 0;
      const int* wr = s_w + (kPerVolleyWeights ? bb * qt + qq : qq) * ld;
      const int* ir = s_i + bb * ld;
      int* gr = s_g + p * ld;              // the pair's gathered weights
      for (int j = sub; j < 4 * words; j += kPairLanes) {
        const int line = ir[j];
        gr[j] = line >= 0 ? wr[line] : 0;
      }
      __syncwarp();
      const int4* tr4 = reinterpret_cast<const int4*>(s_t + bb * ld);
      const int4* gr4 = reinterpret_cast<const int4*>(gr);
      int t_hi = valid ? t_steps : 0;
      if (t_steps > 32) {                  // the pair's own sweep bound
        int last = 0;
        for (int j = sub; j < 4 * words; j += kPairLanes)
          last = max(last, bound_term(s_t[bb * ld + j], gr[j], t_steps));
#pragma unroll
        for (int d = 1; d < kPairLanes; d <<= 1)
          last = max(last, __shfl_xor_sync(kFull, last, d, kPairLanes));
        if (valid) t_hi = sweep_bound(last, t_steps, threshold);
      }
      unsigned carry = 0;
      int fired = kNoSpike, clips = 0;
      for (long long t0 = 0;; t0 += 32) {
        const bool active = t0 < t_hi && (kClip || fired == kNoSpike);
        if (!__any_sync(kFull, active)) break;
        const unsigned tb = (unsigned)t0 + sub * kLaneTicks;
        int raw[kLaneTicks];
#pragma unroll
        for (int m = 0; m < kLaneTicks; ++m) raw[m] = 0;
        if (active) {
          for (int j = 0; j < words; ++j) {
            const int4 tv = tr4[j], wv = gr4[j];
#pragma unroll
            for (int m = 0; m < kLaneTicks; ++m) {
              const unsigned t = tb + m;
              raw[m] += ((t - (unsigned)tv.x) < (unsigned)wv.x) +
                        ((t - (unsigned)tv.y) < (unsigned)wv.y) +
                        ((t - (unsigned)tv.z) < (unsigned)wv.z) +
                        ((t - (unsigned)tv.w) < (unsigned)wv.w);
            }
          }
        }
        // this lane's ticks: increments, inclusive prefix, clip events
        unsigned pre[kLaneTicks], run = 0;
        int lane_clips = 0;
#pragma unroll
        for (int m = 0; m < kLaneTicks; ++m) {
          const bool live = active && tb + m < (unsigned)t_hi;
          int inc = raw[m];
          if (clip_on) {
            inc = raw[m] < k ? raw[m] : k;
            lane_clips += live && raw[m] > k;
          }
          run += live ? (unsigned)inc : 0u;
          pre[m] = run;
        }
        // the pair's lanes before this one, and the step's total
        unsigned incl = run;
#pragma unroll
        for (int d = 1; d < kPairLanes; d <<= 1) {
          const unsigned up = __shfl_up_sync(kFull, incl, d, kPairLanes);
          if (sub >= d) incl += up;
        }
        const unsigned base = carry + incl - run;
        int first = kLaneTicks;
#pragma unroll
        for (int m = kLaneTicks - 1; m >= 0; --m) {
          const bool live = active && tb + m < (unsigned)t_hi;
          if (live && (int)(base + pre[m]) >= threshold) first = m;
        }
        const unsigned hits =
            (__ballot_sync(kFull, first < kLaneTicks) >> (slot * kPairLanes)) &
            ((1u << kPairLanes) - 1);
        const int src = hits ? __ffs(hits) - 1 : 0;
        const int at = __shfl_sync(kFull, first, src, kPairLanes);
        if (fired == kNoSpike && hits)
          fired = (int)t0 + src * kLaneTicks + at;
        if (kClip) {
#pragma unroll
          for (int d = 1; d < kPairLanes; d <<= 1)
            lane_clips += __shfl_xor_sync(kFull, lane_clips, d, kPairLanes);
          clips += lane_clips;
        }
        carry += __shfl_sync(kFull, incl, kPairLanes - 1, kPairLanes);
      }
      if (valid && sub == 0) {
        const long long out = (c * B + b0 + bb) * Q + q0 + qq;
        fire[out] = fired;
        if (kClip) clip[out] = clips;
      }
    }
  }
}

// ------------------------------------------------------- stream kernel

// Stage lines [i0, i0 + kBufLines) of one pair as (time, max(w, 0)) into
// the warp's buffer, every load in flight at once; lines past n become
// (0, 0), which no tick counts. Returns this lane's part of the sweep
// bound over the staged lines.
__device__ __forceinline__ int stage_lines(const int* __restrict__ t_row,
                                           const int* __restrict__ w_row,
                                           int n, int i0, int lane,
                                           int t_steps, int2* buf) {
  int ti[kLinesPerLane], wi[kLinesPerLane];
#pragma unroll
  for (int r = 0; r < kLinesPerLane; ++r) {
    const int i = i0 + r * 32 + lane;
    ti[r] = i < n ? __ldg(t_row + i) : 0;
    wi[r] = i < n ? __ldg(w_row + i) : 0;
  }
  int last = 0;
#pragma unroll
  for (int r = 0; r < kLinesPerLane; ++r) {
    wi[r] = max(wi[r], 0);
    last = max(last, bound_term(ti[r], wi[r], t_steps));
    buf[r * 32 + lane] = make_int2(ti[r], wi[r]);
  }
  return last;
}

// Same layouts as the tile kernel, any n; pair p is the output index
// ((c * B + b) * Q + q). planes: the bit length of the largest increment.
template <bool kClip, bool kPerVolleyWeights>
__global__ void __launch_bounds__(kWarps * 32)
rnl_stream_kernel(const int* __restrict__ times,
                  const int* __restrict__ weights, int* __restrict__ fire,
                  int* __restrict__ clip, long long pairs, int B, int Q,
                  int n, int t_steps, int threshold, int clip_on, int k,
                  int planes) {
  __shared__ int4 s_buf[kWarps][kBufLines / 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned at_or_below = kFull >> (31 - lane);
  int2* buf = reinterpret_cast<int2*>(s_buf[warp]);
  const int4* buf4 = s_buf[warp];
  for (long long p = (long long)blockIdx.x * kWarps + warp; p < pairs;
       p += (long long)gridDim.x * kWarps) {
    const long long row = div_ll(p, Q), c = div_ll(row, B);  // c * B + b
    const int* t_row = times + row * n;
    const int* w_row = kPerVolleyWeights
                           ? weights + p * n
                           : weights + (c * Q + (p - row * Q)) * n;
    int last = 0;
    for (int i0 = 0; i0 < n; i0 += kBufLines)
      last = max(last, stage_lines(t_row, w_row, n, i0, lane, t_steps, buf));
    const int t_hi = sweep_bound(__reduce_max_sync(kFull, last), t_steps,
                                 threshold);
    unsigned carry = 0;
    int fired = kNoSpike, clips = 0;
    for (long long t0 = 0; t0 < t_hi; t0 += 32) {
      const unsigned t = (unsigned)t0 + lane;
      const bool live = t < (unsigned)t_hi;
      int acc[2] = {0, 0};
      for (int i0 = 0; i0 < n; i0 += kBufLines) {
        __syncwarp();
        stage_lines(t_row, w_row, n, i0, lane, t_steps, buf);
        __syncwarp();
#pragma unroll 4
        for (int j = 0; j < (min(kBufLines, n - i0) + 1) / 2; ++j) {
          const int4 v = buf4[j];            // lines 2j, 2j + 1: (t, w)
          acc[0] += (t - (unsigned)v.x) < (unsigned)v.y;
          acc[1] += (t - (unsigned)v.z) < (unsigned)v.w;
        }
      }
      const int raw = acc[0] + acc[1];
      int inc = raw;
      if (clip_on) {
        inc = raw < k ? raw : k;
        if (kClip) clips += __popc(__ballot_sync(kFull, live && raw > k));
      }
      // the prefix of this step's increments, one ballot per bit plane
      unsigned prefix = 0, total = 0;
      for (int b = 0; b < planes; ++b) {
        const unsigned bits =
            __ballot_sync(kFull, live && ((unsigned)inc >> b) & 1u);
        prefix += (unsigned)__popc(bits & at_or_below) << b;
        total += (unsigned)__popc(bits) << b;
      }
      const unsigned over =
          __ballot_sync(kFull, live && (int)(carry + prefix) >= threshold);
      if (fired == kNoSpike && over) {
        fired = (int)t0 + __ffs(over) - 1;
        if (!kClip) break;
      }
      carry += total;
    }
    if (lane == 0) {
      fire[p] = fired;
      if (kClip) clip[p] = clips;
    }
    __syncwarp();                          // buf is restaged by the next pair
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <bool kClip, bool kPerVolleyWeights>
int launch(const void* times, const void* weights, void* fire, void* clip,
           int C, int B, int Q, int n, int t_steps, int threshold,
           int clip_on, int k, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* x = (const int*)times;
  const int* w = (const int*)weights;
  // bits of the largest increment a tick can add
  const unsigned max_inc = (unsigned)(clip_on && k < n ? k : n);
  const int planes = max_inc == 0 ? 0 : 32 - __builtin_clz(max_inc);
  if (n <= kTileLines) {
    const int n4 = (n + 3) & ~3;
    const int ld = (n4 / 4) % 2 ? n4 : n4 + 4;   // an odd number of int4s
    int qt = Q < 32 ? Q : 32;
    int bt = min(B, max(1, kTilePairs / qt));
    auto smem_of = [&](int b, int q) {
      const int w_rows = kPerVolleyWeights ? b * q : q;
      return ((size_t)(2 * b + w_rows + b * q) * ld + b) * sizeof(int);
    };
    auto tiles_of = [&](int b, int q) {
      return (long long)C * ((B + b - 1) / b) * ((Q + q - 1) / q);
    };
    while (bt > 1 && smem_of(bt, qt) > kTileSmem) bt = (bt + 1) / 2;
    // smaller tiles until the card has kTilesPerSm of them an SM
    const long long want = (long long)kTilesPerSm * sm_count();
    while (tiles_of(bt, qt) < want && (bt > 1 || qt > kWarpPairs)) {
      if (bt > 1) bt = (bt + 1) / 2;
      else qt = (qt + 1) / 2;
    }
    const unsigned grid = (unsigned)min(tiles_of(bt, qt), 0x7fffffffLL);
    rnl_tile_kernel<kClip, kPerVolleyWeights>
        <<<grid, kWarps * 32, smem_of(bt, qt), st>>>(
            x, w, (int*)fire, (int*)clip, C, B, Q, n, ld, bt, qt, t_steps,
            threshold, clip_on, k);
  } else {
    const long long pairs = (long long)C * B * Q;
    const long long blocks = (pairs + kWarps - 1) / kWarps;
    const unsigned grid = (unsigned)min(blocks, 0x7fffffffLL);
    rnl_stream_kernel<kClip, kPerVolleyWeights>
        <<<grid, kWarps * 32, 0, st>>>(x, w, (int*)fire, (int*)clip, pairs, B,
                                       Q, n, t_steps, threshold, clip_on, k,
                                       planes);
  }
  return (int)cudaGetLastError();
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
  if (clip != nullptr)
    return launch<true, false>(times, weights, fire, clip, C, B, Q, n,
                               t_steps, threshold, clip_on, k, stream);
  return launch<false, false>(times, weights, fire, nullptr, C, B, Q, n,
                              t_steps, threshold, clip_on, k, stream);
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
  return launch<false, true>(times, weights, fire, nullptr, 1, B, Q, s,
                             t_steps, threshold, clip_on, k, stream);
}

const char* rnl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
