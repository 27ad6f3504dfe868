// Causal or bidirectional GQA self-attention's forward for Hopper (sm_90a):
// scores on the tensor cores (wgmma), an online f32 softmax, P V on the
// tensor cores, one pass over the keys per tile of queries.
//
// Replaces no TPU kernel. The JAX package computes attention in plain jnp
// (src/repro/models/attention.py, _sdpa); XLA fuses it on the TPU. The
// port's plain form (src/repro_torch/models/attention.py, _sdpa_block)
// makes f32 copies of K and V, scores every key for every query, writes
// blocks of f32 scores to device memory, runs some seven elementwise and
// reduction passes over them and takes Q K^T and P V as f32 GEMMs on the
// CUDA cores: at internlm2-1.8b's 32,768-token prefill it took 97 % of the
// forward, 115 times the causal FLOPs' time at the bf16 tensor-core rate.
//
// What it computes, for one KV group g of batch row b, query i and one of
// the group's rep = H / G heads h (q (B, Sq, H, D), k and v (B, Sk, G, D),
// all bf16, read in place through their strides):
//   s_j   = (q_i . k_j) * scale          f32 sums of exact bf16 products,
//                                        times the f32 1/sqrt(D)
//   p_j   = exp(s_j - max_j s_j)         masked keys (j > i when causal,
//   out_i = sum_j p_j v_j / sum_j p_j    j >= Sk) count as -inf: p_j = 0
// the arithmetic of _sdpa_block, step by step: the softmax is exp(x - max)
// over the sum in f32, kept online (a running max and sum; the output
// rescaled in f32 when the max grows), divided by the sum once, in f32,
// and rounded to the output's type once, at the store.
//
// P's precision. P enters the tensor cores as a bf16 pair, hi = bf16(p)
// and lo = bf16(p - hi) (p = hi + lo + e, |e| <= 2^-17 |p|), two products
// P_hi V + P_lo V into the f32 output: V is bf16, exact as an operand, so
// every product is exact and summed in f32, and the result agrees with an
// f32 P V to a few 2^-17 of its scale. This is the split the SSD kernel
// (ssd_scan.cu) uses for its f32 intermediates. P is never rounded once to
// bf16: that gives ~2^-9 relative errors, a lower precision than the
// plain form's f32 probs @ v (the f32 output's test rejects it).
//
// What bounds it on this card. At the prefill call (1 x 32,768 queries,
// 16 heads in 8 groups, D 128, causal) the keys at or below the diagonal
// take 4.4 TFLOP of model products a layer, 4.45 ms at 989 TFLOP/s; the
// split makes the tensor-core work 1.5 times that (Q K^T once, P V twice).
// It moves ~0.4 GB (q, k and v once a block's reads, the output), 0.12 ms
// at 3.35 TB/s: the tensor cores bound it, and what competes with them is
// the softmax on the CUDA cores (an exp, the mask and the split a score).
//
// Blocks and warps. A block takes one KV group's rep query heads for Mq
// queries: 128 rows (Mq x rep, query-major, Mq the largest count with
// Mq * rep <= 128 and a multiple of 8; the rows past it are padding, never
// stored), so each K/V tile that arrives serves every head of the group.
// Three warpgroups: a producer, whose one thread keeps TMA loads of K and
// V tiles in flight in a ring of two stages (an mbarrier per stage that
// the loads complete, another that the consumer warps release), and two
// consumer warpgroups of 64 rows each, which run wgmma:
//   S = Q K^T       m64n128k16, both operands in shared memory, f32 sums
//   T = P_hi V      m64nDk16, P from registers (the S accumulators turned
//   T += P_lo V     into bf16 pairs), V from shared memory, transposed
// and O = O * alpha + T on the CUDA cores, rounded to nearest: the tensor
// cores' f32 sums truncate, so a whole row of keys summed in their
// accumulator would gather a bias growing with its length (at 32,768
// keys, ~1e-4 of the output's scale). setmaxnreg gives the consumers 240
// registers and the producer 24.
// Tiles of 128 keys. Causal: key tiles that lie wholly above a block's last
// query are never loaded or scored; only tiles that cross the diagonal
// (or the end of the keys) are masked, per row, by the query's own index.
// Key 0 is in every row's first tile, so no row is ever fully masked and
// the running max is finite from the first tile on. The grid walks the
// query tiles longest first, so the diagonal's long blocks start early.
//
// Shared memory. Every tile is split into D / CE column chunks of CE
// elements (CE 64, 32 or 16: the widest that divides D), each chunk a
// (rows, CE) tile with rows of CE * 2 bytes, swizzled as TMA writes it and
// wgmma reads it (128, 64 or 32-byte swizzle). Q 128 x D, two stages of K
// and V 128 x D each: 160 KB at D 128. Built for the head dims of the
// registry's configs (64, 80, 96, 128) and the smoke configs' 16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // query rows of a block: two warpgroups of 64
constexpr int kKeys = 128;     // keys of a tile
constexpr int kStages = 2;     // K/V tiles in flight
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

// error codes past cudaError_t's: no cuTensorMapEncodeTiled to build the
// tensor maps with; a tensor map it refused (plus its CUresult)
constexpr int kErrNoEncoder = 9000;
constexpr int kErrEncode = 10000;

template <int D>
struct Shape {
  static constexpr int CE = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int SW = CE * 2;          // bytes of a chunk's row
  static constexpr int CHUNKS = D / CE;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_BYTES = kKeys * D * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;  // barriers, alignment
  // wgmma's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static_assert(D % 16 == 0, "head dims are multiples of 16");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from reading (or reusing) a register that an
// asynchronous wgmma writes (or reads) before the wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// S (+)= A B: A (64 x 16) and B (16 x 128) from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B: A (64 x 16) from registers, B (16 x N) from shared memory,
// N-major (transposed); one per head dim
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Params {
  void* out;
  long long out_sb, out_ss, out_sh;  // elements
  int batch, sq, sk, groups, rep, mq, rows, n_mtiles, causal, out_f32;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    gqa_attention_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const Params prm) {
  using S = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + S::Q_BYTES;
  const uint32_t v_s = k_s + kStages * S::KV_BYTES;
  const uint32_t bars = base + S::BAR_OFF;
  const uint32_t q_bar = bars;
  // full[st] at bars + 8 (1 + st), empty[st] at bars + 8 (1 + kStages + st)
  auto full_bar = [&](int st) { return bars + 8u * (1 + st); };
  auto empty_bar = [&](int st) { return bars + 8u * (1 + kStages + st); };

  // longest query tiles first
  const int bg = blockIdx.x % (prm.batch * prm.groups);
  const int mt = prm.n_mtiles - 1 - blockIdx.x / (prm.batch * prm.groups);
  const int b = bg / prm.groups, g = bg % prm.groups;
  const int i0 = mt * prm.mq;
  // causal: the keys up to the block's last query
  const int kv_len =
      prm.causal ? min(prm.sk, min(prm.sq, i0 + prm.mq)) : prm.sk;
  const int n_tiles = (kv_len + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, prm.rows * D * 2);
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c)
        tma_load_4d(q_s + c * kRows * S::SW, &tq, q_bar, c * S::CE,
                    g * prm.rep, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar(st), ((t / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(st), 2 * S::KV_BYTES);
        const uint32_t ks = k_s + st * S::KV_BYTES;
        const uint32_t vs = v_s + st * S::KV_BYTES;
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c) {
          tma_load_4d(ks + c * kKeys * S::SW, &tk, full_bar(st), c * S::CE, g,
                      t * kKeys, b);
          tma_load_4d(vs + c * kKeys * S::SW, &tv, full_bar(st), c * S::CE, g,
                      t * kKeys, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    const int cq = (lane % 4) * 2;                  // columns cq, cq + 1
    const int qi0 = i0 + r0 / prm.rep, qi1 = i0 + (r0 + 8) / prm.rep;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      mbar_wait(full_bar(st), (t / kStages) & 1);
      const uint32_t ks = k_s + st * S::KV_BYTES;
      const uint32_t vs = v_s + st * S::KV_BYTES;

      // S = Q K^T over D in steps of 16
      float s[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t c = (kk * 16) / S::CE, in = ((kk * 16) % S::CE) * 2;
        const uint64_t da =
            make_desc(q_s + c * kRows * S::SW + wg * 64 * S::SW + in, 16,
                      8 * S::SW, S::LAYOUT);
        const uint64_t db =
            make_desc(ks + c * kKeys * S::SW + in, 16, 8 * S::SW, S::LAYOUT);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(s[i]);

      // scale, mask, the tile's row max
      const int j0 = t * kKeys;
      const bool edge = (prm.causal && j0 + kKeys - 1 > i0) ||
                        j0 + kKeys > prm.sk;
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n * 4 + e] * prm.scale;
          if (edge) {
            const int j = j0 + n * 8 + cq + (e & 1);
            const int qi = (e & 2) ? qi1 : qi0;
            if (j >= prm.sk || (prm.causal && j > qi)) x = -INFINITY;
          }
          s[n * 4 + e] = x;
          if (e & 2)
            x1 = fmaxf(x1, x);
          else
            x0 = fmaxf(x0, x);
        }
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;

      // p = exp(s - max), its row sums, and the bf16 pairs hi + lo as the
      // A operand of P V (k step kk: columns 16 kk .. 16 kk + 15)
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // h = 0: row r0, 1: row r0 + 8
          const float m = h ? m1 : m0;
          const float p0 = expf(s[n * 4 + 2 * h] - m);
          const float p1 = expf(s[n * 4 + 2 * h + 1] - m);
          if (h)
            l1 += p0 + p1;
          else
            l0 += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              p0 - __low2float(hi), p1 - __high2float(hi));
          // register (n % 2) * 2 + h of k step n / 2
          ph[n / 2][(n % 2) * 2 + h] = pack_bf16(hi);
          pl[n / 2][(n % 2) * 2 + h] = pack_bf16(lo);
        }
      }

      // the tile's P_hi V + P_lo V over its keys in steps of 16, in an
      // accumulator of its own (the tensor cores' sums truncate: over a
      // whole row of keys their bias would grow with its length), added
      // to the rescaled O on the CUDA cores, rounded to nearest
      float pv[D / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv = make_desc(vs + kk * 16 * S::SW, kKeys * S::SW,
                                      8 * S::SW, S::LAYOUT);
        wgmma_rs(pv, ph[kk], dv, kk > 0);
        wgmma_rs(pv, pl[kk], dv, 1);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        fence_reg(pv[i]);
        o[i] = fmaf(o[i], (i & 2) ? a1 : a0, pv[i]);
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(ph[kk][r]);
          fence_reg(pl[kk][r]);
        }
      }
      // this warp is done with the stage
      if (lane == 0) mbar_arrive(empty_bar(st));
    }

    // the row sums over the four threads of a row; out = O / sum
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int qi = h ? qi1 : qi0;
      if (r >= prm.rows || qi >= prm.sq) continue;
      const float l = h ? l1 : l0;
      const long long off = b * prm.out_sb + qi * prm.out_ss +
                            (long long)(g * prm.rep + r % prm.rep) * prm.out_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float y0 = o[n * 4 + 2 * h] / l;
        const float y1 = o[n * 4 + 2 * h + 1] / l;
        const long long at = off + n * 8 + cq;
        if (prm.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(prm.out) + at) =
              make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(prm.out) + at) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d bf16 tensor map: dims (D, a, b, batch) with the given element
// strides of a, b and batch, a (ce, box_a, box_b, 1) box, swizzled.
int encode(CUtensorMap* map, const void* ptr, int d, long long na,
           long long nb, long long nbatch, long long sa, long long sb,
           long long sbatch, int ce, int box_a, int box_b) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)na, (cuuint64_t)nb,
                              (cuuint64_t)nbatch};
  const cuuint64_t strides[3] = {(cuuint64_t)sa * 2, (cuuint64_t)sb * 2,
                                 (cuuint64_t)sbatch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ce, (cuuint32_t)box_a,
                             (cuuint32_t)box_b, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      ce == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : ce == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + (int)res;
}

// the queries a block takes: the most with mq * rep <= 128 rows and a
// multiple of 8
int queries_per_block(int rep) {
  for (int mq = kRows / rep; mq >= 1; --mq)
    if ((mq * rep) % 8 == 0) return mq;
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int heads, int groups, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           int causal, float scale, int out_f32, cudaStream_t stream) {
  using S = Shape<D>;
  const int rep = heads / groups;
  const int mq = queries_per_block(rep);
  if (mq == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  // q: (D, H, Sq, B) in a (CE, rep, mq, 1) box: rows query-major
  int err = encode(&tq, q, D, heads, sq, batch, qs[2], qs[1], qs[0], S::CE,
                   rep, mq);
  if (err) return err;
  // k, v: (D, G, Sk, B) in a (CE, 1, 128, 1) box
  err = encode(&tk, k, D, groups, sk, batch, ks[2], ks[1], ks[0], S::CE, 1,
               kKeys);
  if (err) return err;
  err = encode(&tv, v, D, groups, sk, batch, vs[2], vs[1], vs[0], S::CE, 1,
               kKeys);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(gqa_attention_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  S::SMEM);
  if (err) return err;
  Params prm;
  prm.out = out;
  prm.out_sb = os[0];
  prm.out_ss = os[1];
  prm.out_sh = os[2];
  prm.batch = batch;
  prm.sq = sq;
  prm.sk = sk;
  prm.groups = groups;
  prm.rep = rep;
  prm.mq = mq;
  prm.rows = mq * rep;
  prm.n_mtiles = (sq + mq - 1) / mq;
  prm.causal = causal;
  prm.out_f32 = out_f32;
  prm.scale = scale;
  const long long blocks = (long long)prm.n_mtiles * batch * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gqa_attention_kernel<D><<<(unsigned)blocks, kThreads, S::SMEM, stream>>>(
      tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, G, D) bf16, strides in elements (the
// last one 1); out (B, Sq, H, D), bfloat16 or (out_f32) float32. scale is
// the f32 factor of the scores. Returns a cudaError_t code, or past 9000
// a tensor-map failure (gqa_attention_error_string).
int gqa_attention_launch(const void* q, const void* k, const void* v,
                         void* out, int batch, int sq, int sk, int heads,
                         int groups, int head_dim, const long long* q_strides,
                         const long long* k_strides,
                         const long long* v_strides,
                         const long long* out_strides, int causal,
                         float scale, int out_f32, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (sk <= 0 || groups <= 0 || heads % groups != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define GQA_CASE(DIM)                                                       \
  case DIM:                                                                 \
    return launch<DIM>(q, k, v, out, batch, sq, sk, heads, groups,          \
                       q_strides, k_strides, v_strides, out_strides, causal, \
                       scale, out_f32, st);
  switch (head_dim) {
    GQA_CASE(16)
    GQA_CASE(64)
    GQA_CASE(80)
    GQA_CASE(96)
    GQA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GQA_CASE
}

const char* gqa_attention_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled was not found";
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
