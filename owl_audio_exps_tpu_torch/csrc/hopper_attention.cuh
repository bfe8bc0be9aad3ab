// Hopper tile bodies of the port's attention kernels, for sm_90a: the
// forward, dq and dkv of the frame-mask kernels K1 (owl_frame_attn_*)
// and K4 (the ring partial, owl_ring_attn_*), whose entry points are in
// frame_attention.cu, and of the band kernels of band_attention.cu, for
// K2/K3 (owl_band_attn_*) and K5 (owl_band2_attn_*, the same kernels).
//
// The function, with f = row / tpf for a query or key row:
//   visible(i, j) iff (fk <= fq if causal) and (|fq - fk| < window if a
//   window is set) and (doc[fq] == doc[fk] if documents are given);
// q pre-scaled by `scale` and rounded to bf16 before Q.K^T; f32 logits
// and softmax statistics; P and dS rounded to bf16 before their products,
// every product accumulated in f32; the forward's f32 logsumexp when
// asked; delta = rowsum(dO * O) in the dq kernel of K1 and the band
// (stored for its dkv), the caller's delta' = rowsum(dO * O) - g_lse in
// both of K4's gradient kernels; rows past L read as zero and never
// written.
//
// Two softmax forms (the bodies' kFixed policy). The usual one (K1, K4,
// and the band without a bound) keeps an online row max in the forward.
// The fixed shift of the TPU band kernels under QK rms-norm, p =
// exp(min(s, cap) - cap) / sum with cap = sqrt(Dh), keeps no running max
// and never rescales the output accumulator; its forward saves lse =
// cap + log(sum). Either way the backward recomputes P = exp(min(s, cap)
// - lse) (no clamp in the usual form) and dS = P * (dP - delta): the
// clamp passes its gradient straight through, as the TPU band kernel's
// backward does (owl_audio_exps_tpu/ops/band.py:482-508). The clamp
// applies to the f32 scaled logit s, before the exp2's log2(e) factor.
//
// What bounds them on the H100: operations. A visible (query, key) pair
// costs 4 Dh flops in the forward, 6 Dh in dq and 8 Dh in dkv, at 989
// TFLOP/s of dense bf16; their bytes (each of q, k, v, o, dO, dq, dk, dv
// once) are 10-20x below that line at the lengths the port runs (PERF.md
// section 6). Beside the products, each kernel spends one exp2 per visible
// pair on the multi-function unit, 16 a clock per SM against the tensor
// cores' ~2,048 bf16 FMAs: at Dh 64 the forward's 128 FMAs a pair take as
// long as its exp (dq's 192 and dkv's 256 take 1.5 and 2 times as long),
// so the exp work has to overlap the products.
//
// What the design does about it:
// * Every product is a warpgroup MMA (wgmma m64nNk16, bf16 in, f32
//   accumulate), the only way to the tensor cores' full rate. Q.K^T,
//   dO.V^T, and in dkv their transposes K.Q^T and V.dO^T, read both
//   operands from shared memory (K-major). P.V, dS.K, P^T.dO and dS^T.Q
//   take P or dS from the registers of the product before (an m64
//   accumulator's layout is wgmma's register A layout) and read V, K, dO
//   or Q from shared memory MN-major through the descriptor's transpose:
//   no operand is ever transposed or gathered by hand.
// * Tiles arrive by TMA (one thread, whole tiles, completion on an
//   mbarrier) into 128-byte-swizzled shared memory, through 4-D tensor
//   maps (Dh, L, H, B) made on the host from the views' strides, so the
//   [B, H, L, Dh] views of Attn's fused projection are read in place.
//   TMA's zero fill reads rows past L. A ring of kStages stages keeps the
//   next tiles in flight while the current one is multiplied.
// * Warp specialisation: warpgroup 0 is the producer (one warp issues the
//   loads; setmaxnreg gives the others' registers away), warpgroups 1 and
//   2 are consumers, each owning 64 rows of the block's 128-row tile, so
//   each K/V (or Q/dO) tile read from L2 serves 128 rows. The consumers
//   take turns at issuing their products (Turns), so that while one runs
//   its exp work the other's products keep the tensor cores busy.
// * The forward and dq also overlap within a consumer: the exp work of
//   tile t runs while tile t - 1's last product is still on the tensor
//   cores, and tile t + 1's first products are issued with tile t's last
//   (a software pipeline over a ring of 3 stages). dkv keeps the plain
//   order over 2 stages: its four accumulators leave no registers for a
//   second set of S^T, dP^T (ptxas then serializes its products).
// * The walk: key/query ranges in closed form from the frames (kv_range
//   / q_range), FULL tiles that skip the per-element mask, the mask as
//   one unsigned compare of fq - fk against [dmin, dmin + dspan], and the
//   heaviest query tiles of a causal grid first. With documents (K1's kDoc
//   bodies) the walk reads a per-tile summary of the ids (doc_tiles, the
//   section "documents" below): it skips the tiles whose ids cannot meet
//   the block's, runs single-document tiles unmasked, clips the range to
//   the runs of the block's ids, and takes the tiles in the helper's order
//   of work. Under a causal window of
//   w frames (the band) a 128-row tile meets C / 128 + 1 or 2 tiles of
//   the other operand (C = w * tpf); only those at the diagonal and at
//   the window's far edge are PARTIAL (one of each at tpf 64, up to five
//   in all at tpf 65, whose frames straddle the tiles).
// * The band's forward is persistent (fwd_items, a copy of the forward
//   body of its own): one block per SM loops over the 128-row
//   tiles, its producer loading the next tile's Q and first K/V stages
//   while the consumers finish the current one. Its backward, and every
//   kernel of K1 and K4, take a block per tile.
// * No atomics: dq and dkv are two kernels, each the only writer of its
//   output tile, so the backward is deterministic.
//
// The q pre-scale: when `scale` is a power of two (Dh 64's 1/8, K4's 1)
// bf16(scale * q) is scale * q exactly, so the scale is folded into the
// f32 logits (logit_mul) with the same result bit for bit; otherwise the
// consumers rescale their Q rows in shared memory once (dkv: each Q tile,
// both consumers half of it) and round to bf16, as the plain version does.
//
// Frames of a key or query row r are (r + 0.5) * (1 / tpf) truncated: exact
// for r < 2^22, far above any L the entry points are given.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace owl_hopper {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;  // rows a block owns along the grid, 64 a consumer
constexpr int kNoFrame = 1 << 29;  // the frame of a row past L
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ arguments

// Tensor maps of the bf16 [B, H, L, Dh] inputs (o: K1's dq reads O).
struct Maps {
  CUtensorMap q, k, v, o, dout;
};

struct Params {
  bf16* o;      // forward output
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long s_o[3], s_dq[3], s_dk[3], s_dv[3];  // batch, head, row strides
  float* lse;         // [B, H, L] f32, or null
  float* delta;       // [B, H, L] f32: K1 dq writes it, the others read it
  const int* doc;     // per-frame document id [B, n_frames], or null
  const int* dsum;    // its tile summary [B, dsum_row] (doc_tiles), or null
  int B, H, L, tpf, window, causal, n_frames;
  int n64, n128, dsum_row;  // 64- and 128-row tiles along L; summary ints
  float scale;        // the q pre-scale
  float logit_mul;    // multiplies the raw Q.K^T: scale when folded, else 1
  float inv_tpf;
  int scale_q;        // rescale Q in shared memory (scale not a power of 2)
  float cap;          // the fixed shift's bound on s (kFixed bodies only)
  float cap_raw;      // the same bound on the raw Q.K^T: cap / logit_mul
};

// ------------------------------------------------------- device helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, aligned to 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes; TMA and wgmma must agree on it).
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive, and expect `bytes` more of TMA transfer in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// never ends (a protocol fault) traps after ~2^26 tries instead of hanging
// the card: the launch then fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == (1 << 26)) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory,
// completion (its bytes) reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Rows [row0, row0 + R) of (b, h) into an [R, D] tile: D / 64 boxes of
// [R, 64], each R * 128 bytes, 128-byte swizzled.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load(dst + cb * R * 128, map, bar, cb * 64, row0, h, b);
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The two consumers take turns at issuing their products (named barriers
// 4 and 5: a consumer waits for its turn, issues, and hands the turn to
// the other), so that one's exp work overlaps the other's products.
// Consumer 0 starts.
struct Turns {
  int cw;
  __device__ __forceinline__ void init() const {
    if (cw == 0) named_arrive(4, 256);
  }
  __device__ __forceinline__ void begin() const { named_sync(4 + cw, 256); }
  __device__ __forceinline__ void end() const { named_arrive(5 - cw, 256); }
};

// The block of all three bodies: a producer warpgroup and two consumer
// warpgroups of 64 rows each (kBM rows along the grid), setmaxnreg moving
// registers from the producer to the consumers (40 + 2 x 232 a thread of
// each warpgroup: the register file). Each body's tensor maps have boxes
// of kBoxQ rows of Q (and dO, O) and kBoxKV rows of K and V.
struct Shape {
  static constexpr int kConsumers = 2, kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr bool kPersistent = false;  // one tile a block
};

// generic-proxy writes to shared memory, before wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pin registers around wgmma: the compiler may not move their reads or
// writes across this point.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A raw logit as the softmax reads it: min(s, cap_raw) under the fixed
// shift (a power-of-two logit_mul scales both sides exactly, so this is
// min(scaled s, cap) scaled back), s itself under the usual softmax.
template <bool kFixed>
__device__ __forceinline__ float softmax_logit(float s, float cap_raw) {
  if constexpr (kFixed)
    return fminf(s, cap_raw);
  else
    return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// wgmma matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows from r0 of an R-row [R, D] tile, k-step kk (16
// columns; 4 steps per 128-byte column block), 8-row groups 1024 bytes
// apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r0, int kk) {
  return desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (transposed B): rows [16 kk, 16 kk + 16) of an R-row
// [R, D] tile as the K dimension, its D columns as N (column blocks R * 128
// bytes apart).
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, R * 128, 1024);
}

// The four products the bodies use (generated text: the register lists
// must be written out). An m64 x N f32 accumulator: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, for each
// 8-column chunk j, columns 8 j + 2 (t % 4) (+ 1), at d[4 j + 2 half + e].
// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory.
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

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (four bf16x2
// a thread), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers (four bf16x2
// a thread), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

// A from registers, B MN-major (transposed).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}


// An m64 x N f32 accumulator as bf16 A operands of the next product:
// k-step kk covers columns [16 kk, 16 kk + 16).
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Multiply rows [r0, r0 + n) of an R-row [R, D] shared tile by `scale`,
// rounding to bf16 (swizzling permutes 16-byte chunks within a row, so a
// row's bytes stay the row's).
template <int D, int R>
__device__ __forceinline__ void scale_rows(uint8_t* tile, int r0, int n,
                                           float scale, int tid, int threads) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    uint4* base = reinterpret_cast<uint4*>(tile + cb * R * 128 + r0 * 128);
    for (int i = tid; i < n * 8; i += threads) {
      uint4 v = base[i];
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      base[i] = v;
    }
  }
}

// ----------------------------------------------------------- the mask

__device__ __forceinline__ int frame_of(const Params& p, int row) {
  return (int)(((float)row + 0.5f) * p.inv_tpf);
}

__device__ __forceinline__ int doc_of(const Params& p, int b, int f) {
  return p.doc[(long long)b * p.n_frames + f];
}

// The frame mask without documents as one compare: fq - fk lies in
// [dmin, dmin + dspan] (causal: 0 .. w - 1; bidirectional: -(w - 1) ..
// w - 1; w the window, or the frame count without one). A row past L has
// frame kNoFrame (a key) or -kNoFrame (a query), which puts fq - fk below
// any dmin.
struct Mask {
  int dmin;
  unsigned dspan;
};

__device__ __forceinline__ Mask mask_of(const Params& p) {
  const int wl = p.window > 0 ? min(p.window, p.n_frames) : p.n_frames;
  return {p.causal ? 0 : 1 - wl,
          (unsigned)(p.causal ? wl - 1 : 2 * (wl - 1))};
}

__device__ __forceinline__ bool in_mask(Mask m, int fq, int fk) {
  return (unsigned)(fq - fk - m.dmin) <= m.dspan;
}

// Whether every pair of query rows [q0, q0 + nq) and key rows [k0, k0 +
// nk) is visible by the frame mask (as FrameMask.__getitem__ classifies a
// block full); with documents the walk adds the ids' condition.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int nq,
                                          int k0, int nk) {
  if (q0 + nq > p.L || k0 + nk > p.L) return false;
  const int fq_lo = q0 / p.tpf, fq_hi = (q0 + nq - 1) / p.tpf;
  const int fk_lo = k0 / p.tpf, fk_hi = (k0 + nk - 1) / p.tpf;
  if (p.causal && fk_hi > fq_lo) return false;
  if (p.window > 0 &&
      (fq_hi - fk_lo >= p.window || fk_hi - fq_lo >= p.window))
    return false;
  return true;
}

// Key rows [begin, end) that can be visible from query rows [q0, q0 +
// rows), begin aligned down to `bk`.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows,
                                         int bk, int& begin, int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fq_lo = q0 / p.tpf, fq_hi = (min(q0 + rows, p.L) - 1) / p.tpf;
  const int fk_min = w > 0 ? max(0, fq_lo - w + 1) : 0;
  const int fk_max =
      p.causal ? fq_hi : (w > 0 ? min(nf - 1, fq_hi + w - 1) : nf - 1);
  end = min((fk_max + 1) * p.tpf, p.L);
  begin = (fk_min * p.tpf / bk) * bk;
}

// Query rows [begin, end) that can see some key of rows [k0, k0 + rows):
// causal, query frames fk .. fk + window - 1 (to the end without a
// window); bidirectional, |fq - fk| < window. begin aligned down to `bq`.
__device__ __forceinline__ void q_range(const Params& p, int k0, int rows,
                                        int bq, int& begin, int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fk_lo = k0 / p.tpf, fk_hi = (min(k0 + rows, p.L) - 1) / p.tpf;
  const int fq_min = p.causal ? fk_lo : (w > 0 ? max(0, fk_lo - w + 1) : 0);
  const int fq_max = w > 0 ? min(nf - 1, fk_hi + w - 1) : nf - 1;
  end = min((fq_max + 1) * p.tpf, p.L);
  begin = (fq_min * p.tpf / bq) * bq;
}

// ---------------------------------------------------------- documents
//
// K1 with documents (the kDoc bodies) walks a summary of the per-frame
// ids that the helper kernel of frame_attention.cu (owl_doc_tiles)
// computes on the card for each call, and ops/splash.py doc_tiles in
// plain PyTorch, int for int the same. A batch row's dsum_row ints:
//   tiles [n64][4]   the 64-row tile t (its rows below L): the least and
//                    the greatest id, and the first and last frame its
//                    rows can see by document (the bounds of its ids'
//                    runs where the row's ids never decrease, else 0 and
//                    n_frames - 1);
//   runs [n_frames][2]  the first and last frame of each frame's run of
//                    equal ids (0 and n_frames - 1 where ids decrease);
//   order_q [n128], order_k [n128]  the 128-row tiles as query tiles
//                    (forward, dq) and as key tiles (dkv), the heaviest
//                    first: work is the length of the clipped range;
//   mono             1 where the row's ids never decrease, else 0;
// and zeros up to a multiple of 4. Where the ids never decrease an id
// fills one run, so a row sees exactly the keys of its run: the mask of a
// row is one interval of frames (RowIv), and a tile's partners lie in its
// runs (the clip). Elsewhere the same id may fill two runs, which see each
// other; there the per-element test also compares the ids.

__host__ __device__ inline int doc_row_len(int L, int tpf) {
  const int nf = (L + tpf - 1) / tpf, n64 = (L + 63) / 64;
  const int n128 = (L + 127) / 128;
  return (4 * n64 + 2 * nf + 2 * n128 + 1 + 3) / 4 * 4;
}

// The ids of rows [r0, r0 + rows) (r0 < L, a multiple of 64; rows 64 or
// 128) from the tiles of one row's summary.
struct DocSpan {
  int lo, hi, first, last;
};

__device__ __forceinline__ DocSpan doc_span(const int* row, int n64, int r0,
                                            int rows) {
  const int4* t = reinterpret_cast<const int4*>(row);
  const int a = r0 / 64, z = min((r0 + rows) / 64, n64);
  int4 v = t[a];
  DocSpan s{v.x, v.y, v.z, v.w};
  for (int i = a + 1; i < z; ++i) {
    v = t[i];
    s.lo = min(s.lo, v.x);
    s.hi = max(s.hi, v.y);
    s.first = min(s.first, v.z);
    s.last = max(s.last, v.w);
  }
  return s;
}

__device__ __forceinline__ const int* doc_row(const Params& p, int b) {
  return p.dsum + (long long)b * p.dsum_row;
}

__device__ __forceinline__ bool doc_mono(const Params& p, int b) {
  return doc_row(p, b)[4 * p.n64 + 2 * p.n_frames + 2 * p.n128] != 0;
}

// kv_range and q_range of the rows with ids `d`, narrowed to the frames
// [d.first, d.last] they can see by document.
__device__ __forceinline__ void kv_range_doc(const Params& p,
                                             const DocSpan& d, int q0,
                                             int rows, int bk, int& begin,
                                             int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fq_lo = q0 / p.tpf, fq_hi = (min(q0 + rows, p.L) - 1) / p.tpf;
  const int fk_min = max(w > 0 ? max(0, fq_lo - w + 1) : 0, d.first);
  const int fk_max = min(
      p.causal ? fq_hi : (w > 0 ? min(nf - 1, fq_hi + w - 1) : nf - 1),
      d.last);
  end = min((fk_max + 1) * p.tpf, p.L);
  begin = (fk_min * p.tpf / bk) * bk;
}

__device__ __forceinline__ void q_range_doc(const Params& p, const DocSpan& d,
                                            int k0, int rows, int bq,
                                            int& begin, int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fk_lo = k0 / p.tpf, fk_hi = (min(k0 + rows, p.L) - 1) / p.tpf;
  const int fq_min =
      max(p.causal ? fk_lo : (w > 0 ? max(0, fk_lo - w + 1) : 0), d.first);
  const int fq_max = min(w > 0 ? min(nf - 1, fk_hi + w - 1) : nf - 1, d.last);
  end = min((fq_max + 1) * p.tpf, p.L);
  begin = (fq_min * p.tpf / bq) * bq;
}

// The frames a row sees (kKeysOwn false: a query row of frame f, the keys
// it sees) or that see it (kKeysOwn: a key row, the queries that see it):
// the frame mask's interval narrowed to f's run, as lo + [0, span]; `doc`
// is f's id, compared per element only where the ids decrease.
struct RowIv {
  int lo;
  unsigned span;
  int doc;
};

template <bool kKeysOwn>
__device__ __forceinline__ RowIv row_iv(const Params& p, int b, int f) {
  const int nf = p.n_frames, wl = p.window > 0 ? min(p.window, nf) : nf;
  const int2 run =
      reinterpret_cast<const int2*>(doc_row(p, b) + 4 * p.n64)[f];
  int lo = kKeysOwn ? (p.causal ? f : f - wl + 1) : f - wl + 1;
  int hi = kKeysOwn ? f + wl - 1 : (p.causal ? f : f + wl - 1);
  lo = max(lo, run.x);
  hi = min(hi, run.y);
  return {lo, (unsigned)(hi - lo), doc_of(p, b, f)};
}

// A MASKED tile with documents: -inf where column 8 j + 2 t4 + e of the
// other operand's tile at c0 (its frame, kNoFrame past L) is not visible
// to or from the thread's row i (iv[i]), in the m64 x N accumulator s;
// kIds compares the ids too (rows whose ids decrease). A pass of its own
// before the softmax, so that a FULL tile's exp work is the
// document-free one.
template <int N, bool kIds>
__device__ __forceinline__ void doc_mask_cols(float (&s)[N / 2],
                                              const Params& p, int b,
                                              const RowIv (&iv)[2], int c0,
                                              int t4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * t4 + e;
      const int f = col < p.L ? frame_of(p, col) : kNoFrame;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if ((unsigned)(f - iv[i].lo) > iv[i].span ||
            (kIds && doc_of(p, b, f) != iv[i].doc))
          s[4 * j + 2 * i + e] = -INFINITY;
    }
}

template <int N>
__device__ __forceinline__ void doc_mask(float (&s)[N / 2], const Params& p,
                                         int b, const RowIv (&iv)[2],
                                         bool mono, int c0, int t4) {
  if (mono)
    doc_mask_cols<N, false>(s, p, b, iv, c0, t4);
  else
    doc_mask_cols<N, true>(s, p, b, iv, c0, t4);
}

// The tiles of the other operand that a kDoc block visits where its row's
// ids decrease: bit i of vis for tile i of its range, of full[c] where
// that tile is FULL for consumer c's 64 rows (both tiles of one id, the
// same, and the frame mask alone calls the pair full). Built in shared
// memory by every thread of the block before the producer and the
// consumers part, so that both walk the same tiles and the ring's barrier
// phases stay matched. (Where the ids never decrease the clipped range
// holds no tile to skip and FULL follows from the runs: no walk, no reads
// of other tiles' ids; DocSteps, doc_full.)
template <int kWords>
struct DocWalk {
  uint32_t vis[kWords], full[2][kWords];

  // the first visited tile at or after i, or n
  __device__ __forceinline__ int next(int i, int n) const {
    for (int w = i >> 5; 32 * w < n; ++w) {
      const uint32_t m = vis[w] & (w == (i >> 5) ? ~0u << (i & 31) : ~0u);
      if (m) return 32 * w + __ffs(m) - 1;
    }
    return n;
  }
  __device__ __forceinline__ int count(int n) const {
    int c = 0;
    for (int w = 0; 32 * w < n; ++w) c += __popc(vis[w]);
    return c;
  }
  __device__ __forceinline__ bool is_full(int c, int i) const {
    return (full[c][i >> 5] >> (i & 31)) & 1;
  }
};

// Fill `walk` for the block's 128-row tile at own0 (query rows; key rows
// with kKeysOwn) against the n tiles of bt rows of the other operand from
// `begin`: skipped where the two tiles' [lo, hi] id intervals are
// disjoint. One tile a thread, a ballot a word; the caller syncs.
template <bool kKeysOwn, int kWords>
__device__ void doc_walk_build(const Params& p, int b, int own0, int begin,
                               int bt, int n, DocWalk<kWords>* walk) {
  const int* row = doc_row(p, b);
  const DocSpan own = doc_span(row, p.n64, own0, kRows);
  DocSpan half[2];
  bool single[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int r = own0 + 64 * c;
    half[c] = r < p.L ? doc_span(row, p.n64, r, 64) : own;
    single[c] = r < p.L && half[c].lo == half[c].hi;
  }
  for (int i = threadIdx.x; i < (n + 31) / 32 * 32; i += blockDim.x) {
    bool vis = false, f[2] = {false, false};
    if (i < n) {
      const int o0 = begin + i * bt;
      const DocSpan o = doc_span(row, p.n64, o0, bt);
      vis = o.lo <= own.hi && own.lo <= o.hi;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = own0 + 64 * c;
        f[c] = vis && o.lo == o.hi && single[c] && half[c].lo == o.lo &&
               (kKeysOwn ? tile_full(p, o0, bt, r, 64)
                         : tile_full(p, r, 64, o0, bt));
      }
    }
    const uint32_t mv = __ballot_sync(~0u, vis);
    const uint32_t m0 = __ballot_sync(~0u, f[0]);
    const uint32_t m1 = __ballot_sync(~0u, f[1]);
    if (threadIdx.x % 32 == 0) {
      walk->vis[i / 32] = mv;
      walk->full[0][i / 32] = m0;
      walk->full[1][i / 32] = m1;
    }
  }
}

// A kDoc block's walk over the n tiles of its clipped range: every tile
// where the row's ids never decrease (the clip leaves none there that the
// ids skip), else the tiles of the shared-memory walk.
template <int kWords>
struct DocSteps {
  const DocWalk<kWords>* walk;
  int n;
  bool mono;
  __device__ __forceinline__ int next(int i) const {
    return mono ? i : walk->next(i, n);
  }
  __device__ __forceinline__ int count() const {
    return mono ? n : walk->count(n);
  }
};

// A consumer's 64 rows at r0 (query rows; key rows in dkv): whether they
// hold one id, and that id's run as rows [run0, run1) (read where the
// row's ids never decrease, when the run is the id's only one).
struct DocHalf {
  bool single;
  int run0, run1;
};

__device__ __forceinline__ DocHalf doc_half(const Params& p, int b, int r0) {
  if (r0 >= p.L) return {false, 0, 0};
  const DocSpan s = doc_span(doc_row(p, b), p.n64, r0, 64);
  return {s.lo == s.hi, s.first * p.tpf, min((s.last + 1) * p.tpf, p.L)};
}

// Whether the other operand's tile [o0, o0 + bt) (tile ti of the range) is
// FULL for consumer c's rows at r0: where the ids never decrease, the tile
// lies in the run of the rows' one id and the frame mask calls the pair
// full; elsewhere the walk's bit says so.
template <bool kKeysOwn, int kWords>
__device__ __forceinline__ bool doc_full(const Params& p,
                                         const DocSteps<kWords>& steps,
                                         const DocHalf& h, int c, int ti,
                                         int r0, int o0, int bt) {
  if (!steps.mono) return steps.walk->is_full(c, ti);
  return h.single && o0 >= h.run0 && o0 + bt <= h.run1 &&
         (kKeysOwn ? tile_full(p, o0, bt, r0, 64)
                   : tile_full(p, r0, 64, o0, bt));
}

// The block's 128-row tile with documents: its place in the helper's
// order by work (order_k for a dkv block, else order_q).
__device__ __forceinline__ int doc_tile_of(const Params& p, int b,
                                           bool keys) {
  const int* order = doc_row(p, b) + 4 * p.n64 + 2 * p.n_frames +
                     (keys ? p.n128 : 0);
  return order[blockIdx.x] * kRows;
}

__device__ __forceinline__ long long stat_index(const Params& p, int b, int h,
                                                int row) {
  return ((long long)b * p.H + h) * p.L + row;
}

// The work items of a persistent block (fwd_items): the 128-row
// tiles of every (b, h), item w = (b * H + h) * n + tile for n tiles
// along L, taken w = blockIdx.x, blockIdx.x + gridDim.x, ... (neighbouring
// blocks on neighbouring tiles of one head, which share their K/V in L2).
struct Item {
  int b, h, row0;
};

__device__ __forceinline__ int item_count(const Params& p) {
  return (p.L + kRows - 1) / kRows * p.B * p.H;
}

__device__ __forceinline__ Item item_of(const Params& p, int w) {
  const int n = (p.L + kRows - 1) / kRows, bh = w / n;
  return {bh / p.H, bh % p.H, (w % n) * kRows};
}

// The query tile of this block: a causal grid runs its heaviest (last)
// query tiles first.
__device__ __forceinline__ int query_tile(const Params& p, int rows) {
  return (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * rows;
}

// Write a consumer thread's two rows of an m64 x D accumulator, row i
// times mul[i], as bf16; rows at or past L are not written. `row` is the
// first of the two rows (the second is 8 below).
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long s_row,
                                           int row, int L,
                                           const float (&acc)[D / 2],
                                           const float (&mul)[2], int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= L) continue;
    bf16* out = base + (long long)r * s_row + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
  }
}

// ------------------------------------------------------------ forward

// Q [128, D] once; K and V [128, D] per stage. (Three consumers, 192 rows
// a block, would leave 160 registers each, and the forward spills there.)
// With documents the walk's bits follow the barriers: 128 words a mask
// take 4,096 key tiles (L <= kDocMaxL) and fit the 1,992 bytes Dh 128
// leaves.
template <int D>
struct Fwd : Shape {
  static constexpr int kBM = kRows, kBK = 128, kStages = 3;
  static constexpr int kBoxQ = kBM, kBoxKV = kBK;
  static constexpr int kQBytes = kBM * D * 2, kKVBytes = kBK * D * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  static constexpr int kWalkWords = 128;
};

// The longest L K1 takes with documents: every body's walk holds its
// range's tiles (4,096 of 128 rows, 8,192 of 64).
constexpr int kDocMaxL = 1 << 19;

// A body's block with documents: the walk after the barriers.
template <template <int> class Cfg>
struct WithDoc {
  template <int D>
  struct Of : Cfg<D> {
    static constexpr size_t kSmem =
        Cfg<D>::kSmem + sizeof(DocWalk<Cfg<D>::kWalkWords>);
  };
};

// The persistent forward's block: Q double-buffered where shared memory
// holds two (Dh 64), so that the next tile's Q lands while this one runs.
template <int D>
struct FwdItems : Fwd<D> {
  using F = Fwd<D>;
  static constexpr bool kPersistent = true;  // a block per SM (run)
  static constexpr int kQBufs = D == 64 ? 2 : 1;
  static constexpr size_t kSmem = 1024 + kQBufs * F::kQBytes +
                                  2 * F::kStages * F::kKVBytes +
                                  8 * (2 * kQBufs + 2 * F::kStages);
};

// The forward of K1 and K4. Replaces the splash forward kernel reached by
// owl_audio_exps_tpu/ops/splash.py splash_attention (K1) and, with
// save_residuals, splash_attention_lse (K4). Bound: 4 Dh flops and one exp
// a visible pair. One 128-row query tile at q0 of head (b, h): the output,
// and the f32 logsumexp when p.lse. Each consumer: S = Q.K^T (m64 n128,
// K-major Q and K), mask unless the tile is FULL, online softmax in f32
// (row max and sum over the quad that holds a row), O += P.V with P from
// registers and V MN-major; pipelined and taking turns, as the header says.
template <int D, bool kDoc = false>
__device__ __forceinline__ void fwd_block(const Maps& maps, const Params& p,
                                          int b, int h, int q0) {
  using C = Fwd<D>;
  uint8_t* sQ = smem_base();
  uint8_t* sK = sQ + C::kQBytes;
  uint8_t* sV = sK + C::kStages * C::kKVBytes;
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sV + C::kStages * C::kKVBytes);
  uint64_t* full = barQ + 1;
  uint64_t* empty = full + C::kStages;
  [[maybe_unused]] auto* walk =
      reinterpret_cast<DocWalk<C::kWalkWords>*>(empty + C::kStages);
  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kDoc) {  // Q first: the summary's reads overlap it
      mbar_expect_tx(barQ, C::kQBytes);
      load_rows<D, C::kBM>(sQ, &maps.q, barQ, q0, h, b);
    }
  }
  int kv_begin, kv_end;
  [[maybe_unused]] bool mono = false;
  if constexpr (kDoc) {  // the clipped range (and walk), before the sync
    mono = doc_mono(p, b);
    kv_range_doc(p, doc_span(doc_row(p, b), p.n64, q0, C::kBM), q0, C::kBM,
                 C::kBK, kv_begin, kv_end);
    if (!mono)
      doc_walk_build<false>(p, b, q0, kv_begin, C::kBK,
                            (kv_end - kv_begin + C::kBK - 1) / C::kBK, walk);
  }
  __syncthreads();

  if constexpr (!kDoc) kv_range(p, q0, C::kBM, C::kBK, kv_begin, kv_end);
  const int n_tiles = (kv_end - kv_begin + C::kBK - 1) / C::kBK;
  [[maybe_unused]] const DocSteps<C::kWalkWords> steps{walk, n_tiles, mono};

  if (threadIdx.x < 128) {  // producer
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&maps.q);
      prefetch_map(&maps.k);
      prefetch_map(&maps.v);
      if constexpr (!kDoc) {
        mbar_expect_tx(barQ, C::kQBytes);
        load_rows<D, C::kBM>(sQ, &maps.q, barQ, q0, h, b);
      }
      // the t-th tile loaded, key tile ti of the range
      auto load = [&](int t, int ti) {
        const int s = t % C::kStages;
        mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        const int k0 = kv_begin + ti * C::kBK;
        load_rows<D, C::kBK>(sK + s * C::kKVBytes, &maps.k, &full[s], k0, h, b);
        load_rows<D, C::kBK>(sV + s * C::kKVBytes, &maps.v, &full[s], k0, h, b);
      };
      if constexpr (kDoc) {
        for (int t = 0, ti = steps.next(0); ti < n_tiles;
             ++t, ti = steps.next(ti + 1))
          load(t, ti);
      } else {
        for (int t = 0; t < n_tiles; ++t) load(t, t);
      }
    }
  } else {  // consumers
    regs_inc<C::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // rows [64 cw, 64 cw + 64)
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * cw;           // this warpgroup's first row
    const int row = r0 + 16 * warp + g;    // this thread's rows: row, row + 8
    const int L = p.L;
    const Mask mk = mask_of(p);
    int fq[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) fq[i] = min(row + 8 * i, L - 1) / p.tpf;
    [[maybe_unused]] RowIv iv[2];
    [[maybe_unused]] DocHalf half{};
    if constexpr (kDoc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) iv[i] = row_iv<false>(p, b, fq[i]);
      half = doc_half(p, b, r0);
    }
    const float c = p.logit_mul * kLog2e;

    mbar_wait(barQ, 0);
    if (p.scale_q) {
      scale_rows<D, C::kBM>(sQ, 64 * cw, 64, p.scale, tid, 128);
      fence_async_smem();
      named_sync(1 + cw, 128);
    }
    const uint32_t q_addr = smem_u32(sQ);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S_t = Q.K_t^T into sc (stage t % kStages, once it has landed)
    float sc[C::kBK / 2];
    auto ready = [&](int t) {
      mbar_wait(&full[t % C::kStages], (t / C::kStages) & 1);
    };
    auto issue_s = [&](int t) {
      const uint32_t k_addr = smem_u32(sK + t % C::kStages * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<C::kBK>(sc, kmajor<C::kBM>(q_addr, 64 * cw, kk),
                       kmajor<C::kBK>(k_addr, 0, kk), kk > 0);
      wg_commit();
    };
    const Turns turn{cw};
    turn.init();
    ready(0);
    turn.begin();
    wg_fence();
    issue_s(0);
    turn.end();
    wg_wait0();
    keep(sc);

    // Software pipeline: the softmax of tile t runs while P_{t-1}.V_{t-1}
    // is still on the tensor cores, and S_{t+1} is issued with P_t.V_t.
    uint32_t pa[C::kBK / 16][4];
    // the last tile is peeled (no next tile to issue), so that every
    // wgmma group in the loop is committed on every path. Step t runs key
    // tile ti of the range (ti == t without documents).
    auto step = [&](int t, int ti, auto more) {
      const int s = t % C::kStages;
      const int k0 = kv_begin + ti * C::kBK;

      if constexpr (kDoc) {
        if (!doc_full<false>(p, steps, half, cw, ti, r0, k0, C::kBK))
          doc_mask<C::kBK>(sc, p, b, iv, mono, k0, t4);
      } else if (!tile_full(p, r0, 64, k0, C::kBK)) {
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t4 + e;
            const int fk = col < L ? frame_of(p, col) : kNoFrame;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (!in_mask(mk, fq[i], fk)) sc[4 * j + 2 * i + e] = -INFINITY;
          }
      }

      // online softmax; a row's values live in the 4 threads of a quad
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with nothing visible yet keeps m = -inf; shift by 0 then
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2((m[i] - m_use) * c);
        m[i] = m_new;
        const float mc = m_use * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(fmaf(sc[4 * j + 2 * i + e], c, -mc));
            sc[4 * j + 2 * i + e] = pv;
            sum += pv;
          }
        l[i] = l[i] * alpha[i] + sum;
      }
      // P_{t-1}.V_{t-1} done: its stage is free, o is ours (unconditional,
      // so that ptxas sees no path reading o while a product writes it)
      wg_wait0();
      keep(o);
      if (t > 0 && tid == 0) mbar_arrive(&empty[(t - 1) % C::kStages]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      to_a<C::kBK>(pa, sc);
      keep(pa);
      keep(o);
      constexpr bool next = decltype(more)::value;
      if constexpr (next) ready(t + 1);
      turn.begin();
      wg_fence();
      if constexpr (next) issue_s(t + 1);
      const uint32_t v_addr = smem_u32(sV + s * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk)
        mma_rs<D>(o, pa[kk], mnmajor<C::kBK>(v_addr, kk));
      wg_commit();
      turn.end();
      if constexpr (next) {  // S_{t+1} done; P_t.V_t may still run
        wg_wait1();
        keep(sc);
      }
    };
    int n_run = n_tiles;  // the tiles walked
    if constexpr (kDoc) {
      n_run = steps.count();
      int ti = steps.next(0);
      for (int t = 0; t + 1 < n_run; ++t) {
        const int next = steps.next(ti + 1);
        step(t, ti, std::true_type{});
        ti = next;
      }
      step(n_run - 1, ti, std::false_type{});
    } else {
      for (int t = 0; t + 1 < n_tiles; ++t) step(t, t, std::true_type{});
      step(n_tiles - 1, n_tiles - 1, std::false_type{});
    }
    wg_wait0();
    keep(o);
    if (tid == 0) mbar_arrive(&empty[(n_run - 1) % C::kStages]);

    // normalise and write; rows at or past L are not written
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffff, li, 1);
      li += __shfl_xor_sync(0xffffffff, li, 2);
      inv[i] = li > 0.f ? 1.f / li : 0.f;
      const int r = row + 8 * i;
      if (p.lse && t4 == 0 && r < L) {
        const float shift = m[i] == -INFINITY ? 0.f : m[i] * p.logit_mul;
        p.lse[stat_index(p, b, h, r)] = li > 0.f ? shift + logf(li) : INFINITY;
      }
    }
    store_rows<D>(p.o + b * p.s_o[0] + h * p.s_o[1], p.s_o[2], row, L, o,
                  inv, t4);
  }
}

// The band's forward (K2/K3, K5): the same tile work as fwd_block, in
// both softmax forms (kFixed: the sum alone, no max, no rescale), on a
// persistent grid (fwd_items). It is a second copy of the forward, not a
// shared one: built from these parts, fwd_block's code grows (more spills,
// K1 and K4 2.5-4.8% slower on the card, PERF.md section 6). It serves only
// the band, which has no documents (p.doc is null): its mask is the
// window's alone, and a change to K1's document mask needs no copy here.

// The key tiles of the query tile at q0: n_tiles of kBK rows from
// kv_begin.
template <class C>
__device__ __forceinline__ int kv_tiles(const Params& p, int q0,
                                        int& kv_begin) {
  int kv_end;
  kv_range(p, q0, kRows, C::kBK, kv_begin, kv_end);
  return (kv_end - kv_begin + C::kBK - 1) / C::kBK;
}

// The producer's loads for the query tile at q0 of (b, h): Q into sQ
// (completing on barQ), then its n_tiles key tiles from kv_begin through
// the stage ring from slot g0 (stage g % kStages, phase (g / kStages) & 1
// for slot g, so a block that runs several tiles keeps one ring).
template <int D>
__device__ __forceinline__ void fwd_load(const Maps& maps, const Params& p,
                                         int b, int h, int q0, int kv_begin,
                                         int n_tiles, uint8_t* sQ,
                                         uint64_t* barQ, uint8_t* sK,
                                         uint8_t* sV, uint64_t* full,
                                         uint64_t* empty, int g0) {
  using C = Fwd<D>;
  mbar_expect_tx(barQ, C::kQBytes);
  load_rows<D, C::kBM>(sQ, &maps.q, barQ, q0, h, b);
  for (int t = 0; t < n_tiles; ++t) {
    const int g = g0 + t, s = g % C::kStages;
    mbar_wait(&empty[s], ((g / C::kStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * C::kKVBytes);
    const int k0 = kv_begin + t * C::kBK;
    load_rows<D, C::kBK>(sK + s * C::kKVBytes, &maps.k, &full[s], k0, h, b);
    load_rows<D, C::kBK>(sV + s * C::kKVBytes, &maps.v, &full[s], k0, h, b);
  }
}

// A consumer warpgroup's part of the query tile at q0 of (b, h): Q from
// sQ once barQ completes phase q_phase, its n_tiles key tiles from ring
// slot g0; arrives on qfree (when given) once Q is read. `first`: the
// block's first tile (the turns start).
template <int D, bool kFixed>
__device__ __forceinline__ void fwd_compute(const Params& p, int b, int h,
                                            int q0, int kv_begin,
                                            int n_tiles, uint8_t* sQ,
                                            uint64_t* barQ, int q_phase,
                                            uint64_t* qfree, uint8_t* sK,
                                            uint8_t* sV, uint64_t* full,
                                            uint64_t* empty, int g0,
                                            const Turns& turn, bool first) {
  using C = Fwd<D>;
  const int cw = threadIdx.x / 128 - 1;  // rows [64 cw, 64 cw + 64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * cw;           // this warpgroup's first row
  const int row = r0 + 16 * warp + g;    // this thread's rows: row, row + 8
  const int L = p.L;
  const Mask mk = mask_of(p);
  int fq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) fq[i] = min(row + 8 * i, L - 1) / p.tpf;
  const float c = p.logit_mul * kLog2e;
  const float cap2 = kFixed ? p.cap * kLog2e : 0.f;

  mbar_wait(barQ, q_phase);
  if (p.scale_q) {
    scale_rows<D, C::kBM>(sQ, 64 * cw, 64, p.scale, tid, 128);
    fence_async_smem();
    named_sync(1 + cw, 128);
  }
  const uint32_t q_addr = smem_u32(sQ);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // S_t = Q.K_t^T into sc (ring slot g0 + t, once it has landed)
  float sc[C::kBK / 2];
  auto ready = [&](int t) {
    mbar_wait(&full[(g0 + t) % C::kStages], ((g0 + t) / C::kStages) & 1);
  };
  auto issue_s = [&](int t) {
    const uint32_t k_addr =
        smem_u32(sK + (g0 + t) % C::kStages * C::kKVBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<C::kBK>(sc, kmajor<C::kBM>(q_addr, 64 * cw, kk),
                     kmajor<C::kBK>(k_addr, 0, kk), kk > 0);
    wg_commit();
  };
  if (first) turn.init();
  ready(0);
  turn.begin();
  wg_fence();
  issue_s(0);
  turn.end();
  wg_wait0();
  keep(sc);

  // Software pipeline: the softmax of tile t runs while P_{t-1}.V_{t-1}
  // is still on the tensor cores, and S_{t+1} is issued with P_t.V_t.
  uint32_t pa[C::kBK / 16][4];
  // the last tile is peeled (no next tile to issue), so that every
  // wgmma group in the loop is committed on every path
  auto step = [&](int t, auto more) {
    const int s = (g0 + t) % C::kStages;
    const int k0 = kv_begin + t * C::kBK;

    if (!tile_full(p, r0, 64, k0, C::kBK)) {
#pragma unroll
      for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + e;
          const int fk = col < L ? frame_of(p, col) : kNoFrame;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (!in_mask(mk, fq[i], fk)) sc[4 * j + 2 * i + e] = -INFINITY;
        }
    }

    // a row's values live in the 4 threads of a quad
    [[maybe_unused]] float alpha[2];
    if constexpr (kFixed) {  // p = exp(min(s, cap) - cap): no max, no rescale
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(fmaf(
                softmax_logit<true>(sc[4 * j + 2 * i + e], p.cap_raw), c,
                -cap2));
            sc[4 * j + 2 * i + e] = pv;
            sum += pv;
          }
        l[i] += sum;
      }
    } else {  // online softmax
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with nothing visible yet keeps m = -inf; shift by 0 then
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2((m[i] - m_use) * c);
        m[i] = m_new;
        const float mc = m_use * c;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(fmaf(sc[4 * j + 2 * i + e], c, -mc));
            sc[4 * j + 2 * i + e] = pv;
            sum += pv;
          }
        l[i] = l[i] * alpha[i] + sum;
      }
    }
    // P_{t-1}.V_{t-1} done: its stage is free, o is ours (unconditional,
    // so that ptxas sees no path reading o while a product writes it)
    wg_wait0();
    keep(o);
    if (t > 0 && tid == 0) mbar_arrive(&empty[(g0 + t - 1) % C::kStages]);
    if constexpr (!kFixed) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    to_a<C::kBK>(pa, sc);
    keep(pa);
    keep(o);
    constexpr bool next = decltype(more)::value;
    if constexpr (next) ready(t + 1);
    turn.begin();
    wg_fence();
    if constexpr (next) issue_s(t + 1);
    const uint32_t v_addr = smem_u32(sV + s * C::kKVBytes);
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk)
      mma_rs<D>(o, pa[kk], mnmajor<C::kBK>(v_addr, kk));
    wg_commit();
    turn.end();
    if constexpr (next) {  // S_{t+1} done; P_t.V_t may still run
      wg_wait1();
      keep(sc);
    }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::true_type{});
  step(n_tiles - 1, std::false_type{});
  wg_wait0();
  keep(o);
  if (tid == 0) {
    mbar_arrive(&empty[(g0 + n_tiles - 1) % C::kStages]);
    if (qfree) mbar_arrive(qfree);  // this item's Q is read
  }

  // normalise and write; rows at or past L are not written
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffff, li, 1);
    li += __shfl_xor_sync(0xffffffff, li, 2);
    inv[i] = li > 0.f ? 1.f / li : 0.f;
    const int r = row + 8 * i;
    if (p.lse && t4 == 0 && r < L) {
      const float shift =
          kFixed ? p.cap
                 : (m[i] == -INFINITY ? 0.f : m[i] * p.logit_mul);
      p.lse[stat_index(p, b, h, r)] = li > 0.f ? shift + logf(li) : INFINITY;
    }
  }
  store_rows<D>(p.o + b * p.s_o[0] + h * p.s_o[1], p.s_o[2], row, L, o,
                inv, t4);
}

// The persistent forward: a block runs the query tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of all (b, h) (item_of) through one stage
// ring. The producer loads the next tile's Q (into the other buffer, or
// once the consumers have read this one) and its first K/V stages while
// the consumers finish the current tile and write it out.
template <int D, bool kFixed>
__device__ __forceinline__ void fwd_items(const Maps& maps,
                                          const Params& p) {
  using C = FwdItems<D>;
  uint8_t* sQ = smem_base();
  uint8_t* sK = sQ + C::kQBufs * C::kQBytes;
  uint8_t* sV = sK + C::kStages * C::kKVBytes;
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sV + C::kStages * C::kKVBytes);
  uint64_t* qfree = barQ + C::kQBufs;
  uint64_t* full = qfree + C::kQBufs;
  uint64_t* empty = full + C::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kQBufs; ++i) {
      mbar_init(&barQ[i], 1);
      mbar_init(&qfree[i], C::kConsumers);
    }
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_items = item_count(p);
  if (threadIdx.x < 128) {  // producer
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&maps.q);
      prefetch_map(&maps.k);
      prefetch_map(&maps.v);
      for (int i = 0, w = blockIdx.x, g = 0; w < n_items;
           ++i, w += gridDim.x) {
        const int qb = i % C::kQBufs, use = i / C::kQBufs;
        const Item it = item_of(p, w);
        int kv_begin;
        const int n_tiles = kv_tiles<C>(p, it.row0, kv_begin);
        mbar_wait(&qfree[qb], (use & 1) ^ 1);
        fwd_load<D>(maps, p, it.b, it.h, it.row0, kv_begin, n_tiles,
                    sQ + qb * C::kQBytes, &barQ[qb], sK, sV, full, empty, g);
        g += n_tiles;
      }
    }
  } else {  // consumers
    regs_inc<C::kConsumerRegs>();
    const Turns turn{(int)threadIdx.x / 128 - 1};
    for (int i = 0, w = blockIdx.x, g = 0; w < n_items; ++i, w += gridDim.x) {
      const int qb = i % C::kQBufs, use = i / C::kQBufs;
      const Item it = item_of(p, w);
      int kv_begin;
      const int n_tiles = kv_tiles<C>(p, it.row0, kv_begin);
      fwd_compute<D, kFixed>(p, it.b, it.h, it.row0, kv_begin, n_tiles,
                             sQ + qb * C::kQBytes, &barQ[qb], use & 1,
                             &qfree[qb], sK, sV, full, empty, g, turn,
                             i == 0);
      g += n_tiles;
    }
  }
}

// ----------------------------------------------------------------- dq

// Q, dO (and O, for K1's delta) [128, D] once; K and V [64, D] per stage.
template <int D>
struct Dq : Shape {
  static constexpr int kBM = kRows, kBK = 64, kStages = 3;
  static constexpr int kBoxQ = kRows, kBoxKV = kBK;
  static constexpr int kQBytes = kRows * D * 2, kKVBytes = kBK * D * 2;
  static constexpr size_t kSmem = 1024 + 3 * kQBytes +
                                  2 * kStages * kKVBytes + 4 * kRows +
                                  8 * (1 + 2 * kStages);
  static constexpr int kWalkWords = 256;  // 8,192 key tiles of 64 rows
};

// dq. Replaces the splash library's dq kernel (_splash_attention_bwd_dq,
// reached by splash_attention's vjp, K1, and splash_attention_lse_vjp,
// K4), and the query side of the band backwards (K2/K3, K5). Bound: 6 Dh
// flops and one exp a visible pair. dq of the 128-row
// query tile at q0: the same keys as the forward, in 64-row tiles (128
// need 64 more registers a thread, and ptxas serializes the products). Each
// consumer: S = Q.K^T and dP = dO.V^T (m64 n64, K-major), P = exp(S - lse)
// masked, dS = P (dP - delta), dQ += dS.K with dS from registers and K
// MN-major; pipelined and taking turns. delta comes from this tile's dO
// and O and is stored for the dkv pass, or, with kReadDelta (K4), is read
// from p.delta. With kFixed, P = exp(min(S, cap) - lse).
template <int D, bool kReadDelta, bool kFixed = false, bool kDoc = false>
__device__ __forceinline__ void dq_block(const Maps& maps, const Params& p,
                                         int b, int h, int q0) {
  using C = Dq<D>;
  uint8_t* sQ = smem_base();
  uint8_t* sdO = sQ + C::kQBytes;
  uint8_t* sO = sdO + C::kQBytes;
  uint8_t* sK = sO + C::kQBytes;
  uint8_t* sV = sK + C::kStages * C::kKVBytes;
  float* sDelta = reinterpret_cast<float*>(sV + C::kStages * C::kKVBytes);
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sDelta + kRows);
  uint64_t* full = barQ + 1;
  uint64_t* empty = full + C::kStages;
  [[maybe_unused]] auto* walk =
      reinterpret_cast<DocWalk<C::kWalkWords>*>(empty + C::kStages);
  // Q, dO (and O) of the query tile
  auto load_own = [&] {
    mbar_expect_tx(barQ, (kReadDelta ? 2 : 3) * C::kQBytes);
    load_rows<D, kRows>(sQ, &maps.q, barQ, q0, h, b);
    load_rows<D, kRows>(sdO, &maps.dout, barQ, q0, h, b);
    if (!kReadDelta) load_rows<D, kRows>(sO, &maps.o, barQ, q0, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kDoc) load_own();  // the summary's reads overlap it
  }
  int kv_begin, kv_end;
  [[maybe_unused]] bool mono = false;
  if constexpr (kDoc) {  // the clipped range (and walk), before the sync
    mono = doc_mono(p, b);
    kv_range_doc(p, doc_span(doc_row(p, b), p.n64, q0, kRows), q0, kRows,
                 C::kBK, kv_begin, kv_end);
    if (!mono)
      doc_walk_build<false>(p, b, q0, kv_begin, C::kBK,
                            (kv_end - kv_begin + C::kBK - 1) / C::kBK, walk);
  }
  __syncthreads();

  if constexpr (!kDoc) kv_range(p, q0, kRows, C::kBK, kv_begin, kv_end);
  const int n_tiles = (kv_end - kv_begin + C::kBK - 1) / C::kBK;
  [[maybe_unused]] const DocSteps<C::kWalkWords> steps{walk, n_tiles, mono};

  if (threadIdx.x < 128) {  // producer
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      if constexpr (!kDoc) load_own();
      // the t-th tile loaded, key tile ti of the range
      auto load = [&](int t, int ti) {
        const int s = t % C::kStages;
        mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        const int k0 = kv_begin + ti * C::kBK;
        load_rows<D, C::kBK>(sK + s * C::kKVBytes, &maps.k, &full[s], k0, h, b);
        load_rows<D, C::kBK>(sV + s * C::kKVBytes, &maps.v, &full[s], k0, h, b);
      };
      if constexpr (kDoc) {
        for (int t = 0, ti = steps.next(0); ti < n_tiles;
             ++t, ti = steps.next(ti + 1))
          load(t, ti);
      } else {
        for (int t = 0; t < n_tiles; ++t) load(t, t);
      }
    }
  } else {  // consumers
    regs_inc<C::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * cw;
    const int row = r0 + 16 * warp + g;
    const int L = p.L;
    const Mask mk = mask_of(p);
    int fq[2];
    float lse2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      fq[i] = min(r, L - 1) / p.tpf;
      lse2[i] = r < L ? p.lse[stat_index(p, b, h, r)] * kLog2e : INFINITY;
      if (kReadDelta) delta[i] = r < L ? p.delta[stat_index(p, b, h, r)] : 0.f;
    }
    [[maybe_unused]] RowIv iv[2];
    [[maybe_unused]] DocHalf half{};
    if constexpr (kDoc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) iv[i] = row_iv<false>(p, b, fq[i]);
      half = doc_half(p, b, r0);
    }
    const float c = p.logit_mul * kLog2e;

    mbar_wait(barQ, 0);
    if (p.scale_q) {
      scale_rows<D, kRows>(sQ, 64 * cw, 64, p.scale, tid, 128);
      fence_async_smem();
    }
    if (!kReadDelta) {
      // delta = rowsum(dO * O): two threads a row, each half the row's
      // 16-byte chunks (dO and O are swizzled alike, so chunks pair up)
      const int rl = 64 * cw + tid / 2, half = tid % 2;
      float acc = 0.f;
#pragma unroll
      for (int ch = 0; ch < D / 16; ++ch) {
        const int chunk = half * (D / 16) + ch;  // of the row's D / 8
        const int off = (chunk / 8) * kRows * 128 + rl * 128 + (chunk % 8) * 16;
        const uint4 a = *reinterpret_cast<const uint4*>(sdO + off);
        const uint4 bb = *reinterpret_cast<const uint4*>(sO + off);
        const bf16* ea = reinterpret_cast<const bf16*>(&a);
        const bf16* eb = reinterpret_cast<const bf16*>(&bb);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += __bfloat162float(ea[e]) * __bfloat162float(eb[e]);
      }
      acc += __shfl_xor_sync(0xffffffff, acc, 1);
      if (half == 0) {
        sDelta[rl] = acc;
        if (q0 + rl < L) p.delta[stat_index(p, b, h, q0 + rl)] = acc;
      }
    }
    if (p.scale_q || !kReadDelta) named_sync(1 + cw, 128);
    if (!kReadDelta) {
#pragma unroll
      for (int i = 0; i < 2; ++i) delta[i] = sDelta[row + 8 * i - q0];
    }
    const uint32_t q_addr = smem_u32(sQ), do_addr = smem_u32(sdO);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // S_t = Q.K_t^T and dP_t = dO.V_t^T into sc, dp
    float sc[C::kBK / 2], dp[C::kBK / 2];
    auto ready = [&](int t) {
      mbar_wait(&full[t % C::kStages], (t / C::kStages) & 1);
    };
    auto issue_s = [&](int t) {
      const int st = t % C::kStages;
      const uint32_t k_addr = smem_u32(sK + st * C::kKVBytes);
      const uint32_t v_addr = smem_u32(sV + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<C::kBK>(sc, kmajor<kRows>(q_addr, 64 * cw, kk),
                       kmajor<C::kBK>(k_addr, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<C::kBK>(dp, kmajor<kRows>(do_addr, 64 * cw, kk),
                       kmajor<C::kBK>(v_addr, 0, kk), kk > 0);
      wg_commit();
    };
    const Turns turn{cw};
    turn.init();
    ready(0);
    turn.begin();
    wg_fence();
    issue_s(0);
    turn.end();
    wg_wait0();
    keep(sc);
    keep(dp);

    // Software pipeline: dS of tile t is computed while dS_{t-1}.K_{t-1}
    // is still on the tensor cores; S_{t+1}, dP_{t+1} go with dS_t.K_t.
    uint32_t da[C::kBK / 16][4];
    // the last tile is peeled (no next tile to issue), so that every
    // wgmma group in the loop is committed on every path. Step t runs key
    // tile ti of the range (ti == t without documents).
    auto step = [&](int t, int ti, auto more) {
      const int s = t % C::kStages;
      const int k0 = kv_begin + ti * C::kBK;
      if constexpr (kDoc) {  // masked to -inf first: exp(-inf) is 0
        if (!doc_full<false>(p, steps, half, cw, ti, r0, k0, C::kBK))
          doc_mask<C::kBK>(sc, p, b, iv, mono, k0, t4);
#pragma unroll
        for (int x = 0; x < C::kBK / 2; ++x) {
          const int i = (x / 2) % 2;
          const float pij = ex2(fmaf(softmax_logit<kFixed>(sc[x], p.cap_raw),
                                     c, -lse2[i]));
          sc[x] = pij * (dp[x] - delta[i]);  // dS
        }
      } else {
        const bool full_tile = tile_full(p, r0, 64, k0, C::kBK);
#pragma unroll
        for (int j = 0; j < C::kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t4 + e;
            int fk = 0;
            if (!full_tile) fk = col < L ? frame_of(p, col) : kNoFrame;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * j + 2 * i + e;
              const bool vis = full_tile || in_mask(mk, fq[i], fk);
              const float pij =
                  vis ? ex2(fmaf(softmax_logit<kFixed>(sc[x], p.cap_raw), c,
                                 -lse2[i]))
                      : 0.f;
              sc[x] = pij * (dp[x] - delta[i]);  // dS
            }
          }
      }
      // dS_{t-1}.K_{t-1} done: its stage and da are free
      wg_wait0();
      keep(acc);
      if (t > 0 && tid == 0) mbar_arrive(&empty[(t - 1) % C::kStages]);
      to_a<C::kBK>(da, sc);
      keep(da);
      keep(acc);
      constexpr bool next = decltype(more)::value;
      if constexpr (next) ready(t + 1);
      turn.begin();
      wg_fence();
      if constexpr (next) issue_s(t + 1);
      const uint32_t k_addr = smem_u32(sK + s * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk)
        mma_rs<D>(acc, da[kk], mnmajor<C::kBK>(k_addr, kk));
      wg_commit();
      turn.end();
      if constexpr (next) {  // S_{t+1}, dP_{t+1} done; dS_t.K_t may run on
        wg_wait1();
        keep(sc);
        keep(dp);
      }
    };
    int n_run = n_tiles;  // the tiles walked
    if constexpr (kDoc) {
      n_run = steps.count();
      int ti = steps.next(0);
      for (int t = 0; t + 1 < n_run; ++t) {
        const int next = steps.next(ti + 1);
        step(t, ti, std::true_type{});
        ti = next;
      }
      step(n_run - 1, ti, std::false_type{});
    } else {
      for (int t = 0; t + 1 < n_tiles; ++t) step(t, t, std::true_type{});
      step(n_tiles - 1, n_tiles - 1, std::false_type{});
    }
    wg_wait0();
    keep(acc);
    if (tid == 0) mbar_arrive(&empty[(n_run - 1) % C::kStages]);
    // s = scale q . k, so dq = scale * dS . K
    const float mul[2] = {p.scale, p.scale};
    store_rows<D>(p.dq + b * p.s_dq[0] + h * p.s_dq[1], p.s_dq[2], row, L,
                  acc, mul, t4);
  }
}

// ---------------------------------------------------------------- dkv

// K and V [128, D] once; Q and dO [64, D], and the 64 rows' lse and delta,
// per stage.
template <int D>
struct Dkv : Shape {
  static constexpr int kBM = kRows, kBQ = 64, kStages = 2;
  static constexpr int kBoxQ = kBQ, kBoxKV = kRows;
  static constexpr int kKVBytes = kRows * D * 2, kQBytes = kBQ * D * 2;
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  kStages * (2 * kQBytes + 8 * kBQ) +
                                  8 * (1 + 2 * kStages);
  static constexpr int kWalkWords = 256;  // 8,192 query tiles of 64 rows
};

// dkv. Replaces the splash library's dkv kernel (_splash_attention_bwd_dkv,
// K1 and K4), and the key side of the band backwards (K2/K3, K5). Bound:
// 8 Dh flops and one exp a visible pair. dk, dv of the
// 128-row key tile at k0: the query tiles that can see it (q_range), taking
// turns but not pipelined (see the header). Each consumer computes the
// transposed products directly:
// S^T = K.Q^T and dP^T = V.dO^T (m64 n64, K-major), P^T = exp(S^T - lse)
// masked, dS^T = P^T (dP^T - delta), both left in the accumulator layout,
// which is the register A operand of dV += P^T.dO and dK += dS^T.Q (dO and
// Q MN-major). The producer warp's 32 lanes also copy each query tile's
// lse (times log2 e) and delta into shared memory and arrive with it.
// With kFixed, P^T = exp(min(S^T, cap) - lse).
template <int D, bool kFixed = false, bool kDoc = false>
__device__ __forceinline__ void dkv_block(const Maps& maps, const Params& p,
                                          int b, int h, int k0) {
  using C = Dkv<D>;
  uint8_t* sK = smem_base();
  uint8_t* sV = sK + C::kKVBytes;
  uint8_t* sQ = sV + C::kKVBytes;
  uint8_t* sdO = sQ + C::kStages * C::kQBytes;
  float* sLse2 = reinterpret_cast<float*>(sdO + C::kStages * C::kQBytes);
  float* sDelta = sLse2 + C::kStages * C::kBQ;
  uint64_t* barKV = reinterpret_cast<uint64_t*>(sDelta + C::kStages * C::kBQ);
  uint64_t* full = barKV + 1;
  uint64_t* empty = full + C::kStages;
  [[maybe_unused]] auto* walk =
      reinterpret_cast<DocWalk<C::kWalkWords>*>(empty + C::kStages);
  auto load_own = [&] {  // K and V of the key tile
    mbar_expect_tx(barKV, 2 * C::kKVBytes);
    load_rows<D, kRows>(sK, &maps.k, barKV, k0, h, b);
    load_rows<D, kRows>(sV, &maps.v, barKV, k0, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (kDoc) load_own();  // the summary's reads overlap it
  }
  int q_begin, q_end;
  [[maybe_unused]] bool mono = false;
  if constexpr (kDoc) {  // the clipped range (and walk), before the sync
    mono = doc_mono(p, b);
    q_range_doc(p, doc_span(doc_row(p, b), p.n64, k0, kRows), k0, kRows,
                C::kBQ, q_begin, q_end);
    if (!mono)
      doc_walk_build<true>(p, b, k0, q_begin, C::kBQ,
                           (q_end - q_begin + C::kBQ - 1) / C::kBQ, walk);
  }
  __syncthreads();

  if constexpr (!kDoc) q_range(p, k0, kRows, C::kBQ, q_begin, q_end);
  const int n_tiles = (q_end - q_begin + C::kBQ - 1) / C::kBQ;
  const int L = p.L;
  [[maybe_unused]] const DocSteps<C::kWalkWords> steps{walk, n_tiles, mono};

  if (threadIdx.x < 128) {  // producer
    regs_dec<C::kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (!kDoc && lane == 0) load_own();
      // the t-th tile loaded, query tile ti of the range
      auto load = [&](int t, int ti) {
        const int s = t % C::kStages;
        const int qt = q_begin + ti * C::kBQ;
        mbar_wait(&empty[s], ((t / C::kStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < C::kBQ / 32; ++i) {
          const int r = lane + 32 * i, row = qt + r;
          sLse2[s * C::kBQ + r] =
              row < L ? p.lse[stat_index(p, b, h, row)] * kLog2e : INFINITY;
          sDelta[s * C::kBQ + r] =
              row < L ? p.delta[stat_index(p, b, h, row)] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQBytes);
          load_rows<D, C::kBQ>(sQ + s * C::kQBytes, &maps.q, &full[s], qt, h, b);
          load_rows<D, C::kBQ>(sdO + s * C::kQBytes, &maps.dout, &full[s], qt,
                               h, b);
        } else {
          mbar_arrive(&full[s]);
        }
      };
      if constexpr (kDoc) {
        for (int t = 0, ti = steps.next(0); ti < n_tiles;
             ++t, ti = steps.next(ti + 1))
          load(t, ti);
      } else {
        for (int t = 0; t < n_tiles; ++t) load(t, t);
      }
    }
  } else {  // consumers
    regs_inc<C::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // key rows [64 cw, 64 cw + 64)
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int kr0 = k0 + 64 * cw;
    const int row = kr0 + 16 * warp + g;
    const Mask mk = mask_of(p);
    int fk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) fk[i] = min(row + 8 * i, L - 1) / p.tpf;
    [[maybe_unused]] RowIv iv[2];
    [[maybe_unused]] DocHalf half{};
    if constexpr (kDoc) {
#pragma unroll
      for (int i = 0; i < 2; ++i) iv[i] = row_iv<true>(p, b, fk[i]);
      half = doc_half(p, b, kr0);
    }
    const float c = p.logit_mul * kLog2e;
    const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
    mbar_wait(barKV, 0);

    float adk[D / 2], adv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

    const Turns turn{cw};
    turn.init();
    const int n_run = kDoc ? steps.count() : n_tiles;
    // step t runs query tile ti of the range (ti == t without documents)
    for (int t = 0, ti = kDoc ? steps.next(0) : 0; t < n_run;
         ++t, ti = kDoc ? steps.next(ti + 1) : t) {
      const int s = t % C::kStages;
      const int qt = q_begin + ti * C::kBQ;
      uint8_t* q_tile = sQ + s * C::kQBytes;
      const uint32_t q_addr = smem_u32(q_tile);
      const uint32_t do_addr = smem_u32(sdO + s * C::kQBytes);
      const float* lse2 = sLse2 + s * C::kBQ;
      const float* dl = sDelta + s * C::kBQ;
      mbar_wait(&full[s], (t / C::kStages) & 1);
      if (p.scale_q) {  // each consumer rescales half the Q tile
        scale_rows<D, C::kBQ>(q_tile, 32 * cw, 32, p.scale, tid, 128);
        fence_async_smem();
        named_sync(3, 256);
      }

      // transposed products: rows are this warpgroup's keys, columns the
      // tile's queries
      float st[C::kBQ / 2], dpt[C::kBQ / 2];
      turn.begin();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<C::kBQ>(st, kmajor<kRows>(k_addr, 64 * cw, kk),
                       kmajor<C::kBQ>(q_addr, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<C::kBQ>(dpt, kmajor<kRows>(v_addr, 64 * cw, kk),
                       kmajor<C::kBQ>(do_addr, 0, kk), kk > 0);
      wg_commit();
      turn.end();
      wg_wait0();
      keep(st);
      keep(dpt);

      if constexpr (kDoc) {  // masked to -inf first: exp(-inf) is 0
        if (!doc_full<true>(p, steps, half, cw, ti, kr0, qt, C::kBQ))
          doc_mask<C::kBQ>(st, p, b, iv, mono, qt, t4);
#pragma unroll
        for (int x = 0; x < C::kBQ / 2; ++x) {
          const int col = 8 * (x / 4) + 2 * t4 + x % 2;
          const float pij = ex2(fmaf(softmax_logit<kFixed>(st[x], p.cap_raw),
                                     c, -lse2[col]));
          st[x] = pij;                         // P^T
          dpt[x] = pij * (dpt[x] - dl[col]);   // dS^T
        }
      } else {
        const bool full_tile = tile_full(p, qt, C::kBQ, kr0, 64);
#pragma unroll
        for (int j = 0; j < C::kBQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t4 + e, qrow = qt + col;
            const float lc = lse2[col], dc = dl[col];
            int fqc = 0;
            if (!full_tile) fqc = qrow < L ? frame_of(p, qrow) : -kNoFrame;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * j + 2 * i + e;
              const bool vis = full_tile || in_mask(mk, fqc, fk[i]);
              const float pij =
                  vis ? ex2(fmaf(softmax_logit<kFixed>(st[x], p.cap_raw), c,
                                 -lc))
                      : 0.f;
              st[x] = pij;                       // P^T
              dpt[x] = pij * (dpt[x] - dc);      // dS^T
            }
          }
      }
      uint32_t pa[C::kBQ / 16][4], dsa[C::kBQ / 16][4];
      to_a<C::kBQ>(pa, st);
      to_a<C::kBQ>(dsa, dpt);
      keep(pa);
      keep(dsa);
      keep(adv);
      keep(adk);
      turn.begin();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBQ / 16; ++kk)
        mma_rs<D>(adv, pa[kk], mnmajor<C::kBQ>(do_addr, kk));
#pragma unroll
      for (int kk = 0; kk < C::kBQ / 16; ++kk)
        mma_rs<D>(adk, dsa[kk], mnmajor<C::kBQ>(q_addr, kk));
      wg_commit();
      turn.end();
      wg_wait0();
      keep(adv);
      keep(adk);
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    // dK = dS^T . (scale q): the folded scale is applied here
    const float mul[2] = {p.logit_mul, p.logit_mul}, one[2] = {1.f, 1.f};
    store_rows<D>(p.dk + b * p.s_dk[0] + h * p.s_dk[1], p.s_dk[2], row, L,
                  adk, mul, t4);
    store_rows<D>(p.dv + b * p.s_dv[0] + h * p.s_dv[1], p.s_dv[2], row, L,
                  adv, one, t4);
  }
}

// --------------------------------------------------------------- host

// encode_map's error: this plus the CUresult of cuTensorMapEncodeTiled
constexpr int kEncodeError = 10000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (CUDA driver API), reached through the runtime
// (so the library links nothing beyond cudart).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, H, L, Dh] view with element strides `st`
// (batch, head, row; the last dim contiguous): dims (Dh, L, H, B), byte
// strides (row, head, batch), a box of [box_rows, 64] elements, 128-byte
// swizzle, rows past L read as zero. The strides are taken as they come:
// ops/_attn_launch.py map_strides has already given a dim of extent 1 the
// stride a dense layout would (TMA wants multiples of 16 bytes), and
// tma_geometry raises on what TMA cannot take. Returns 0 or a CUDA error.
inline int encode_map(CUtensorMap* map, const void* ptr, const long long* st,
                      int B, int H, int L, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Set the dynamic shared-memory limit, launch, and report the error.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads,
           cudaStream_t stream, const Maps& maps, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

enum Operand { OP_Q, OP_K, OP_V, OP_O, OP_DO, OP_DQ, OP_DK, OP_DV };

// Every C entry point (frame_attention.cu, band_attention.cu) takes the
// same arrays: 12 pointers (q, k, v, o, dout, dq, dk, dv, lse, delta,
// doc, its tile summary), 24 element strides (batch, head, row of the 8
// tensor operands in that order, a dim of extent 1 given its dense stride
// by ops/_attn_launch.py map_strides) and 7 ints (B, H, L, Dh, tpf,
// window, causal); band2's 3 more ints are its plan. `cap` is the fixed shift's
// bound on the scaled logits (read by kFixed bodies).
inline Params make_params(const void* const* ptr, const long long* st,
                          const int* in, float scale, float cap) {
  Params p;
  p.o = static_cast<bf16*>(const_cast<void*>(ptr[OP_O]));
  p.dq = static_cast<bf16*>(const_cast<void*>(ptr[OP_DQ]));
  p.dk = static_cast<bf16*>(const_cast<void*>(ptr[OP_DK]));
  p.dv = static_cast<bf16*>(const_cast<void*>(ptr[OP_DV]));
  for (int j = 0; j < 3; ++j) {
    p.s_o[j] = st[3 * OP_O + j];
    p.s_dq[j] = st[3 * OP_DQ + j];
    p.s_dk[j] = st[3 * OP_DK + j];
    p.s_dv[j] = st[3 * OP_DV + j];
  }
  p.lse = static_cast<float*>(const_cast<void*>(ptr[8]));
  p.delta = static_cast<float*>(const_cast<void*>(ptr[9]));
  p.doc = static_cast<const int*>(ptr[10]);
  p.dsum = static_cast<const int*>(ptr[11]);
  p.B = in[0];
  p.H = in[1];
  p.L = in[2];
  p.tpf = in[4];
  p.window = in[5];
  p.causal = in[6];
  p.n_frames = (p.L + p.tpf - 1) / p.tpf;
  p.n64 = (p.L + 63) / 64;
  p.n128 = (p.L + kRows - 1) / kRows;
  p.dsum_row = doc_row_len(p.L, p.tpf);
  p.inv_tpf = 1.f / (float)p.tpf;
  p.scale = scale;
  // a power-of-two scale folds into the f32 logits exactly
  int e;
  const bool pow2 = frexpf(scale, &e) == 0.5f;
  p.logit_mul = pow2 ? scale : 1.f;
  p.scale_q = !pow2;
  p.cap = cap;
  p.cap_raw = cap / p.logit_mul;  // exact: logit_mul is a power of two
  return p;
}

// Tensor maps of the inputs a kernel reads, with its box heights.
inline int make_maps(Maps* m, const void* const* ptr, const long long* st,
                     const int* in, int rows_q, int rows_kv, bool with_o,
                     bool with_dout) {
  const int B = in[0], H = in[1], L = in[2], D = in[3];
  int err = encode_map(&m->q, ptr[OP_Q], st + 3 * OP_Q, B, H, L, D, rows_q);
  if (!err)
    err = encode_map(&m->k, ptr[OP_K], st + 3 * OP_K, B, H, L, D, rows_kv);
  if (!err)
    err = encode_map(&m->v, ptr[OP_V], st + 3 * OP_V, B, H, L, D, rows_kv);
  if (!err && with_o)
    err = encode_map(&m->o, ptr[OP_O], st + 3 * OP_O, B, H, L, D, rows_q);
  if (!err && with_dout)
    err = encode_map(&m->dout, ptr[OP_DO], st + 3 * OP_DO, B, H, L, D,
                     rows_q);
  return err;
}

// One launch of the kernel for head dim D with block shape Cfg<D>: its
// tensor maps (boxes of Cfg's rows), its grid, its threads and shared
// memory. The grid: Cfg::kBM-row tiles x (B * H), one tile a block; a
// persistent kernel (Cfg::kPersistent, fwd_items) takes min(sms, tiles)
// blocks on a 1-D grid, each looping over the tiles.
template <template <int> class Cfg, int D, typename Kernel>
int launch_d(Kernel kernel, const Params& p, const void* const* ptr,
             const long long* st, const int* in, cudaStream_t stream,
             bool with_o, bool with_dout, int sms) {
  using C = Cfg<D>;
  Maps m{};
  const int err =
      make_maps(&m, ptr, st, in, C::kBoxQ, C::kBoxKV, with_o, with_dout);
  if (err) return err;
  dim3 grid((p.L + C::kBM - 1) / C::kBM, p.B * p.H);
  if (C::kPersistent) grid = dim3(min(sms, (int)(grid.x * grid.y)));
  return launch(kernel, C::kSmem, grid, C::kThreads, stream, m, p);
}

// The kernel for the head dim (64 or 128), on q's device.
template <template <int> class Cfg, typename K64, typename K128>
int run(K64 k64, K128 k128, const Params& p, const void* const* ptr,
        const long long* st, const int* in, void* stream, bool with_o,
        bool with_dout) {
  if (in[3] != 64 && in[3] != 128) return (int)cudaErrorInvalidValue;
  // Bind q's device to this thread: the tensor-map encoder (a CUDA
  // driver API call) needs a current context (an autograd thread may have
  // none yet), and the launch must go to the tensors' device. The
  // caller's device is restored before returning.
  cudaPointerAttributes attr;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaPointerGetAttributes(&attr, ptr[OP_Q]);
  if (e == cudaSuccess) e = cudaSetDevice(attr.device);
  int sms = 0;
  if (e == cudaSuccess && Cfg<64>::kPersistent)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               attr.device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      in[3] == 64 ? launch_d<Cfg, 64>(k64, p, ptr, st, in, s, with_o,
                                      with_dout, sms)
                  : launch_d<Cfg, 128>(k128, p, ptr, st, in, s, with_o,
                                       with_dout, sms);
  if (prev != attr.device) e = cudaSetDevice(prev);
  return err ? err : (int)e;
}

}  // namespace owl_hopper
