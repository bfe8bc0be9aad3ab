// Tile bodies shared by the port's attention kernels (frame_attention.cu,
// band_attention.cu, band2_attention.cu), for Hopper (sm_90a).
//
// All of them compute attention under the frame algebra of the JAX
// package's FrameMask: with f = index / tpf,
//
//   visible(i, j)  iff  (fk <= fq if causal) and (|fq - fk| < window if a
//                        window is set) and (doc[fq] == doc[fk] if doc)
//
// q is pre-scaled by `scale` in bf16 (as ops/splash.py on the TPU does),
// logits and softmax statistics are f32, P and dS are rounded to bf16
// before their products, and every product accumulates in f32 on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 out).
//
// A block is 4 warps; each warp owns 16 rows of a 64-row tile and keeps
// its A operands and its f32 accumulators in registers. The loop over the
// other operand's 64-row tiles is bounded in closed form from the frame
// ranges (kv_range, q_range), so invisible tiles are never visited, and
// a tile whose every pair is visible skips the per-element mask
// (tile_full). The ragged tail (L not a multiple of 64) is masked, not
// padded: rows past L are loaded as zero, never written, and invisible.
// The band2 kernel instead walks the tiles of its chunk plan (the bodies'
// kPlan policy: plan_kv_range, plan_q_range), without the tiles of that
// walk that hold no visible pair (cut_skip_tiles).
//
// Softmax forms. `cap` = +inf is the usual softmax (online row max in the
// forward). A finite `cap` is the fixed-shift softmax of the TPU band
// kernel, p = exp(min(s - cap, 0)) / sum: no running max, no rescale of
// the output accumulator. Either way the forward can save
// lse = shift + log(sum), and the backward recomputes
// P = exp(min(s, cap) - lse), with dS = P * (dP - delta), delta =
// rowsum(dO * O). The clamp passes its gradient straight through, as the
// TPU band kernel's backward does (ops/band.py:489-508).
//
// A cotangent on the logsumexp as well (the ring partials of
// ops/splash.py splash_attention_lse) folds into delta: d lse_i / d s_ij
// = P_ij, so the backward is the usual one with delta' = rowsum(dO * O)
// - g_lse (and d lse / d V = 0). The caller computes delta' in f32 from
// the f32 output cotangent, as the TPU package does, and both passes read
// it (dq_tile with kReadDelta).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace owl_attn {

constexpr int kBQ = 64;        // rows per tile (queries or keys)
constexpr int kBK = 64;        // rows of the other operand's tiles
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kNoFrame = 1 << 29;  // the forward's frame of a key past L

using bf16 = __nv_bfloat16;

enum Operand { OP_Q, OP_K, OP_V, OP_O, OP_DO, OP_DQ, OP_DK, OP_DV, OP_N };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;           // forward output (written by fwd, read by bwd)
  const bf16* dout;  // output cotangent
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;        // [B, H, L] f32, or null
  float* delta;      // [B, H, L] f32 rowsum(dO * O), or null
  const int* doc;    // per-frame document id [B, n_frames], or null
  long long s[OP_N][3];  // batch, head, row strides in elements
  int B, H, L, tpf, window, causal, n_frames;
  float scale;  // q pre-scale
  float cap;    // fixed-shift bound; +inf for the usual softmax
  // band2 chunk plan (kPlan bodies only): span S, previous refs m, the
  // NEXT ref's tokens (0 for a frame-aligned span), chunks L / S
  int span, nrefs, next_cols, n_chunks;
};

// The C entry points all take the same arrays: 11 pointers (q, k, v, o,
// dout, dq, dk, dv, lse, delta, doc), 24 strides (batch, head, row of
// the 8 tensor operands in that order) and 7 ints (B, H, L, Dh, tpf,
// window, causal).
inline Params make_params(const void* const* ptr, const long long* st,
                          const int* in, float scale, float cap) {
  Params p;
  p.q = static_cast<const bf16*>(ptr[0]);
  p.k = static_cast<const bf16*>(ptr[1]);
  p.v = static_cast<const bf16*>(ptr[2]);
  p.o = static_cast<bf16*>(const_cast<void*>(ptr[3]));
  p.dout = static_cast<const bf16*>(ptr[4]);
  p.dq = static_cast<bf16*>(const_cast<void*>(ptr[5]));
  p.dk = static_cast<bf16*>(const_cast<void*>(ptr[6]));
  p.dv = static_cast<bf16*>(const_cast<void*>(ptr[7]));
  p.lse = static_cast<float*>(const_cast<void*>(ptr[8]));
  p.delta = static_cast<float*>(const_cast<void*>(ptr[9]));
  p.doc = static_cast<const int*>(ptr[10]);
  for (int i = 0; i < OP_N; ++i)
    for (int j = 0; j < 3; ++j) p.s[i][j] = st[3 * i + j];
  p.B = in[0];
  p.H = in[1];
  p.L = in[2];
  p.tpf = in[4];
  p.window = in[5];
  p.causal = in[6];
  p.n_frames = (p.L + p.tpf - 1) / p.tpf;
  p.scale = scale;
  p.cap = cap;
  p.span = p.nrefs = p.next_cols = p.n_chunks = 0;
  return p;
}

template <typename T>
__device__ __forceinline__ T* base(T* ptr, const Params& p, int op, int b,
                                   int h) {
  return ptr + b * p.s[op][0] + h * p.s[op][1];
}

__device__ __forceinline__ long long stat_index(const Params& p, int b, int h,
                                                int row) {
  return ((long long)b * p.H + h) * p.L + row;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// Copy a [64, D] tile of rows [row0, row0 + 64) into shared memory with
// 16-byte loads; rows at or past L are zero. With `scale` > 0 every
// element is multiplied by it and rounded back to bf16 (q pre-scaling).
template <int D, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long s_l, int row0, int L,
                                          float scale) {
  constexpr int kChunks = kBQ * D / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * s_l +
                                            col);
      if (scale > 0.f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
  }
}

// A-operand fragments (row-major 16x16 slices) of this warp's 16 rows.
template <int D, int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* s, int wr, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(&s[(wr + g) * LDS + c]);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(&s[(wr + g + 8) * LDS + c]);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(&s[(wr + g) * LDS + c + 8]);
    a[kk][3] =
        *reinterpret_cast<const uint32_t*>(&s[(wr + g + 8) * LDS + c + 8]);
  }
}

// acc[16 x 64] = A[16 x D] . B^T, B a [64, D] tile in shared memory.
template <int D, int LDS>
__device__ __forceinline__ void mma_abt(float (&acc)[kBK / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* sB, int g, int t4) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* brow = &sB[(n * 8 + g) * LDS + t4 * 2];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kk * 16);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(brow + kk * 16 + 8);
      mma_bf16(acc[n], a[kk], b0, b1);
    }
  }
}

// acc[16 x D] += bf16(P[16 x 64]) . B, P in the accumulator layout of
// mma_abt (which is the A-operand layout), B a [64, D] tile in shared
// memory.
template <int D, int LDS>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&pm)[kBK / 8][4],
                                       const bf16* sB, int g, int t4) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(pm[2 * j][0], pm[2 * j][1]);
    pa[1] = pack_bf16(pm[2 * j][2], pm[2 * j][3]);
    pa[2] = pack_bf16(pm[2 * j + 1][0], pm[2 * j + 1][1]);
    pa[3] = pack_bf16(pm[2 * j + 1][2], pm[2 * j + 1][3]);
    const bf16* b0p = &sB[(j * 16 + t4 * 2) * LDS + g];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const bf16* bc = b0p + d * 8;
      const uint32_t b0 = pack_bf16(bc[0], bc[LDS]);
      const uint32_t b1 = pack_bf16(bc[8 * LDS], bc[9 * LDS]);
      mma_bf16(acc[d], pa, b0, b1);
    }
  }
}

// Write this warp's 16 rows of an f32 [16 x D] accumulator, times `mul`,
// as bf16; rows at or past L are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long s_l, int row0,
                                           int L, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int g,
                                           int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= L) continue;
    bf16* out = dst + (long long)row * s_l + t4 * 2;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(out + d * 8) = __floats2bfloat162_rn(
          acc[d][2 * i] * mul[i], acc[d][2 * i + 1] * mul[i]);
  }
}

// The mask's scalars, read once per block into registers.
struct Mask {
  int causal, window;
  bool doc;
};

__device__ __forceinline__ Mask mask_of(const Params& p) {
  return {p.causal, p.window, p.doc != nullptr};
}

// Branch-free: the unrolled per-element loops keep it in predicates.
__device__ __forceinline__ bool visible(const Mask& m, int fq, int fk,
                                        int docq, int dock) {
  bool vis = (fq >= 0) & (fk >= 0);
  if (m.causal) vis &= fk <= fq;
  if (m.window > 0) vis &= abs(fq - fk) < m.window;
  if (m.doc) vis &= docq == dock;
  return vis;
}

// Frame range of the 64-row tile at r0, and whether it lies inside L.
struct TileFrames {
  int lo, hi;
  bool inside;
};

__device__ __forceinline__ TileFrames tile_frames(const Params& p, int r0) {
  return {r0 / p.tpf, (r0 + kBQ - 1) / p.tpf, r0 + kBQ <= p.L};
}

// Whether every pair of a query tile and a key tile is visible (as
// FrameMask.__getitem__ classifies a block full).
__device__ __forceinline__ bool tile_full(const Mask& m, TileFrames q,
                                          TileFrames k) {
  if (!q.inside || !k.inside || m.doc) return false;
  if (m.causal && k.hi > q.lo) return false;
  if (m.window > 0 && (q.hi - k.lo >= m.window || k.hi - q.lo >= m.window))
    return false;
  return true;
}

// Key rows [begin, end) that can be visible from the query tile at q0.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int& begin,
                                         int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fq_lo = q0 / p.tpf, fq_hi = (min(q0 + kBQ, p.L) - 1) / p.tpf;
  const int fk_min = w > 0 ? max(0, fq_lo - w + 1) : 0;
  const int fk_max =
      p.causal ? fq_hi : (w > 0 ? min(nf - 1, fq_hi + w - 1) : nf - 1);
  end = min((fk_max + 1) * p.tpf, p.L);
  begin = (fk_min * p.tpf / kBK) * kBK;
}

// Query rows [begin, end) that can see some key of the tile at k0:
// causal, query frames fk .. fk + window - 1 (to the end without a
// window); bidirectional, |fq - fk| < window.
__device__ __forceinline__ void q_range(const Params& p, int k0, int& begin,
                                        int& end) {
  const int nf = p.n_frames, w = p.window;
  const int fk_lo = k0 / p.tpf, fk_hi = (min(k0 + kBK, p.L) - 1) / p.tpf;
  const int fq_min = p.causal ? fk_lo : (w > 0 ? max(0, fk_lo - w + 1) : 0);
  const int fq_max = w > 0 ? min(nf - 1, fk_hi + w - 1) : nf - 1;
  end = min((fq_max + 1) * p.tpf, p.L);
  begin = (fq_min * p.tpf / kBQ) * kBQ;
}

// The band2 plan's walks (kPlan bodies; band2_attention.cu). A walk is
// the 64-row tiles at begin, begin + 64, ... below end. Its SKIP tiles,
// those that hold no visible pair, all lie before or after the rows
// [lo, hi) that the tile at hand can see (a contiguous range under the
// causal window), so they are cut off here in closed form: the tiles
// kept each hold a visible pair, and no SKIP tile is visited or loaded.
__device__ __forceinline__ void cut_skip_tiles(int lo, int hi, int& begin,
                                               int& end) {
  if (lo > begin) begin += (lo - begin) / kBK * kBK;
  end = min(end, hi);
}

// Key tiles of the query tile at q0: the plan gives kv chunks i - m .. i
// of each query chunk i the tile touches, and the NEXT ref of the last of
// them, clamped to the sequence; the tile sees key frames fq_lo - window
// + 1 .. fq_hi.
__device__ __forceinline__ void plan_kv_range(const Params& p, int q0,
                                              int& begin, int& end) {
  const int last = min(q0 + kBQ, p.L) - 1;
  const int i_lo = q0 / p.span, i_hi = last / p.span;
  begin = max(0, (i_lo - p.nrefs) * p.span);
  end = min(p.L, (i_hi + 1) * p.span +
                     (i_hi + 1 < p.n_chunks ? p.next_cols : 0));
  cut_skip_tiles(max(0, q0 / p.tpf - p.window + 1) * p.tpf,
                 min(p.L, (last / p.tpf + 1) * p.tpf), begin, end);
}

// Query tiles of the key tile at k0: the plan reads it from query chunks
// t .. t + m of each kv chunk t the tile touches, and from chunk t - 1
// where the tile lies in chunk t's NEXT ref; query frames fk_lo .. fk_hi
// + window - 1 see it.
__device__ __forceinline__ void plan_q_range(const Params& p, int k0,
                                             int& begin, int& end) {
  const int last = min(k0 + kBK, p.L) - 1;
  const int t_lo = k0 / p.span, t_hi = last / p.span;
  const int first = k0 - t_lo * p.span < p.next_cols ? t_lo - 1 : t_lo;
  begin = max(0, first * p.span);
  end = min(p.L, (t_hi + p.nrefs + 1) * p.span);
  cut_skip_tiles(k0 / p.tpf * p.tpf,
                 min(p.L, (last / p.tpf + p.window) * p.tpf), begin, end);
}

__device__ __forceinline__ int doc_of(const Params& p, int b, int f) {
  return (p.doc && f >= 0) ? p.doc[(long long)b * p.n_frames + f] : 0;
}

// ------------------------------------------------------------ forward

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(bf16) +
         2 * kBK * sizeof(int);
}

// One 64-row query tile at q0 of head (b, h): out, and lse when p.lse.
// The mask stays written out inline here, in this form: variants of this
// body that call visible() / tile_full() compiled to markedly slower code
// on the H100, and the one compare below ran 4-24% faster there than the
// three compares it replaced. With kPlan the key tiles are the band2
// plan's (plan_kv_range).
template <int D, bool kFixed, bool kPlan = false>
__device__ __forceinline__ void fwd_tile(const Params& p, int b, int h, int q0) {
  constexpr int LDS = D + 8;  // padded shared-memory row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * LDS;
  bf16* sV = sK + kBK * LDS;
  int* sKf = reinterpret_cast<int*>(sV + kBK * LDS);  // key frame
  int* sKd = sKf + kBK;                               // key document

  const int L = p.L, tpf = p.tpf, window = p.window, nf = p.n_frames;
  const bool causal = p.causal != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* qg = base(p.q, p, OP_Q, b, h);
  const bf16* kg = base(p.k, p, OP_K, b, h);
  const bf16* vg = base(p.v, p, OP_V, b, h);
  const int* docb = p.doc ? p.doc + (long long)b * nf : nullptr;

  load_tile<D, LDS>(sQ, qg, p.s[OP_Q][2], q0, L, p.scale);
  __syncthreads();

  // Q fragments of this warp's 16 rows (A operand, row-major 16x16 slices)
  uint32_t qa[D / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = *reinterpret_cast<uint32_t*>(&sQ[(wr + g) * LDS + c]);
    qa[kk][1] = *reinterpret_cast<uint32_t*>(&sQ[(wr + g + 8) * LDS + c]);
    qa[kk][2] = *reinterpret_cast<uint32_t*>(&sQ[(wr + g) * LDS + c + 8]);
    qa[kk][3] = *reinterpret_cast<uint32_t*>(&sQ[(wr + g + 8) * LDS + c + 8]);
  }

  // this thread's two rows: r[0] = wr + g, r[1] = wr + g + 8
  int fq[2], dq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    fq[i] = row / tpf;
    dq[i] = docb ? docb[min(fq[i], nf - 1)] : 0;
  }

  // The frame mask without documents as one compare: fq - fk lies in
  // [dmin, dmin + dspan] (causal: 0 .. w - 1; bidirectional: -(w - 1) ..
  // w - 1; w the window, or the frame count without one). A key at or
  // past L has frame kNoFrame, which puts fq - fk below any dmin.
  const int wl = window > 0 ? min(window, nf) : nf;
  const int dmin = causal ? 0 : 1 - wl;
  const unsigned dspan = causal ? wl - 1 : 2 * (wl - 1);

  // frames the block's queries span, and the key range that can be visible
  const int fq_lo = q0 / tpf;
  const int fq_hi = (min(q0 + kBQ, L) - 1) / tpf;
  int kv_begin, kv_end;
  if constexpr (kPlan) {
    plan_kv_range(p, q0, kv_begin, kv_end);
  } else {
    const int fk_min = window > 0 ? max(0, fq_lo - window + 1) : 0;
    const int fk_max = causal ? fq_hi
                              : (window > 0 ? min(nf - 1, fq_hi + window - 1)
                                            : nf - 1);
    kv_end = min((fk_max + 1) * tpf, L);
    kv_begin = (fk_min * tpf / kBK) * kBK;
  }

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, LDS>(sK, kg, p.s[OP_K][2], k0, L, 0.f);
    load_tile<D, LDS>(sV, vg, p.s[OP_V][2], k0, L, 0.f);
    if (threadIdx.x < kBK) {
      const int j = k0 + threadIdx.x;
      sKf[threadIdx.x] = j < L ? j / tpf : kNoFrame;
      sKd[threadIdx.x] = (docb && j < L) ? docb[j / tpf] : 0;
    }
    __syncthreads();

    const int fk_lo = k0 / tpf;
    const int fk_hi = (min(k0 + kBK, L) - 1) / tpf;
    const bool full = k0 + kBK <= L && docb == nullptr &&
                      (!causal || fk_hi <= fq_lo) &&
                      (window <= 0 ||
                       (fq_hi - fk_lo < window && fk_hi - fq_lo < window));

    // S = Q K^T for 16 rows x 64 columns
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* krow = &sK[(n * 8 + g) * LDS + t4 * 2];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }

    if (!full) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + t4 * 2 + (e & 1);
          const int i = e >> 1;
          bool vis = (unsigned)(fq[i] - sKf[j] - dmin) <= dspan;
          if (docb) vis = vis && sKd[j] == dq[i];
          if (!vis) s[n][e] = -INFINITY;
        }
      }
    }

    if constexpr (kFixed) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          s[n][2 * i] = __expf(fminf(s[n][2 * i] - p.cap, 0.f));
          s[n][2 * i + 1] = __expf(fminf(s[n][2 * i + 1] - p.cap, 0.f));
          l[i] += s[n][2 * i] + s[n][2 * i + 1];
        }
    } else {
      // online softmax; each row's 64 values live in the 4 threads of a quad
      float alpha[2];
  #pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
  #pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with nothing visible yet keeps m = -inf; shift by 0 then
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = __expf(m[i] - m_use);
        m[i] = m_new;
        float sum = 0.f;
  #pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          s[n][2 * i] = __expf(s[n][2 * i] - m_use);
          s[n][2 * i + 1] = __expf(s[n][2 * i + 1] - m_use);
          sum += s[n][2 * i] + s[n][2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + sum;
      }
  #pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
    }
    // O += P V; the S accumulator layout is the A-operand layout of P
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const bf16* v0 = &sV[(j * 16 + t4 * 2) * LDS + g];
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        const bf16* vc = v0 + d * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[LDS]);
        const uint32_t b1 = pack_bf16(vc[8 * LDS], vc[9 * LDS]);
        mma_bf16(o[d], pa, b0, b1);
      }
    }
  }

  // normalise and write; rows at or past L are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffff, li, 1);
    li += __shfl_xor_sync(0xffffffff, li, 2);
    const float inv = li > 0.f ? 1.f / li : 0.f;
    const int row = q0 + wr + g + 8 * i;
    if (p.lse && t4 == 0 && row < L) {
      const float shift = kFixed ? p.cap : (m[i] == -INFINITY ? 0.f : m[i]);
      p.lse[stat_index(p, b, h, row)] = li > 0.f ? shift + logf(li) : INFINITY;
    }
    if (row < L) {
      bf16* og =
          base(p.o, p, OP_O, b, h) + (long long)row * p.s[OP_O][2] + t4 * 2;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(og + d * 8) =
            __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    }
  }
}



// ----------------------------------------------------------- backward

template <int D>
constexpr size_t bwd_smem() {
  return (size_t)4 * 64 * (D + 8) * sizeof(bf16) + 4 * 64 * sizeof(float);
}

// delta[r] = sum_d dO[r, d] * O[r, d] for the 64 rows of two tiles in
// shared memory, two threads per row.
template <int D, int LDS>
__device__ __forceinline__ float tile_delta(const bf16* sdO, const bf16* sO,
                                            int& row) {
  row = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (D / 2);
  float acc = 0.f;
#pragma unroll 8
  for (int c = c0; c < c0 + D / 2; ++c)
    acc += __bfloat162float(sdO[row * LDS + c]) *
           __bfloat162float(sO[row * LDS + c]);
  return acc + __shfl_xor_sync(0xffffffff, acc, 1);
}

// dq of the 64-row query tile at q0: the block walks the same key tiles
// as the forward. delta comes from this tile's dO and O; with
// `write_delta` it is also stored for the dkv pass. With `kReadDelta` it
// is read from p.delta instead (a delta' the caller computed). With kPlan
// the key tiles are the band2 plan's, as in fwd_tile.
template <int D, bool kReadDelta = false, bool kPlan = false>
__device__ __forceinline__ void dq_tile(const Params& p, int b, int h, int q0,
                                        bool write_delta) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDS = D + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kBQ * LDS;
  bf16* sK = sdO + kBQ * LDS;
  bf16* sV = sK + kBK * LDS;
  float* sDelta = reinterpret_cast<float*>(sV + kBK * LDS);
  float* sLse = sDelta + 64;
  int* sKf = reinterpret_cast<int*>(sLse + 64);
  int* sKd = sKf + 64;

  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const bf16* kg = base(p.k, p, OP_K, b, h);
  const bf16* vg = base(p.v, p, OP_V, b, h);

  load_tile<D, LDS>(sQ, base(p.q, p, OP_Q, b, h), p.s[OP_Q][2], q0, L,
                    p.scale);
  load_tile<D, LDS>(sdO, base(p.dout, p, OP_DO, b, h), p.s[OP_DO][2], q0, L,
                    0.f);
  if constexpr (kReadDelta) {
    if (threadIdx.x < 64) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < L ? p.lse[stat_index(p, b, h, row)] : INFINITY;
      sDelta[threadIdx.x] = row < L ? p.delta[stat_index(p, b, h, row)] : 0.f;
    }
    __syncthreads();
  } else {
    load_tile<D, LDS>(sK, base(static_cast<const bf16*>(p.o), p, OP_O, b, h),
                      p.s[OP_O][2], q0, L, 0.f);  // O, for delta
    if (threadIdx.x < 64) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < L ? p.lse[stat_index(p, b, h, row)] : INFINITY;
    }
    __syncthreads();
    {
      int r;
      const float d = tile_delta<D, LDS>(sdO, sK, r);
      if ((threadIdx.x & 1) == 0) {
        sDelta[r] = d;
        if (write_delta && q0 + r < L) p.delta[stat_index(p, b, h, q0 + r)] = d;
      }
    }
    __syncthreads();
  }

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D, LDS>(qa, sQ, wr, g, t4);
  load_a<D, LDS>(da, sdO, wr, g, t4);
  int fq[2], dd[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i, row = q0 + r;
    fq[i] = row < L ? row / p.tpf : -1;
    dd[i] = doc_of(p, b, fq[i]);
    lse[i] = sLse[r];
    delta[i] = sDelta[r];
  }
  int kv_begin, kv_end;
  if constexpr (kPlan)
    plan_kv_range(p, q0, kv_begin, kv_end);
  else
    kv_range(p, q0, kv_begin, kv_end);
  const Mask mk = mask_of(p);
  const TileFrames qf = tile_frames(p, q0);

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<D, LDS>(sK, kg, p.s[OP_K][2], k0, L, 0.f);
    load_tile<D, LDS>(sV, vg, p.s[OP_V][2], k0, L, 0.f);
    if (threadIdx.x < kBK) {
      const int j = k0 + threadIdx.x;
      const int f = j < L ? j / p.tpf : -1;
      sKf[threadIdx.x] = f;
      sKd[threadIdx.x] = doc_of(p, b, f);
    }
    __syncthreads();

    const bool full = tile_full(mk, qf, tile_frames(p, k0));
    float s[kBK / 8][4], dp[kBK / 8][4];
    mma_abt<D, LDS>(s, qa, sK, g, t4);
    mma_abt<D, LDS>(dp, da, sV, g, t4);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + t4 * 2 + (e & 1), i = e >> 1;
        const bool vis = full || visible(mk, fq[i], sKf[j], dd[i], sKd[j]);
        const float pij = vis ? __expf(fminf(s[n][e], p.cap) - lse[i]) : 0.f;
        s[n][e] = pij * (dp[n][e] - delta[i]);  // dS
      }
    mma_pb<D, LDS>(acc, s, sK, g, t4);
  }
  // s = qs . k with qs = scale * q, so dq = scale * dS . K
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(base(p.dq, p, OP_DQ, b, h), p.s[OP_DQ][2], q0 + wr, L, acc,
                mul, g, t4);
}

// dk, dv of the 64-row key tile at k0: the block walks the query tiles
// that can see it (q_range). delta is read from p.delta, or, with
// `local_delta`, computed here from each query tile's dO and O. With
// kPlan the query tiles are those whose band2 plan reads this key tile
// (plan_q_range).
template <int D, bool kPlan = false>
__device__ __forceinline__ void dkv_tile(const Params& p, int b, int h, int k0,
                                         bool local_delta) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDS = D + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBK * LDS;  // V, then each query tile's O
  bf16* sQ = sV + kBK * LDS;
  bf16* sdO = sQ + kBQ * LDS;
  float* sDelta = reinterpret_cast<float*>(sdO + kBQ * LDS);
  float* sLse = sDelta + 64;
  int* sQf = reinterpret_cast<int*>(sLse + 64);
  int* sQd = sQf + 64;

  const int L = p.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3, wr = warp * 16;
  const bf16* qg = base(p.q, p, OP_Q, b, h);
  const bf16* dog = base(p.dout, p, OP_DO, b, h);
  const bf16* og = base(static_cast<const bf16*>(p.o), p, OP_O, b, h);

  load_tile<D, LDS>(sK, base(p.k, p, OP_K, b, h), p.s[OP_K][2], k0, L, 0.f);
  load_tile<D, LDS>(sV, base(p.v, p, OP_V, b, h), p.s[OP_V][2], k0, L, 0.f);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D, LDS>(ka, sK, wr, g, t4);
  load_a<D, LDS>(va, sV, wr, g, t4);
  int fk[2], dk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wr + g + 8 * i;
    fk[i] = row < L ? row / p.tpf : -1;
    dk[i] = doc_of(p, b, fk[i]);
  }
  int q_begin, q_end;
  if constexpr (kPlan)
    plan_q_range(p, k0, q_begin, q_end);
  else
    q_range(p, k0, q_begin, q_end);
  const Mask mk = mask_of(p);
  const TileFrames kf = tile_frames(p, k0);

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    adk[d][0] = adk[d][1] = adk[d][2] = adk[d][3] = 0.f;
    adv[d][0] = adv[d][1] = adv[d][2] = adv[d][3] = 0.f;
  }

  for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
    __syncthreads();  // previous tile (and the V fragments) consumed
    load_tile<D, LDS>(sQ, qg, p.s[OP_Q][2], q0, L, p.scale);
    load_tile<D, LDS>(sdO, dog, p.s[OP_DO][2], q0, L, 0.f);
    if (local_delta) load_tile<D, LDS>(sV, og, p.s[OP_O][2], q0, L, 0.f);
    if (threadIdx.x < 64) {
      const int row = q0 + threadIdx.x;
      const int f = row < L ? row / p.tpf : -1;
      sQf[threadIdx.x] = f;
      sQd[threadIdx.x] = doc_of(p, b, f);
      sLse[threadIdx.x] =
          row < L ? p.lse[stat_index(p, b, h, row)] : INFINITY;
      if (!local_delta)
        sDelta[threadIdx.x] =
            row < L ? p.delta[stat_index(p, b, h, row)] : 0.f;
    }
    __syncthreads();
    if (local_delta) {
      int r;
      const float d = tile_delta<D, LDS>(sdO, sV, r);
      if ((threadIdx.x & 1) == 0) sDelta[r] = d;
      __syncthreads();
    }

    const bool full = tile_full(mk, tile_frames(p, q0), kf);
    // transposed products: rows are this warp's keys, columns the queries
    float s[kBQ / 8][4], dp[kBQ / 8][4];
    mma_abt<D, LDS>(s, ka, sQ, g, t4);
    mma_abt<D, LDS>(dp, va, sdO, g, t4);
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + t4 * 2 + (e & 1), i = e >> 1;
        const bool vis = full || visible(mk, sQf[j], fk[i], sQd[j], dk[i]);
        const float pij =
            vis ? __expf(fminf(s[n][e], p.cap) - sLse[j]) : 0.f;
        s[n][e] = pij;                              // P^T
        dp[n][e] = pij * (dp[n][e] - sDelta[j]);    // dS^T
      }
    mma_pb<D, LDS>(adv, s, sdO, g, t4);   // dV += P^T dO
    mma_pb<D, LDS>(adk, dp, sQ, g, t4);   // dK += dS^T (scale q)
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(base(p.dk, p, OP_DK, b, h), p.s[OP_DK][2], k0 + wr, L, adk,
                one, g, t4);
  store_rows<D>(base(p.dv, p, OP_DV, b, h), p.s[OP_DV][2], k0 + wr, L, adv,
                one, g, t4);
}

// Set the dynamic shared-memory limit, launch, and report the error.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace owl_attn
