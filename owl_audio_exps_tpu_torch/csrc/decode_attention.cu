// Decode attention of a few new query tokens over two key sources, the
// ring KV cache and the new tokens ([ring | new]), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package deleted its flash-decode kernel
// and runs cached attention as plain XLA (owl_audio_exps_tpu/nn/attn.py
// `cached_attention`, ops/attention.py `dot_attention`), which the port
// first copied as plain PyTorch: a float32 upcast and concatenation of
// the whole ring, two float32 GEMMs on CUDA cores and a softmax over every
// slot of the allocation. ops/decode_attention.py routes the cached
// forward's calls here and holds the plain version of this algorithm.
//
// Numerics: ops/attention.py's contract. Logits in float32 from the
// stored bf16 (or fp16) operands (mma.sync with float32 accumulators),
// softmax in float32 over every visible key of both sources (kept in
// base-2 units: exp2 of logits scaled by scale * log2 e), probabilities
// normalised first and then rounded to V's dtype, P.V accumulated in
// float32, output in q's dtype. A row's max and sum must be known before
// its first P.V product, so there are two passes: pass 1 reads K and
// writes each split's partial (max, sum) a row; pass 2 combines them in
// split order, reads K and V again and forms the normalised P; a last
// kernel sums pass 2's split outputs in split order. No atomics: runs
// repeat bit for bit. A row that sees no key gives zeros (dot_attention's
// finfo.min fill would average every value).
//
// Bound on the H100: bytes. At the serve's 65-130 query rows the
// arithmetic intensity is ~lq / 3 FLOP a byte of K and V, far below the
// card's ~295, so the kernel is designed for memory and latency:
//   * the ring and the new tokens are read in place, in their stored
//     dtype, through their own pointers and strides (no copy, no cat);
//   * a block holds every query row of its (batch, head) up to 160
//     (16-row mma.sync granularity: 65 rows take 80, 130 take 144), so
//     K and V are read once a pass for all of them;
//   * a plan kernel turns the bool mask into a 64-bit word a row and tile
//     and a flag a tile, once for every head; 64-key tiles whose mask
//     block is all false are never loaded (the ring's shadow slots, the
//     fused write's hidden ring on local layers), and the visible tiles
//     are dealt evenly to the splits, flash-decoding style, to fill the
//     132 SMs;
//   * K/V tiles and their mask words stream through a cp.async ring of
//     4 stages (pass 1) or 3 (pass 2); a warp whose rows see a whole tile
//     skips the mask, and pass 2 forms P 16 keys at a time.
//
// Plain C interface (built by ops/_build.py with nvcc, bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeys = 64;       // keys a tile
constexpr int kMaxWarps = 10;   // 160 query rows a block
constexpr int kStages1 = 4;     // tiles in flight in pass 1 (K)
constexpr int kStages2 = 3;     // tiles in flight in pass 2 (K and V)
constexpr int kMaxTiles = 1 << 14;  // the tile list in shared memory
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* rk;
  const void* rv;
  const void* nk;
  const void* nv;
  const unsigned char* mask;   // bool [Bm, lq, S + t]
  void* out;                   // [B, H, lq, Dh] in q's dtype
  float2* ml;                  // [B * H, nq, ns, rows] pass 1's (max, sum)
  float* po;                   // [B * H, nq, ns, rows, Dh] pass 2's splits
  unsigned long long* bits;    // [Bm, nq, T, rows] mask words
  unsigned char* flags;        // [Bm, nq, T] 1 where a row sees the tile
  long long qs[3], rks[3], rvs[3], nks[3], nvs[3], os[3];  // (b, h, row)
  long long ms[3];             // mask (b, row, col) in bytes
  int B, H, lq, S, t, rows, nq, ns, nr, T, mask_batched;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// four 8x8 b16 matrices: the B fragments of two 8-key tiles of K at one
// 16-wide slice of the head dim (keys down, head dim across)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// four 8x8 b16 matrices, transposed: the B fragments of two 8-column
// tiles of V (keys down, head dim across)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&v);
  }
  return u;
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// tile j's first key in its source, its key count and first mask column:
// the ring's ceil(S / 64) tiles, then the new tokens' ceil(t / 64)
__device__ __forceinline__ void tile_keys(const Args& a, int j, int& k0,
                                          int& n, int& col0) {
  if (j < a.nr) {
    k0 = j * kKeys;
    n = min(kKeys, a.S - k0);
    col0 = k0;
  } else {
    k0 = (j - a.nr) * kKeys;
    n = min(kKeys, a.t - k0);
    col0 = a.S + k0;
  }
}

// The plan: grid (T, nq, Bm), blockDim 32 * rows / 16. Warp w writes the
// words of rows 16 w .. + 15 of tile j (bit i: key i of the tile, only
// keys the source holds), the block the tile's flag.
__global__ void __launch_bounds__(kMaxWarps * 32)
    decode_attn_plan(const Args a) {
  const int j = blockIdx.x, qt = blockIdx.y, bm = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int k0, n, col0;
  tile_keys(a, j, k0, n, col0);
  const int row0 = qt * a.rows + warp * 16;
  const unsigned char* mb = a.mask + bm * a.ms[0] + col0 * a.ms[2];
  bool v0[16], v1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    const unsigned char* mr = mb + row * a.ms[1];
    v0[r] = row < a.lq && lane < n && mr[lane * a.ms[2]] != 0;
    v1[r] = row < a.lq && lane + 32 < n && mr[(lane + 32) * a.ms[2]] != 0;
  }
  unsigned long long mine = 0ull;
  bool any = false;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const unsigned long long w =
        ((unsigned long long)__ballot_sync(0xffffffffu, v1[r]) << 32) |
        __ballot_sync(0xffffffffu, v0[r]);
    if (lane == r) mine = w;
    any |= w != 0ull;
  }
  const long long tile = ((long long)bm * a.nq + qt) * a.T + j;
  if (lane < 16) a.bits[tile * a.rows + warp * 16 + lane] = mine;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) a.flags[tile] = any ? 1 : 0;
}

// Passes 1 and 2. Grid (ns, nq, B * H); blockDim 32 * rows / 16. Warp w
// owns the 16 query rows qt * rows + 16 w .. + 15; a thread holds rows
// g and g + 8 of them (g = lane / 4), as mma.sync's accumulators do.
// Split s takes visible tiles [s nv / ns, (s + 1) nv / ns) of the nv
// tiles the plan flagged for the block's (mask batch, query tile).
template <typename T, int D, bool kPass2>
__global__ void __launch_bounds__(kMaxWarps * 32, D == 64 ? 2 : 1)
    decode_attn_pass(const Args a) {
  constexpr int kStages = kPass2 ? kStages2 : kStages1;
  constexpr int kLd = D + 8;          // padded row: conflict-free reads
  constexpr int kTile = kKeys * kLd;  // elements a K or V stage
  constexpr int kChunks = D / 8;      // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [stage][key][d]
  T* vs = ks + kStages * kTile;                         // pass 2 only
  unsigned long long* ws = reinterpret_cast<unsigned long long*>(
      vs + (kPass2 ? kStages * kTile : 0));             // [stage][row]
  int* list = reinterpret_cast<int*>(ws + kStages * a.rows);  // [T]
  __shared__ int n_visible;

  const int s = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rloc0 = warp * 16;
  const int row0 = qt * a.rows + rloc0;  // the warp's first query row
  const int bm = a.mask_batched ? b : 0;
  const long long tiles0 = ((long long)bm * a.nq + qt) * a.T;
  const float c2 = a.scale * kLog2e;

  // the visible tiles, in order: the flags into the list's room in one
  // round of loads, then one warp packs their indices in place
  for (int j = threadIdx.x; j < a.T; j += blockDim.x)
    list[j] = a.flags[tiles0 + j];
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < a.T; base += 32) {
      const int j = base + lane;
      const bool v = j < a.T && list[j] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, v);
      __syncwarp();  // every lane has read its flag before any write
      if (v) list[count + __popc(bal & ((1u << lane) - 1u))] = j;
      count += __popc(bal);
    }
    if (lane == 0) n_visible = count;
  }
  __syncthreads();
  const int nv = n_visible;
  const int first = (int)((long long)s * nv / a.ns);
  const int cnt = (int)((long long)(s + 1) * nv / a.ns) - first;

  auto load = [&](int i, int stage) {
    const int j = list[first + i];
    int k0, n, col0;
    tile_keys(a, j, k0, n, col0);
    const bool ring = j < a.nr;
    const long long kr = ring ? a.rks[2] : a.nks[2];
    const long long vr = ring ? a.rvs[2] : a.nvs[2];
    const T* kb = static_cast<const T*>(ring ? a.rk : a.nk) +
                  b * (ring ? a.rks[0] : a.nks[0]) +
                  h * (ring ? a.rks[1] : a.nks[1]) + k0 * kr;
    const T* vb = static_cast<const T*>(ring ? a.rv : a.nv) +
                  b * (ring ? a.rvs[0] : a.nvs[0]) +
                  h * (ring ? a.rvs[1] : a.nvs[1]) + k0 * vr;
    T* kd = ks + stage * kTile;
    T* vd = vs + stage * kTile;
    for (int x = threadIdx.x; x < kKeys * kChunks; x += blockDim.x) {
      const int r = x / kChunks, ch = x % kChunks;
      const bool ok = r < n;  // keys past the source read as zero
      const int rr = ok ? r : 0;
      cp_async16(kd + r * kLd + ch * 8, kb + rr * kr + ch * 8, ok ? 16 : 0);
      if (kPass2)
        cp_async16(vd + r * kLd + ch * 8, vb + rr * vr + ch * 8,
                   ok ? 16 : 0);
    }
    const unsigned long long* wsrc = a.bits + (tiles0 + j) * a.rows;
    for (int x = threadIdx.x; x < a.rows / 2; x += blockDim.x)
      cp_async16(ws + stage * a.rows + 2 * x, wsrc + 2 * x, 16);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < cnt) load(i, i);
    cp_async_commit();
  }

  // Q's A fragments, once (rows past lq read as zero)
  uint32_t qf[D / 16][4];
  {
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const int rg = row0 + g, rh = rg + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = 16 * kk + 2 * c;
      qf[kk][0] = rg < a.lq ? ld32(qb + rg * a.qs[2] + col) : 0u;
      qf[kk][1] = rh < a.lq ? ld32(qb + rh * a.qs[2] + col) : 0u;
      qf[kk][2] = rg < a.lq ? ld32(qb + rg * a.qs[2] + col + 8) : 0u;
      qf[kk][3] = rh < a.lq ? ld32(qb + rh * a.qs[2] + col + 8) : 0u;
    }
  }

  // pass 1: running max and (per thread, unreduced) sum of rows g, g + 8
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // pass 2: the rows' max over all splits and 1 / their sum
  float m_all[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  const long long ml0 = ((long long)bh * a.nq + qt) * a.ns * a.rows;
  if (kPass2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = rloc0 + g + 8 * r;
      float m = -INFINITY, l = 0.f;
#pragma unroll 8
      for (int s2 = 0; s2 < a.ns; ++s2)
        m = fmaxf(m, a.ml[ml0 + (long long)s2 * a.rows + rl].x);
#pragma unroll 8
      for (int s2 = 0; s2 < a.ns; ++s2) {
        const float2 p = a.ml[ml0 + (long long)s2 * a.rows + rl];
        if (p.y > 0.f) l += p.y * exp2f(p.x - m);
      }
      // a row that sees nothing: every p is exp2(-inf - 0) * 0 = 0
      m_all[r] = l > 0.f ? m : 0.f;
      inv_l[r] = l > 0.f ? 1.f / l : 0.f;
    }
  }

  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    {
      const int nx = i + kStages - 1;
      if (nx < cnt) load(nx, nx % kStages);
      cp_async_commit();
    }
    const int stage = i % kStages;
    const unsigned long long wg = ws[stage * a.rows + rloc0 + g];
    const unsigned long long wh = ws[stage * a.rows + rloc0 + g + 8];
    if (!__any_sync(0xffffffffu, (wg | wh) != 0ull)) continue;
    // every row of the warp sees every key of the tile: no mask
    const bool full = __all_sync(0xffffffffu, (wg & wh) == ~0ull);
    const unsigned long long wgs = wg >> (2 * c), whs = wh >> (2 * c);
    // this lane's ldmatrix row of K: key (lane & 7) + 8 (lane >> 4), the
    // d half (lane >> 3) & 1 of a 16-wide slice
    const T* kl = ks + stage * kTile +
                  ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;

    // raw logits of keys 16 p .. + 15 (n-tiles 2 p, 2 p + 1), -inf where
    // the mask hides the key
    auto logits16 = [&](int p, float (*sc)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kl + 16 * p * kLd + 16 * kk);
        mma16816<T>(sc[0], qf[kk], kb[0], kb[1]);
        mma16816<T>(sc[1], qf[kk], kb[2], kb[3]);
      }
      if (!full) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned long long w = (e >> 1) ? whs : wgs;
            if (!((w >> ((2 * p + half) * 8 + (e & 1))) & 1ull))
              sc[half][e] = -INFINITY;
          }
      }
    };

    if (!kPass2) {
      float sc[8][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) logits16(p, sc + 2 * p);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          tmax = fmaxf(tmax, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        if (tmax == -INFINITY) continue;  // the row sees none of the tile
        // scale > 0: the max of the scaled logits is the scaled max
        const float m_tile = tmax * c2;
        if (m_tile > m_run[r]) {
          l_run[r] *= exp2f(m_run[r] - m_tile);
          m_run[r] = m_tile;
        }
        const float m = m_run[r];
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sum += exp2f(fmaf(sc[nt][2 * r], c2, -m)) +
                 exp2f(fmaf(sc[nt][2 * r + 1], c2, -m));
        l_run[r] += sum;
      }
    } else {
      const T* vt = vs + stage * kTile;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // P of keys 16 p .. + 15, normalised, then rounded to V's dtype
        float sc[2][4];
        logits16(p, sc);
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pr[e] = exp2f(fmaf(sc[half][e], c2, -m_all[e >> 1])) *
                    inv_l[e >> 1];
          pa[2 * half] = pack2<T>(pr[0], pr[1]);
          pa[2 * half + 1] = pack2<T>(pr[2], pr[3]);
        }
        const T* vr = vt + (16 * p + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kLd + (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < D / 8; dn += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vr + dn * 8);
          mma16816<T>(o[dn], pa, vb[0], vb[1]);
          mma16816<T>(o[dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  if (!kPass2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (c == 0)
        a.ml[ml0 + (long long)s * a.rows + rloc0 + g + 8 * r] =
            make_float2(m_run[r], l);
    }
    return;
  }
  if (a.ns == 1) {
    // one split: the output itself
    T* ob = static_cast<T*>(a.out) + b * a.os[0] + h * a.os[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= a.lq) continue;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<uint32_t*>(ob + row * a.os[2] + dn * 8 + 2 * c) =
            pack2<T>(o[dn][2 * r], o[dn][2 * r + 1]);
    }
    return;
  }
  float* pb = a.po + (ml0 + (long long)s * a.rows) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = rloc0 + g + 8 * r;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(pb + (long long)rl * D + dn * 8 + 2 * c) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
  }
}

// The splits' outputs summed in split order, in q's dtype: one thread
// per 4 columns of a row.
template <typename T, int D>
__global__ void __launch_bounds__(256) decode_attn_reduce(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kPer = D / 4;
  if (i >= (long long)a.B * a.H * a.lq * kPer) return;
  const int c4 = (int)(i % kPer);
  const long long rrow = i / kPer;
  const int row = (int)(rrow % a.lq), bh = (int)(rrow / a.lq);
  const int qt = row / a.rows, rl = row % a.rows;
  const float4* p =
      reinterpret_cast<const float4*>(
          a.po + ((((long long)bh * a.nq + qt) * a.ns) * a.rows + rl) * D) +
      c4;
  const long long step = (long long)a.rows * kPer;
  float4 acc = p[0];
  for (int s = 1; s < a.ns; ++s) {
    const float4 x = p[s * step];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int b = bh / a.H, h = bh % a.H;
  T* ob = static_cast<T*>(a.out) + b * a.os[0] + h * a.os[1] +
          row * a.os[2] + 4 * c4;
  uint2 u;
  u.x = pack2<T>(acc.x, acc.y);
  u.y = pack2<T>(acc.z, acc.w);
  *reinterpret_cast<uint2*>(ob) = u;
}

// dynamic shared memory of a pass: its K (and V) stages, its words
// stages and the tile list
template <typename T, int D, bool kPass2>
int pass_smem(const Args& a) {
  const int stages = kPass2 ? kStages2 : kStages1;
  const int tile = kKeys * (D + 8) * (int)sizeof(T);
  return stages * ((kPass2 ? 2 : 1) * tile + 8 * a.rows) + 4 * a.T;
}

// raise a kernel's dynamic shared memory limit once per device to what a
// launch needs (a no-op inside a graph capture of a shape already run)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e;
  if (allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

template <typename T, int D>
int run(const Args& a, cudaStream_t stream) {
  static int allowed1[64] = {}, allowed2[64] = {};
  const int threads = 32 * (a.rows / 16);
  const int smem1 = pass_smem<T, D, false>(a);
  const int smem2 = pass_smem<T, D, true>(a);
  cudaError_t e = allow_smem(decode_attn_pass<T, D, false>, smem1, allowed1);
  if (e == cudaSuccess)
    e = allow_smem(decode_attn_pass<T, D, true>, smem2, allowed2);
  if (e != cudaSuccess) return (int)e;
  decode_attn_plan<<<dim3(a.T, a.nq, a.mask_batched ? a.B : 1), threads, 0,
                     stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid(a.ns, a.nq, a.B * a.H);
  decode_attn_pass<T, D, false><<<grid, threads, smem1, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  decode_attn_pass<T, D, true><<<grid, threads, smem2, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (a.ns > 1) {
    const long long n = (long long)a.B * a.H * a.lq * (D / 4);
    decode_attn_reduce<T, D>
        <<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// ptr: q, ring k, ring v, new k, new v, mask, out, the (max,
// sum) scratch, the split outputs (null when ns is 1), the mask words,
// the tile flags. strides: (b, h, row) elements of q, ring k, ring v, new
// k, new v, out, then the mask's (b, row, col) bytes. ints: B, H, lq, S,
// t, Dh, fp16, rows, nq, ns, mask_batched.
// Returns a CUDA error, 0 on success.
extern "C" int owl_decode_attn(const void* const* ptr,
                               const long long* strides, const int* ints,
                               float scale, void* stream) {
  Args a;
  a.q = ptr[0];
  a.rk = ptr[1];
  a.rv = ptr[2];
  a.nk = ptr[3];
  a.nv = ptr[4];
  a.mask = static_cast<const unsigned char*>(ptr[5]);
  a.out = const_cast<void*>(ptr[6]);
  a.ml = static_cast<float2*>(const_cast<void*>(ptr[7]));
  a.po = static_cast<float*>(const_cast<void*>(ptr[8]));
  a.bits = static_cast<unsigned long long*>(const_cast<void*>(ptr[9]));
  a.flags = static_cast<unsigned char*>(const_cast<void*>(ptr[10]));
  long long* dst[7] = {a.qs, a.rks, a.rvs, a.nks, a.nvs, a.os, a.ms};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  a.B = ints[0];
  a.H = ints[1];
  a.lq = ints[2];
  a.S = ints[3];
  a.t = ints[4];
  const int D = ints[5], fp16 = ints[6];
  a.rows = ints[7];
  a.nq = ints[8];
  a.ns = ints[9];
  a.mask_batched = ints[10];
  a.scale = scale;
  a.nr = (a.S + kKeys - 1) / kKeys;
  a.T = a.nr + (a.t + kKeys - 1) / kKeys;
  if (a.B < 1 || a.H < 1 || a.lq < 1 || a.S < 0 || a.t < 1 ||
      a.rows < 16 || a.rows % 16 || a.rows > 16 * kMaxWarps || a.nq < 1 ||
      (long long)a.nq * a.rows < a.lq || a.ns < 1 || a.ns > a.T ||
      a.mask == nullptr || (a.ns > 1 && a.po == nullptr) ||
      (long long)a.B * a.H > 65535 ||
      a.nq > 65535 || a.T > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return fp16 ? run<__half, 64>(a, st) : run<__nv_bfloat16, 64>(a, st);
  if (D == 128)
    return fp16 ? run<__half, 128>(a, st) : run<__nv_bfloat16, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}
