// Frame-mask flash attention, forward (K1 fwd), for Hopper (sm_90a).
//
// Replaces the TPU kernel reached by owl_audio_exps_tpu/ops/splash.py
// `splash_attention` (JAX's splash Pallas kernel under the `FrameMask`
// computable mask). Same function:
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h, j]) v[b, h, j]
//   over the keys j visible from query i, where with f = index / tpf
//     visible  iff  (fk <= fq if causal) and (|fq - fk| < window if window)
//                   and (doc[b, fq] == doc[b, fk] if doc is given)
//
// Numerics follow ops/attention.dot_attention: q is pre-scaled in bf16
// (as splash.py does), logits and the online softmax are f32, P is
// rounded to bf16 for the PV product, PV accumulates in f32, and the
// output is bf16.
//
// Design. One block of 4 warps owns a 64-row query tile of one (b, h);
// each warp owns 16 rows and keeps its Q fragments, its f32 O
// accumulator and its row statistics in registers. The block walks only
// the 64-column KV tiles that can be visible, bounded in closed form
// from the tile's frame range (causal: up to the end of the last query
// frame; window: from frame fq_lo - window + 1). Each tile is
// classified full or partial from its frame range, as
// FrameMask.__getitem__ does on the TPU side; a full tile skips the
// per-element mask. Frames of 65 tokens do not align with 64-wide
// tiles, so partial tiles are common there. The ragged tail (L not a
// multiple of 64) is masked here instead of padded: rows past L are
// neither loaded nor written, and columns past L are invisible. Products
// run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32 out).
//
// Bound on the H100. At W = 60 frames of 65 tokens (L = 3900), 24
// heads of 64, one causal global layer does ~47.5 GFLOP over the
// visible pairs (~48 us at 989 TFLOP/s), while q, k, v and o move ~48 MB
// (~14 us at 3.35 TB/s): the kernel is bound by operations once
// invisible tiles are skipped. This first version loads tiles with plain
// 16-byte loads, without cp.async/TMA pipelining or wgmma, so it runs
// well below that bound; chip_smoke.py measures and prints both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key columns per tile
constexpr int kThreads = 128; // 4 warps x 16 query rows

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* doc;  // per-frame document id [B, n_frames], or null
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int H, L, tpf, window, causal, n_frames;
  float scale;
};

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// Copy a [64, D] tile of rows [row0, row0 + 64) into shared memory with
// 16-byte loads; rows at or past L are zero. With `scale` > 0 every
// element is multiplied by it and rounded back to bf16 (q pre-scaling).
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
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
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    frame_attn_fwd_kernel(const Params p) {
  constexpr int LDS = D + 8;  // padded shared-memory row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * LDS;
  __nv_bfloat16* sV = sK + kBK * LDS;
  int* sKf = reinterpret_cast<int*>(sV + kBK * LDS);  // key frame, -1 past L
  int* sKd = sKf + kBK;                               // key document

  const int L = p.L, tpf = p.tpf, window = p.window, nf = p.n_frames;
  const bool causal = p.causal != 0;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int* docb = p.doc ? p.doc + (long long)b * nf : nullptr;

  load_tile<D, LDS>(sQ, qg, p.q_sl, q0, L, p.scale);
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

  // frames the block's queries span, and the key range that can be visible
  const int fq_lo = q0 / tpf;
  const int fq_hi = (min(q0 + kBQ, L) - 1) / tpf;
  const int fk_min = window > 0 ? max(0, fq_lo - window + 1) : 0;
  const int fk_max =
      causal ? fq_hi : (window > 0 ? min(nf - 1, fq_hi + window - 1) : nf - 1);
  const int kv_end = min((fk_max + 1) * tpf, L);
  const int kv_begin = (fk_min * tpf / kBK) * kBK;

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, LDS>(sK, kg, p.k_sl, k0, L, 0.f);
    load_tile<D, LDS>(sV, vg, p.v_sl, k0, L, 0.f);
    if (threadIdx.x < kBK) {
      const int j = k0 + threadIdx.x;
      const int f = j < L ? j / tpf : -1;
      sKf[threadIdx.x] = f;
      sKd[threadIdx.x] = (docb && f >= 0) ? docb[f] : 0;
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
      const __nv_bfloat16* krow = &sK[(n * 8 + g) * LDS + t4 * 2];
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
          const int fk = sKf[j];
          bool vis = fk >= 0;
          if (causal) vis = vis && fk <= fq[i];
          if (window > 0) vis = vis && abs(fq[i] - fk) < window;
          if (docb) vis = vis && sKd[j] == dq[i];
          if (!vis) s[n][e] = -INFINITY;
        }
      }
    }

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

    // O += P V; the S accumulator layout is the A-operand layout of P
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = &sV[(j * 16 + t4 * 2) * LDS + g];
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        const __nv_bfloat16* vc = v0 + d * 8;
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
    if (row < L) {
      __nv_bfloat16* og =
          p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sl + t4 * 2;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(og + d * 8) =
            __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    }
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(__nv_bfloat16) +
      2 * kBK * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      frame_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.L + kBQ - 1) / kBQ, B * p.H);
  frame_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers and the stream are
// passed as void*, strides in elements; `window` <= 0 means no window
// and a null `doc` means no document masking. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported head dim.
extern "C" int owl_frame_attn_fwd(
    const void* q, const void* k, const void* v, void* o, const void* doc,
    long long q_sb, long long q_sh, long long q_sl, long long k_sb,
    long long k_sh, long long k_sl, long long v_sb, long long v_sh,
    long long v_sl, long long o_sb, long long o_sh, long long o_sl, int B,
    int H, int L, int Dh, int tpf, int window, int causal, float scale,
    void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.doc = static_cast<const int*>(doc);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.H = H;
  p.L = L;
  p.tpf = tpf;
  p.window = window;
  p.causal = causal;
  p.n_frames = (L + tpf - 1) / tpf;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64>(p, B, s);
  if (Dh == 128) return launch<128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
