// Causal frame-window band attention over a sub-window chunk plan (S, m),
// forward and backward, for Hopper (sm_90a).
//
// Replaces K5, the TPU band2 kernel of owl_audio_exps_tpu/ops/band2.py:
// `_fwd` with `_fwd_kernel` (pallas_call at :348) and `_bwd` with
// `_bwd_kernel` (pallas_call at :552), joined by the custom vjp
// `_band2_hl`. The function is the band's (band_attention.cu): query frame
// f sees key frames f - window + 1 .. f, no documents, with either the
// fixed-shift softmax exp(min(s - cap, 0)) / sum (the clamp's gradient
// passed straight through) or the usual softmax (cap = +inf).
//
// What the TPU design is about, and what is kept here:
//   * the plan is the unit of work: query chunk i (S tokens) reads kv
//     chunks i - m .. i, and, for a ragged span (S % tpf != 0), the first
//     fcols tokens of chunk i + 1, the NEXT ref that holds the tail of a
//     frame straddling the chunk boundary. Chunks before the first and the
//     last chunk's NEXT ref are gated out, here by clamping the ranges
//     (attention_tiles.cuh plan_kv_range). A legal plan (m * S >= C - 1,
//     fcols >= tpf, checked by the wrapper) holds every visible pair, so
//     masks built from global token indices give exactly the TPU kernel's
//     output.
//   * tiles are classified, not masked by default: every (64-row query
//     tile, 64-row key tile) pair of the walk is SKIP, FULL (tile_full) or
//     PARTIAL. The TPU's `_ref_class` classifies (row sub-block, ref)
//     statically and, for ragged spans, conservatively, because the chunk
//     index is not static there; a Hopper block knows its global rows, so
//     the class is exact at any span. The SKIP tiles of a block's walk all
//     lie before or after the contiguous rows it can see, so they are cut
//     off the walk in closed form (cut_skip_tiles) and never visited or
//     loaded; FULL tiles run without a mask, PARTIAL tiles are masked per
//     element.
//   * S = 520 (8 frames of 65) is not a multiple of 64: the 64-row tiles
//     are laid over the sequence, not over chunks, and a tile that crosses
//     a chunk boundary walks the union of its chunks' refs. That costs no
//     masked work: the refs of the later chunk that the earlier rows
//     cannot see classify as SKIP or PARTIAL like any other tile.
//   * the backward is one launch with one writer per output. The TPU's
//     dk/dv planes mod P = m + 1 (ops/band2.py:483-510, :566-587) relied
//     on its grid running in order; blocks here run in no order, so
//     blocks with blockIdx.z == 0 own a query tile and write its dq, and
//     blocks with blockIdx.z == 1 own a key tile of chunk t and write its
//     dk and dv, walking query chunks t .. t + m, and chunk t - 1 as well
//     where the tile lies in chunk t's NEXT ref (plan_q_range). No atomics.
//   * the TPU backward recomputes the row statistics (its vjp saves only
//     qs, k, v). Here the forward saves the f32 logsumexp (shift +
//     log(sum)), as band_attention.cu does, and both backward roles
//     recompute P = exp(min(s, cap) - lse) without a statistics pass; each
//     computes delta = rowsum(dO * O) from the tiles it loads.
//
// The tile bodies are the shared ones of attention_tiles.cuh (mma.sync
// bf16), run with their kPlan policy: only the walk differs from the band
// kernel's.
//
// Bound on the H100. At the AV training geometry (L = 24,960 = 384 frames
// of 65 tokens, 24 heads of 64, window 16, plan (520, 2)) the heads hold
// 610.8 M visible pairs: the forward does 156.4 GFLOP (0.158 ms at 989
// TFLOP/s) against 0.092 ms of q, k, v, o traffic at 3.35 TB/s, the
// backward (10 * Dh per pair) 0.395 ms against ~0.18 ms: bound by
// operations. This first version uses plain loads and mma.sync and runs
// well below either bound; chip_smoke.py prints both.

#include "attention_tiles.cuh"

using namespace owl_attn;

namespace {

template <int D, bool kFixed>
__global__ void __launch_bounds__(kThreads)
    band2_attn_fwd_kernel(const Params p) {
  fwd_tile<D, kFixed, true>(p, blockIdx.y / p.H, blockIdx.y % p.H,
                            blockIdx.x * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    band2_attn_bwd_kernel(const Params p) {
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  if (blockIdx.z == 0)
    dq_tile<D, false, true>(p, b, h, blockIdx.x * kBQ, false);
  else
    dkv_tile<D, true>(p, b, h, blockIdx.x * kBK, true);
}

// The launch arrays of make_params, with the plan in ints[7..9] (S, m,
// fcols). Returns false for what the kernels do not take.
bool read_args(const void* const* ptr, const long long* strides,
               const int* ints, float scale, float cap, Params& p) {
  p = make_params(ptr, strides, ints, scale, cap);
  p.causal = 1;      // the band is causal by definition
  p.doc = nullptr;   // and has no documents
  p.span = ints[7];
  p.nrefs = ints[8];
  p.next_cols = ints[9];
  if (p.window < 1 || p.span < 1 || p.nrefs < 1 || p.next_cols < 0 ||
      p.L % p.span != 0)
    return false;
  p.n_chunks = p.L / p.span;
  return p.n_chunks >= p.nrefs + 1;
}

template <int D>
int band2_fwd(const Params& p, cudaStream_t s) {
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.B * p.H);
  if (p.cap == INFINITY)
    return launch(band2_attn_fwd_kernel<D, false>, fwd_smem<D>(), grid, s, p);
  return launch(band2_attn_fwd_kernel<D, true>, fwd_smem<D>(), grid, s, p);
}

template <int D>
int band2_bwd(const Params& p, cudaStream_t s) {
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.B * p.H, 2);
  return launch(band2_attn_bwd_kernel<D>, bwd_smem<D>(), grid, s, p);
}

}  // namespace

// Plain C entry points (bound with ctypes): the arrays of make_params with
// 10 ints (B, H, L, Dh, tpf, window, causal, S, m, fcols); `cap` is the
// fixed-shift bound, or +inf for the usual softmax. The forward writes out
// and the logsumexp; the backward reads q, k, v, out, dout and the
// logsumexp and writes dq, dk, dv. Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for a head dim other than 64/128 or
// a plan that does not tile L.
extern "C" int owl_band2_attn_fwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, float cap, void* stream) {
  Params p;
  if (!read_args(ptr, strides, ints, scale, cap, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64) return band2_fwd<64>(p, s);
  if (ints[3] == 128) return band2_fwd<128>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int owl_band2_attn_bwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, float cap, void* stream) {
  Params p;
  if (!read_args(ptr, strides, ints, scale, cap, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64) return band2_bwd<64>(p, s);
  if (ints[3] == 128) return band2_bwd<128>(p, s);
  return (int)cudaErrorInvalidValue;
}
