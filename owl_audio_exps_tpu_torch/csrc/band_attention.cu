// Causal frame-window band attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces both bodies of the TPU band kernel in
// owl_audio_exps_tpu/ops/band.py: K2, the frame-exact bodies
// `_fwd_kernel_fw` / `_bwd_kernel_fw` (lane-aligned spans, dit_v4's
// C = 16 * 64 = 1024), and K3, the v1 bodies `_fwd_kernel` /
// `_bwd_kernel` (ragged spans, C = 520 / 1040 at tpf 65). Both compute
// the same function: query frame f sees key frames f - window + 1 .. f,
// no documents, with either the fixed-shift softmax
// exp(min(s - bound, 0)) / sum (the TPU default under QK rms-norm,
// bound = sqrt(Dh)) or the usual softmax. Which body the TPU ran was a
// layout policy of its vector unit (band.py:133-158); on Hopper one
// kernel pair serves every span.
//
// Design. The band is the causal-window case of the frame algebra, so
// the tiles are those of frame_attention.cu (attention_tiles.cuh): 64-row
// tiles, key ranges bounded in closed form, only partial tiles masked per
// element, ragged tails masked instead of padded, any tpf (65 included).
// What the band adds:
//   * the fixed-shift forward keeps no running max and never rescales its
//     output accumulator;
//   * the forward saves the logsumexp (shift + log(sum)), so the backward
//     recomputes P without a statistics pass. The TPU kernel recomputes
//     the row statistics instead (its custom vjp saves only qs, k, v,
//     band.py:634-637), which is cheap there because a grid step holds
//     the whole [C, 2C] band in VMEM; here a key tile would repeat that
//     pass for each of the ~17 query tiles that see it;
//   * the backward is one launch: blocks with blockIdx.z == 0 own a query
//     tile and write its dq, blocks with blockIdx.z == 1 own a key tile
//     and write its dk, dv, walking the query tiles that see it (query
//     frames fk .. fk + window - 1, i.e. kv chunk t's gradients from
//     query chunks t and t + 1). This key-owning loop replaces the TPU's
//     parity planes (band.py:545-575), which relied on the grid running
//     in order; blocks here run in no order, so each output has exactly
//     one writer and no atomics are needed. Both roles compute delta =
//     rowsum(dO * O) from the tiles they load.
//
// Bound on the H100. At L = 16,384, 24 heads of 64, window 16 x 64: a
// query sees ~1,024 keys, so the forward does ~0.10 TFLOP (~0.10 ms at
// 989 TFLOP/s) against ~0.06 ms of q, k, v, o traffic at 3.35 TB/s, and
// the backward (10 * Dh per pair) ~0.25 ms against ~0.12 ms for its eight
// tensors: bound by operations, narrowly.
// This version, like frame_attention.cu, uses plain loads and mma.sync
// and runs well below either bound; chip_smoke.py prints both.

#include "attention_tiles.cuh"

using namespace owl_attn;

namespace {

template <int D, bool kFixed>
__global__ void __launch_bounds__(kThreads) band_attn_fwd_kernel(const Params p) {
  fwd_tile<D, kFixed>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads) band_attn_bwd_kernel(const Params p) {
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  if (blockIdx.z == 0)
    dq_tile<D>(p, b, h, blockIdx.x * kBQ, false);
  else
    dkv_tile<D>(p, b, h, blockIdx.x * kBK, true);
}

Params band_params(const void* const* ptr, const long long* strides,
                   const int* ints, float scale, float cap) {
  Params p = make_params(ptr, strides, ints, scale, cap);
  p.causal = 1;      // the band is causal by definition
  p.doc = nullptr;   // and has no documents
  return p;
}

template <int D>
int band_fwd(const Params& p, cudaStream_t s) {
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.B * p.H);
  if (p.cap == INFINITY)
    return launch(band_attn_fwd_kernel<D, false>, fwd_smem<D>(), grid, s, p);
  return launch(band_attn_fwd_kernel<D, true>, fwd_smem<D>(), grid, s, p);
}

template <int D>
int band_bwd(const Params& p, cudaStream_t s) {
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.B * p.H, 2);
  return launch(band_attn_bwd_kernel<D>, bwd_smem<D>(), grid, s, p);
}

}  // namespace

// Plain C entry points (bound with ctypes), with the argument arrays of
// make_params; `cap` is the fixed-shift bound, or +inf for the usual
// softmax. The forward writes out and the logsumexp; the backward reads
// q, k, v, out, dout and the logsumexp and writes dq, dk, dv. Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// head dim other than 64/128 or a window < 1.
extern "C" int owl_band_attn_fwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 float scale, float cap, void* stream) {
  if (ints[5] < 1) return (int)cudaErrorInvalidValue;
  const Params p = band_params(ptr, strides, ints, scale, cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64) return band_fwd<64>(p, s);
  if (ints[3] == 128) return band_fwd<128>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int owl_band_attn_bwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 float scale, float cap, void* stream) {
  if (ints[5] < 1) return (int)cudaErrorInvalidValue;
  const Params p = band_params(ptr, strides, ints, scale, cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64) return band_bwd<64>(p, s);
  if (ints[3] == 128) return band_bwd<128>(p, s);
  return (int)cudaErrorInvalidValue;
}
