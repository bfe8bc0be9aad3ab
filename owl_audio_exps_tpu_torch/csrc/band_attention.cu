// Causal frame-window band attention, forward and backward, for Hopper
// (sm_90a): the counterpart of K2/K3 and, behind a plan check, of K5.
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
// layout policy of its vector unit (band.py:133-158); on Hopper one set
// of kernels serves every span.
//
// Also replaces K5, the TPU band2 kernel of owl_audio_exps_tpu/ops/band2.py
// (`_fwd` with `_fwd_kernel`, pallas_call at :348; `_bwd` with
// `_bwd_kernel`, pallas_call at :552; the custom vjp `_band2_hl`). Its
// function is the band's; what the TPU kernel adds is a plan (S, m):
// query chunk i of S tokens reads kv chunks i - m .. i and, for a ragged
// span, the first fcols tokens of chunk i + 1. A legal plan (m * S >= C -
// 1, fcols >= tpf; the wrapper's check_plan) holds every visible pair, so
// the plan shaped the TPU's work and never its output. Here the plan is
// validated (owl_band2_attn_*) and the band's kernels run: on the H100 the
// plan no longer shapes the work.
//
// Design. The band is the causal-window case of the frame algebra, so its
// kernels are the wgmma + TMA bodies of hopper_attention.cuh (K1's), run
// causal with a window and no documents: 128-row tiles of a producer
// warpgroup and two consumers, tensor maps over the [B, H, L, Dh] views
// (Attn's fused projection read in place), key and query ranges in closed
// form (kv_range / q_range: the exact tiles that hold a visible pair,
// which every legal plan's walk contains), FULL tiles unmasked, ragged
// tails (any tpf, 65 included) masked instead of padded; tiles are laid
// over the sequence, not over chunks, so S = 520 needs no special case.
// What the band adds:
//   * the fixed shift (the bodies' kFixed policy, chosen by a finite
//     `cap`): the forward keeps no running max and never rescales its
//     output accumulator;
//   * a persistent forward (fwd_items, its own copy of the forward body):
//     one block per SM, each looping over 128-row query tiles, its
//     producer loading the next tile's Q and first K/V stages while the
//     consumers finish the current one (one block per tile ran 5-7%
//     slower, PERF.md section 6). The backward keeps K1's block-per-tile
//     dq / dkv bodies;
//   * the forward saves the logsumexp (cap + log(sum)), so the backward
//     recomputes P without a statistics pass. The TPU kernel recomputes
//     the row statistics instead (its custom vjp saves only qs, k, v,
//     band.py:634-637), which is cheap there because a grid step holds
//     the whole [C, 2C] band in VMEM; here a key tile would repeat that
//     pass for each of the query tiles that see it;
//   * the backward is two kernels, as K1's: dq blocks own a query tile,
//     write its dq and store delta = rowsum(dO * O); dkv blocks then own
//     a key tile and write its dk, dv, walking the query tiles that see
//     it (query frames fk .. fk + window - 1). This key-owning loop
//     replaces the TPU's parity planes (band.py:545-575; band2.py's planes
//     mod m + 1, :483-510, :566-587), which relied on the grid running in
//     order; blocks here run in no order, so each output has exactly one
//     writer and no atomics are needed (the backward is deterministic).
//
// Bound on the H100. At L = 16,384, 24 heads of 64, window 16 x 64: a
// query sees ~1,024 keys, so the forward does ~0.10 TFLOP (~0.10 ms at
// 989 TFLOP/s) against ~0.06 ms of q, k, v, o traffic at 3.35 TB/s, and
// the backward (10 * Dh per pair) ~0.25 ms against ~0.12 ms for its eight
// tensors: bound by operations, narrowly. The two-kernel backward does
// 14 * Dh per pair (dq recomputes S and dP). A 128-row tile meets only
// 9-11 tiles of the other operand at this window, so each tile's fixed
// costs (barriers, the Q load, the pipeline's fill and drain, the
// epilogue) weigh more than in K1's long walks: hence the persistent
// forward. chip_smoke.py prints the time against the bound.

#include "hopper_attention.cuh"

using namespace owl_hopper;

namespace {

template <int D, bool kFixed>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    band_attn_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  fwd_items<D, kFixed>(maps, p);
}

template <int D, bool kFixed>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    band_attn_bwd_dq_kernel(const __grid_constant__ Maps maps,
                            const Params p) {
  dq_block<D, false, kFixed>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
                             query_tile(p, Dq<D>::kBM));
}

template <int D, bool kFixed>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1)
    band_attn_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                             const Params p) {
  dkv_block<D, kFixed>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
                       blockIdx.x * Dkv<D>::kBM);
}

template <bool kFixed>
int band_fwd(const Params& p, const void* const* ptr, const long long* st,
             const int* in, void* stream) {
  return run<FwdItems>(band_attn_fwd_kernel<64, kFixed>,
                       band_attn_fwd_kernel<128, kFixed>, p, ptr, st, in,
                       stream, false, false);
}

// dq (storing delta), then dkv (reading it), on the same stream
template <bool kFixed>
int band_bwd(const Params& p, const void* const* ptr, const long long* st,
             const int* in, void* stream) {
  const int err = run<Dq>(band_attn_bwd_dq_kernel<64, kFixed>,
                          band_attn_bwd_dq_kernel<128, kFixed>, p, ptr, st,
                          in, stream, true, true);
  if (err) return err;
  return run<Dkv>(band_attn_bwd_dkv_kernel<64, kFixed>,
                  band_attn_bwd_dkv_kernel<128, kFixed>, p, ptr, st, in,
                  stream, false, true);
}

// The band's parameters: causal by definition, no documents.
Params band_params(const void* const* ptr, const long long* st,
                   const int* ints, float scale, float cap) {
  Params p = make_params(ptr, st, ints, scale, cap);
  p.causal = 1;
  p.doc = nullptr;
  p.dsum = nullptr;
  return p;
}

// A band2 plan in ints[7..9] (S, m, fcols) that tiles L.
bool plan_tiles(const int* ints) {
  const int L = ints[2], span = ints[7], nrefs = ints[8], fcols = ints[9];
  return span >= 1 && nrefs >= 1 && fcols >= 0 && L % span == 0 &&
         L / span >= nrefs + 1;
}

}  // namespace

// Plain C entry points (bound with ctypes), with the argument arrays of
// hopper_attention.cuh make_params; `cap` is the fixed-shift bound, or
// +inf for the usual softmax. The forward writes out and the logsumexp;
// the backward reads q, k, v, out, dout and the logsumexp, writes dq, dk,
// dv, and uses `delta` ([B, H, L] f32) between its two kernels. Each
// returns the CUDA error of its launches, cudaErrorInvalidValue for a
// head dim other than 64/128, a window < 1 or a missing lse / delta, or
// 10000 + the CUresult of cuTensorMapEncodeTiled for a view TMA cannot
// take.
extern "C" int owl_band_attn_fwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 float scale, float cap, void* stream) {
  if (ints[5] < 1 || ptr[8] == nullptr) return (int)cudaErrorInvalidValue;
  const Params p = band_params(ptr, strides, ints, scale, cap);
  return cap == INFINITY ? band_fwd<false>(p, ptr, strides, ints, stream)
                         : band_fwd<true>(p, ptr, strides, ints, stream);
}

extern "C" int owl_band_attn_bwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 float scale, float cap, void* stream) {
  if (ints[5] < 1 || ptr[8] == nullptr || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p = band_params(ptr, strides, ints, scale, cap);
  return cap == INFINITY ? band_bwd<false>(p, ptr, strides, ints, stream)
                         : band_bwd<true>(p, ptr, strides, ints, stream);
}

// K5's entry points: the band's, with 10 ints (B, H, L, Dh, tpf, window,
// causal, S, m, fcols); cudaErrorInvalidValue also for a plan that does
// not tile L.
extern "C" int owl_band2_attn_fwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, float cap, void* stream) {
  if (!plan_tiles(ints)) return (int)cudaErrorInvalidValue;
  return owl_band_attn_fwd(ptr, strides, ints, scale, cap, stream);
}

extern "C" int owl_band2_attn_bwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, float cap, void* stream) {
  if (!plan_tiles(ints)) return (int)cudaErrorInvalidValue;
  return owl_band_attn_bwd(ptr, strides, ints, scale, cap, stream);
}
