// Frame-mask flash attention, forward and backward (K1), and the ring
// partial of context parallelism (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel reached by owl_audio_exps_tpu/ops/splash.py
// `splash_attention` (JAX's splash Pallas kernel under the `FrameMask`
// computable mask) and its custom-vjp backward (the library's
// `_splash_attention_bwd_dq` / `_bwd_dkv`). Same function:
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h, j]) v[b, h, j]
//   over the keys j visible from query i (the frame algebra, with the
//   same-document rule when `doc` is given; see hopper_attention.cuh).
//
// Three kernels, each a grid of 128-row tiles x (B * H), 384 threads (a
// TMA producer warpgroup and two wgmma consumer warpgroups):
//   * forward: a block owns a query tile, walks its visible key tiles
//     (128 rows) with an online softmax; optionally saves the f32
//     logsumexp (training), which the serve path does not ask for;
//   * dq: a block owns a query tile and walks the same keys as the
//     forward (64-row tiles); it computes delta = rowsum(dO * O) for its
//     rows and stores it for the dkv pass;
//   * dkv: a block owns a key tile and walks the 64-row query tiles that
//     see it, bounded in closed form (causal: query frames fk .. fk +
//     window - 1, or to the end without a window; bidirectional: |fq - fk|
//     < window; documents and the ragged tail masked per element).
// The two gradient kernels write disjoint outputs and use no atomics, so
// the backward is deterministic; dkv runs after dq on the same stream.
//
// Bound on the H100: operations. Forward 4 * Dh flops per visible pair,
// dq 6, dkv 8; at L = 16,384, 24 heads of 64, causal global, the forward
// is ~0.84 ms and dq + dkv ~2.9 ms of tensor-core time at 989 TFLOP/s,
// against ~0.06 ms of q, k, v, o traffic (~0.12 ms with dO, dq, dk, dv).
// The bodies (hopper_attention.cuh) answer it with wgmma for every
// product, TMA into swizzled shared memory on an mbarrier ring, and warp
// specialisation; chip_smoke.py measures each kernel against its bound.
//
// K4, the ring partial. Replaces the TPU kernels reached by
// owl_audio_exps_tpu/ops/splash.py `splash_attention_lse` (the splash
// forward with `save_residuals`) and `splash_attention_lse_vjp` (the
// library's dq / dkv kernels with di' = rowsum(out * g_out) - g_lse), which
// parallel/context.py runs once per ring step. The same bodies with their
// own entry points (so the launches are counted and profiled apart from
// K1): q arrives pre-scaled, so `scale` is 1; the mask is the shard's own
// frame-causal one or, for an earlier shard's K/V, none; the forward
// always writes the logsumexp the merge reads; the lse cotangent folds
// into delta' = rowsum(dO * O) - g_lse, which the caller computes in f32
// as the TPU package computes di', and which both gradient kernels read,
// so the backward is one dq + dkv pass. At the 98,304-token config split
// four ways (24,576 tokens a shard, 24 heads of 64) a full partial's
// forward is ~3.7 TFLOP (~3.8 ms at 989 TFLOP/s) against ~0.4 ms of
// traffic: bound by operations, like K1.

#include "hopper_attention.cuh"

using namespace owl_hopper;

namespace {

template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    frame_attn_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  fwd_block<D>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
               query_tile(p, Fwd<D>::kBM));
}

template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    frame_attn_bwd_dq_kernel(const __grid_constant__ Maps maps,
                             const Params p) {
  dq_block<D, false>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
                     query_tile(p, Dq<D>::kBM));
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1)
    frame_attn_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                              const Params p) {
  dkv_block<D>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
               blockIdx.x * Dkv<D>::kBM);
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    ring_attn_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  fwd_block<D>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
               query_tile(p, Fwd<D>::kBM));
}

template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    ring_attn_bwd_dq_kernel(const __grid_constant__ Maps maps,
                            const Params p) {
  dq_block<D, true>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
                    query_tile(p, Dq<D>::kBM));
}

template <int D>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1)
    ring_attn_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                             const Params p) {
  dkv_block<D>(maps, p, blockIdx.y / p.H, blockIdx.y % p.H,
               blockIdx.x * Dkv<D>::kBM);
}

// K4: the scale is 1, the softmax the usual one; `window` must be <= 0,
// `doc` null, `lse` set.
bool ring_ok(const int* ints, const void* const* ptr) {
  return ints[5] <= 0 && ptr[8] != nullptr && ptr[10] == nullptr;
}

}  // namespace

// Plain C entry points (bound with ctypes); the argument arrays are laid
// out as hopper_attention.cuh make_params documents. A `window` <= 0
// means no window and a null `doc` no document masking. Each returns
// cudaGetLastError() after its launch, cudaErrorInvalidValue for a head
// dim other than 64/128,
// 10000 + the CUresult of cuTensorMapEncodeTiled for a view TMA cannot
// take, or cudaErrorNotSupported without cuTensorMapEncodeTiled.
extern "C" int owl_frame_attn_fwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, void* stream) {
  return run<Fwd>(frame_attn_fwd_kernel<64>, frame_attn_fwd_kernel<128>,
                  make_params(ptr, strides, ints, scale, INFINITY), ptr,
                  strides, ints, stream, false, false);
}

extern "C" int owl_frame_attn_bwd_dq(const void* const* ptr,
                                     const long long* strides, const int* ints,
                                     float scale, void* stream) {
  return run<Dq>(frame_attn_bwd_dq_kernel<64>, frame_attn_bwd_dq_kernel<128>,
                 make_params(ptr, strides, ints, scale, INFINITY), ptr,
                 strides, ints, stream, true, true);
}

extern "C" int owl_frame_attn_bwd_dkv(const void* const* ptr,
                                      const long long* strides,
                                      const int* ints, float scale,
                                      void* stream) {
  return run<Dkv>(frame_attn_bwd_dkv_kernel<64>, frame_attn_bwd_dkv_kernel<128>,
                  make_params(ptr, strides, ints, scale, INFINITY), ptr,
                  strides, ints, stream, false, true);
}

// K4 entry points: the same arrays, no float; both backward kernels read
// `delta` (delta') and neither reads `o`.
extern "C" int owl_ring_attn_fwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 void* stream) {
  if (!ring_ok(ints, ptr)) return (int)cudaErrorInvalidValue;
  return run<Fwd>(ring_attn_fwd_kernel<64>, ring_attn_fwd_kernel<128>,
                  make_params(ptr, strides, ints, 1.f, INFINITY), ptr,
                  strides, ints, stream, false, false);
}

extern "C" int owl_ring_attn_bwd_dq(const void* const* ptr,
                                    const long long* strides, const int* ints,
                                    void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<Dq>(ring_attn_bwd_dq_kernel<64>, ring_attn_bwd_dq_kernel<128>,
                 make_params(ptr, strides, ints, 1.f, INFINITY), ptr,
                 strides, ints, stream, false, true);
}

extern "C" int owl_ring_attn_bwd_dkv(const void* const* ptr,
                                     const long long* strides,
                                     const int* ints, void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<Dkv>(ring_attn_bwd_dkv_kernel<64>, ring_attn_bwd_dkv_kernel<128>,
                  make_params(ptr, strides, ints, 1.f, INFINITY), ptr,
                  strides, ints, stream, false, true);
}
