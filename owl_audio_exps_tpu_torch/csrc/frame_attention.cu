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
//   same-document rule when `doc` is given; see attention_tiles.cuh).
//
// Three kernels, each a grid of 64-row tiles x (B * H):
//   * forward: a block owns a query tile, walks its visible key tiles
//     with an online softmax; optionally saves the f32 logsumexp
//     (training), which the serve path does not ask for;
//   * dq: a block owns a query tile and walks the same key tiles as the
//     forward; it computes delta = rowsum(dO * O) for its rows and stores
//     it for the dkv pass;
//   * dkv: a block owns a key tile and walks the query tiles that see it,
//     bounded in closed form (causal: query frames fk .. fk + window - 1,
//     or to the end without a window; bidirectional: |fq - fk| < window;
//     documents and the ragged tail masked per element).
// The two gradient kernels write disjoint outputs and use no atomics, so
// the backward is deterministic; dkv runs after dq on the same stream.
//
// Bound on the H100. Forward: 4 * Dh flops per visible pair, backward 10
// (the five products); at L = 16,384, 24 heads of 64, causal global, the
// forward is ~0.83 ms and the backward ~2.1 ms of tensor-core time at 989
// TFLOP/s, against ~0.06 ms of q, k, v, o traffic (~0.12 ms with dO, dq,
// dk, dv): bound by operations. This version loads tiles with plain 16-byte loads
// and multiplies with mma.sync (no cp.async/TMA pipelining, no wgmma), so
// it runs well below that bound; chip_smoke.py measures and prints both.
//
// K4, the ring partial. Replaces the TPU kernels reached by
// owl_audio_exps_tpu/ops/splash.py `splash_attention_lse` (the splash
// forward with `save_residuals`) and `splash_attention_lse_vjp` (the
// library's dq / dkv kernels with di' = rowsum(out * g_out) - g_lse), which
// parallel/context.py runs once per ring step. The same tile bodies with
// their own entry points (so the launches are counted and profiled apart
// from K1): q arrives pre-scaled, so `scale` is 1; the mask is the
// shard's own frame-causal one or, for an earlier shard's K/V, none; the
// forward always writes the logsumexp the merge reads; the lse cotangent
// folds into delta' = rowsum(dO * O) - g_lse (attention_tiles.cuh), which
// the caller computes in f32 as the TPU package computes di', and which
// both gradient kernels read, so the backward is one dq + dkv pass, not
// the three-pass decomposition. At the 98,304-token
// config split four ways (24,576 tokens a shard, 24 heads of 64) a full
// partial's forward is ~3.7 TFLOP (~3.8 ms at 989 TFLOP/s) against
// ~0.4 ms of traffic: bound by operations, like K1.

#include "attention_tiles.cuh"

using namespace owl_attn;

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads) frame_attn_fwd_kernel(const Params p) {
  fwd_tile<D, false>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads) frame_attn_bwd_dq_kernel(const Params p) {
  dq_tile<D>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBQ, true);
}

template <int D>
__global__ void __launch_bounds__(kThreads) frame_attn_bwd_dkv_kernel(const Params p) {
  dkv_tile<D>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBK, false);
}

template <int D>
__global__ void __launch_bounds__(kThreads) ring_attn_fwd_kernel(const Params p) {
  fwd_tile<D, false>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads) ring_attn_bwd_dq_kernel(const Params p) {
  dq_tile<D, true>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBQ,
                   false);
}

template <int D>
__global__ void __launch_bounds__(kThreads) ring_attn_bwd_dkv_kernel(const Params p) {
  dkv_tile<D>(p, blockIdx.y / p.H, blockIdx.y % p.H, blockIdx.x * kBK, false);
}

dim3 tile_grid(const Params& p) {
  return dim3((p.L + kBQ - 1) / kBQ, p.B * p.H);
}

}  // namespace

// Plain C entry points (bound with ctypes); the argument arrays are laid
// out as make_params documents. A `window` <= 0 means no window and a
// null `doc` no document masking. Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for a head dim other than 64/128.
extern "C" int owl_frame_attn_fwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, void* stream) {
  const Params p = make_params(ptr, strides, ints, scale, INFINITY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(frame_attn_fwd_kernel<64>, fwd_smem<64>(), tile_grid(p), s, p);
  if (ints[3] == 128)
    return launch(frame_attn_fwd_kernel<128>, fwd_smem<128>(), tile_grid(p), s,
                  p);
  return (int)cudaErrorInvalidValue;
}

extern "C" int owl_frame_attn_bwd_dq(const void* const* ptr,
                                     const long long* strides, const int* ints,
                                     float scale, void* stream) {
  const Params p = make_params(ptr, strides, ints, scale, INFINITY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(frame_attn_bwd_dq_kernel<64>, bwd_smem<64>(), tile_grid(p), s,
                  p);
  if (ints[3] == 128)
    return launch(frame_attn_bwd_dq_kernel<128>, bwd_smem<128>(), tile_grid(p),
                  s, p);
  return (int)cudaErrorInvalidValue;
}

extern "C" int owl_frame_attn_bwd_dkv(const void* const* ptr,
                                      const long long* strides,
                                      const int* ints, float scale,
                                      void* stream) {
  const Params p = make_params(ptr, strides, ints, scale, INFINITY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(frame_attn_bwd_dkv_kernel<64>, bwd_smem<64>(), tile_grid(p),
                  s, p);
  if (ints[3] == 128)
    return launch(frame_attn_bwd_dkv_kernel<128>, bwd_smem<128>(),
                  tile_grid(p), s, p);
  return (int)cudaErrorInvalidValue;
}

// K4 entry points: the same arrays, no float (the scale is 1 and the
// softmax the usual one); `window` must be <= 0, `doc` null, `lse` set;
// both backward kernels read `delta` (delta') and neither reads `o`.
namespace {

Params ring_params(const void* const* ptr, const long long* strides,
                   const int* ints) {
  Params p = make_params(ptr, strides, ints, 1.f, INFINITY);
  p.window = 0;
  p.doc = nullptr;
  return p;
}

bool ring_ok(const int* ints, const void* const* ptr) {
  return ints[5] <= 0 && ptr[8] != nullptr && ptr[10] == nullptr &&
         (ints[3] == 64 || ints[3] == 128);
}

}  // namespace

extern "C" int owl_ring_attn_fwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 void* stream) {
  if (!ring_ok(ints, ptr)) return (int)cudaErrorInvalidValue;
  const Params p = ring_params(ptr, strides, ints);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(ring_attn_fwd_kernel<64>, fwd_smem<64>(), tile_grid(p), s, p);
  return launch(ring_attn_fwd_kernel<128>, fwd_smem<128>(), tile_grid(p), s, p);
}

extern "C" int owl_ring_attn_bwd_dq(const void* const* ptr,
                                    const long long* strides, const int* ints,
                                    void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p = ring_params(ptr, strides, ints);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(ring_attn_bwd_dq_kernel<64>, bwd_smem<64>(), tile_grid(p), s,
                  p);
  return launch(ring_attn_bwd_dq_kernel<128>, bwd_smem<128>(), tile_grid(p), s,
                p);
}

extern "C" int owl_ring_attn_bwd_dkv(const void* const* ptr,
                                     const long long* strides, const int* ints,
                                     void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p = ring_params(ptr, strides, ints);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3] == 64)
    return launch(ring_attn_bwd_dkv_kernel<64>, bwd_smem<64>(), tile_grid(p),
                  s, p);
  return launch(ring_attn_bwd_dkv_kernel<128>, bwd_smem<128>(), tile_grid(p),
                s, p);
}
