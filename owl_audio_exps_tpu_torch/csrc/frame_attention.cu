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

enum Operand { OP_Q, OP_K, OP_V, OP_O, OP_DO, OP_DQ, OP_DK, OP_DV };

// The C entry points all take the same arrays: 11 pointers (q, k, v, o,
// dout, dq, dk, dv, lse, delta, doc), 24 element strides (batch, head, row
// of the 8 tensor operands in that order, a dim of extent 1 given its
// dense stride by ops/_attn_launch.py map_strides) and 7 ints (B, H, L,
// Dh, tpf, window, causal).
Params make_params(const void* const* ptr, const long long* st,
                   const int* in, float scale) {
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
  p.B = in[0];
  p.H = in[1];
  p.L = in[2];
  p.tpf = in[4];
  p.window = in[5];
  p.causal = in[6];
  p.n_frames = (p.L + p.tpf - 1) / p.tpf;
  p.inv_tpf = 1.f / (float)p.tpf;
  p.scale = scale;
  // a power-of-two scale folds into the f32 logits exactly
  int e;
  const bool pow2 = frexpf(scale, &e) == 0.5f;
  p.logit_mul = pow2 ? scale : 1.f;
  p.scale_q = !pow2;
  return p;
}

// Tensor maps of the inputs a kernel reads, with its box heights.
int make_maps(Maps* m, const void* const* ptr, const long long* st,
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
// tensor maps (boxes of Cfg's rows), its grid of Cfg::kBM-row tiles x
// (B * H), its threads and shared memory.
template <template <int> class Cfg, int D, typename Kernel>
int launch_d(Kernel kernel, const void* const* ptr, const long long* st,
             const int* in, float scale, cudaStream_t stream, bool with_o,
             bool with_dout) {
  using C = Cfg<D>;
  const Params p = make_params(ptr, st, in, scale);
  Maps m{};
  const int err =
      make_maps(&m, ptr, st, in, C::kBoxQ, C::kBoxKV, with_o, with_dout);
  if (err) return err;
  const dim3 grid((p.L + C::kBM - 1) / C::kBM, p.B * p.H);
  return launch(kernel, C::kSmem, grid, C::kThreads, stream, m, p);
}

// The kernel for the head dim (64 or 128), on q's device.
template <template <int> class Cfg, typename K64, typename K128>
int run(K64 k64, K128 k128, const void* const* ptr, const long long* st,
        const int* in, float scale, void* stream, bool with_o,
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
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      in[3] == 64
          ? launch_d<Cfg, 64>(k64, ptr, st, in, scale, s, with_o, with_dout)
          : launch_d<Cfg, 128>(k128, ptr, st, in, scale, s, with_o,
                               with_dout);
  if (prev != attr.device) e = cudaSetDevice(prev);
  return err ? err : (int)e;
}

// K4: the scale is 1, the softmax the usual one; `window` must be <= 0,
// `doc` null, `lse` set.
bool ring_ok(const int* ints, const void* const* ptr) {
  return ints[5] <= 0 && ptr[8] != nullptr && ptr[10] == nullptr;
}

}  // namespace

// Plain C entry points (bound with ctypes); the argument arrays are laid
// out as make_params documents. A `window` <= 0 means no window and a
// null `doc` no document masking. Each returns cudaGetLastError() after
// its launch, cudaErrorInvalidValue for a head dim other than 64/128,
// 10000 + the CUresult of cuTensorMapEncodeTiled for a view TMA cannot
// take, or cudaErrorNotSupported without cuTensorMapEncodeTiled.
extern "C" int owl_frame_attn_fwd(const void* const* ptr,
                                  const long long* strides, const int* ints,
                                  float scale, void* stream) {
  return run<Fwd>(frame_attn_fwd_kernel<64>, frame_attn_fwd_kernel<128>, ptr,
                  strides, ints, scale, stream, false, false);
}

extern "C" int owl_frame_attn_bwd_dq(const void* const* ptr,
                                     const long long* strides, const int* ints,
                                     float scale, void* stream) {
  return run<Dq>(frame_attn_bwd_dq_kernel<64>, frame_attn_bwd_dq_kernel<128>,
                 ptr, strides, ints, scale, stream, true, true);
}

extern "C" int owl_frame_attn_bwd_dkv(const void* const* ptr,
                                      const long long* strides,
                                      const int* ints, float scale,
                                      void* stream) {
  return run<Dkv>(frame_attn_bwd_dkv_kernel<64>, frame_attn_bwd_dkv_kernel<128>,
                  ptr, strides, ints, scale, stream, false, true);
}

// K4 entry points: the same arrays, no float; both backward kernels read
// `delta` (delta') and neither reads `o`.
extern "C" int owl_ring_attn_fwd(const void* const* ptr,
                                 const long long* strides, const int* ints,
                                 void* stream) {
  if (!ring_ok(ints, ptr)) return (int)cudaErrorInvalidValue;
  return run<Fwd>(ring_attn_fwd_kernel<64>, ring_attn_fwd_kernel<128>, ptr,
                  strides, ints, 1.f, stream, false, false);
}

extern "C" int owl_ring_attn_bwd_dq(const void* const* ptr,
                                    const long long* strides, const int* ints,
                                    void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<Dq>(ring_attn_bwd_dq_kernel<64>, ring_attn_bwd_dq_kernel<128>, ptr,
                 strides, ints, 1.f, stream, false, true);
}

extern "C" int owl_ring_attn_bwd_dkv(const void* const* ptr,
                                     const long long* strides,
                                     const int* ints, void* stream) {
  if (!ring_ok(ints, ptr) || ptr[9] == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<Dkv>(ring_attn_bwd_dkv_kernel<64>, ring_attn_bwd_dkv_kernel<128>,
                  ptr, strides, ints, 1.f, stream, false, true);
}
