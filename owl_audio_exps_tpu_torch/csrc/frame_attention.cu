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
//     < window; the ragged tail masked per element).
// The two gradient kernels write disjoint outputs and use no atomics, so
// the backward is deterministic; dkv runs after dq on the same stream.
//
// With documents (doc_id given) each of the three runs its kDoc body, on
// the per-tile summary that the helper kernel below (owl_doc_tiles)
// writes on the card first, with no host read of the ids: a block skips
// the tiles whose ids cannot meet its own, runs a tile of one document,
// the same on both sides, unmasked when the frame mask calls it full,
// clips its range to its documents' runs where a row's ids never
// decrease, and takes its tile from the summary's order by work. The
// TPU's splash does none of this: it reads its SegmentIds per element in
// every block the frame mask leaves (ops/splash.py:279-295), which the
// port's first kernel copied, and which left the document rows at 7-14%
// of their bound (PERF.md section 6).
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

// K1's blocks with documents: the walk after each body's barriers
template <int D>
using FwdDoc = WithDoc<Fwd>::Of<D>;
template <int D>
using DqDoc = WithDoc<Dq>::Of<D>;
template <int D>
using DkvDoc = WithDoc<Dkv>::Of<D>;

template <int D, bool kDoc>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    frame_attn_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  const int b = blockIdx.y / p.H;
  fwd_block<D, kDoc>(maps, p, b, blockIdx.y % p.H,
                     kDoc ? doc_tile_of(p, b, false)
                          : query_tile(p, Fwd<D>::kBM));
}

template <int D, bool kDoc>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    frame_attn_bwd_dq_kernel(const __grid_constant__ Maps maps,
                             const Params p) {
  const int b = blockIdx.y / p.H;
  dq_block<D, false, false, kDoc>(maps, p, b, blockIdx.y % p.H,
                                  kDoc ? doc_tile_of(p, b, false)
                                       : query_tile(p, Dq<D>::kBM));
}

template <int D, bool kDoc>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1)
    frame_attn_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                              const Params p) {
  const int b = blockIdx.y / p.H;
  dkv_block<D, false, kDoc>(maps, p, b, blockIdx.y % p.H,
                            kDoc ? doc_tile_of(p, b, true)
                                 : blockIdx.x * Dkv<D>::kBM);
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

// K1 with documents needs their summary and an L its walks hold.
bool doc_ok(const int* ints, const void* const* ptr) {
  return ptr[11] != nullptr && ints[2] <= kDocMaxL;
}

// K1's three kernels: the kDoc bodies when `doc` is given.
template <template <int> class Cfg, template <int> class CfgDoc, typename K64,
          typename K128, typename D64, typename D128>
int run_k1(K64 k64, K128 k128, D64 d64, D128 d128, const void* const* ptr,
           const long long* st, const int* ints, float scale, void* stream,
           bool with_o, bool with_dout) {
  const Params p = make_params(ptr, st, ints, scale, INFINITY);
  if (ptr[10] == nullptr)
    return run<Cfg>(k64, k128, p, ptr, st, ints, stream, with_o, with_dout);
  if (!doc_ok(ints, ptr)) return (int)cudaErrorInvalidValue;
  return run<CfgDoc>(d64, d128, p, ptr, st, ints, stream, with_o, with_dout);
}

// ------------------------------------------------ the document summary

__device__ int lower_bound(const int* a, int n, int x) {  // first a[i] >= x
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) / 2;
    if (a[m] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

__device__ int upper_bound(const int* a, int n, int x) {  // first a[i] > x
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) / 2;
    if (a[m] <= x) lo = m + 1; else hi = m;
  }
  return lo;
}

constexpr int kDocThreads = 1024;

// The summary of one batch row's per-frame ids (doc [B, n_frames] int32),
// laid out as hopper_attention.cuh's section "documents" says, into
// p.dsum; a block per row. Replaces no TPU kernel: the TPU's splash builds
// its block masks on the host from the frame mask alone and compares the
// SegmentIds per element. Bound by latency (a few dependent loads a frame
// and an O(n128^2) ranking; ~30 KB moved at L 98,304).
__global__ void __launch_bounds__(kDocThreads)
    doc_tiles_kernel(const int* __restrict__ doc, int* row_out,
                     const Params p) {
  extern __shared__ int work[];  // [2][n128]: query side, key side
  const int nf = p.n_frames, T = blockDim.x;
  const int* d = doc + (long long)blockIdx.x * nf;
  int* row = row_out + (long long)blockIdx.x * p.dsum_row;
  int ok = 1;
  for (int f = threadIdx.x; f + 1 < nf; f += T) ok &= d[f] <= d[f + 1];
  const bool mono = __syncthreads_and(ok);

  int2* runs = reinterpret_cast<int2*>(row + 4 * p.n64);
  for (int f = threadIdx.x; f < nf; f += T)
    runs[f] = mono ? make_int2(lower_bound(d, nf, d[f]),
                               upper_bound(d, nf, d[f]) - 1)
                   : make_int2(0, nf - 1);
  int4* tiles = reinterpret_cast<int4*>(row);
  for (int t = threadIdx.x; t < p.n64; t += T) {
    const int fa = 64 * t / p.tpf, fz = (min(64 * t + 64, p.L) - 1) / p.tpf;
    int lo = d[fa], hi = d[fa];
    for (int f = fa + 1; f <= fz; ++f) {
      lo = min(lo, d[f]);
      hi = max(hi, d[f]);
    }
    tiles[t] = mono ? make_int4(lo, hi, lower_bound(d, nf, lo),
                                upper_bound(d, nf, hi) - 1)
                    : make_int4(lo, hi, 0, nf - 1);
  }
  __syncthreads();

  // work: the length of each 128-row tile's clipped range
  int* wq = work;
  int* wk = work + p.n128;
  for (int t = threadIdx.x; t < p.n128; t += T) {
    const DocSpan s = doc_span(row, p.n64, t * kRows, kRows);
    int begin, end;
    kv_range_doc(p, s, t * kRows, kRows, 1, begin, end);
    wq[t] = end - begin;
    q_range_doc(p, s, t * kRows, kRows, 1, begin, end);
    wk[t] = end - begin;
  }
  __syncthreads();
  // the order: by decreasing work, ties by tile
  int* order_q = row + 4 * p.n64 + 2 * nf;
  int* order_k = order_q + p.n128;
  for (int t = threadIdx.x; t < p.n128; t += T) {
    int rq = 0, rk = 0;
    for (int u = 0; u < p.n128; ++u) {
      rq += wq[u] > wq[t] || (wq[u] == wq[t] && u < t);
      rk += wk[u] > wk[t] || (wk[u] == wk[t] && u < t);
    }
    order_q[rq] = t;
    order_k[rk] = t;
  }
  for (int i = 4 * p.n64 + 2 * nf + 2 * p.n128 + threadIdx.x; i < p.dsum_row;
       i += T)
    row[i] = i == 4 * p.n64 + 2 * nf + 2 * p.n128 ? (int)mono : 0;
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
  return run_k1<Fwd, FwdDoc>(
      frame_attn_fwd_kernel<64, false>, frame_attn_fwd_kernel<128, false>,
      frame_attn_fwd_kernel<64, true>, frame_attn_fwd_kernel<128, true>, ptr,
      strides, ints, scale, stream, false, false);
}

extern "C" int owl_frame_attn_bwd_dq(const void* const* ptr,
                                     const long long* strides, const int* ints,
                                     float scale, void* stream) {
  return run_k1<Dq, DqDoc>(frame_attn_bwd_dq_kernel<64, false>,
                           frame_attn_bwd_dq_kernel<128, false>,
                           frame_attn_bwd_dq_kernel<64, true>,
                           frame_attn_bwd_dq_kernel<128, true>, ptr, strides,
                           ints, scale, stream, true, true);
}

extern "C" int owl_frame_attn_bwd_dkv(const void* const* ptr,
                                      const long long* strides,
                                      const int* ints, float scale,
                                      void* stream) {
  return run_k1<Dkv, DkvDoc>(frame_attn_bwd_dkv_kernel<64, false>,
                             frame_attn_bwd_dkv_kernel<128, false>,
                             frame_attn_bwd_dkv_kernel<64, true>,
                             frame_attn_bwd_dkv_kernel<128, true>, ptr,
                             strides, ints, scale, stream, false, true);
}

// The document summary of K1's kDoc bodies: doc (ptr[0], int32 [B,
// n_frames]) into out (ptr[1], int32 [B, doc_row_len(L, tpf)]); ints are
// (B, L, tpf, window, causal) with window <= 0 for none. Returns the CUDA
// error of the launch, or cudaErrorInvalidValue for L past kDocMaxL.
extern "C" int owl_doc_tiles(const void* const* ptr, const int* ints,
                             void* stream) {
  const int B = ints[0], L = ints[1];
  if (B < 1 || L < 1 || L > kDocMaxL || ints[2] < 1)
    return (int)cudaErrorInvalidValue;
  const int in[7] = {B, 1, L, 64, ints[2], ints[3], ints[4]};
  const void* none[12] = {};
  none[11] = ptr[1];
  const long long st[24] = {};
  const Params p = make_params(none, st, in, 1.f, INFINITY);
  const size_t smem = 2 * sizeof(int) * p.n128;
  // on out's device, the caller's restored after (as run does)
  cudaPointerAttributes attr;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaPointerGetAttributes(&attr, ptr[1]);
  if (e == cudaSuccess) e = cudaSetDevice(attr.device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(doc_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  doc_tiles_kernel<<<B, kDocThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr[0]),
      static_cast<int*>(const_cast<void*>(ptr[1])), p);
  e = cudaGetLastError();
  const cudaError_t back =
      prev != attr.device ? cudaSetDevice(prev) : cudaSuccess;
  return (int)(e != cudaSuccess ? e : back);
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
