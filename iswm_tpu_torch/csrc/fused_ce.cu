// Fused binary softmax cross-entropy for Hopper (sm_90a): the forward
// reduction and the backward elementwise pass.
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_ce.py
// `fused_binary_ce` (forward body `_fwd_kernel`, backward body
// `_bwd_kernel`), which the training step runs for the default binary
// ce_loss / IWce_loss (iswm_tpu/ops/losses.py `make_loss_fn`).
//
// For logits [B, 2, H, W] (a = class-0 plane, b = class-1 plane), labels
// y [B, H, W], class weights cw[2] and ignore_index:
//   logz = max(a, b) + log1p(exp(-|a - b|)),   ce = logz - (y == 1 ? b : a)
//   w    = y == ignore ? 0 : (y == 1 ? cw[1] : cw[0])
//   forward:  out = (sum w * ce, sum w)
//   backward: p1 = sigmoid(b - a), y1 = (y == 1), scale = g / w_sum
//             da = ((1 - p1) - (1 - y1)) * w * scale
//             db = (p1 - y1) * w * scale
// Any label that is neither 1 nor ignore counts as class 0.
//
// What bounds it on this card: device memory.  A pixel costs two logits
// and one label read and a few transcendental ops (plus two writes in the
// backward); at the training slice's [8, 2, 512, 512] bf16 logits the
// forward reads about 10 MB, a few microseconds at 3.35 TB/s.  The design:
//   - no padding to 128-lane rows as on the TPU: both kernels read the two
//     class planes in place through the logits' strides (NCHW-contiguous
//     or channels-last alike) and stop at the ragged end;
//   - the forward is deterministic without atomics: a fixed grid (a
//     function of the pixel count alone) writes one partial pair per block
//     into scratch, then one block sums the partials in a fixed order, so
//     the same inputs give the same bits on every launch;
//   - the backward writes d_logits directly, in its own strides and the
//     logits' dtype.
// Built without fast math: expf, log1pf and the division are the accurate
// versions, as in the plain PyTorch version.
//
// Contract (checked by the Python wrapper): logits bf16 or f32 with
// element strides (sn, sc, sh, sw); labels contiguous [B, H, W] of uint8,
// int32 or int64; cw, grad and w_sum f32 on the device; partials holds
// MAX_PARTIALS float2.  Launches are asynchronous on `stream`; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // pixels per thread that the forward grid aims at
constexpr int MAX_PARTIALS = 1024;

struct Geom {
  long long total;  // B * H * W
  long long hw, w;
  long long sn, sc, sh, sw;  // strides in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element offset of pixel i (flat over B, H, W) in the class-0 plane.
__device__ __forceinline__ long long offset(const Geom& g, long long i) {
  const long long n = i / g.hw;
  const long long p = i - n * g.hw;
  const long long h = p / g.w;
  return n * g.sn + h * g.sh + (p - h * g.w) * g.sw;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float2 block_sum(float2 v) {
  __shared__ float2 warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = make_float2(0.f, 0.f);
  if (warp == 0) {
    if (lane < THREADS / 32) v = warp_sums[lane];
    v = warp_sum(v);
  }
  return v;
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    ce_fwd_partial(const T* __restrict__ logits, const L* __restrict__ labels,
                   const float* __restrict__ cw, long long ignore, Geom g,
                   float2* __restrict__ partials) {
  const float w0 = cw[0];
  const float w1 = cw[1];
  float2 acc = make_float2(0.f, 0.f);
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < g.total; i += step) {
    const long long off = offset(g, i);
    const float a = to_f32(logits[off]);
    const float b = to_f32(logits[off + g.sc]);
    const long long y = static_cast<long long>(labels[i]);
    const bool one = y == 1;
    const float logz = fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
    const float ce = logz - (one ? b : a);
    const float w = y == ignore ? 0.f : (one ? w1 : w0);
    acc.x += ce * w;
    acc.y += w;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
    ce_fwd_final(const float2* __restrict__ partials, int n,
                 float* __restrict__ out) {
  float2 acc = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    acc.x += partials[i].x;
    acc.y += partials[i].y;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    out[0] = acc.x;
    out[1] = acc.y;
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    ce_bwd(const T* __restrict__ logits, const L* __restrict__ labels,
           const float* __restrict__ cw, const float* __restrict__ grad,
           const float* __restrict__ w_sum, long long ignore, Geom g,
           T* __restrict__ d_logits, Geom dg) {
  const float scale = grad[0] / w_sum[0];
  const float w0 = cw[0];
  const float w1 = cw[1];
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < g.total; i += step) {
    const long long off = offset(g, i);
    const float a = to_f32(logits[off]);
    const float b = to_f32(logits[off + g.sc]);
    const long long y = static_cast<long long>(labels[i]);
    const bool one = y == 1;
    const float p1 = 1.f / (1.f + expf(-(b - a)));
    const float y1 = one ? 1.f : 0.f;
    const float w = y == ignore ? 0.f : (one ? w1 : w0);
    const long long doff = offset(dg, i);
    store(d_logits + doff, ((1.f - p1) - (1.f - y1)) * w * scale);
    store(d_logits + doff + dg.sc, (p1 - y1) * w * scale);
  }
}

Geom make_geom(long long B, long long H, long long W, long long sn,
               long long sc, long long sh, long long sw) {
  return Geom{B * H * W, H * W, W, sn, sc, sh, sw};
}

}  // namespace

// T: the logits' type, L: the labels' type; the body sees both.
#define ISWM_DISPATCH_LABEL(KIND, ...)  \
  switch (KIND) {                        \
    case 0: {                            \
      using L = uint8_t;                 \
      __VA_ARGS__;                       \
    } break;                             \
    case 1: {                            \
      using L = int32_t;                 \
      __VA_ARGS__;                       \
    } break;                             \
    default: {                           \
      using L = int64_t;                 \
      __VA_ARGS__;                       \
    } break;                             \
  }
#define ISWM_DISPATCH(BF16, KIND, ...)        \
  if (BF16) {                                 \
    using T = __nv_bfloat16;                  \
    ISWM_DISPATCH_LABEL(KIND, __VA_ARGS__);   \
  } else {                                    \
    using T = float;                          \
    ISWM_DISPATCH_LABEL(KIND, __VA_ARGS__);   \
  }

extern "C" {

int iswm_fused_ce_max_partials() { return MAX_PARTIALS; }

// logits_bf16: 1 for bf16 logits, 0 for f32.  label_kind: 0 uint8,
// 1 int32, 2 int64.  out: 2 floats (sum w * ce, sum w).
int iswm_fused_ce_fwd(const void* logits, int logits_bf16, const void* labels,
                      int label_kind, const void* cw, long long ignore,
                      long long B, long long H, long long W, long long sn,
                      long long sc, long long sh, long long sw, void* partials,
                      void* out, void* stream) {
  const Geom g = make_geom(B, H, W, sn, sc, sh, sw);
  long long blocks = (g.total + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_PARTIALS) blocks = MAX_PARTIALS;
  const int nb = static_cast<int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partials);
  const float* w = static_cast<const float*>(cw);
  ISWM_DISPATCH(logits_bf16, label_kind,
                ce_fwd_partial<T, L><<<nb, THREADS, 0, s>>>(
                    static_cast<const T*>(logits),
                    static_cast<const L*>(labels), w, ignore, g, part))
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_final<<<1, THREADS, 0, s>>>(part, nb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// d_logits has the logits' dtype and its own strides (dsn, dsc, dsh, dsw).
int iswm_fused_ce_bwd(const void* logits, int logits_bf16, const void* labels,
                      int label_kind, const void* cw, const void* grad,
                      const void* w_sum, long long ignore, long long B,
                      long long H, long long W, long long sn, long long sc,
                      long long sh, long long sw, void* d_logits, long long dsn,
                      long long dsc, long long dsh, long long dsw,
                      void* stream) {
  const Geom g = make_geom(B, H, W, sn, sc, sh, sw);
  const Geom dg = make_geom(B, H, W, dsn, dsc, dsh, dsw);
  if (g.total == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (g.total + THREADS - 1) / THREADS;
  if (blocks > 65536) blocks = 65536;
  const int nb = static_cast<int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(cw);
  const float* gr = static_cast<const float*>(grad);
  const float* ws = static_cast<const float*>(w_sum);
  ISWM_DISPATCH(logits_bf16, label_kind,
                ce_bwd<T, L><<<nb, THREADS, 0, s>>>(
                    static_cast<const T*>(logits),
                    static_cast<const L*>(labels), w, gr, ws, ignore, g,
                    static_cast<T*>(d_logits), dg))
  return static_cast<int>(cudaGetLastError());
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
