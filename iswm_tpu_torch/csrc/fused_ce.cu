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
// What bounds it on this card: device memory by bytes, instruction issue in
// practice.  A pixel costs two logits and one label read (plus two writes
// in the backward) and about fifty instructions in the forward (expf and
// log1pf are forty of them), twenty-five in the backward: at the training
// slice's [8, 2, 512, 512] bf16 logits the forward reads 16.8 MB, 5 us at
// 3.35 TB/s, and issues for about 3.5 us on 132 SMs.  So nothing else may
// cost instructions per pixel (the first bodies added two 64-bit integer
// divisions a pixel forward and four backward, each a software routine of
// dozens of instructions).  The design:
//   - the wrapper picks one of three bodies from the layout before launch:
//     `channels_last` (dense strides (2HW, 1, 2W, 2): a pixel's (a, b) pair
//     is adjacent, a thread's pixels are consecutive, no index division),
//     `nchw` (contiguous, H*W a multiple of the vector: one 32-bit division
//     a vector, none within a plane), or `strided` (any view: the first
//     body, one 64-bit offset computation a pixel);
//   - the vector bodies read logits and labels, and the backward writes
//     d_logits, in 16-byte accesses (a vector: 4 bf16 or 2 f32 pixels
//     channels-last, 8 or 4 pixels of each plane NCHW), a thread's vectors
//     of a step (1, 2 or 4; 1 by default, the fastest in a sweep) loaded
//     before any math, with 32-bit indices wherever 2 * B * H * W < 2^31
//     (a 64-bit instantiation otherwise);
//   - the forward is one launch and deterministic without float atomics:
//     a grid that is a function of the pixel count and the layout alone
//     writes one partial pair a block into a workspace, and the last block
//     to take an atomic ticket sums all partials in index order with a
//     fixed tree, writes out[2] and resets the ticket; so the same inputs
//     give the same bits on every launch and every card, whichever block
//     ends last (with an acquire-release add, not __threadfence, the
//     ticket measured faster than the same sum in a second launch);
//   - the backward reads g / w_sum once a block, takes sigmoid's
//     reciprocal with __frcp_rn (correctly rounded, as the division was),
//     and keeps the first body's operations in their order: every body
//     gives the same bits.
// Built without fast math: expf, log1pf, the division and the reciprocal
// are the accurate versions, as in the plain PyTorch version.
//
// Contract (checked by the Python wrapper): logits bf16 or f32 with
// element strides (sn, sc, sh, sw); labels contiguous [B, H, W] of uint8,
// int32 or int64; cw, grad and w_sum f32 on the device; the workspace
// holds iswm_fused_ce_workspace_bytes(), zeroed before its first use and
// used by one stream at a time.  A vector layout also needs the logits,
// labels and d_logits 16-byte aligned and d_logits in the logits' strides.
// Launches are asynchronous on `stream`; each C entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // pixels per thread that the strided forward grid aims at
constexpr int MAX_PARTIALS = 1024;
constexpr int MAX_BWD_BLOCKS = 65536;
// Vectors a thread loads before its math, by default (block_bwd_ab.py
// --kind ce --sweep).
constexpr int FWD_VECTORS = 1;
constexpr int BWD_VECTORS = 1;

enum Layout { STRIDED = 0, NCHW = 1, CHANNELS_LAST = 2 };

struct Geom {
  long long total;  // B * H * W
  long long hw, w;
  long long sn, sc, sh, sw;  // strides in elements
};

struct Weights {
  float w0, w1;
  long long ignore;
};

// A label's weight, and whether it is class 1: labels of 32 bits or fewer
// are compared in 32 bits (the same outcome as in 64: an ignore_index
// outside int32 matches none of them).
template <typename L>
__device__ __forceinline__ float label_weight(L y, const Weights& k, bool& one) {
  if constexpr (sizeof(L) <= 4) {
    const int v = static_cast<int>(y);
    const bool ignored = k.ignore == static_cast<int>(k.ignore) &&
                         v == static_cast<int>(k.ignore);
    one = v == 1;
    return ignored ? 0.f : (one ? k.w1 : k.w0);
  } else {
    one = y == 1;
    return y == k.ignore ? 0.f : (one ? k.w1 : k.w0);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One pixel of the forward, added to acc = (sum w * ce, sum w).
template <typename L>
__device__ __forceinline__ void add_fwd(float a, float b, L y, const Weights& k,
                                        float2& acc) {
  bool one;
  const float w = label_weight(y, k, one);
  const float logz = fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  const float ce = logz - (one ? b : a);
  acc.x += ce * w;
  acc.y += w;
}

// One pixel of the backward: (da, db).
template <typename L>
__device__ __forceinline__ float2 bwd_pair(float a, float b, L y, const Weights& k,
                                           float scale) {
  bool one;
  const float w = label_weight(y, k, one);
  const float p1 = __frcp_rn(1.f + expf(-(b - a)));
  const float y1 = one ? 1.f : 0.f;
  return make_float2(((1.f - p1) - (1.f - y1)) * w * scale,
                     (p1 - y1) * w * scale);
}

// ------------------------------------------------------------ vector access
template <int BYTES>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
};
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<4> {
  using type = unsigned int;
};
template <>
struct Chunk<2> {
  using type = unsigned short;
};

// N values of E at p (aligned to their size up to 16 bytes) into v, in
// loads of at most 16 bytes.
template <int N, typename E>
__device__ __forceinline__ void load_vec(const E* __restrict__ p, E* v) {
  constexpr int BYTES = N * static_cast<int>(sizeof(E));
  constexpr int STEP = BYTES < 16 ? BYTES : 16;
  using C = typename Chunk<STEP>::type;
#pragma unroll
  for (int k = 0; k < BYTES / STEP; ++k) {
    const C c = __ldg(reinterpret_cast<const C*>(p) + k);
    memcpy(reinterpret_cast<char*>(v) + k * STEP, &c, STEP);
  }
}

template <int N, typename E>
__device__ __forceinline__ void store_vec(E* __restrict__ p, const E* v) {
  constexpr int BYTES = N * static_cast<int>(sizeof(E));
  constexpr int STEP = BYTES < 16 ? BYTES : 16;
  using C = typename Chunk<STEP>::type;
#pragma unroll
  for (int k = 0; k < BYTES / STEP; ++k) {
    C c;
    memcpy(&c, reinterpret_cast<const char*>(v) + k * STEP, STEP);
    reinterpret_cast<C*>(p)[k] = c;
  }
}

// A vector of a layout: PIX pixels whose logits take 16 bytes
// channels-last (a, b interleaved) or 16 bytes of each plane NCHW.
template <typename T, int LAYOUT>
struct Vec {
  static constexpr int PIX =
      LAYOUT == CHANNELS_LAST ? 16 / (2 * static_cast<int>(sizeof(T)))
                              : 16 / static_cast<int>(sizeof(T));
  // Element offset of the class-0 logit of pixel i (i a multiple of PIX
  // for NCHW, whose H * W is a multiple of PIX).
  template <typename I>
  __device__ static __forceinline__ I offset(I i, I hw) {
    return LAYOUT == CHANNELS_LAST ? 2 * i : i + (i / hw) * hw;
  }
  // raw holds a vector's logits as loaded: a of pixel k at a(k), b at b(k).
  __device__ static __forceinline__ int a(int k) {
    return LAYOUT == CHANNELS_LAST ? 2 * k : k;
  }
  __device__ static __forceinline__ int b(int k) {
    return LAYOUT == CHANNELS_LAST ? 2 * k + 1 : PIX + k;
  }
  template <typename I>
  __device__ static __forceinline__ void load(const T* __restrict__ logits, I off,
                                              I hw, T* raw) {
    if constexpr (LAYOUT == CHANNELS_LAST) {
      load_vec<2 * PIX>(logits + off, raw);
    } else {
      load_vec<PIX>(logits + off, raw);
      load_vec<PIX>(logits + off + hw, raw + PIX);
    }
  }
  template <typename I>
  __device__ static __forceinline__ void store(T* __restrict__ d, I off, I hw,
                                               const T* raw) {
    if constexpr (LAYOUT == CHANNELS_LAST) {
      store_vec<2 * PIX>(d + off, raw);
    } else {
      store_vec<PIX>(d + off, raw);
      store_vec<PIX>(d + off + hw, raw + PIX);
    }
  }
};

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

// The sum of partials[0, n) in index order by a fixed tree: thread t adds
// t, t + THREADS, ... (all loaded at once); then block_sum.  Valid in
// thread 0.
__device__ __forceinline__ float2 sum_partials(const float2* partials, int n) {
  constexpr int PER_THREAD = MAX_PARTIALS / THREADS;
  float2 p[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    // from L2: other blocks wrote them
    p[j] = i < n ? __ldcg(partials + i) : make_float2(0.f, 0.f);
  }
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    acc.x += p[j].x;
    acc.y += p[j].y;
  }
  return block_sum(acc);
}

// The ticket's old value: an add with acquire-release semantics at device
// scope, so this thread's partial is visible before it and every partial
// of the blocks before it is visible after it (a lighter fence than
// __threadfence's sequentially consistent one).
__device__ __forceinline__ unsigned int take_ticket(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// The end of every forward block: its partial into the workspace; the last
// block to take the ticket (its thread 0 acquires, the barrier passes that
// on to the block) sums them all into out and resets the ticket for the
// next launch on the stream.
__device__ __forceinline__ void finish_fwd(float2 acc, float2* partials,
                                           unsigned int* ticket, float* out) {
  acc = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    last = take_ticket(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const float2 sum = sum_partials(partials, gridDim.x);
  if (threadIdx.x == 0) {
    out[0] = sum.x;
    out[1] = sum.y;
    *ticket = 0u;
  }
}

// ------------------------------------------------------------ vector bodies
// I: uint32_t where 2 * B * H * W < 2^31, else uint64_t.  V vectors a
// thread per step of the grid-stride loop, THREADS apart so that a warp's
// accesses are consecutive.  The channels-last tail (total % PIX pixels)
// goes one pixel a thread.
template <typename T, typename L, int LAYOUT, typename I, int V>
__global__ void __launch_bounds__(THREADS)
    ce_fwd_vec(const T* __restrict__ logits, const L* __restrict__ labels,
               const float* __restrict__ cw, long long ignore, I total, I hw,
               float2* __restrict__ partials, unsigned int* ticket,
               float* __restrict__ out) {
  using Shape = Vec<T, LAYOUT>;
  constexpr int PIX = Shape::PIX;
  const Weights k{cw[0], cw[1], ignore};
  float2 acc = make_float2(0.f, 0.f);
  const I nvec = total / PIX;
  const I step = static_cast<I>(gridDim.x) * THREADS * V;
  for (I v0 = static_cast<I>(blockIdx.x) * THREADS * V + threadIdx.x; v0 < nvec;
       v0 += step) {
    T raw[V][2 * PIX];
    L y[V][PIX];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const I v = v0 + static_cast<I>(u) * THREADS;
      if (v < nvec) {
        Shape::load(logits, Shape::offset(v * PIX, hw), hw, raw[u]);
        load_vec<PIX>(labels + v * PIX, y[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (v0 + static_cast<I>(u) * THREADS < nvec) {
#pragma unroll
        for (int p = 0; p < PIX; ++p)
          add_fwd(to_f32(raw[u][Shape::a(p)]), to_f32(raw[u][Shape::b(p)]),
                  y[u][p], k, acc);
      }
    }
  }
  const I t = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (t < total - nvec * PIX) {
    const I i = nvec * PIX + t;
    const I off = 2 * i;  // only channels-last has a tail
    add_fwd(to_f32(logits[off]), to_f32(logits[off + 1]),
            labels[i], k, acc);
  }
  finish_fwd(acc, partials, ticket, out);
}

template <typename T, typename L, int LAYOUT, typename I, int V>
__global__ void __launch_bounds__(THREADS)
    ce_bwd_vec(const T* __restrict__ logits, const L* __restrict__ labels,
               const float* __restrict__ cw, const float* __restrict__ grad,
               const float* __restrict__ w_sum, long long ignore, I total, I hw,
               T* __restrict__ d_logits) {
  using Shape = Vec<T, LAYOUT>;
  constexpr int PIX = Shape::PIX;
  __shared__ float block_scale;
  if (threadIdx.x == 0) block_scale = grad[0] / w_sum[0];
  const Weights k{cw[0], cw[1], ignore};
  __syncthreads();
  const float scale = block_scale;
  const I nvec = total / PIX;
  const I step = static_cast<I>(gridDim.x) * THREADS * V;
  for (I v0 = static_cast<I>(blockIdx.x) * THREADS * V + threadIdx.x; v0 < nvec;
       v0 += step) {
    T raw[V][2 * PIX];
    L y[V][PIX];
    I off[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const I v = v0 + static_cast<I>(u) * THREADS;
      off[u] = Shape::offset(v * PIX, hw);
      if (v < nvec) {
        Shape::load(logits, off[u], hw, raw[u]);
        load_vec<PIX>(labels + v * PIX, y[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (v0 + static_cast<I>(u) * THREADS < nvec) {
        T d[2 * PIX];
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          const float2 g =
              bwd_pair(to_f32(raw[u][Shape::a(p)]), to_f32(raw[u][Shape::b(p)]),
                       y[u][p], k, scale);
          d[Shape::a(p)] = from_f32<T>(g.x);
          d[Shape::b(p)] = from_f32<T>(g.y);
        }
        Shape::store(d_logits, off[u], hw, d);
      }
    }
  }
  const I t = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (t < total - nvec * PIX) {
    const I i = nvec * PIX + t;
    const I off = 2 * i;  // only channels-last has a tail
    const float2 g = bwd_pair(to_f32(logits[off]), to_f32(logits[off + 1]),
                              labels[i], k, scale);
    d_logits[off] = from_f32<T>(g.x);
    d_logits[off + 1] = from_f32<T>(g.y);
  }
}

// ------------------------------------------------------------ strided bodies
// Any strides: one pixel a thread, its offsets from two 64-bit divisions.
__device__ __forceinline__ long long offset(const Geom& g, long long i) {
  const long long n = i / g.hw;
  const long long p = i - n * g.hw;
  const long long h = p / g.w;
  return n * g.sn + h * g.sh + (p - h * g.w) * g.sw;
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    ce_fwd_strided(const T* __restrict__ logits, const L* __restrict__ labels,
                   const float* __restrict__ cw, long long ignore, Geom g,
                   float2* __restrict__ partials, unsigned int* ticket,
                   float* __restrict__ out) {
  const Weights k{cw[0], cw[1], ignore};
  float2 acc = make_float2(0.f, 0.f);
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < g.total; i += step) {
    const long long off = offset(g, i);
    add_fwd(to_f32(logits[off]), to_f32(logits[off + g.sc]),
            labels[i], k, acc);
  }
  finish_fwd(acc, partials, ticket, out);
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    ce_bwd_strided(const T* __restrict__ logits, const L* __restrict__ labels,
                   const float* __restrict__ cw, const float* __restrict__ grad,
                   const float* __restrict__ w_sum, long long ignore, Geom g,
                   T* __restrict__ d_logits, Geom dg) {
  __shared__ float block_scale;
  if (threadIdx.x == 0) block_scale = grad[0] / w_sum[0];
  const Weights k{cw[0], cw[1], ignore};
  __syncthreads();
  const float scale = block_scale;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < g.total; i += step) {
    const long long off = offset(g, i);
    const float2 d = bwd_pair(to_f32(logits[off]), to_f32(logits[off + g.sc]),
                              labels[i], k, scale);
    const long long doff = offset(dg, i);
    d_logits[doff] = from_f32<T>(d.x);
    d_logits[doff + dg.sc] = from_f32<T>(d.y);
  }
}

Geom make_geom(long long B, long long H, long long W, long long sn,
               long long sc, long long sh, long long sw) {
  return Geom{B * H * W, H * W, W, sn, sc, sh, sw};
}

// Pixels a vector holds, for the grid.
int vector_pixels(int layout, bool bf16) {
  const int esize = bf16 ? 2 : 4;
  return layout == CHANNELS_LAST ? 16 / (2 * esize) : 16 / esize;
}

// The built-in grid: a function of the pixel count and the layout alone.
// A caller's own vectors or blocks (> 0) stand in for the defaults.
void plan(bool backward, int layout, bool bf16, long long total, int& vectors,
          int& blocks) {
  long long nb;
  if (layout == STRIDED) {
    vectors = 1;
    nb = backward ? (total + THREADS - 1) / THREADS
                  : (total + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  } else {
    if (vectors <= 0) vectors = backward ? BWD_VECTORS : FWD_VECTORS;
    const long long per_block =
        static_cast<long long>(THREADS) * vectors * vector_pixels(layout, bf16);
    nb = (total + per_block - 1) / per_block;
  }
  if (blocks > 0) nb = blocks;
  const long long cap = backward ? MAX_BWD_BLOCKS : MAX_PARTIALS;
  blocks = static_cast<int>(nb < 1 ? 1 : nb > cap ? cap : nb);
}

// What a vector body assumes of its call (the wrapper's layout choice).
bool vector_call_ok(int layout, bool bf16, long long total, long long hw,
                    int index64, const void* a, const void* b, const void* c) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return (layout == NCHW || layout == CHANNELS_LAST) && aligned(a) &&
         aligned(b) && aligned(c) &&
         (layout == CHANNELS_LAST || hw % vector_pixels(layout, bf16) == 0) &&
         (index64 || 2 * total < (1LL << 31));
}

struct Workspace {
  float2* partials;
  unsigned int* ticket;
};

Workspace split(void* workspace) {
  float2* partials = static_cast<float2*>(workspace);
  return {partials, reinterpret_cast<unsigned int*>(partials + MAX_PARTIALS)};
}

template <int V>
using Vectors = std::integral_constant<int, V>;

// go(Vectors<V>{}) for the caller's vectors a thread: 1, 2 or 4 with 32-bit
// indices, the default alone with 64-bit ones.
template <typename I, int DEFAULT, typename Go>
cudaError_t with_vectors(int vectors, Go go) {
  if constexpr (sizeof(I) == 8) {
    return vectors == DEFAULT ? go(Vectors<DEFAULT>{}) : cudaErrorInvalidValue;
  } else {
    switch (vectors) {
      case 1:
        return go(Vectors<1>{});
      case 2:
        return go(Vectors<2>{});
      case 4:
        return go(Vectors<4>{});
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename T, typename L, int LAYOUT, typename I>
cudaError_t launch_fwd_vec(int vectors, int blocks, cudaStream_t s,
                           const void* logits, const void* labels,
                           const float* cw, long long ignore, long long total,
                           long long hw, Workspace ws, float* out) {
  return with_vectors<I, FWD_VECTORS>(vectors, [&](auto v) {
    ce_fwd_vec<T, L, LAYOUT, I, decltype(v)::value><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels), cw, ignore,
        static_cast<I>(total), static_cast<I>(hw), ws.partials, ws.ticket, out);
    return cudaGetLastError();
  });
}

template <typename T, typename L, int LAYOUT, typename I>
cudaError_t launch_bwd_vec(int vectors, int blocks, cudaStream_t s,
                           const void* logits, const void* labels,
                           const float* cw, const float* grad,
                           const float* w_sum, long long ignore,
                           long long total, long long hw, void* d_logits) {
  return with_vectors<I, BWD_VECTORS>(vectors, [&](auto v) {
    ce_bwd_vec<T, L, LAYOUT, I, decltype(v)::value><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels), cw, grad,
        w_sum, ignore, static_cast<I>(total), static_cast<I>(hw),
        static_cast<T*>(d_logits));
    return cudaGetLastError();
  });
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
// ... and the vector layout and index type.
#define ISWM_DISPATCH_VEC(LAYOUT_, INDEX64, ...)   \
  if ((LAYOUT_) == CHANNELS_LAST) {                \
    constexpr int LAYOUT = CHANNELS_LAST;          \
    if (INDEX64) {                                 \
      using I = uint64_t;                          \
      __VA_ARGS__;                                 \
    } else {                                       \
      using I = uint32_t;                          \
      __VA_ARGS__;                                 \
    }                                              \
  } else {                                         \
    constexpr int LAYOUT = NCHW;                   \
    if (INDEX64) {                                 \
      using I = uint64_t;                          \
      __VA_ARGS__;                                 \
    } else {                                       \
      using I = uint32_t;                          \
      __VA_ARGS__;                                 \
    }                                              \
  }

extern "C" {

int iswm_fused_ce_workspace_bytes() {
  return MAX_PARTIALS * static_cast<int>(sizeof(float2)) + 16;
}

// The built-in (vectors a thread, blocks) of a call: backward 0 or 1,
// layout 0 strided, 1 nchw, 2 channels_last.
void iswm_fused_ce_plan(int backward, int layout, int logits_bf16,
                        long long pixels, int* vectors_blocks) {
  int vectors = 0, blocks = 0;
  plan(backward != 0, layout, logits_bf16 != 0, pixels, vectors, blocks);
  vectors_blocks[0] = vectors;
  vectors_blocks[1] = blocks;
}

// logits_bf16: 1 for bf16 logits, 0 for f32.  label_kind: 0 uint8,
// 1 int32, 2 int64.  layout: 0 strided, 1 nchw, 2 channels_last (the
// wrapper's choice); index64: 64-bit indices in a vector body.  vectors,
// blocks: 0 for the built-in plan.  out: 2 floats (sum w * ce, sum w).
int iswm_fused_ce_fwd(const void* logits, int logits_bf16, const void* labels,
                      int label_kind, const void* cw, long long ignore,
                      long long B, long long H, long long W, long long sn,
                      long long sc, long long sh, long long sw, int layout,
                      int index64, int vectors, int blocks, void* workspace,
                      void* out, void* stream) {
  const Geom g = make_geom(B, H, W, sn, sc, sh, sw);
  plan(false, layout, logits_bf16 != 0, g.total, vectors, blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace ws = split(workspace);
  const float* w = static_cast<const float*>(cw);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (layout == STRIDED) {
    ISWM_DISPATCH(logits_bf16, label_kind,
                  ce_fwd_strided<T, L><<<blocks, THREADS, 0, s>>>(
                      static_cast<const T*>(logits),
                      static_cast<const L*>(labels), w, ignore, g,
                      ws.partials, ws.ticket, o))
    err = cudaGetLastError();
  } else if (!vector_call_ok(layout, logits_bf16 != 0, g.total, g.hw, index64,
                             logits, labels, logits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    ISWM_DISPATCH(logits_bf16, label_kind,
                  ISWM_DISPATCH_VEC(layout, index64,
                                    err = (launch_fwd_vec<T, L, LAYOUT, I>(
                                        vectors, blocks, s, logits, labels, w,
                                        ignore, g.total, g.hw, ws, o))))
  }
  return static_cast<int>(err);
}

// d_logits has the logits' dtype and its own strides (dsn, dsc, dsh, dsw),
// the logits' own in a vector layout.
int iswm_fused_ce_bwd(const void* logits, int logits_bf16, const void* labels,
                      int label_kind, const void* cw, const void* grad,
                      const void* w_sum, long long ignore, long long B,
                      long long H, long long W, long long sn, long long sc,
                      long long sh, long long sw, void* d_logits, long long dsn,
                      long long dsc, long long dsh, long long dsw, int layout,
                      int index64, int vectors, int blocks, void* stream) {
  const Geom g = make_geom(B, H, W, sn, sc, sh, sw);
  const Geom dg = make_geom(B, H, W, dsn, dsc, dsh, dsw);
  if (g.total == 0) return static_cast<int>(cudaGetLastError());
  plan(true, layout, logits_bf16 != 0, g.total, vectors, blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(cw);
  const float* gr = static_cast<const float*>(grad);
  const float* wsum = static_cast<const float*>(w_sum);
  cudaError_t err = cudaSuccess;
  if (layout == STRIDED) {
    ISWM_DISPATCH(logits_bf16, label_kind,
                  ce_bwd_strided<T, L><<<blocks, THREADS, 0, s>>>(
                      static_cast<const T*>(logits),
                      static_cast<const L*>(labels), w, gr, wsum, ignore, g,
                      static_cast<T*>(d_logits), dg))
    err = cudaGetLastError();
  } else if (!vector_call_ok(layout, logits_bf16 != 0, g.total, g.hw, index64,
                             logits, labels, d_logits) ||
             dsn != sn || dsc != sc || dsh != sh || dsw != sw) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    ISWM_DISPATCH(logits_bf16, label_kind,
                  ISWM_DISPATCH_VEC(layout, index64,
                                    err = (launch_bwd_vec<T, L, LAYOUT, I>(
                                        vectors, blocks, s, logits, labels, w,
                                        gr, wsum, ignore, g.total, g.hw,
                                        d_logits))))
  }
  return static_cast<int>(err);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
