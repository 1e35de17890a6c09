// Fused bottleneck convs for Hopper (sm_90a): a 1x1 or 3x3 / stride 1 / pad 1
// conv that applies the previous BatchNorm + ReLU to its input on the way in
// (the "prologue"), emits the BatchNorm statistics of its own output in the
// same pass, and whose backward fuses the statistics' cotangents, the ReLU
// mask, the data gradient, the prologue's gradients and the weight gradient.
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_block.py:
//   matmul_bn_stats forward   (`_mm_fwd_kernel`)  -> conv_fwd<T, 1, *>
//   matmul_bn_stats backward  (`_mm_bwd_kernel`)  -> bf16: dgrad_1x1_bf16 + wgrad_1x1_bf16
//                                                  (pipelined, below the first version's kernels);
//                                                  f32: conv_dgrad<f32, 1, *> + conv_wgrad<f32, 1, *>
//   conv3x3_bn_stats forward  (`_c3_fwd_kernel`)  -> conv_fwd<T, 9, true>
//   conv3x3_bn_stats backward (`_c3_bwd_kernel`)  -> conv_dgrad<T, 9, true> + conv_wgrad<T, 9, true>
// each followed by sum_partials where it reduces over blocks.
//
// With x [M, C] the rows of an NHWC activation (M = B * H * W pixels), the
// folded affine a, b [C] f32, T the compute type (bf16 or f32), rd() rounding
// to T, and off(tap) = (tap / 3 - 1, tap % 3 - 1) (0 for the 1x1):
//   z      = prologue ? rd(relu(x * a + b)) : x        (0 outside the image:
//            the padding is applied AFTER the prologue)
//   y[p]   = rd(sum_tap z[p + off(tap)] @ w[tap])      [M, N]
//   s, q   = sum_p y, sum_p y^2 in f32 over the ROUNDED y
// and, given dy [M, N] and ds, dq [N] f32:
//   dyt    = rd(dy + ds + 2 * y * dq)                  (formed in f32)
//   dz[p]  = sum_tap dyt[p - off(tap)] @ w[tap]^T      (f32)
//   dzm    = dz where the prologue's ReLU passed (1x1: x * a + b > 0 in f32;
//            3x3: the rounded z > 0), else 0;  without prologue dzm = dz
//   dx     = rd(dzm * a),  da = sum_p dzm * x,  db = sum_p dzm
//   dw[tap] = sum_p z[p + off(tap)]^T @ dyt[p]         [taps * C, N] f32
// Neither z nor dyt nor an unrounded dz is ever written to device memory:
// the two backward kernels each recompute what they need from x, y and dy.
//
// What bounds it on this card: at the training slice's shapes (ResNet-50 at
// batch 8, 512^2) the 1x1 convs up to 1024 output channels are bound by
// device memory, the widest 1x1 and every 3x3 by the tensor cores.  Two
// designs live here.
//
// The bf16 1x1 backward (#7b, the main path's largest share) is pipelined:
// cp.async stages, dyt and z formed in shared memory, ldmatrix fragments,
// 128-wide data-gradient tiles and a weight-gradient split that keeps its
// partials small; its own note stands above dgrad_1x1_bf16.
//
// Everything else (conv_fwd for #7a and #8a, the nine-tap backward #8b, and
// every float32 instantiation) runs the first version's body, which is
// simple and exact in its rounding points, not fast:
//   - every kernel is one tiled GEMM, 128 x 64 outputs a block, 8 warps of
//     32 x 32, a 32-deep step through shared memory; what differs is how the
//     two operand tiles are produced ("loaders") and what happens to the
//     accumulators ("epilogue").  The 3x3 is an implicit GEMM over (tap,
//     channel): a loader gathers the shifted pixel and writes zeros outside
//     the image, so there is no halo buffer and any H, W works;
//   - bf16 runs `mma.sync.aligned.m16n8k16` with f32 accumulators (inline
//     PTX; no copy is in flight during the math, and wgmma and TMA are for
//     the versions that make it fast); f32 runs FMAs on the same
//     accumulator layout, so the loaders and epilogues are shared;
//   - loaders move 8 neighbouring channels a thread (16 bytes in bf16) and
//     apply the prologue, or form dyt, in registers on the way to shared
//     memory.  The weight gradient reduces over pixels, so its loaders write
//     the tiles transposed;
//   - the TPU kernels add s, q, da, db and dw into one block across a
//     sequential grid.  Here every block writes its partial in a fixed place
//     and sum_partials adds them in block order: no float atomics, so two
//     launches give the same bits.  The weight gradient splits the pixels
//     over as many blocks as fill the card (a function of the shape alone);
//   - the affine and dyt use separate IEEE multiplies and adds (no FMA
//     contraction), so z, the mask and dyt equal the plain PyTorch version's
//     bit for bit, and the kernels differ from it by summation order only.
// Built without fast math.
//
// Contract (checked by the Python wrapper): C % 8 == 0, N % 8 == 0; every
// activation dense, row-major, 16-byte aligned, of type T; the weight given
// in the two layouts the kernels read, [N][taps * C] for the forward and
// [C][taps * N] for the data gradient, in T; vectors f32 on the device;
// scratch as iswm_fb_sums_scratch and iswm_fb_wgrad_splits size it; M < 2^31
// (pixels are indexed with 32 bits, element offsets with 64).  Launches are
// asynchronous on `stream`; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows of a block
constexpr int BN = 64;   // output columns of a block
constexpr int BK = 32;   // reduction depth of one step
constexpr int THREADS = 256;
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int WM = BM / WARPS_M;  // 32
constexpr int WN = BN / WARPS_N;  // 32
constexpr int MF = WM / 16;       // m16 fragments of a warp
constexpr int NF = WN / 8;        // n8 fragments of a warp
constexpr int G = 8;              // neighbouring channels a thread moves
constexpr int WGRAD_BLOCKS = 264; // blocks the weight gradient aims for (2 an SM)
constexpr int MAX_SPLITS = 1024;

static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
static_assert(BK % 16 == 0 && BK % G == 0, "whole mma steps and chunks");

// Row pitch of a shared tile: 80 bytes in bf16 and 144 in f32, so that the
// fragment loads of a warp hit 32 different banks.
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int LD = BK + 8; };
template <> struct Tile<float> { static constexpr int LD = BK + 4; };

struct Geo {
  int H, W;  // the image (unused by the 1x1)
  int M;     // pixels, B * H * W
};

// The pixel (dy, dx) away from pixel p, or -1 outside the image.
__device__ __forceinline__ int shifted(const Geo& g, int p, int dy, int dx) {
  const int w = p % g.W;
  const int h = (p / g.W) % g.H;
  const int hh = h + dy, ww = w + dx;
  if (hh < 0 || hh >= g.H || ww < 0 || ww >= g.W) return -1;
  return p + dy * g.W + dx;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[G]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[G]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void zero8(float (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = 0.f;
}
// Eight values rounded to T into 16-byte aligned memory.
__device__ __forceinline__ void store8(float* p, const float (&v)[G]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[G]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Two neighbouring values (an even column) rounded to T.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// v rounded to T and back: what a stored value would hold.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x * a + b with a separate multiply and add, as the plain version.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// ------------------------------------------------------------------ loaders

// A row-major matrix [rows][depth] of T (a weight in the layout its kernel
// reads): ROWS x BK of it into shared memory, zeros past its edges.
template <typename T, int ROWS>
struct MatrixLoader {
  const T* p;
  int rows, depth;

  __device__ __forceinline__ void load(T* S, int r0, int k0, int k_end) const {
    constexpr int LD = Tile<T>::LD;
    for (int v = threadIdx.x; v < ROWS * (BK / G); v += THREADS) {
      const int r = v / (BK / G);
      const int kc = (v % (BK / G)) * G;
      float f[G];
      if (r0 + r < rows && k0 + kc < k_end) {
        load8(p + static_cast<size_t>(r0 + r) * depth + k0 + kc, f);
      } else {
        zero8(f);
      }
      store8(S + r * LD + kc, f);
    }
  }
};

// z, the conv's input after the optional prologue, gathered per tap.
template <typename T, int TAPS, bool PROLOGUE>
struct ActLoader {
  const T* x;
  const float* a;
  const float* b;
  Geo g;
  int C;

  // channels c..c+7 of z at pixel p + off(tap); zeros outside the image
  __device__ __forceinline__ void fetch(int p, int tap, int c, float (&f)[G]) const {
    int src = p;
    if constexpr (TAPS == 9) src = shifted(g, p, tap / 3 - 1, tap % 3 - 1);
    if (src < 0) {
      zero8(f);
      return;
    }
    load8(x + static_cast<size_t>(src) * C + c, f);
    if constexpr (PROLOGUE) {
      float sa[G], sb[G];
      load8(a + c, sa);
      load8(b + c, sb);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        f[i] = round_to<T>(fmaxf(affine(f[i], sa[i], sb[i]), 0.f));
      }
    }
  }

  // rows: pixels m0.., columns: (tap, channel) k0..  (forward's A)
  __device__ __forceinline__ void load(T* S, int m0, int k0, int k_end) const {
    constexpr int LD = Tile<T>::LD;
    for (int v = threadIdx.x; v < BM * (BK / G); v += THREADS) {
      const int r = v / (BK / G);
      const int kc = (v % (BK / G)) * G;
      const int p = m0 + r, kk = k0 + kc;
      float f[G];
      if (p < g.M && kk < k_end) {
        fetch(p, kk / C, kk % C, f);
      } else {
        zero8(f);
      }
      store8(S + r * LD + kc, f);
    }
  }

  // rows: (tap, channel) r0.., columns: pixels k0..  (weight gradient's A);
  // a warp takes 32 pixels of one channel group, so its transposed stores
  // fall into neighbouring shared-memory words
  __device__ __forceinline__ void load_t(T* S, int r0, int k0, int k_end) const {
    constexpr int LD = Tile<T>::LD;
    for (int v = threadIdx.x; v < (BM / G) * BK; v += THREADS) {
      const int pc = v % BK;
      const int rc = (v / BK) * G;
      const int p = k0 + pc, rr = r0 + rc;
      float f[G];
      if (rr < TAPS * C && p < k_end) {
        fetch(p, rr / C, rr % C, f);
      } else {
        zero8(f);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) store1(S + (rc + i) * LD + pc, f[i]);
    }
  }
};

// dyt = rd(dy + ds + 2 * y * dq), the total cotangent of the conv's output.
template <typename T, int TAPS>
struct GradLoader {
  const T* dy;
  const T* y;
  const float* ds;
  const float* dq;
  Geo g;
  int N;

  __device__ __forceinline__ void fetch(int src, int n, float (&f)[G]) const {
    float d[G], yy[G], s[G], q[G];
    const size_t at = static_cast<size_t>(src) * N + n;
    load8(dy + at, d);
    load8(y + at, yy);
    load8(ds + n, s);
    load8(dq + n, q);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      f[i] = round_to<T>(__fadd_rn(__fadd_rn(d[i], s[i]),
                                   __fmul_rn(__fmul_rn(2.f, yy[i]), q[i])));
    }
  }

  // rows: pixels m0.., columns: (tap, output channel) k0.., each tap read at
  // pixel p - off(tap)  (data gradient's A)
  __device__ __forceinline__ void load(T* S, int m0, int k0, int k_end) const {
    constexpr int LD = Tile<T>::LD;
    for (int v = threadIdx.x; v < BM * (BK / G); v += THREADS) {
      const int r = v / (BK / G);
      const int kc = (v % (BK / G)) * G;
      const int p = m0 + r, kk = k0 + kc;
      float f[G];
      int src = -1;
      if (p < g.M && kk < k_end) {
        src = p;
        if constexpr (TAPS == 9) {
          const int tap = kk / N;
          src = shifted(g, p, 1 - tap / 3, 1 - tap % 3);
        }
      }
      if (src >= 0) {
        fetch(src, kk % N, f);
      } else {
        zero8(f);
      }
      store8(S + r * LD + kc, f);
    }
  }

  // rows: output channels n0.., columns: pixels k0..  (weight gradient's B)
  __device__ __forceinline__ void load_t(T* S, int n0, int k0, int k_end) const {
    constexpr int LD = Tile<T>::LD;
    for (int v = threadIdx.x; v < (BN / G) * BK; v += THREADS) {
      const int pc = v % BK;
      const int nc = (v / BK) * G;
      const int p = k0 + pc, n = n0 + nc;
      float f[G];
      if (n < N && p < k_end) {
        fetch(p, n, f);
      } else {
        zero8(f);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) store1(S + (nc + i) * LD + pc, f[i]);
    }
  }
};

// ------------------------------------------------------------ the tile product

// Where this thread's accumulators lie in the block's 128 x 64 tile:
// acc[i][j][2 * h + e] is row wm0 + 16 i + g + 8 h, column wn0 + 8 j + 2 t + e.
struct Lane {
  int wm0, wn0, g, t;
  __device__ __forceinline__ Lane() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm0 = (warp / WARPS_N) * WM;
    wn0 = (warp % WARPS_N) * WN;
    g = lane >> 2;
    t = lane & 3;
  }
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += As (rows x BK) . Bs (columns x BK)^T on the tensor cores.
__device__ __forceinline__ void tile_product(float (&acc)[MF][NF][4],
                                             const __nv_bfloat16* As,
                                             const __nv_bfloat16* Bs,
                                             const Lane& ln) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MF][4];
    uint32_t b[NF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      const __nv_bfloat16* p = As + (ln.wm0 + i * 16 + ln.g) * LD + kk + ln.t * 2;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const __nv_bfloat16* p = Bs + (ln.wn0 + j * 8 + ln.g) * LD + kk + ln.t * 2;
      b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

// The same in full float32 with FMAs, on the same accumulator layout.
__device__ __forceinline__ void tile_product(float (&acc)[MF][NF][4],
                                             const float* As, const float* Bs,
                                             const Lane& ln) {
  constexpr int LD = Tile<float>::LD;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[MF][2], bv[NF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[i][h] = As[(ln.wm0 + i * 16 + ln.g + 8 * h) * LD + k];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bv[j][e] = Bs[(ln.wn0 + j * 8 + ln.t * 2 + e) * LD + k];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[i][j][2 * h + e] = fmaf(av[i][h], bv[j][e], acc[i][j][2 * h + e]);
  }
}

__device__ __forceinline__ void clear(float (&acc)[MF][NF][4]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// Two per-column sums of the block's tile, each thread holding those of its
// own rows: added over the warp's 8 row groups (shuffles), then over the 4
// warps along the rows in a fixed order.  out_u[c], out_v[c] for columns
// n0 + 0..63 below `width`.
__device__ __forceinline__ void block_column_sums(float (&u)[NF][2], float (&v)[NF][2],
                                                  const Lane& ln, float* out_u,
                                                  float* out_v, int n0, int width) {
  __shared__ float red[2][WARPS_M][BN];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        u[j][e] += __shfl_xor_sync(0xffffffffu, u[j][e], off);
        v[j][e] += __shfl_xor_sync(0xffffffffu, v[j][e], off);
      }
  if (ln.g == 0) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ln.wn0 + j * 8 + ln.t * 2 + e;
        red[0][ln.wm0 / WM][col] = u[j][e];
        red[1][ln.wm0 / WM][col] = v[j][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < width) {
    float su = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_M; ++w) {
      su += red[0][w][threadIdx.x];
      sv += red[1][w][threadIdx.x];
    }
    out_u[n0 + threadIdx.x] = su;
    out_v[n0 + threadIdx.x] = sv;
  }
}

// out[c] = sum over parts of partials[part][c] in a fixed order: 32 columns a
// block, 8 threads a column that each add every eighth part, then one of them
// adds the eight.
constexpr int FIN_COLS = 32;
constexpr int FIN_LANES = THREADS / FIN_COLS;

__global__ void __launch_bounds__(THREADS)
    sum_partials(const float* __restrict__ partials, int parts, int width,
                 float* __restrict__ out) {
  __shared__ float red[FIN_LANES][FIN_COLS];
  const int col = threadIdx.x % FIN_COLS;
  const int lane = threadIdx.x / FIN_COLS;
  const int c = blockIdx.x * FIN_COLS + col;
  float s = 0.f;
  if (c < width) {
    for (int b = lane; b < parts; b += FIN_LANES) {
      s += partials[static_cast<size_t>(b) * width + c];
    }
  }
  red[lane][col] = s;
  __syncthreads();
  if (lane == 0 && c < width) {
    float t = 0.f;
    for (int l = 0; l < FIN_LANES; ++l) t += red[l][col];
    out[c] = t;
  }
}

// ------------------------------------------------------------------ forward

// y = rd(z (*) w) and, per block of 128 pixels, the column sums of y and y^2
// into partials[m tile][2][N].  Blocks walk the N tiles fastest, so those
// that share a pixel tile run together and find it in L2.
template <typename T, int TAPS, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
    conv_fwd(ActLoader<T, TAPS, PROLOGUE> A, MatrixLoader<T, BN> Bw,
             T* __restrict__ y, float* __restrict__ partials, int N) {
  __shared__ __align__(16) T As[BM * Tile<T>::LD];
  __shared__ __align__(16) T Bs[BN * Tile<T>::LD];
  const int n_tiles = (N + BN - 1) / BN;
  const int mt = blockIdx.x / n_tiles;
  const int m0 = mt * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int depth = TAPS * A.C;
  const Lane ln;

  float acc[MF][NF][4];
  clear(acc);
  for (int k0 = 0; k0 < depth; k0 += BK) {
    A.load(As, m0, k0, depth);
    Bw.load(Bs, n0, k0, depth);
    __syncthreads();
    tile_product(acc, As, Bs, ln);
    __syncthreads();
  }

  // rows past M and columns past N hold zeros: they add nothing to the sums
  float cs[NF][2], cq[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
    const int col = n0 + ln.wn0 + j * 8 + ln.t * 2;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + ln.wm0 + i * 16 + ln.g + 8 * h;
        const float v0 = round_to<T>(acc[i][j][2 * h]);
        const float v1 = round_to<T>(acc[i][j][2 * h + 1]);
        if (row < A.g.M && col < N) {
          store2(y + static_cast<size_t>(row) * N + col, v0, v1);
        }
        cs[j][0] += v0;
        cs[j][1] += v1;
        cq[j][0] += v0 * v0;
        cq[j][1] += v1 * v1;
      }
  }
  float* part = partials + static_cast<size_t>(mt) * 2 * N;
  block_column_sums(cs, cq, ln, part, part + N, n0, N);
}

// ------------------------------------------------- backward: data gradient

// dx = rd(mask(dyt (*) w^T) * a) and, per block of 128 pixels, the column
// sums of dzm * x (da) and dzm (db) into partials[m tile][2][C].
template <typename T, int TAPS, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
    conv_dgrad(GradLoader<T, TAPS> A, MatrixLoader<T, BN> Bw,
               const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, T* __restrict__ dx,
               float* __restrict__ partials, int C) {
  __shared__ __align__(16) T As[BM * Tile<T>::LD];
  __shared__ __align__(16) T Bs[BN * Tile<T>::LD];
  const int c_tiles = (C + BN - 1) / BN;
  const int mt = blockIdx.x / c_tiles;
  const int m0 = mt * BM;
  const int n0 = (blockIdx.x % c_tiles) * BN;
  const int depth = TAPS * A.N;
  const Lane ln;

  float acc[MF][NF][4];
  clear(acc);
  for (int k0 = 0; k0 < depth; k0 += BK) {
    A.load(As, m0, k0, depth);
    Bw.load(Bs, n0, k0, depth);
    __syncthreads();
    tile_product(acc, As, Bs, ln);
    __syncthreads();
  }

  float da[NF][2], db[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    da[j][0] = da[j][1] = db[j][0] = db[j][1] = 0.f;
    const int col = n0 + ln.wn0 + j * 8 + ln.t * 2;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (PROLOGUE && col < C) {
      a0 = a[col]; a1 = a[col + 1];
      b0 = b[col]; b1 = b[col + 1];
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + ln.wm0 + i * 16 + ln.g + 8 * h;
        if (row >= A.g.M || col >= C) continue;
        float d0 = acc[i][j][2 * h], d1 = acc[i][j][2 * h + 1];
        T* out = dx + static_cast<size_t>(row) * C + col;
        if constexpr (PROLOGUE) {
          const float2 xv = load2(x + static_cast<size_t>(row) * C + col);
          const float z0 = affine(xv.x, a0, b0), z1 = affine(xv.y, a1, b1);
          bool pos0, pos1;
          if constexpr (TAPS == 9) {  // on the rounded z, as the TPU kernel
            pos0 = round_to<T>(fmaxf(z0, 0.f)) > 0.f;
            pos1 = round_to<T>(fmaxf(z1, 0.f)) > 0.f;
          } else {
            pos0 = z0 > 0.f;
            pos1 = z1 > 0.f;
          }
          d0 = pos0 ? d0 : 0.f;
          d1 = pos1 ? d1 : 0.f;
          store2(out, __fmul_rn(d0, a0), __fmul_rn(d1, a1));
          da[j][0] += d0 * xv.x;
          da[j][1] += d1 * xv.y;
          db[j][0] += d0;
          db[j][1] += d1;
        } else {
          store2(out, d0, d1);
        }
      }
  }
  if constexpr (PROLOGUE) {
    float* part = partials + static_cast<size_t>(mt) * 2 * C;
    block_column_sums(da, db, ln, part, part + C, n0, C);
  }
}

// ----------------------------------------------- backward: weight gradient

// partials[split][taps * C][N] = z^T (*) dyt over this split's pixels.
template <typename T, int TAPS, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
    conv_wgrad(ActLoader<T, TAPS, PROLOGUE> A, GradLoader<T, TAPS> Bg,
               float* __restrict__ partials, int steps_per_split) {
  __shared__ __align__(16) T As[BM * Tile<T>::LD];
  __shared__ __align__(16) T Bs[BN * Tile<T>::LD];
  const int N = Bg.N;
  const int rows = TAPS * A.C;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long begin = static_cast<long long>(blockIdx.y) * steps_per_split * BK;
  const long long stop = begin + static_cast<long long>(steps_per_split) * BK;
  const int k_end = static_cast<int>(stop < A.g.M ? stop : A.g.M);
  const Lane ln;

  float acc[MF][NF][4];
  clear(acc);
  for (long long k0 = begin; k0 < k_end; k0 += BK) {
    A.load_t(As, m0, static_cast<int>(k0), k_end);
    Bg.load_t(Bs, n0, static_cast<int>(k0), k_end);
    __syncthreads();
    tile_product(acc, As, Bs, ln);
    __syncthreads();
  }

  float* out = partials + static_cast<size_t>(blockIdx.y) * rows * N;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int col = n0 + ln.wn0 + j * 8 + ln.t * 2;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + ln.wm0 + i * 16 + ln.g + 8 * h;
        if (row < rows && col < N) {
          store2(out + static_cast<size_t>(row) * N + col, acc[i][j][2 * h],
                 acc[i][j][2 * h + 1]);
        }
      }
  }
}

// ============================================ bf16 1x1 backward, pipelined
//
// Replaces, for bf16 and one tap, the TPU kernel `_mm_bwd_kernel`
// (iswm_tpu/ops/pallas/fused_block.py:82, called at :161, the VJP of
// matmul_bn_stats :192): dgrad_1x1_bf16 takes the place of
// conv_dgrad<bf16, 1, *> and wgrad_1x1_bf16 that of conv_wgrad<bf16, 1, *>.
// Same arithmetic, rounding points and outputs as those; only the order of
// the float32 sums differs.
//
// What bounds it: each half does 2 M C N operations and moves about
// 2 (M C + M N) bf16 values (data gradient: dy, y in, dx out, and x with
// the prologue; weight gradient: x, dy, y in).  With N output channels,
// the operations outweigh the bytes at 989 TFLOP/s against 3.35 TB/s only
// where C N / (C + N) > ~295.  Of the training slice's 11 shapes
// (chip_smoke.py BLOCK_MM_SHAPES: C x N = 64x64, 64x256 twice, 256x64,
// 512x128, 128x512, 1024x256, 256x1024 at M = 131072 ... 8192) eight are
// bound by bytes; layer4.0's 1024x512, 512x2048 and 1024x2048 by the
// tensor cores.  So the design is about how the bytes move:
//   - a ring of 4 stages of cp.async.cg (16 B a copy, through L2
//     only) brings the raw dy and y tiles and the other operand (w for the
//     data gradient, x for the weight gradient) straight into shared
//     memory, PK = 64 deep, without passing through registers; the data
//     gradient's stage also carries its 64 values of ds and dq;
//   - dyt (and the prologue's z) are formed in place in shared memory, each
//     thread over the chunks it copied itself, with the separate IEEE adds
//     and multiplies of GradLoader / ActLoader and one rounding on the store,
//     so both stay bit-equal to the plain version's; rows past M and
//     channels past C or N are zeroed there.  Stage k + 1 is formed while
//     stage k is multiplied: a thread reads all its chunks of stage k + 1
//     at once, then writes one round per mma step, so the transform's
//     arithmetic overlaps the tensor cores and one barrier a stage suffices;
//     the stages after k + 1 are in flight meanwhile;
//   - fragments come by ldmatrix; the weight gradient reduces over pixels,
//     so it reads both row-major tiles with ldmatrix.trans instead of
//     storing them transposed, and loads step kk + 1's fragments before
//     step kk's products (in the data gradient that measured no faster);
//   - the data gradient covers 128 pixels x 128 of dx's channels a block,
//     so dy and y are read and dyt formed ceil(C / 128) times, not
//     ceil(C / 64); where C <= 64, 64 x 64 blocks, two an SM.  A 128 x 256
//     block halves that again, but its 8 warps' 64 x 64 tiles hold 128
//     accumulators a thread and spilled: on the card it was slower at three
//     of the four slice shapes with C >= 512 and N >= 256;
//   - the weight gradient takes its tile (128 or 64 each way, 64 rows where
//     C = 64) and its split of the pixels from the shape alone: the split's
//     float32 partials, written and read once, stay within a tenth of the
//     call's bytes, and the tile shrinks until the blocks fill about the
//     card; with one split it writes dw itself, with no partials at all.
// The epilogues are conv_dgrad's and conv_wgrad's: the mask on the float32 x a + b > 0,
// dx = rd(dzm a), per-block partials of da, db that sum_partials adds in
// block order; no float atomics, so two launches give the same bits.
// What the card showed (PERF.md; block_bwd_ab.py): twice as fast as the
// first version's bf16 body over a train step, and 3.2 (data gradient) and
// 3.5 times (weight gradient) each half's own bound.  Taking the transform
// out saves 10% of the data gradient's time and 16% of the weight
// gradient's, taking the products out 14% and 16%.  What is left is mostly
// the traffic from L2: at the M = 8192 shapes every tile of dy and y is read
// again for each block of columns (8 times at C = 1024), and of x for each
// block of rows -- the case for larger tiles shared across blocks
// (clusters, TMA multicast, wgmma), a later redesign.

constexpr int PK = 64;          // depth of one stage: output channels or pixels
constexpr int RING = 4;         // stages in each ring (3 measured slower in both halves)
constexpr int PAD = 8;      // bf16 after each shared row: ldmatrix's 8 rows hit 8 bank groups
constexpr int SUMS_ROWS = 64;  // the fewest pixels a block sums columns over
static_assert(RING >= 3, "a stage multiplied, one formed, the rest in flight");
static_assert(SUMS_ROWS <= BM, "iswm_fb_sums_scratch sizes for the shortest block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from device to shared memory; zeros, and no read, where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
// Four 8x8 bf16 matrices, row i of matrix j from the address of lane 8 j + i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Eight bf16 values as 16 raw bytes, and as floats.
__device__ __forceinline__ uint4 raw8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[G]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Eight values of dy + ds + 2 * y * dq, as GradLoader::fetch, from the raw dy
// and y and the chunk's ds and dq; store8 rounds them to dyt.
__device__ __forceinline__ void total_cotangent8(const uint4& dy, const uint4& y,
                                                 const float (&s)[G], const float (&q)[G],
                                                 float (&f)[G]) {
  float d[G], yy[G];
  unpack8(dy, d);
  unpack8(y, yy);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    f[i] = __fadd_rn(__fadd_rn(d[i], s[i]), __fmul_rn(__fmul_rn(2.f, yy[i]), q[i]));
  }
}

// Per-column sums of a tile, each thread holding those of its own rows in
// the mma accumulator layout: added over the warp's 8 row groups
// (shuffles), then over the WARPS_M warps along the rows in a fixed order
// through `red` (2 * WARPS_M * WIDTH floats of shared memory).
template <int NF, int WARPS_M, int WIDTH>
__device__ __forceinline__ void tile_column_sums(float (&u)[NF][2], float (&v)[NF][2],
                                                 int warp_row, int wn0, float* red,
                                                 float* out_u, float* out_v, int n0,
                                                 int width) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        u[j][e] += __shfl_xor_sync(0xffffffffu, u[j][e], off);
        v[j][e] += __shfl_xor_sync(0xffffffffu, v[j][e], off);
      }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn0 + j * 8 + lane * 2 + e;
        red[warp_row * WIDTH + col] = u[j][e];
        red[(WARPS_M + warp_row) * WIDTH + col] = v[j][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < WIDTH && n0 + static_cast<int>(threadIdx.x) < width) {
    float su = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_M; ++w) {
      su += red[w * WIDTH + threadIdx.x];
      sv += red[(WARPS_M + w) * WIDTH + threadIdx.x];
    }
    out_u[n0 + threadIdx.x] = su;
    out_v[n0 + threadIdx.x] = sv;
  }
}

// The data gradient's block: BM pixels x BNC of dx's channels, 8 warps in
// WARPS_M rows; a stage holds dy (then dyt) and y [BM][PK], w [BNC][PK] and
// the stage's ds and dq [PK] in f32.
template <int BM_, int BNC>
struct Dgrad1x1 {
  static constexpr int BM = BM_;
  static constexpr int WARPS_M = BM / 32;         // 2 or 4
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int MF = WM / 16;
  static constexpr int NF = BNC / WARPS_N / 8;
  static constexpr int STAGES = RING;
  static constexpr int LD = PK + PAD;
  static constexpr int TILE = BM * LD;
  static constexpr int STAGE = 2 * TILE + BNC * LD + 4 * PK;  // bf16 elements: dy, y, w, ds and dq
  static constexpr int ROUNDS = BM * (PK / G) / THREADS;  // dyt chunks a thread forms a stage
  static_assert(WARPS_M * WARPS_N * 32 == THREADS && NF % 2 == 0, "8 warps, x4 B loads");
  static_assert(ROUNDS * THREADS == BM * (PK / G) && BNC * (PK / G) % THREADS == 0,
                "whole copy rounds");
  static_assert(PK / 16 % ROUNDS == 0, "dyt rounds spread over the mma steps");
};

// dx = rd(mask(dyt w^T) * a) over BM pixels and BNC channels and, with the
// prologue, the block's column sums of dzm * x and dzm into
// partials[m tile][2][C].
template <int BM, int BNC, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS, BM * BNC <= 64 * 64 ? 2 : 1)
    dgrad_1x1_bf16(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ ds, const float* __restrict__ dq,
                   const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partials, int M, int C,
                   int N) {
  using bf16 = __nv_bfloat16;
  using D = Dgrad1x1<BM, BNC>;
  constexpr int CH = PK / G;  // 16-byte chunks in a stage row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int c_tiles = (C + BNC - 1) / BNC;
  const int mt = blockIdx.x / c_tiles;
  const int m0 = mt * BM;
  const int c0 = (blockIdx.x % c_tiles) * BNC;
  const int ksteps = (N + PK - 1) / PK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_row = warp / D::WARPS_N;
  const int wm0 = warp_row * D::WM;
  const int wn0 = (warp % D::WARPS_N) * (BNC / D::WARPS_N);
  const int kc = (tid % CH) * G;  // a thread's chunk of output channels in every round

  // stage k's ds and dq
  auto vectors = [&](int k) {
    return reinterpret_cast<float*>(smem + (k % D::STAGES) * D::STAGE + 2 * D::TILE +
                                    BNC * D::LD);
  };
  auto load = [&](int k) {
    bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    bf16* sy = sd + D::TILE;
    bf16* sw = sy + D::TILE;
    const int k0 = k * PK;
#pragma unroll
    for (int i = 0; i < D::ROUNDS; ++i) {
      const int r = (tid + i * THREADS) / CH;
      const bool ok = m0 + r < M && k0 + kc < N;
      const size_t at = ok ? static_cast<size_t>(m0 + r) * N + k0 + kc : 0;
      cp_async16(sd + r * D::LD + kc, dy + at, ok);
      cp_async16(sy + r * D::LD + kc, y + at, ok);
    }
#pragma unroll
    for (int i = 0; i < BNC * CH / THREADS; ++i) {
      const int r = (tid + i * THREADS) / CH;
      const bool ok = c0 + r < C && k0 + kc < N;
      cp_async16(sw + r * D::LD + kc,
                 w + (ok ? static_cast<size_t>(c0 + r) * N + k0 + kc : 0), ok);
    }
    if (tid < PK / 2) {  // ds then dq, four floats a copy; zeros past N
      const int n = k0 + (tid % (PK / 4)) * 4;
      const float* v = tid < PK / 4 ? ds : dq;
      cp_async16(vectors(k) + (tid / (PK / 4)) * PK + (tid % (PK / 4)) * 4, v + (n < N ? n : 0),
                 n < N);
    }
  };

  // dyt over stage k's dy tile, in place, in rounds: fetch() reads every
  // round's dy and y chunks and the chunk's ds and dq at once, so their
  // latencies overlap; form(i) writes round i; zeros past M and N
  uint4 raw_dy[D::ROUNDS], raw_y[D::ROUNDS];
  float s[G], q[G];
  auto fetch_dyt = [&](int k) {
    const bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    load8(vectors(k) + kc, s);
    load8(vectors(k) + PK + kc, q);
#pragma unroll
    for (int i = 0; i < D::ROUNDS; ++i) {
      const int r = (tid + i * THREADS) / CH;
      raw_dy[i] = raw8(sd + r * D::LD + kc);
      raw_y[i] = raw8(sd + D::TILE + r * D::LD + kc);
    }
  };
  auto form_dyt = [&](int k, int i) {
    bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    const int r = (tid + i * THREADS) / CH;
    float f[G];
    total_cotangent8(raw_dy[i], raw_y[i], s, q, f);
    if (m0 + r >= M || k * PK + kc >= N) zero8(f);
    store8(sd + r * D::LD + kc, f);
  };
  // fragments of mma step kk of a stage: A = dyt rows, B = w rows
  auto fragments = [&](const bf16* sa, const bf16* sw, int kk, uint32_t (&af)[D::MF][4],
                       uint32_t (&bfr)[D::NF][2]) {
#pragma unroll
    for (int i = 0; i < D::MF; ++i) {
      ldsm_x4(af[i], sa + (wm0 + 16 * i + lane % 16) * D::LD + 16 * kk + (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < D::NF; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, sw + (wn0 + 8 * j + lane % 8 + (lane / 16) * 8) * D::LD + 16 * kk +
                     ((lane / 8) % 2) * 8);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
  };

  float acc[D::MF][D::NF][4];
#pragma unroll
  for (int i = 0; i < D::MF; ++i)
#pragma unroll
    for (int j = 0; j < D::NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // The ring: stage k is multiplied while stage k + 1's dyt is formed (the
  // two interleaved) and stages k + 2 .. k + STAGES - 1 are in flight.
#pragma unroll
  for (int st = 0; st < D::STAGES - 1; ++st) {
    if (st < ksteps) load(st);
    cp_async_commit();
  }
  cp_async_wait<D::STAGES - 2>();
  __syncthreads();
  fetch_dyt(0);
#pragma unroll
  for (int i = 0; i < D::ROUNDS; ++i) form_dyt(0, i);
  for (int k = 0; k < ksteps; ++k) {
    cp_async_wait<D::STAGES - 3>();  // stage k + 1 has landed
    __syncthreads();               // ... for every thread; stage k's dyt is whole; k - 1 is free
    if (k + D::STAGES - 1 < ksteps) load(k + D::STAGES - 1);
    cp_async_commit();
    const bool next = k + 1 < ksteps;
    if (next) fetch_dyt(k + 1);
    const bf16* sa = smem + (k % D::STAGES) * D::STAGE;
    const bf16* sw = sa + 2 * D::TILE;
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk) {
      if (next && kk % (PK / 16 / D::ROUNDS) == 0) form_dyt(k + 1, kk / (PK / 16 / D::ROUNDS));
      uint32_t af[D::MF][4], bfr[D::NF][2];
      fragments(sa, sw, kk, af, bfr);
#pragma unroll
      for (int i = 0; i < D::MF; ++i)
#pragma unroll
        for (int j = 0; j < D::NF; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the column sums

  const int g = lane / 4, t = lane % 4;
  float da[D::NF][2], db[D::NF][2];
#pragma unroll
  for (int j = 0; j < D::NF; ++j) {
    da[j][0] = da[j][1] = db[j][0] = db[j][1] = 0.f;
    const int col = c0 + wn0 + j * 8 + t * 2;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (PROLOGUE && col < C) {
      a0 = a[col]; a1 = a[col + 1];
      b0 = b[col]; b1 = b[col + 1];
    }
#pragma unroll
    for (int i = 0; i < D::MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= M || col >= C) continue;
        float d0 = acc[i][j][2 * h], d1 = acc[i][j][2 * h + 1];
        bf16* out = dx + static_cast<size_t>(row) * C + col;
        if constexpr (PROLOGUE) {
          const float2 xv = load2(x + static_cast<size_t>(row) * C + col);
          d0 = affine(xv.x, a0, b0) > 0.f ? d0 : 0.f;
          d1 = affine(xv.y, a1, b1) > 0.f ? d1 : 0.f;
          store2(out, __fmul_rn(d0, a0), __fmul_rn(d1, a1));
          da[j][0] += d0 * xv.x;
          da[j][1] += d1 * xv.y;
          db[j][0] += d0;
          db[j][1] += d1;
        } else {
          store2(out, d0, d1);
        }
      }
  }
  if constexpr (PROLOGUE) {
    float* part = partials + static_cast<size_t>(mt) * 2 * C;
    tile_column_sums<D::NF, D::WARPS_M, BNC>(da, db, warp_row, wn0,
                                             reinterpret_cast<float*>(smem_raw), part,
                                             part + C, c0, C);
  }
}

// The weight gradient's block: BC rows of dw (input channels) x BNW columns
// (output channels), 8 warps of 32 x BNW / WARPS_N; a stage holds x (then z)
// [PK][BC] and dy (then dyt) and y [PK][BNW], PK pixels as they lie in memory.
template <int BC, int BNW>
struct Wgrad1x1 {
  static constexpr int WARPS_C = BC / 32;      // 2 or 4
  static constexpr int WARPS_N = 8 / WARPS_C;  // 4 or 2
  static constexpr int WN = BNW / WARPS_N;
  static constexpr int MF = 2;
  static constexpr int NF = WN / 8;            // 2, 4 or 8
  static constexpr int LDX = BC + PAD;
  static constexpr int LDG = BNW + PAD;
  static constexpr int XT = PK * LDX;
  static constexpr int GT = PK * LDG;
  static constexpr int STAGE = XT + 2 * GT;  // bf16 elements
  static constexpr int STAGES = RING;
  static constexpr int XROUNDS = PK * (BC / G) / THREADS;   // z chunks a thread forms a stage
  static constexpr int GROUNDS = PK * (BNW / G) / THREADS;  // dyt chunks
  static_assert(WARPS_C * WARPS_N * 32 == THREADS && NF % 2 == 0, "8 warps, x4 B loads");
  static_assert(XROUNDS * THREADS == PK * (BC / G) && GROUNDS * THREADS == PK * (BNW / G),
                "whole copy rounds");
};

// out[blockIdx.y][C][N] = z^T dyt over this split's pixels (out = dw itself
// when there is one split).
template <int BC, int BNW, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_1x1_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
                   const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds,
                   const float* __restrict__ dq, float* __restrict__ out, int M, int C,
                   int N, int steps_per_split) {
  using bf16 = __nv_bfloat16;
  using Wt = Wgrad1x1<BC, BNW>;
  constexpr int XCH = BC / G, GCH = BNW / G;  // 16-byte chunks in a stage row
  // z rounds (with the prologue) and dyt rounds, spread over the mma steps
  constexpr int UNITS = (PROLOGUE ? Wt::XROUNDS : 0) + Wt::GROUNDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_tiles = (N + BNW - 1) / BNW;
  const int c0 = (blockIdx.x / n_tiles) * BC;
  const int n0 = (blockIdx.x % n_tiles) * BNW;
  const long long begin = static_cast<long long>(blockIdx.y) * steps_per_split * PK;
  const long long stop = begin + static_cast<long long>(steps_per_split) * PK;
  const int p_begin = static_cast<int>(begin);
  const int p_end = static_cast<int>(stop < M ? stop : M);
  const int ksteps = (p_end - p_begin + PK - 1) / PK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wc0 = (warp / Wt::WARPS_N) * 32;
  const int wn0 = (warp % Wt::WARPS_N) * Wt::WN;
  // a thread's chunks of channels are the same in every round and stage
  const int cc = (tid % XCH) * G, nc = (tid % GCH) * G;
  const bool c_in = c0 + cc < C, n_in = n0 + nc < N;
  float sa[G], sb[G], s[G], q[G];
  if (PROLOGUE && c_in) {
    load8(a + c0 + cc, sa);
    load8(b + c0 + cc, sb);
  } else {
    zero8(sa);
    zero8(sb);
  }
  if (n_in) {
    load8(ds + n0 + nc, s);
    load8(dq + n0 + nc, q);
  } else {
    zero8(s);
    zero8(q);
  }

  auto load = [&](int k) {
    bf16* sx = smem + (k % Wt::STAGES) * Wt::STAGE;
    bf16* sd = sx + Wt::XT;
    bf16* sy = sd + Wt::GT;
    const int p0 = p_begin + k * PK;
#pragma unroll
    for (int i = 0; i < Wt::XROUNDS; ++i) {
      const int r = (tid + i * THREADS) / XCH;
      const bool ok = p0 + r < p_end && c_in;
      cp_async16(sx + r * Wt::LDX + cc,
                 x + (ok ? static_cast<size_t>(p0 + r) * C + c0 + cc : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < Wt::GROUNDS; ++i) {
      const int r = (tid + i * THREADS) / GCH;
      const bool ok = p0 + r < p_end && n_in;
      const size_t at = ok ? static_cast<size_t>(p0 + r) * N + n0 + nc : 0;
      cp_async16(sd + r * Wt::LDG + nc, dy + at, ok);
      cp_async16(sy + r * Wt::LDG + nc, y + at, ok);
    }
  };

  // round u of stage k, in place: z over x (u < XROUNDS, with the prologue),
  // else dyt over dy; zeros past the split's pixels and past C and N.
  // fetch() reads every round's chunks at once, so their latencies overlap.
  uint4 raw_a[UNITS], raw_b[UNITS];  // x, or dy and y
  auto at_x = [&](int k, int u) {
    return smem + (k % Wt::STAGES) * Wt::STAGE + (tid + u * THREADS) / XCH * Wt::LDX + cc;
  };
  auto at_dy = [&](int k, int u) {
    const int i = PROLOGUE ? u - Wt::XROUNDS : u;
    return smem + (k % Wt::STAGES) * Wt::STAGE + Wt::XT + (tid + i * THREADS) / GCH * Wt::LDG +
           nc;
  };
  auto is_x = [](int u) { return PROLOGUE && u < Wt::XROUNDS; };
  auto fetch = [&](int k) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (is_x(u)) {
        raw_a[u] = raw8(at_x(k, u));
      } else {
        raw_a[u] = raw8(at_dy(k, u));
        raw_b[u] = raw8(at_dy(k, u) + Wt::GT);
      }
    }
  };
  auto form = [&](int k, int u) {
    const int p0 = p_begin + k * PK;
    float f[G];
    if (is_x(u)) {
      const int r = (tid + u * THREADS) / XCH;
      unpack8(raw_a[u], f);
#pragma unroll
      for (int e = 0; e < G; ++e) f[e] = fmaxf(affine(f[e], sa[e], sb[e]), 0.f);  // store8 rounds
      if (p0 + r >= p_end || !c_in) zero8(f);
      store8(at_x(k, u), f);
    } else {
      const int r = (tid + (PROLOGUE ? u - Wt::XROUNDS : u) * THREADS) / GCH;
      total_cotangent8(raw_a[u], raw_b[u], s, q, f);
      if (p0 + r >= p_end || !n_in) zero8(f);
      store8(at_dy(k, u), f);
    }
  };
  // fragments of mma step kk of a stage, by ldmatrix.trans (lane l addresses
  // row l % 8 of matrix l / 8): A = z^T, matrices (pixels 0-7 | 8-15) x
  // (channels 0-7 | 8-15); B = dyt, matrices (pixels 0-7 | 8-15) of output
  // channels j, then j + 1
  const int mi = lane / 8, r8 = lane % 8;
  auto fragments = [&](const bf16* sx, const bf16* sd, int kk, uint32_t (&af)[Wt::MF][4],
                       uint32_t (&bfr)[Wt::NF][2]) {
#pragma unroll
    for (int i = 0; i < Wt::MF; ++i) {
      ldsm_x4_trans(af[i], sx + (16 * kk + r8 + (mi / 2) * 8) * Wt::LDX + wc0 + 16 * i +
                               (mi % 2) * 8);
    }
#pragma unroll
    for (int j = 0; j < Wt::NF; j += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, sd + (16 * kk + r8 + (mi % 2) * 8) * Wt::LDG + wn0 + 8 * j + (mi / 2) * 8);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
  };

  float acc[Wt::MF][Wt::NF][4];
#pragma unroll
  for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
    for (int j = 0; j < Wt::NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // the ring as in dgrad_1x1_bf16
#pragma unroll
  for (int st = 0; st < Wt::STAGES - 1; ++st) {
    if (st < ksteps) load(st);
    cp_async_commit();
  }
  cp_async_wait<Wt::STAGES - 2>();
  __syncthreads();
  fetch(0);
#pragma unroll
  for (int u = 0; u < UNITS; ++u) form(0, u);
  for (int k = 0; k < ksteps; ++k) {
    cp_async_wait<Wt::STAGES - 3>();
    __syncthreads();
    if (k + Wt::STAGES - 1 < ksteps) load(k + Wt::STAGES - 1);
    cp_async_commit();
    const bool next = k + 1 < ksteps;
    if (next) fetch(k + 1);
    const bf16* sx = smem + (k % Wt::STAGES) * Wt::STAGE;
    const bf16* sd = sx + Wt::XT;
    // the fragments of step kk + 1 are loaded before step kk's products
    uint32_t af[2][Wt::MF][4], bfr[2][Wt::NF][2];
    fragments(sx, sd, 0, af[0], bfr[0]);
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk) {
      if (kk + 1 < PK / 16) fragments(sx, sd, kk + 1, af[(kk + 1) % 2], bfr[(kk + 1) % 2]);
#pragma unroll
      for (int u = kk * UNITS / (PK / 16); u < (kk + 1) * UNITS / (PK / 16); ++u) {
        if (next) form(k + 1, u);
      }
#pragma unroll
      for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
        for (int j = 0; j < Wt::NF; ++j) mma_bf16(acc[i][j], af[kk % 2][i], bfr[kk % 2][j]);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  float* dst = out + static_cast<size_t>(blockIdx.y) * C * N;
#pragma unroll
  for (int j = 0; j < Wt::NF; ++j) {
    const int col = n0 + wn0 + j * 8 + t * 2;
#pragma unroll
    for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c0 + wc0 + i * 16 + g + 8 * h;
        if (row < C && col < N) {
          store2(dst + static_cast<size_t>(row) * N + col, acc[i][j][2 * h],
                 acc[i][j][2 * h + 1]);
        }
      }
  }
}

// ---------------------------------------------------------------- the host

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// How many parts the weight gradient splits the M pixels into: enough
// blocks to fill the card, from the shape alone.  (64, 64) at M = 131072
// takes 264 parts of 16 KB; (1024, 2048) has 256 output tiles and takes one.
int wgrad_splits(int M, int rows, int N) {
  const int tiles = ceil_div(rows, BM) * ceil_div(N, BN);
  const int steps = ceil_div(M, BK);
  int splits = WGRAD_BLOCKS / tiles;
  if (splits < 1) splits = 1;
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  if (splits > steps) splits = steps;
  const int per = ceil_div(steps, splits);
  return ceil_div(steps, per);  // no empty part
}

int finish(const float* partials, int parts, int width, void* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<ceil_div(width, FIN_COLS), THREADS, 0, s>>>(
      partials, parts, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 1x1 weight gradient's tile and split of the M pixels, from the
// shape alone.  Partials are written and read once, so a split may add at
// most 8 C N bytes per part while the parts stay within a tenth of the
// call's bytes (x, dy, y read and dx written in bf16, w and dw); the largest
// tile whose tiles x splits fill about the card (WGRAD_FILL blocks) wins,
// else the one with the most blocks.  At the slice: 64x64 at 187 splits for
// (131072, 64, 64), 128x64 at 16 for (32768, 512, 128), 64x64 at 2 for
// (8192, 1024, 256), 128x128 at 1 (no partials) for (8192, 1024, 2048).
constexpr int WGRAD_FILL = 128;  // blocks that count as a full card

struct WgradPlan {
  int bc, bn, splits, per;  // per: PK steps of pixels a split
};

WgradPlan plan_wgrad_1x1(int M, int C, int N) {
  const double call = 4.0 * M * C + 4.0 * M * N + 6.0 * C * N;
  int cap = static_cast<int>(0.1 * call / (8.0 * C * N));
  if (cap < 1) cap = 1;
  const int steps = ceil_div(M, PK);
  WgradPlan best{64, 64, 1, steps};
  long long best_blocks = 0;
  const int sides[2] = {128, 64};
  for (const int bc : sides) {
    for (const int bn : sides) {
      if ((bc == 128 && C <= 64) || (bn == 128 && N <= 64)) continue;
      const int tiles = ceil_div(C, bc) * ceil_div(N, bn);
      int splits = ceil_div(WGRAD_BLOCKS, tiles);
      if (splits > cap) splits = cap;
      if (splits > steps) splits = steps;
      const int per = ceil_div(steps, splits);
      const WgradPlan plan{bc, bn, ceil_div(steps, per), per};  // no empty part
      const long long blocks = static_cast<long long>(tiles) * plan.splits;
      if (blocks >= WGRAD_FILL) return plan;
      if (blocks > best_blocks) {
        best = plan;
        best_blocks = blocks;
      }
    }
  }
  return best;
}

// Lets `kernel` take `bytes` of dynamic shared memory, which above 48 KB must
// be asked for; asked before every launch, since the attribute is per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The data gradient's launch for one instantiation: conv_dgrad ...  Each
// writes `rows` rows of per-block column sums for finish().
template <typename T, int TAPS, bool PROLOGUE>
struct DgradLaunch {
  static int run(const void* dy, const void* y, const void* ds, const void* dq,
                 const void* w_ckn, const void* x, const void* a, const void* b, void* dx,
                 float* part, Geo geo, int C, int N, cudaStream_t s, int& rows) {
    GradLoader<T, TAPS> A{static_cast<const T*>(dy), static_cast<const T*>(y),
                          static_cast<const float*>(ds), static_cast<const float*>(dq), geo, N};
    MatrixLoader<T, BN> Bw{static_cast<const T*>(w_ckn), C, TAPS * N};
    rows = ceil_div(geo.M, BM);
    conv_dgrad<T, TAPS, PROLOGUE><<<rows * ceil_div(C, BN), THREADS, 0, s>>>(
        A, Bw, static_cast<const T*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<T*>(dx), part, C);
    return 0;
  }
};

// ... and the pipelined one for bf16 and one tap: 64 x 64 blocks, two an SM,
// where C <= 64, else 128 x 128.
template <bool PROLOGUE>
struct DgradLaunch<__nv_bfloat16, 1, PROLOGUE> {
  template <int BMP, int BNC>
  static int go(const void* dy, const void* y, const void* ds, const void* dq,
                const void* w_ckn, const void* x, const void* a, const void* b, void* dx,
                float* part, int M, int C, int N, cudaStream_t s, int& rows) {
    using bf16 = __nv_bfloat16;
    using D = Dgrad1x1<BMP, BNC>;
    static_assert(BMP >= SUMS_ROWS, "iswm_fb_sums_scratch's rows");
    const int steps = ceil_div(N, PK);
    const int bytes = static_cast<int>(sizeof(bf16)) * D::STAGE *
                      (steps < D::STAGES ? steps : D::STAGES);
    const cudaError_t err = allow_smem(dgrad_1x1_bf16<BMP, BNC, PROLOGUE>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows = ceil_div(M, BMP);
    dgrad_1x1_bf16<BMP, BNC, PROLOGUE>
        <<<rows * ceil_div(C, BNC), THREADS, bytes, s>>>(
            static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
            static_cast<const float*>(ds), static_cast<const float*>(dq),
            static_cast<const bf16*>(w_ckn), static_cast<const bf16*>(x),
            static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<bf16*>(dx), part, M, C, N);
    return 0;
  }

  static int run(const void* dy, const void* y, const void* ds, const void* dq,
                 const void* w_ckn, const void* x, const void* a, const void* b, void* dx,
                 float* part, Geo geo, int C, int N, cudaStream_t s, int& rows) {
    if (C <= 64)
      return go<64, 64>(dy, y, ds, dq, w_ckn, x, a, b, dx, part, geo.M, C, N, s, rows);
    return go<128, 128>(dy, y, ds, dq, w_ckn, x, a, b, dx, part, geo.M, C, N, s, rows);
  }
};

// The weight gradient's launch: the kernel writes `parts` partials into
// `part` for finish(), or dw itself (parts = 0).  conv_wgrad ...
template <typename T, int TAPS, bool PROLOGUE>
struct WgradLaunch {
  static int run(const void* x, const void* a, const void* b, const void* dy, const void* y,
                 const void* ds, const void* dq, float* part, void* /*dw*/, Geo geo, int C,
                 int N, cudaStream_t s, int& parts) {
    const int rows = TAPS * C;
    parts = wgrad_splits(geo.M, rows, N);
    const int per = ceil_div(ceil_div(geo.M, BK), parts);
    const dim3 grid(ceil_div(rows, BM) * ceil_div(N, BN), parts);
    ActLoader<T, TAPS, PROLOGUE> A{static_cast<const T*>(x), static_cast<const float*>(a),
                                   static_cast<const float*>(b), geo, C};
    GradLoader<T, TAPS> Bg{static_cast<const T*>(dy), static_cast<const T*>(y),
                           static_cast<const float*>(ds), static_cast<const float*>(dq), geo, N};
    conv_wgrad<T, TAPS, PROLOGUE><<<grid, THREADS, 0, s>>>(A, Bg, part, per);
    return 0;
  }
};

// ... and the pipelined one for bf16 and one tap.
template <bool PROLOGUE>
struct WgradLaunch<__nv_bfloat16, 1, PROLOGUE> {
  template <int BC, int BNW>
  static int go(const void* x, const void* a, const void* b, const void* dy, const void* y,
                const void* ds, const void* dq, float* out, int M, int C, int N, int splits,
                int per, cudaStream_t s) {
    using bf16 = __nv_bfloat16;
    const int bytes = static_cast<int>(sizeof(bf16)) * Wgrad1x1<BC, BNW>::STAGE *
                      (per < Wgrad1x1<BC, BNW>::STAGES ? per : Wgrad1x1<BC, BNW>::STAGES);
    const cudaError_t err = allow_smem(wgrad_1x1_bf16<BC, BNW, PROLOGUE>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(ceil_div(C, BC) * ceil_div(N, BNW), splits);
    wgrad_1x1_bf16<BC, BNW, PROLOGUE><<<grid, THREADS, bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(y), static_cast<const float*>(ds),
        static_cast<const float*>(dq), out, M, C, N, per);
    return 0;
  }

  static int run(const void* x, const void* a, const void* b, const void* dy, const void* y,
                 const void* ds, const void* dq, float* part, void* dw, Geo geo, int C, int N,
                 cudaStream_t s, int& parts) {
    const WgradPlan p = plan_wgrad_1x1(geo.M, C, N);
    parts = p.splits > 1 ? p.splits : 0;
    float* out = parts ? part : static_cast<float*>(dw);
    if (p.bc == 128 && p.bn == 128)
      return go<128, 128>(x, a, b, dy, y, ds, dq, out, geo.M, C, N, p.splits, p.per, s);
    if (p.bc == 128)
      return go<128, 64>(x, a, b, dy, y, ds, dq, out, geo.M, C, N, p.splits, p.per, s);
    if (p.bn == 128)
      return go<64, 128>(x, a, b, dy, y, ds, dq, out, geo.M, C, N, p.splits, p.per, s);
    return go<64, 64>(x, a, b, dy, y, ds, dq, out, geo.M, C, N, p.splits, p.per, s);
  }
};

}  // namespace

// Runs the statement with T, TAPS and PROLOGUE bound to one of the six
// instantiations: 1x1 with and without prologue, 3x3 (always with one).
#define ISWM_FB_DISPATCH(BF16, TAPS_, PROLOGUE_, ...)             \
  {                                                               \
    const bool pro_ = (PROLOGUE_) != 0;                           \
    if ((TAPS_) == 9 && pro_) {                                   \
      constexpr int TAPS = 9;                                     \
      constexpr bool PROLOGUE = true;                             \
      if (BF16) { using T = __nv_bfloat16; __VA_ARGS__; }         \
      else { using T = float; __VA_ARGS__; }                      \
    } else if ((TAPS_) == 1 && pro_) {                            \
      constexpr int TAPS = 1;                                     \
      constexpr bool PROLOGUE = true;                             \
      if (BF16) { using T = __nv_bfloat16; __VA_ARGS__; }         \
      else { using T = float; __VA_ARGS__; }                      \
    } else if ((TAPS_) == 1) {                                    \
      constexpr int TAPS = 1;                                     \
      constexpr bool PROLOGUE = false;                            \
      if (BF16) { using T = __nv_bfloat16; __VA_ARGS__; }         \
      else { using T = float; __VA_ARGS__; }                      \
    } else {                                                      \
      return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                             \
  }

extern "C" {

// Floats of scratch: the forward's and the data gradient's per-block column
// sums (`width` = N or C), for blocks of SUMS_ROWS pixels or more.
long long iswm_fb_sums_scratch(int M, int width) {
  return static_cast<long long>(ceil_div(M, SUMS_ROWS)) * 2 * width;
}
// Parts of the weight gradient's scratch: enough for conv_wgrad and for
// wgrad_1x1_bf16 (rows = taps * C).
int iswm_fb_wgrad_splits(int M, int rows, int N) {
  const int general = wgrad_splits(M, rows, N);
  const int piped = plan_wgrad_1x1(M, rows, N).splits;
  return general > piped ? general : piped;
}

// y [M, N] in T and sq [2 N] f32 (s then q).  x [M, C]; w_nk [N][taps * C];
// a, b [C] f32 (unused without prologue).  M = B * H * W; the 1x1 ignores H, W.
int iswm_fb_fwd(const void* x, const void* w_nk, const void* a, const void* b,
                void* y, void* scratch, void* sq, int bf16, int taps, int prologue,
                int M, int H, int W, int C, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const Geo geo{H, W, M};
  const int m_tiles = ceil_div(M, BM);
  const int blocks = m_tiles * ceil_div(N, BN);
  ISWM_FB_DISPATCH(bf16, taps, prologue, {
    ActLoader<T, TAPS, PROLOGUE> A{static_cast<const T*>(x), static_cast<const float*>(a),
                                   static_cast<const float*>(b), geo, C};
    MatrixLoader<T, BN> Bw{static_cast<const T*>(w_nk), N, TAPS * C};
    conv_fwd<T, TAPS, PROLOGUE><<<blocks, THREADS, 0, s>>>(A, Bw, static_cast<T*>(y), part, N);
  })
  return finish(part, m_tiles, 2 * N, sq, s);
}

// dx [M, C] in T and dab [2 C] f32 (da then db; written only with prologue).
// dy, y [M, N]; ds, dq [N] f32; w_ckn [C][taps * N]; x, a, b as the forward's.
int iswm_fb_dgrad(const void* dy, const void* y, const void* ds, const void* dq,
                  const void* w_ckn, const void* x, const void* a, const void* b,
                  void* dx, void* scratch, void* dab, int bf16, int taps, int prologue,
                  int M, int H, int W, int C, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const Geo geo{H, W, M};
  int err = 0, rows = 0;
  ISWM_FB_DISPATCH(bf16, taps, prologue,
                   err = DgradLaunch<T, TAPS, PROLOGUE>::run(dy, y, ds, dq, w_ckn, x, a, b, dx,
                                                             part, geo, C, N, s, rows))
  if (err) return err;
  if (!prologue) return static_cast<int>(cudaGetLastError());
  return finish(part, rows, 2 * C, dab, s);
}

// dw [taps * C][N] f32.  scratch holds iswm_fb_wgrad_splits(M, taps * C, N)
// parts of taps * C * N floats.
int iswm_fb_wgrad(const void* x, const void* a, const void* b, const void* dy,
                  const void* y, const void* ds, const void* dq, void* scratch,
                  void* dw, int bf16, int taps, int prologue, int M, int H, int W,
                  int C, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const Geo geo{H, W, M};
  int err = 0, parts = 0;
  ISWM_FB_DISPATCH(bf16, taps, prologue,
                   err = WgradLaunch<T, TAPS, PROLOGUE>::run(x, a, b, dy, y, ds, dq, part, dw,
                                                             geo, C, N, s, parts))
  if (err) return err;
  if (!parts) return static_cast<int>(cudaGetLastError());
  return finish(part, parts, taps * C * N, dw, s);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
