// Fused bottleneck convs for Hopper (sm_90a): a 1x1 or 3x3 / stride 1 / pad 1
// conv that applies the previous BatchNorm + ReLU to its input on the way in
// (the "prologue"), emits the BatchNorm statistics of its own output in the
// same pass, and whose backward fuses the statistics' cotangents, the ReLU
// mask, the data gradient, the prologue's gradients and the weight gradient.
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_block.py:
//   matmul_bn_stats forward   (`_mm_fwd_kernel`)  -> conv_fwd<T, 1, *>
//   matmul_bn_stats backward  (`_mm_bwd_kernel`)  -> conv_dgrad<T, 1, *> + conv_wgrad<T, 1, *>
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
// device memory, the widest 1x1 and every 3x3 by the tensor cores.  This
// first version is simple and exact in its rounding points, not fast:
//   - every kernel is one tiled GEMM, 128 x 64 outputs a block, 8 warps of
//     32 x 32, a 32-deep step through shared memory; what differs is how the
//     two operand tiles are produced ("loaders") and what happens to the
//     accumulators ("epilogue").  The 3x3 is an implicit GEMM over (tap,
//     channel): a loader gathers the shifted pixel and writes zeros outside
//     the image, so there is no halo buffer and any H, W works;
//   - bf16 runs `mma.sync.aligned.m16n8k16` with f32 accumulators (inline
//     PTX; wgmma, TMA and pipelining are for the versions that make it
//     fast); f32 runs FMAs on the same accumulator layout, so the loaders
//     and epilogues are shared;
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
// sums (`width` = N or C), and the weight gradient's parts.
long long iswm_fb_sums_scratch(int M, int width) {
  return static_cast<long long>(ceil_div(M, BM)) * 2 * width;
}
int iswm_fb_wgrad_splits(int M, int rows, int N) { return wgrad_splits(M, rows, N); }

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
  const int m_tiles = ceil_div(M, BM);
  const int blocks = m_tiles * ceil_div(C, BN);
  ISWM_FB_DISPATCH(bf16, taps, prologue, {
    GradLoader<T, TAPS> A{static_cast<const T*>(dy), static_cast<const T*>(y),
                          static_cast<const float*>(ds), static_cast<const float*>(dq), geo, N};
    MatrixLoader<T, BN> Bw{static_cast<const T*>(w_ckn), C, TAPS * N};
    conv_dgrad<T, TAPS, PROLOGUE><<<blocks, THREADS, 0, s>>>(
        A, Bw, static_cast<const T*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<T*>(dx), part, C);
  })
  if (!prologue) return static_cast<int>(cudaGetLastError());
  return finish(part, m_tiles, 2 * C, dab, s);
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
  const int rows = taps * C;
  const int splits = wgrad_splits(M, rows, N);
  const int per = ceil_div(ceil_div(M, BK), splits);
  const dim3 grid(ceil_div(rows, BM) * ceil_div(N, BN), splits);
  ISWM_FB_DISPATCH(bf16, taps, prologue, {
    ActLoader<T, TAPS, PROLOGUE> A{static_cast<const T*>(x), static_cast<const float*>(a),
                                   static_cast<const float*>(b), geo, C};
    GradLoader<T, TAPS> Bg{static_cast<const T*>(dy), static_cast<const T*>(y),
                           static_cast<const float*>(ds), static_cast<const float*>(dq), geo, N};
    conv_wgrad<T, TAPS, PROLOGUE><<<grid, THREADS, 0, s>>>(A, Bg, part, per);
  })
  return finish(part, splits, rows * N, dw, s);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
