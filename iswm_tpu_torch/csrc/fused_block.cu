// Fused bottleneck convs for Hopper (sm_90a): a 1x1 or 3x3 / stride 1 / pad 1
// conv that applies the previous BatchNorm + ReLU to its input on the way in
// (the "prologue"), emits the BatchNorm statistics of its own output in the
// same pass, and whose backward fuses the statistics' cotangents, the ReLU
// mask, the data gradient, the prologue's gradients and the weight gradient.
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_block.py:
//   matmul_bn_stats forward   (`_mm_fwd_kernel`)  -> bf16: fwd_1x1_bf16 (pipelined, below
//                                                  the first version's kernels);
//                                                  f32: conv_fwd<f32, 1, *>
//   matmul_bn_stats backward  (`_mm_bwd_kernel`)  -> bf16: dgrad_1x1_bf16 + wgrad_1x1_bf16
//                                                  (pipelined the same way);
//                                                  f32: conv_dgrad<f32, 1, *> + conv_wgrad<f32, 1, *>
//   conv3x3_bn_stats forward  (`_c3_fwd_kernel`)  -> bf16: fwd_3x3_bf16 (pipelined, wgmma);
//                                                  f32: conv_fwd<f32, 9, true>
//   conv3x3_bn_stats backward (`_c3_bwd_kernel`)  -> bf16: dgrad_3x3_bf16 + wgrad_3x3_bf16
//                                                  (pipelined);
//                                                  f32: conv_dgrad<f32, 9, true> + conv_wgrad<f32, 9, true>
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
// Every bf16 kernel is pipelined: cp.async stages, the prologue's z and the
// backward's dyt formed in shared memory, ldmatrix fragments, tiles and
// splits planned from the shape.  The backward (1x1 #7b, 3x3 #8b) has its
// note above dgrad_pipelined, the forward (1x1 #7a, 3x3 #8a, the 3x3 on
// wgmma) above fwd_pipelined.
//
// Every float32 instantiation (conv_fwd, conv_dgrad, conv_wgrad) runs the
// first version's body, which is simple and exact in its rounding points,
// not fast:
//   - every kernel is one tiled GEMM, 128 x 64 outputs a block, 8 warps of
//     32 x 32, a 32-deep step through shared memory; what differs is how the
//     two operand tiles are produced ("loaders") and what happens to the
//     accumulators ("epilogue").  The 3x3 is an implicit GEMM over (tap,
//     channel): a loader gathers the shifted pixel and writes zeros outside
//     the image, so there is no halo buffer and any H, W works;
//   - the products are FMAs in the accumulator layout of mma.sync (which
//     this body ran in bf16 before the pipelined kernels took bf16 over), no
//     copy in flight during the math;
//   - loaders move 8 neighbouring channels a thread and
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

#include <type_traits>

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

// Row pitch of a shared tile: 144 bytes in f32, so that the fragment loads
// of a warp hit 32 different banks.
template <typename T> struct Tile;
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

// acc += As (rows x BK) . Bs (columns x BK)^T in full float32 with FMAs, in
// the mma.sync accumulator layout.
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

// ================================================ bf16 backward, pipelined
//
// Replaces, for bf16 and one tap, the TPU kernel `_mm_bwd_kernel`
// (iswm_tpu/ops/pallas/fused_block.py:82, called at :161, the VJP of
// matmul_bn_stats :192): dgrad_1x1_bf16 takes the place of
// conv_dgrad<bf16, 1, *> and wgrad_1x1_bf16 that of conv_wgrad<bf16, 1, *>;
// and for bf16 and nine taps `_c3_bwd_kernel` (:277, called at :431, the VJP
// of conv3x3_bn_stats :470): wgrad_3x3_bf16 is wgrad_pipelined with
// TAPS = 9 and dgrad_3x3_bf16 runs dgrad_3x3_rows, the same ring by kernel
// rows.  Same arithmetic, rounding points and outputs as the first
// version's body; only the order of the float32 sums differs.
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
// The epilogues are conv_dgrad's and conv_wgrad's: the mask on the float32
// x a + b > 0 (the 3x3's on the rounded z), dx = rd(dzm a), per-block
// partials of da, db that sum_partials adds in
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
//
// Nine taps (#8b): every slice shape is bound by the tensor cores (2 M 9 C N
// operations a half on about the 1x1's bytes: 9.7 GFLOP a half at layer1 to
// layer3, 38.7 at layer4.0), so here the design is about keeping them fed.
// The same ring, with these differences:
//   - the data gradient (dgrad_3x3_rows) runs over (kernel row, 32 output
//     channels) stages.  The three taps of a kernel row read dyt at pixel
//     rows that differ by one, so a stage copies the BM + 2 rows they share
//     (from p - off(tap), with cp_async16's zero-fill outside [0, M)) and
//     each tap reads them from its own row on: dyt is formed once for three
//     taps and dy, y copied a third as often.  (Per-tap stages, 64 deep,
//     took 1.68 ms a step against 1.29 in one block_bwd_ab.py call.)  A row
//     is another pixel's dyt where a tap reads outside the image, so each
//     lane keeps a 9-bit mask of the taps its accumulator rows read inside
//     the image and zeroes the A fragments of the others after ldmatrix; a
//     zero-filled row would otherwise count as ds.  The mask on dz is taken
//     on the rounded z, as conv_dgrad's;
//   - a weight-gradient block takes one tap's rows of dw: x is copied from
//     p + off(tap), each round's image row and column stepped by 64 pixels
//     a stage (no division in the loop), and a bit a round and stage records
//     whether it lay inside the image, so that z is 0 there and not
//     rd(relu(b)): the padding comes after the prologue.  Its chains are
//     cut at every stage into a second float32 accumulator (see
//     wgrad_pipelined);
//   - plan_wgrad_3x3 takes the tile and the split from the shape, counting
//     waves of blocks, not only whether they fill the card.

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

// The data gradient's epilogue over a block's accumulators (rows m0 + wm0 +
// 16 i + g + 8 h, columns c0 + wn0 + 8 j + 2 t + e): the prologue's ReLU mask
// (on the float32 x a + b > 0, or, with ROUNDED_Z as the nine-tap kernels, on
// the rounded z), dx = rd(dzm a) and, with the prologue, the block's column
// sums of dzm * x and dzm into partials[m tile][2][C] through `red`.
template <bool ROUNDED_Z, bool PROLOGUE, int MF, int NF, int WARPS_M, int BNC>
__device__ __forceinline__ void dgrad_epilogue(const float (&acc)[MF][NF][4],
                                               const __nv_bfloat16* __restrict__ x,
                                               const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               __nv_bfloat16* __restrict__ dx,
                                               float* __restrict__ partials, float* red, int M,
                                               int C, int m0, int c0, int mt, int wm0, int wn0,
                                               int warp_row) {
  using bf16 = __nv_bfloat16;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float da[NF][2], db[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    da[j][0] = da[j][1] = db[j][0] = db[j][1] = 0.f;
    const int col = c0 + wn0 + j * 8 + t * 2;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (PROLOGUE && col < C) {
      a0 = a[col]; a1 = a[col + 1];
      b0 = b[col]; b1 = b[col + 1];
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= M || col >= C) continue;
        float d0 = acc[i][j][2 * h], d1 = acc[i][j][2 * h + 1];
        bf16* out = dx + static_cast<size_t>(row) * C + col;
        if constexpr (PROLOGUE) {
          const float2 xv = load2(x + static_cast<size_t>(row) * C + col);
          const float z0 = affine(xv.x, a0, b0), z1 = affine(xv.y, a1, b1);
          if constexpr (ROUNDED_Z) {  // as conv_dgrad<T, 9, true>
            d0 = round_to<bf16>(fmaxf(z0, 0.f)) > 0.f ? d0 : 0.f;
            d1 = round_to<bf16>(fmaxf(z1, 0.f)) > 0.f ? d1 : 0.f;
          } else {
            d0 = z0 > 0.f ? d0 : 0.f;
            d1 = z1 > 0.f ? d1 : 0.f;
          }
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
    tile_column_sums<NF, WARPS_M, BNC>(da, db, warp_row, wn0, red, part, part + C, c0, C);
  }
}

// The data gradient's block: BM pixels x BNC of dx's channels, 8 warps in
// WARPS_M rows; a stage holds dy (then dyt) and y [BM][PK], w [BNC][PK] and
// the stage's ds and dq [PK] in f32.
template <int BM_, int BNC>
struct DgradTile {
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
// partials[m tile][2][C]; stage k holds output channels 64 k.. of dy, y, w.
template <int BM, int BNC, bool PROLOGUE>
__device__ __forceinline__ void dgrad_pipelined(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ ds, const float* __restrict__ dq,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ b, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partials, const Geo geo, int C, int N) {
  using bf16 = __nv_bfloat16;
  using D = DgradTile<BM, BNC>;
  constexpr int CH = PK / G;  // 16-byte chunks in a stage row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int M = geo.M;
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

  dgrad_epilogue<false, PROLOGUE, D::MF, D::NF, D::WARPS_M, BNC>(
      acc, x, a, b, dx, partials, reinterpret_cast<float*>(smem_raw), M, C, m0, c0, mt, wm0,
      wn0, warp_row);
}

// The nine-tap data gradient by kernel rows: a stage serves the three taps
// of one kernel row ky (tap = 3 ky + kx) over PK3 output channels.  Pixel p's
// taps in that row read dyt at p + (1 - ky) W + 1 - kx, so the stage holds
// the BM + 2 rows from m0 + (1 - ky) W - 1 on, and tap kx reads them from
// row 2 - kx on: dyt is formed once for three taps, where per-tap stages
// form it for each, and dy and y are copied a third as often.
constexpr int PK3 = 32;  // output channels of a row stage
template <int BM_, int BNC>
struct DgradRowTile {
  static constexpr int BM = BM_;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int MF = WM / 16;
  static constexpr int NF = BNC / WARPS_N / 8;
  static constexpr int STAGES = RING;
  static constexpr int LD = PK3 + PAD;  // 80-byte rows: ldmatrix's 8 rows hit 8 bank groups
  static constexpr int CH = PK3 / G;    // 16-byte chunks in a row
  static constexpr int RT = BM + 2;     // the block's pixels and one more on each side
  static constexpr int TILE = RT * LD;
  static constexpr int WTILE = BNC * LD;
  static constexpr int STAGE = 2 * TILE + 3 * WTILE + 4 * PK3;  // bf16 elements: dy, y, 3 w, ds and dq
  static constexpr int ROUNDS = (RT * CH + THREADS - 1) / THREADS;  // dyt chunks a thread forms, the last round in part
  static constexpr int WROUNDS = 3 * BNC * CH / THREADS;
  static constexpr int STEPS = 3 * (PK3 / 16);  // mma steps a stage: three taps
  static_assert(WARPS_M * WARPS_N * 32 == THREADS && NF % 2 == 0, "8 warps, x4 B loads");
  static_assert(WROUNDS * THREADS == 3 * BNC * CH && THREADS % CH == 0, "whole copy rounds");
  static_assert(STEPS % ROUNDS == 0, "dyt rounds spread over the mma steps");
  static_assert(TILE % 8 == 0 && WTILE % 8 == 0, "16-byte aligned tiles");
};

template <int BM, int BNC>
__device__ __forceinline__ void dgrad_3x3_rows(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ ds, const float* __restrict__ dq,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ b, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partials, const Geo geo, int C, int N) {
  using bf16 = __nv_bfloat16;
  using D = DgradRowTile<BM, BNC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int M = geo.M;
  const int c_tiles = (C + BNC - 1) / BNC;
  const int mt = blockIdx.x / c_tiles;
  const int m0 = mt * BM;
  const int c0 = (blockIdx.x % c_tiles) * BNC;
  const int row_steps = (N + PK3 - 1) / PK3;  // stages a kernel row
  const int ksteps = 3 * row_steps;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_row = warp / D::WARPS_N;
  const int wm0 = warp_row * D::WM;
  const int wn0 = (warp % D::WARPS_N) * (BNC / D::WARPS_N);
  const int kc = (tid % D::CH) * G;  // a thread's chunk of output channels in every round

  // bit `tap` of taps_in[i][h] is set where this lane's accumulator row
  // wm0 + 16 i + lane / 4 + 8 h reads inside the image at that tap: a stage's
  // rows are shared by three taps, so the A fragments of the others are zeroed
  uint32_t taps_in[D::MF][2];
#pragma unroll
  for (int i = 0; i < D::MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + wm0 + 16 * i + lane / 4 + 8 * h;
      uint32_t mask = 0;
      if (p < M) {
        const int pw = p % geo.W, ph = (p / geo.W) % geo.H;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int hh = ph + 1 - tap / 3, ww = pw + 1 - tap % 3;
          if (hh >= 0 && hh < geo.H && ww >= 0 && ww < geo.W) mask |= 1u << tap;
        }
      }
      taps_in[i][h] = mask;
    }
  auto ky_of = [&](int k) { return k / row_steps; };
  auto n0_of = [&](int k) { return (k % row_steps) * PK3; };
  // the pixel of stage k's row j
  auto pixel_of = [&](int k, int j) { return m0 + (1 - ky_of(k)) * geo.W - 1 + j; };
  // whether round i's chunk of stage k is a row of the stage holding data
  auto chunk_in = [&](int k, int i) {
    const int j = (tid + i * THREADS) / D::CH;
    const int q = pixel_of(k, j);
    return q >= 0 && q < M && n0_of(k) + kc < N;
  };
  auto vectors = [&](int k) {
    return reinterpret_cast<float*>(smem + (k % D::STAGES) * D::STAGE + 2 * D::TILE +
                                    3 * D::WTILE);
  };
  auto load = [&](int k) {
    bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    bf16* sy = sd + D::TILE;
    bf16* sw = sy + D::TILE;
    const int ky = ky_of(k), n0 = n0_of(k);
#pragma unroll
    for (int i = 0; i < D::ROUNDS; ++i) {
      const int j = (tid + i * THREADS) / D::CH;
      if (j < D::RT) {
        const bool ok = chunk_in(k, i);
        const size_t at = ok ? static_cast<size_t>(pixel_of(k, j)) * N + n0 + kc : 0;
        cp_async16(sd + j * D::LD + kc, dy + at, ok);
        cp_async16(sy + j * D::LD + kc, y + at, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < D::WROUNDS; ++i) {  // w's rows of taps 3 ky .. 3 ky + 2
      const int v = (tid + i * THREADS) / D::CH;
      const int kx = v / BNC, r = v % BNC;
      const bool ok = c0 + r < C && n0 + kc < N;
      cp_async16(sw + v * D::LD + kc,
                 w + (ok ? static_cast<size_t>(c0 + r) * 9 * N + (3 * ky + kx) * N + n0 + kc
                         : 0),
                 ok);
    }
    if (tid < PK3 / 2) {  // ds then dq, four floats a copy; zeros past N
      const int n = n0 + (tid % (PK3 / 4)) * 4;
      const float* v = tid < PK3 / 4 ? ds : dq;
      cp_async16(vectors(k) + (tid / (PK3 / 4)) * PK3 + (tid % (PK3 / 4)) * 4,
                 v + (n < N ? n : 0), n < N);
    }
  };

  // dyt over stage k's dy tile, in place, as dgrad_pipelined's: zeros for
  // rows outside [0, M) and channels past N
  uint4 raw_dy[D::ROUNDS], raw_y[D::ROUNDS];
  float s[G], q[G];
  auto fetch_dyt = [&](int k) {
    const bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    load8(vectors(k) + kc, s);
    load8(vectors(k) + PK3 + kc, q);
#pragma unroll
    for (int i = 0; i < D::ROUNDS; ++i) {
      const int j = (tid + i * THREADS) / D::CH;
      if (j < D::RT) {
        raw_dy[i] = raw8(sd + j * D::LD + kc);
        raw_y[i] = raw8(sd + D::TILE + j * D::LD + kc);
      }
    }
  };
  auto form_dyt = [&](int k, int i) {
    const int j = (tid + i * THREADS) / D::CH;
    if (j >= D::RT) return;
    bf16* sd = smem + (k % D::STAGES) * D::STAGE;
    float f[G];
    total_cotangent8(raw_dy[i], raw_y[i], s, q, f);
    if (!chunk_in(k, i)) zero8(f);
    store8(sd + j * D::LD + kc, f);
  };
  // fragments of tap kx's mma step kk: A = dyt rows from 2 - kx on, the rows
  // whose pixel reads outside the image at this tap zeroed; B = w rows
  auto fragments = [&](const bf16* sa, const bf16* sw, int tap, int kx, int kk,
                       uint32_t (&af)[D::MF][4], uint32_t (&bfr)[D::NF][2]) {
#pragma unroll
    for (int i = 0; i < D::MF; ++i) {
      ldsm_x4(af[i], sa + (wm0 + 16 * i + lane % 16 + 2 - kx) * D::LD + 16 * kk +
                         (lane / 16) * 8);
      if (!((taps_in[i][0] >> tap) & 1u)) af[i][0] = af[i][2] = 0u;
      if (!((taps_in[i][1] >> tap) & 1u)) af[i][1] = af[i][3] = 0u;
    }
#pragma unroll
    for (int j = 0; j < D::NF; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, sw + (kx * BNC + wn0 + 8 * j + lane % 8 + (lane / 16) * 8) * D::LD + 16 * kk +
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

  // the ring as in dgrad_pipelined, three taps a stage
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
    cp_async_wait<D::STAGES - 3>();
    __syncthreads();
    if (k + D::STAGES - 1 < ksteps) load(k + D::STAGES - 1);
    cp_async_commit();
    const bool next = k + 1 < ksteps;
    if (next) fetch_dyt(k + 1);
    const bf16* sa = smem + (k % D::STAGES) * D::STAGE;
    const bf16* sw = sa + 2 * D::TILE;
    const int tap0 = 3 * ky_of(k);
#pragma unroll
    for (int st = 0; st < D::STEPS; ++st) {
      constexpr int EVERY = D::STEPS / D::ROUNDS;
      if (next && st % EVERY == 0) form_dyt(k + 1, st / EVERY);
      const int kx = st / (PK3 / 16), kk = st % (PK3 / 16);
      uint32_t af[D::MF][4], bfr[D::NF][2];
      fragments(sa, sw, tap0 + kx, kx, kk, af, bfr);
#pragma unroll
      for (int i = 0; i < D::MF; ++i)
#pragma unroll
        for (int j = 0; j < D::NF; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the column sums
  dgrad_epilogue<true, true, D::MF, D::NF, D::WARPS_M, BNC>(
      acc, x, a, b, dx, partials, reinterpret_cast<float*>(smem_raw), M, C, m0, c0, mt, wm0,
      wn0, warp_row);
}

template <int BM, int BNC, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS, BM * BNC <= 64 * 64 ? 2 : 1)
    dgrad_1x1_bf16(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ ds, const float* __restrict__ dq,
                   const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partials, const Geo geo,
                   int C, int N) {
  dgrad_pipelined<BM, BNC, PROLOGUE>(dy, y, ds, dq, w, x, a, b, dx, partials, geo, C, N);
}

template <int BM, int BNC>
__global__ void __launch_bounds__(THREADS, BM * BNC <= 64 * 64 ? 2 : 1)
    dgrad_3x3_bf16(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ ds, const float* __restrict__ dq,
                   const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partials, const Geo geo,
                   int C, int N) {
  dgrad_3x3_rows<BM, BNC>(dy, y, ds, dq, w, x, a, b, dx, partials, geo, C, N);
}

// The weight gradient's block: BC rows of dw (input channels of one tap) x
// BNW columns (output channels), 8 warps of 32 x BNW / WARPS_N; a stage holds
// x (then z) [PK][BC] and dy (then dyt) and y [PK][BNW], PK pixels as they
// lie in memory.
template <int BC, int BNW>
struct WgradTile {
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
  static_assert(STAGES * XROUNDS <= 32, "one bit a stage's x chunk in x_in");
};

// out[blockIdx.y][taps * C][N] = z^T dyt over this split's pixels (out = dw
// itself when there is one split).  Nine taps: a block's rows lie in one tap,
// its x rows are read at p + off(tap), and z is 0 outside the image (the
// padding comes after the prologue).
template <int TAPS, int BC, int BNW, bool PROLOGUE>
__device__ __forceinline__ void wgrad_pipelined(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds,
    const float* __restrict__ dq, float* __restrict__ out, const Geo geo, int C, int N,
    int steps_per_split) {
  using bf16 = __nv_bfloat16;
  using Wt = WgradTile<BC, BNW>;
  constexpr int XCH = BC / G, GCH = BNW / G;  // 16-byte chunks in a stage row
  // z rounds (with the prologue) and dyt rounds, spread over the mma steps
  constexpr int UNITS = (PROLOGUE ? Wt::XROUNDS : 0) + Wt::GROUNDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int M = geo.M;
  const int n_tiles = (N + BNW - 1) / BNW;
  const int ct = blockIdx.x / n_tiles;  // (tap, channel tile)
  const int c_tiles = (C + BC - 1) / BC;
  const int tap = TAPS == 9 ? ct / c_tiles : 0;
  const int c0 = (TAPS == 9 ? ct % c_tiles : ct) * BC;
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

  // Nine taps: the image row and column of each x round's pixel in the next
  // stage to load, stepped by PK pixels a stage (load() runs over the stages
  // in order), so no stage divides; bit (k % STAGES) * XROUNDS + i of x_in
  // is set where round i's x chunk of stage k was read inside the image.
  int xh[Wt::XROUNDS], xw[Wt::XROUNDS];
  uint32_t x_in = 0;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;  // off(tap)
  const int step_w = TAPS == 9 ? PK % geo.W : 0, step_h = TAPS == 9 ? (PK / geo.W) % geo.H : 0;
  if constexpr (TAPS == 9) {
#pragma unroll
    for (int i = 0; i < Wt::XROUNDS; ++i) {
      const int p = p_begin + (tid + i * THREADS) / XCH;
      xw[i] = p % geo.W;
      xh[i] = (p / geo.W) % geo.H;
    }
  }

  auto load = [&](int k) {
    bf16* sx = smem + (k % Wt::STAGES) * Wt::STAGE;
    bf16* sd = sx + Wt::XT;
    bf16* sy = sd + Wt::GT;
    const int p0 = p_begin + k * PK;
#pragma unroll
    for (int i = 0; i < Wt::XROUNDS; ++i) {
      const int r = (tid + i * THREADS) / XCH;
      bool ok = p0 + r < p_end && c_in;
      int src = p0 + r;
      if constexpr (TAPS == 9) {
        const int hh = xh[i] + dh, ww = xw[i] + dw;
        ok = ok && hh >= 0 && hh < geo.H && ww >= 0 && ww < geo.W;
        src += dh * geo.W + dw;
        const uint32_t bit = 1u << ((k % Wt::STAGES) * Wt::XROUNDS + i);
        x_in = ok ? (x_in | bit) : (x_in & ~bit);
        xw[i] += step_w;  // on to the next stage's pixel
        xh[i] += step_h;
        if (xw[i] >= geo.W) {
          xw[i] -= geo.W;
          ++xh[i];
        }
        if (xh[i] >= geo.H) xh[i] -= geo.H;
      }
      cp_async16(sx + r * Wt::LDX + cc,
                 x + (ok ? static_cast<size_t>(src) * C + c0 + cc : 0), ok);
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
  // else dyt over dy; zeros past the split's pixels, outside the image and
  // past C and N.  fetch() reads every round's chunks at once, so their
  // latencies overlap.
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
      bool in;
      if constexpr (TAPS == 9) {
        in = (x_in >> ((k % Wt::STAGES) * Wt::XROUNDS + u)) & 1u;
      } else {
        in = p0 + r < p_end && c_in;
      }
      if (!in) zero8(f);
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

  // Nine taps: acc holds one stage's products, and `sum` adds them up with
  // IEEE adds.  The tensor cores' float32 accumulation truncates the products
  // it adds, a bias toward zero that grows with the chain: a 16384-pixel
  // split drifted 6.4e-5 * max from the float64 dw, so no chain runs longer
  // than a stage's PK pixels.  (Adding every 4 or 16 stages measured the
  // same within 3%.)  At one tap the chains are shorter.
  float acc[Wt::MF][Wt::NF][4], sum[Wt::MF][Wt::NF][4];
#pragma unroll
  for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
    for (int j = 0; j < Wt::NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = sum[i][j][r] = 0.f;

  // the ring as in dgrad_pipelined
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
    if constexpr (TAPS == 9) {
#pragma unroll
      for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
        for (int j = 0; j < Wt::NF; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sum[i][j][r] = __fadd_rn(sum[i][j][r], acc[i][j][r]);
            acc[i][j][r] = 0.f;
          }
    }
  }
  cp_async_wait<0>();
  if constexpr (TAPS == 9) {
#pragma unroll
    for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
      for (int j = 0; j < Wt::NF; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = sum[i][j][r];
  }

  const int g = lane / 4, t = lane % 4;
  float* dst = out + static_cast<size_t>(blockIdx.y) * TAPS * C * N;
#pragma unroll
  for (int j = 0; j < Wt::NF; ++j) {
    const int col = n0 + wn0 + j * 8 + t * 2;
#pragma unroll
    for (int i = 0; i < Wt::MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c0 + wc0 + i * 16 + g + 8 * h;
        if (row < C && col < N) {
          store2(dst + static_cast<size_t>(tap * C + row) * N + col, acc[i][j][2 * h],
                 acc[i][j][2 * h + 1]);
        }
      }
  }
}

template <int BC, int BNW, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_1x1_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
                   const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds,
                   const float* __restrict__ dq, float* __restrict__ out, const Geo geo, int C,
                   int N, int steps_per_split) {
  wgrad_pipelined<1, BC, BNW, PROLOGUE>(x, a, b, dy, y, ds, dq, out, geo, C, N,
                                        steps_per_split);
}

template <int BC, int BNW>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_3x3_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
                   const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds,
                   const float* __restrict__ dq, float* __restrict__ out, const Geo geo, int C,
                   int N, int steps_per_split) {
  wgrad_pipelined<9, BC, BNW, true>(x, a, b, dy, y, ds, dq, out, geo, C, N, steps_per_split);
}

// ================================================= bf16 forward, pipelined
//
// Replaces, for bf16, the TPU kernels `_mm_fwd_kernel`
// (iswm_tpu/ops/pallas/fused_block.py:60, called at :130, reached from
// matmul_bn_stats :192) with fwd_1x1_bf16 and `_c3_fwd_kernel` (:224,
// called at :396, reached from conv3x3_bn_stats :470) with fwd_3x3_bf16,
// in the place of conv_fwd<bf16, *, *>.  Same arithmetic and rounding
// points as conv_fwd: z = rd(relu(x a + b)) with ActLoader::fetch's IEEE
// multiply and add, the padding after the prologue, y = rd(sum z w), s and q
// over the rounded y; only the order of the float32 sums differs.
//
// What bounds it: the 1x1 does 2 M C N operations on M C + M N bf16 values,
// so eight of the slice's 11 shapes are bound by bytes and layer4.0's three
// by the tensor cores; every 3x3 shape does nine times the operations on the
// same bytes and is bound by the tensor cores.  Each is the data gradient of
// its backward turned around, with x in the place of dy and y:
//   - fwd_pipelined (1x1) runs dgrad_pipelined's ring: 4 stages of
//     cp.async.cg, PK = 64 input channels deep, bring the raw x tile, w's
//     rows and the stage's a, b straight into shared memory; with the
//     prologue, z is formed in place one stage ahead (each thread over the
//     chunks it copied, one barrier a stage), rows past M zeroed there so
//     that relu(b) does not enter s and q; without it a stage is a copy.
//     Fragments by ldmatrix, products by mma.sync; a block may walk several
//     column tiles through one ring (see plan_fwd).  (The same body on
//     wgmma measured no faster: 128 x 128 tiles 1-2% faster, 128 x 64 ones
//     3-12% slower; block_bwd_ab.py --kind mm_fwd);
//   - fwd_3x3_rows runs dgrad_3x3_rows's ring over (kernel row ky, PK3 = 32
//     input channels) stages.  Pixel p's three taps in row ky read z at
//     p + (ky - 1) W + kx - 1, so a stage copies the BM + 2 raw x rows from
//     m0 + (ky - 1) W - 1 on, with the three w tiles of taps 3 ky + kx, and
//     tap kx reads them from row kx on: z is formed once for three taps,
//     where conv_fwd recomputed it for all nine.  A row is another pixel's
//     (or a zero-filled row's relu(b)) where a tap reads outside the image,
//     so each lane keeps a 9-bit mask of the taps its accumulator rows read
//     inside the image and zeroes the A fragments of the others after
//     ldmatrix: the padding stays after the prologue.  The products are
//     wgmma's, A (those masked fragments) from registers, B (w) from shared
//     memory in the 64-byte swizzle (see Fwd3x3Stage): 0.9104 -> 0.7945 ms a
//     step against the same body on mma.sync (block_bwd_ab.py);
//   - a block covers up to 128 x 128 outputs, so x is read and transformed
//     ceil(N / 128) times where conv_fwd read it ceil(N / 64) times;
//   - fwd_epilogue rounds the accumulators to bf16, stages the tile through
//     free shared memory and writes y in coalesced 16-byte stores, and takes
//     the column sums of the rounded values into partials[m tile][2][N]
//     (tile_column_sums; finish() adds them in block order: no atomics, so
//     two launches give the same bits);
//   - plan_fwd takes the tile from the shape alone, counting waves of blocks
//     on 132 SMs.

// A 1x1 forward block: BM pixels x BN output channels, 8 warps of 32 rows in
// BM / 32 rows of warps.
template <int BM_, int BN_>
struct FwdTile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int NF = BN / WARPS_N / 8;
  static_assert(WARPS_M * WARPS_N * 32 == THREADS && NF % 2 == 0, "8 warps, x4 B loads");
};

// The 1x1 stage: x (then z) [BM][PK], w [BN][PK], a and b [PK] f32.
template <int BM, int BN>
struct Fwd1x1Stage {
  static constexpr int LD = PK + PAD;
  static constexpr int CH = PK / G;  // 16-byte chunks in a row
  static constexpr int XT = BM * LD;
  static constexpr int ELEMS = XT + BN * LD + 4 * PK;  // bf16 elements
  static constexpr int ROUNDS = BM * CH / THREADS;     // x chunks a thread copies (and forms)
  static constexpr int WROUNDS = BN * CH / THREADS;
  static constexpr int STEPS = PK / 16;
  static_assert(ROUNDS * THREADS == BM * CH && WROUNDS * THREADS == BN * CH, "whole rounds");
  static_assert(STEPS % ROUNDS == 0 && ELEMS % 8 == 0, "z rounds spread over the mma steps");
};

// A block's accumulators (rows m0 + wm0 + 16 i + g + 8 h, columns n0 + wn0 +
// 8 j + 2 t + e; WARPS_M rows of warps) rounded to bf16: staged in shared
// memory at `region`, written to y in 16-byte rows of chunks, and their
// column sums and sums of squares into partials[m tile][2][N].  Rows past M
// and columns past N hold zeros (the stages zero them), so they add nothing
// to the sums.  The region (epilogue_bytes) must be free.
template <int BM, int BN, int WARPS_M>
constexpr int epilogue_bytes() {
  return BM * (BN + PAD) * 2 + 2 * WARPS_M * BN * 4;
}

template <int BM, int BN, int MF, int NF, int WARPS_M>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[MF][NF][4],
                                             unsigned char* region,
                                             __nv_bfloat16* __restrict__ y,
                                             float* __restrict__ partials, int M, int N,
                                             int m0, int n0, int mt, int wm0, int wn0,
                                             int warp_row) {
  using bf16 = __nv_bfloat16;
  constexpr int OUT_LD = BN + PAD;
  static_assert(BM * OUT_LD * 2 % 16 == 0, "16-byte aligned column sums");
  bf16* out = reinterpret_cast<bf16*>(region);
  float* red = reinterpret_cast<float*>(region + BM * OUT_LD * 2);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float cs[NF][2], cq[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
    const int col = wn0 + j * 8 + t * 2;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + i * 16 + g + 8 * h;
        const float v0 = round_to<bf16>(acc[i][j][2 * h]);
        const float v1 = round_to<bf16>(acc[i][j][2 * h + 1]);
        store2(out + row * OUT_LD + col, v0, v1);
        cs[j][0] += v0;
        cs[j][1] += v1;
        cq[j][0] += v0 * v0;
        cq[j][1] += v1 * v1;
      }
  }
  float* part = partials + static_cast<size_t>(mt) * 2 * N;
  // its barrier also publishes the staged tile
  tile_column_sums<NF, WARPS_M, BN>(cs, cq, warp_row, wn0, red, part, part + N, n0, N);
  constexpr int CH = BN / G;
  for (int v = threadIdx.x; v < BM * CH; v += THREADS) {
    const int r = v / CH, c = (v % CH) * G;
    if (m0 + r < M && n0 + c < N) {
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + r) * N + n0 + c) =
          raw8(out + r * OUT_LD + c);
    }
  }
}

// y = rd(z w^T) over BM pixels and the block's NT (or fewer) column tiles of
// BN output channels, one after another through one ring, and each tile's
// column sums of y and y^2.  Stage k holds input channels 64 (k % kper).. of
// x and of column tile t0 + k / kper's w (kper stages a tile), so the next
// tile's copies are in flight while a tile's epilogue runs; that epilogue
// then stages y in a region of its own after the ring.
template <int BM, int BN, bool PROLOGUE>
__device__ __forceinline__ void fwd_pipelined(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ w,
                                              const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              __nv_bfloat16* __restrict__ y,
                                              float* __restrict__ partials, int M, int C, int N,
                                              int nt) {
  using bf16 = __nv_bfloat16;
  using F = FwdTile<BM, BN>;
  using S = Fwd1x1Stage<BM, BN>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_tiles = (N + BN - 1) / BN;
  const int groups = (n_tiles + nt - 1) / nt;
  const int mt = blockIdx.x / groups;
  const int m0 = mt * BM;
  const int t0 = (blockIdx.x % groups) * nt;  // the block's first column tile
  const int tiles = n_tiles - t0 < nt ? n_tiles - t0 : nt;
  const int kper = (C + PK - 1) / PK;  // stages a column tile
  const int ksteps = tiles * kper;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_row = warp / F::WARPS_N;
  const int wm0 = warp_row * 32;
  const int wn0 = (warp % F::WARPS_N) * (BN / F::WARPS_N);
  const int kc = (tid % S::CH) * G;  // a thread's chunk of channels in every round
  auto n0_of = [&](int k) { return (t0 + k / kper) * BN; };
  auto k0_of = [&](int k) { return (k % kper) * PK; };

  auto stage = [&](int k) { return smem + (k % RING) * S::ELEMS; };
  auto vectors = [&](int k) { return reinterpret_cast<float*>(stage(k) + S::XT + BN * LD); };
  auto load = [&](int k) {
    bf16* sx = stage(k);
    bf16* sw = sx + S::XT;
    const int k0 = k0_of(k), n0 = n0_of(k);
    const bool c_in = k0 + kc < C;
#pragma unroll
    for (int i = 0; i < S::ROUNDS; ++i) {
      const int r = (tid + i * THREADS) / S::CH;
      const bool ok = m0 + r < M && c_in;
      cp_async16(sx + r * LD + kc, x + (ok ? static_cast<size_t>(m0 + r) * C + k0 + kc : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < S::WROUNDS; ++i) {
      const int r = (tid + i * THREADS) / S::CH;
      const bool ok = n0 + r < N && c_in;
      cp_async16(sw + r * LD + kc, w + (ok ? static_cast<size_t>(n0 + r) * C + k0 + kc : 0), ok);
    }
    if (PROLOGUE && tid < PK / 2) {  // a then b, four floats a copy; zeros past C
      const int c = k0 + (tid % (PK / 4)) * 4;
      const float* v = tid < PK / 4 ? a : b;
      cp_async16(vectors(k) + (tid / (PK / 4)) * PK + (tid % (PK / 4)) * 4, v + (c < C ? c : 0),
                 c < C);
    }
  };

  // z over stage k's x tile, in place, in rounds, as dgrad_pipelined forms
  // dyt: fetch_z reads every round's chunk and the chunk's a, b at once;
  // form_z writes round i, zeros past M and C
  uint4 raw[S::ROUNDS];
  float sa[G], sb[G];
  auto fetch_z = [&](int k) {
    const bf16* sx = stage(k);
    load8(vectors(k) + kc, sa);
    load8(vectors(k) + PK + kc, sb);
#pragma unroll
    for (int i = 0; i < S::ROUNDS; ++i) raw[i] = raw8(sx + (tid + i * THREADS) / S::CH * LD + kc);
  };
  auto form_z = [&](int k, int i) {
    const int r = (tid + i * THREADS) / S::CH;
    float f[G];
    unpack8(raw[i], f);
#pragma unroll
    for (int e = 0; e < G; ++e) f[e] = fmaxf(affine(f[e], sa[e], sb[e]), 0.f);  // store8 rounds
    if (m0 + r >= M || k0_of(k) + kc >= C) zero8(f);
    store8(stage(k) + r * LD + kc, f);
  };
  auto fragments = [&](const bf16* sx, const bf16* sw, int kk, uint32_t (&af)[2][4],
                       uint32_t (&bfr)[F::NF][2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(af[i], sx + (wm0 + 16 * i + lane % 16) * LD + 16 * kk + (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < F::NF; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, sw + (wn0 + 8 * j + lane % 8 + (lane / 16) * 8) * LD + 16 * kk +
                     ((lane / 8) % 2) * 8);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
  };

  float acc[2][F::NF][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < F::NF; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  };
  clear();

  // The ring as in dgrad_pipelined: with the prologue, stage k is multiplied
  // while stage k + 1's z is formed and stages k + 2 .. k + RING - 1 are in
  // flight; without it, stage k is multiplied while k + 1 .. k + RING - 1 are.
#pragma unroll
  for (int st = 0; st < RING - 1; ++st) {
    if (st < ksteps) load(st);
    cp_async_commit();
  }
  if constexpr (PROLOGUE) {
    cp_async_wait<RING - 2>();
    __syncthreads();
    fetch_z(0);
#pragma unroll
    for (int i = 0; i < S::ROUNDS; ++i) form_z(0, i);
  }
  for (int k = 0; k < ksteps; ++k) {
    if constexpr (PROLOGUE) {
      cp_async_wait<RING - 3>();  // stage k + 1 has landed
    } else {
      cp_async_wait<RING - 2>();  // stage k has landed
    }
    __syncthreads();  // ... for every thread; stage k's z is whole; k - 1 is free
    if (k + RING - 1 < ksteps) load(k + RING - 1);
    cp_async_commit();
    const bool next = PROLOGUE && k + 1 < ksteps;
    if (next) fetch_z(k + 1);
    const bf16* sx = stage(k);
    const bf16* sw = sx + S::XT;
#pragma unroll
    for (int kk = 0; kk < S::STEPS; ++kk) {
      constexpr int EVERY = S::STEPS / S::ROUNDS;
      if (next && kk % EVERY == 0) form_z(k + 1, kk / EVERY);
      uint32_t af[2][4], bfr[F::NF][2];
      fragments(sx, sw, kk, af, bfr);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < F::NF; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    if (tiles > 1 && k % kper == kper - 1) {  // a column tile is whole
      const int ring = ksteps < RING ? ksteps : RING;
      fwd_epilogue<BM, BN, 2, F::NF, F::WARPS_M>(acc, smem_raw + ring * S::ELEMS * 2, y,
                                                 partials, M, N, m0, n0_of(k), mt, wm0, wn0,
                                                 warp_row);
      clear();
    }
  }
  if (tiles == 1) {
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the epilogue
    fwd_epilogue<BM, BN, 2, F::NF, F::WARPS_M>(acc, smem_raw, y, partials, M, N, m0, n0_of(0),
                                               mt, wm0, wn0, warp_row);
  }
}

// ---------------------------------------------------- wgmma for the 3x3

// A K-major wgmma operand in shared memory with the 64-byte swizzle: rows of
// 64 bytes whose 16-byte chunk c sits at c ^ ((row / 2) % 4), in atoms of 8
// rows (512 bytes, 512-byte aligned), `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t{1} << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{2} << 62;
}
// Byte offset of byte `kbyte` (< 64) of row r of such an operand.
__device__ __forceinline__ int sw64(int r, int kbyte) {
  return r * 64 + ((((kbyte >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (kbyte & 15);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Makes this thread's shared-memory writes (landed cp.async copies) visible
// to wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving the accumulators across an async wgmma.
template <int NF>
__device__ __forceinline__ void fence_operands(float (&d)[NF][4]) {
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// D[64 x 128] f32 += A[64 x 16] bf16 x B[128 x 16]^T bf16, one warpgroup: A from
// registers, each warp's 16 rows in mma_bf16's A layout; B K-major in shared
// memory; D in mma_bf16's accumulator layout of each warp's 16 rows, n8
// block j in d[j].
__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
// D[64 x 64] f32 += A[64 x 16] bf16 x B[64 x 16]^T bf16, one warpgroup: A from
// registers, each warp's 16 rows in mma_bf16's A layout; B K-major in shared
// memory; D in mma_bf16's accumulator layout of each warp's 16 rows, n8
// block j in d[j].
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The 3x3 stage of kernel row ky: the three w tiles of taps 3 ky + kx
// [3][BN][PK3] in wgmma's 64-byte swizzle (a PK3-deep row is 64 bytes), then
// the BM + 2 x (then z) rows [BM + 2][PK3 + PAD] for ldmatrix, then a and b
// [PK3] f32.  A block is 128 pixels x BN; warp v holds rows 16 v .. 16 v +
// 15 and all BN columns, its warpgroup's 64 rows multiplied by m64nBNk16
// wgmma.  A stage's six products are issued at once and run while stage
// k + 1's z is formed; at BN = 128 they also run on over the next stage's
// barrier, copies and fragments (one group in flight, a fifth ring slot for
// it: 0.7825 -> 0.7699 ms a step); at BN = 64 a ring of five would not fit
// two blocks an SM, so each group is waited for within its stage.
template <int BN>
struct Fwd3x3Stage {
  static constexpr int BM = 128;
  static constexpr bool OVERLAP = BN == 128;  // a stage's group still in flight over the next
  static constexpr int SLOTS = OVERLAP ? RING + 1 : RING;
  static constexpr int AHEAD = RING - 1;  // stages copied ahead of the one multiplied
  static constexpr int LD = PK3 + PAD;  // 80-byte rows: ldmatrix's 8 rows hit 8 bank groups
  static constexpr int CH = PK3 / G;    // 16-byte chunks in a row
  static constexpr int RT = BM + 2;     // the block's pixels and one more on each side
  static constexpr int WBYTES = BN * PK3 * 2;       // one tap's swizzled w tile
  static constexpr int XOFF = 3 * WBYTES;           // the z rows' byte offset
  static constexpr int VOFF = XOFF + RT * LD * 2;   // a's and b's
  static constexpr int BYTES = (VOFF + 2 * PK3 * 4 + 511) / 512 * 512;  // whole swizzle atoms
  static constexpr int ROUNDS = (RT * CH + THREADS - 1) / THREADS;  // the last round in part
  static constexpr int WROUNDS = 3 * BN * CH / THREADS;
  static constexpr int NF = BN / 8;
  static_assert(PK3 * 2 == 64, "a w row is one 64-byte swizzle row");
  static_assert(WROUNDS * THREADS == 3 * BN * CH && THREADS % CH == 0, "whole copy rounds");
  static_assert(XOFF % 16 == 0 && VOFF % 16 == 0, "16-byte aligned rows");
};

// y = rd(sum_tap z[p + off(tap)] w[tap]) over 128 pixels and BN output
// channels, and the block's column sums of y and y^2; see the note above.
template <int BN>
__device__ __forceinline__ void fwd_3x3_rows(const __nv_bfloat16* __restrict__ x,
                                             const __nv_bfloat16* __restrict__ w,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             __nv_bfloat16* __restrict__ y,
                                             float* __restrict__ partials, const Geo geo, int C,
                                             int N) {
  using bf16 = __nv_bfloat16;
  using S = Fwd3x3Stage<BN>;
  constexpr int BM = S::BM, LD = S::LD, NF = S::NF;
  extern __shared__ __align__(1024) unsigned char smem_wg[];  // whole swizzle atoms
  const int M = geo.M;
  const int n_tiles = (N + BN - 1) / BN;
  const int mt = blockIdx.x / n_tiles;
  const int m0 = mt * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int row_steps = (C + PK3 - 1) / PK3;
  const int ksteps = 3 * row_steps;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = warp * 16;
  const int kc = (tid % S::CH) * G;

  // bit `tap` of taps_in[h] is set where this lane's accumulator row
  // wm0 + lane / 4 + 8 h reads z inside the image at that tap
  uint32_t taps_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + wm0 + lane / 4 + 8 * h;
    uint32_t mask = 0;
    if (p < M) {
      const int pw = p % geo.W, ph = (p / geo.W) % geo.H;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
        if (hh >= 0 && hh < geo.H && ww >= 0 && ww < geo.W) mask |= 1u << tap;
      }
    }
    taps_in[h] = mask;
  }
  auto ky_of = [&](int k) { return k / row_steps; };
  auto c0_of = [&](int k) { return (k % row_steps) * PK3; };
  auto pixel_of = [&](int k, int j) { return m0 + (ky_of(k) - 1) * geo.W - 1 + j; };
  auto chunk_in = [&](int k, int i) {
    const int q = pixel_of(k, (tid + i * THREADS) / S::CH);
    return q >= 0 && q < M && c0_of(k) + kc < C;
  };
  auto stage = [&](int k) { return smem_wg + (k % S::SLOTS) * S::BYTES; };
  auto zrows = [&](int k) { return reinterpret_cast<bf16*>(stage(k) + S::XOFF); };
  auto vectors = [&](int k) { return reinterpret_cast<float*>(stage(k) + S::VOFF); };
  auto load = [&](int k) {
    const int ky = ky_of(k), c0 = c0_of(k);
#pragma unroll
    for (int i = 0; i < S::ROUNDS; ++i) {
      const int j = (tid + i * THREADS) / S::CH;
      if (j < S::RT) {
        const bool ok = chunk_in(k, i);
        const size_t at = ok ? static_cast<size_t>(pixel_of(k, j)) * C + c0 + kc : 0;
        cp_async16(zrows(k) + j * LD + kc, x + at, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < S::WROUNDS; ++i) {  // w's rows of taps 3 ky .. 3 ky + 2, swizzled
      const int v = (tid + i * THREADS) / S::CH;
      const int kx = v / BN, r = v % BN;
      const bool ok = n0 + r < N && c0 + kc < C;
      cp_async16(stage(k) + kx * S::WBYTES + sw64(r, kc * 2),
                 w + (ok ? static_cast<size_t>(n0 + r) * 9 * C + (3 * ky + kx) * C + c0 + kc
                         : 0),
                 ok);
    }
    if (tid < PK3 / 2) {  // a then b, four floats a copy; zeros past C
      const int c = c0 + (tid % (PK3 / 4)) * 4;
      const float* v = tid < PK3 / 4 ? a : b;
      cp_async16(vectors(k) + (tid / (PK3 / 4)) * PK3 + (tid % (PK3 / 4)) * 4,
                 v + (c < C ? c : 0), c < C);
    }
  };

  // z over stage k's x rows, in place, as fwd_pipelined's: zeros for rows
  // outside [0, M) and channels past C
  uint4 raw[S::ROUNDS];
  float sa[G], sb[G];
  auto fetch_z = [&](int k) {
    load8(vectors(k) + kc, sa);
    load8(vectors(k) + PK3 + kc, sb);
#pragma unroll
    for (int i = 0; i < S::ROUNDS; ++i) {
      const int j = (tid + i * THREADS) / S::CH;
      if (j < S::RT) raw[i] = raw8(zrows(k) + j * LD + kc);
    }
  };
  auto form_z = [&](int k, int i) {
    const int j = (tid + i * THREADS) / S::CH;
    if (j >= S::RT) return;
    float f[G];
    unpack8(raw[i], f);
#pragma unroll
    for (int e = 0; e < G; ++e) f[e] = fmaxf(affine(f[e], sa[e], sb[e]), 0.f);  // store8 rounds
    if (!chunk_in(k, i)) zero8(f);
    store8(zrows(k) + j * LD + kc, f);
  };

  float acc[1][NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[0][j][r] = 0.f;

  // The ring: stage k is multiplied while stage k + 1's z is formed and
  // stages k + 2 .. k + AHEAD are in flight.  Stage k + AHEAD's copies go
  // into the slot of stage k - 2 (k - 1 without the overlap), whose wgmma
  // group the barrier has seen waited for.
#pragma unroll
  for (int st = 0; st < S::AHEAD; ++st) {
    if (st < ksteps) load(st);
    cp_async_commit();
  }
  cp_async_wait<S::AHEAD - 1>();
  fence_proxy_async();  // this thread's landed w copies, for wgmma
  __syncthreads();
  fetch_z(0);
#pragma unroll
  for (int i = 0; i < S::ROUNDS; ++i) form_z(0, i);
  uint32_t af[S::OVERLAP ? 2 : 1][6][4];  // a stage's A fragments, two stages' while one is in flight
  for (int k = 0; k < ksteps; ++k) {
    cp_async_wait<S::AHEAD - 2>();  // stage k + 1 has landed
    fence_proxy_async();
    __syncthreads();  // stage k's z is whole, its w visible to wgmma; its copies' slot is free
    if (k + S::AHEAD < ksteps) load(k + S::AHEAD);
    cp_async_commit();
    const bool next = k + 1 < ksteps;
    if (next) fetch_z(k + 1);
    const int tap0 = 3 * ky_of(k);
    uint32_t (&fr)[6][4] = af[S::OVERLAP ? k % 2 : 0];
    // the stage's A fragments: tap kx = st / 2, k16 step st % 2; the rows
    // whose pixel reads outside the image at that tap zeroed
#pragma unroll
    for (int st = 0; st < 6; ++st) {
      const int kx = st / 2, kk = st % 2;
      ldsm_x4(fr[st], zrows(k) + (wm0 + lane % 16 + kx) * LD + 16 * kk + (lane / 16) * 8);
      if (!((taps_in[0] >> (tap0 + kx)) & 1u)) fr[st][0] = fr[st][2] = 0u;
      if (!((taps_in[1] >> (tap0 + kx)) & 1u)) fr[st][1] = fr[st][3] = 0u;
    }
    fence_operands(acc[0]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 6; ++st) {
      const int kx = st / 2, kk = st % 2;
      wgmma_bf16(acc[0], fr[st], smem_desc_sw64(stage(k) + kx * S::WBYTES + kk * 32, 512));
    }
    wgmma_commit();
    if (next) {
#pragma unroll
      for (int i = 0; i < S::ROUNDS; ++i) form_z(k + 1, i);
    }
    if constexpr (S::OVERLAP) {
      wgmma_wait<1>();  // stage k - 1's group is done: its fragments and slot are free
    } else {
      wgmma_wait<0>();
    }
    fence_operands(acc[0]);
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
  fwd_epilogue<BM, BN, 1, NF, 8>(acc, smem_wg, y, partials, M, N, m0, n0, mt, wm0, 0, warp);
}

// Tiles of 128 x 64 outputs or fewer run two blocks an SM (layer1's 3x3 at
// 128 x 64 on mma.sync: 0.1067 -> 0.0789 ms, block_bwd_ab.py); 128 x 128 one.
template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
    fwd_3x3_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ a, const float* __restrict__ b,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ partials, const Geo geo,
                 int C, int N, int /*nt: one column tile a block*/) {
  fwd_3x3_rows<BN>(x, w, a, b, y, partials, geo, C, N);
}

template <int BM, int BN, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS, BM * BN <= 128 * 64 ? 2 : 1)
    fwd_1x1_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ a, const float* __restrict__ b,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ partials, const Geo geo,
                 int C, int N, int nt) {
  fwd_pipelined<BM, BN, PROLOGUE>(x, w, a, b, y, partials, geo.M, C, N, nt);
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

// The bf16 nine-tap weight gradient's tile and split of the M pixels, from
// the shape alone.  dw has 9 C N outputs and a block's rows lie in one tap.
// The tile is 128x64, 64x128 or 64x64: the second accumulator of
// wgrad_pipelined would give a 128x128 tile 128 floats a thread.
// The partials (8 * 9 C N bytes a part, written and read once) stay within a
// tenth of what the card moves in the call's least time: its bytes, as
// plan_wgrad_1x1 caps them, or, where the call is bound by its operations
// (every #8b shape is), what 3.35 TB/s moves while the tensor cores do them.
// (Capped by the bytes alone, (32768, 128, 128) got 2 splits, 72 blocks, and
// was no faster than the first version's body.)  Within the cap the plan
// with the least estimated time wins, counted in waves: a block takes one
// SM, WAVE_SMS blocks run at once, and a PK-pixel stage of a bc x bn tile
// costs bc bn + 64 x 64: its products plus a share (copies, the transform,
// the barrier) that does not shrink with the tile.  On the card a 64x64
// stage took 0.70 of a 128x64 one (block_bwd_ab.py; the model says 0.67).
// A wave that is partly full costs as much as a full one, so
//   cost = ceil(tiles x splits / WAVE_SMS) x per x stage cost
// prefers plans whose blocks fill their waves; a tie goes to the larger tile
// and the fewer splits.  At the slice: 64x64 at 14 splits (126 blocks) for
// (131072, 64, 64), 128x64 at 5 (90) for (32768, 128, 128), 128x64 at 1
// (72) for (8192, 256, 256) and 128x64 at 1 (288, 2.2 waves) for (8192, 512,
// 512), where 64x64 tiles take 4.4 waves and 128x128 tiles would give 144
// blocks, a second wave 9% full.
constexpr int WAVE_SMS = 132;

constexpr double BYTES_PER_OP = 3.35e12 / 989e12;  // device memory rate / bf16 tensor peak

WgradPlan plan_wgrad_3x3(int M, int C, int N) {
  const double call = 4.0 * M * C + 4.0 * M * N + 6.0 * 9 * C * N;
  const double ops = 2.0 * 2.0 * M * 9.0 * C * N;  // the two halves' products
  const double least = call > ops * BYTES_PER_OP ? call : ops * BYTES_PER_OP;
  const int steps = ceil_div(M, PK);
  int cap = static_cast<int>(0.1 * least / (8.0 * 9 * C * N));
  if (cap > MAX_SPLITS) cap = MAX_SPLITS;
  if (cap > steps) cap = steps;
  if (cap < 1) cap = 1;
  WgradPlan best{64, 64, 1, steps};
  double best_cost = -1.0;
  const int sides[2] = {128, 64};
  for (const int bc : sides) {
    for (const int bn : sides) {
      if ((bc == 128 && C <= 64) || (bn == 128 && N <= 64) || bc * bn > 128 * 64) continue;
      const long long tiles = 9LL * ceil_div(C, bc) * ceil_div(N, bn);
      for (int want = 1; want <= cap; ++want) {
        const int per = ceil_div(steps, want);
        const int splits = ceil_div(steps, per);  // no empty part
        const long long waves = (tiles * splits + WAVE_SMS - 1) / WAVE_SMS;
        const double cost = static_cast<double>(waves) * per * (bc * bn + 64.0 * 64.0);
        if (best_cost < 0.0 || cost < best_cost) {
          best = WgradPlan{bc, bn, splits, per};
          best_cost = cost;
        }
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

// ... and the pipelined ones for bf16, one tap or nine: 64 x 64 blocks, two
// an SM, where C <= 64, else 128 x 128.
template <int TAPS, int BM, int BNC, bool PROLOGUE>
auto dgrad_kernel() {
  if constexpr (TAPS == 1) {
    return dgrad_1x1_bf16<BM, BNC, PROLOGUE>;
  } else {
    static_assert(TAPS == 9 && PROLOGUE, "the 3x3 always has the prologue");
    return dgrad_3x3_bf16<BM, BNC>;
  }
}

template <int TAPS, bool PROLOGUE>
struct DgradLaunch<__nv_bfloat16, TAPS, PROLOGUE> {
  template <int BMP, int BNC>
  static int go(const void* dy, const void* y, const void* ds, const void* dq,
                const void* w_ckn, const void* x, const void* a, const void* b, void* dx,
                float* part, Geo geo, int C, int N, cudaStream_t s, int& rows) {
    using bf16 = __nv_bfloat16;
    static_assert(BMP >= SUMS_ROWS, "iswm_fb_sums_scratch's rows");
    const int steps = TAPS == 1 ? ceil_div(N, PK) : 3 * ceil_div(N, PK3);
    const int stage = TAPS == 1 ? DgradTile<BMP, BNC>::STAGE : DgradRowTile<BMP, BNC>::STAGE;
    const int bytes = static_cast<int>(sizeof(bf16)) * stage * (steps < RING ? steps : RING);
    const auto kernel = dgrad_kernel<TAPS, BMP, BNC, PROLOGUE>();
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows = ceil_div(geo.M, BMP);
    kernel<<<rows * ceil_div(C, BNC), THREADS, bytes, s>>>(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
        static_cast<const float*>(ds), static_cast<const float*>(dq),
        static_cast<const bf16*>(w_ckn), static_cast<const bf16*>(x),
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<bf16*>(dx),
        part, geo, C, N);
    return 0;
  }

  static int run(const void* dy, const void* y, const void* ds, const void* dq,
                 const void* w_ckn, const void* x, const void* a, const void* b, void* dx,
                 float* part, Geo geo, int C, int N, cudaStream_t s, int& rows) {
    if (C <= 64)
      return go<64, 64>(dy, y, ds, dq, w_ckn, x, a, b, dx, part, geo, C, N, s, rows);
    return go<128, 128>(dy, y, ds, dq, w_ckn, x, a, b, dx, part, geo, C, N, s, rows);
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

// ... and the pipelined ones for bf16, one tap or nine.
template <int TAPS, int BC, int BNW, bool PROLOGUE>
auto wgrad_kernel() {
  if constexpr (TAPS == 1) {
    return wgrad_1x1_bf16<BC, BNW, PROLOGUE>;
  } else {
    static_assert(TAPS == 9 && PROLOGUE, "the 3x3 always has the prologue");
    return wgrad_3x3_bf16<BC, BNW>;
  }
}

template <int TAPS, bool PROLOGUE>
struct WgradLaunch<__nv_bfloat16, TAPS, PROLOGUE> {
  template <int BC, int BNW>
  static int go(const void* x, const void* a, const void* b, const void* dy, const void* y,
                const void* ds, const void* dq, float* out, Geo geo, int C, int N, int splits,
                int per, cudaStream_t s) {
    using bf16 = __nv_bfloat16;
    using Wt = WgradTile<BC, BNW>;
    const int bytes = static_cast<int>(sizeof(bf16)) * Wt::STAGE *
                      (per < Wt::STAGES ? per : Wt::STAGES);
    const auto kernel = wgrad_kernel<TAPS, BC, BNW, PROLOGUE>();
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(TAPS * ceil_div(C, BC) * ceil_div(N, BNW), splits);
    kernel<<<grid, THREADS, bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
        static_cast<const float*>(ds), static_cast<const float*>(dq), out, geo, C, N, per);
    return 0;
  }

  static int run(const void* x, const void* a, const void* b, const void* dy, const void* y,
                 const void* ds, const void* dq, float* part, void* dw, Geo geo, int C, int N,
                 cudaStream_t s, int& parts) {
    const WgradPlan p = TAPS == 1 ? plan_wgrad_1x1(geo.M, C, N) : plan_wgrad_3x3(geo.M, C, N);
    parts = p.splits > 1 ? p.splits : 0;
    float* out = parts ? part : static_cast<float*>(dw);
    if constexpr (TAPS == 1) {  // not planned for nine taps: see plan_wgrad_3x3
      if (p.bc == 128 && p.bn == 128)
        return go<128, 128>(x, a, b, dy, y, ds, dq, out, geo, C, N, p.splits, p.per, s);
    }
    if (p.bc == 128)
      return go<128, 64>(x, a, b, dy, y, ds, dq, out, geo, C, N, p.splits, p.per, s);
    if (p.bn == 128)
      return go<64, 128>(x, a, b, dy, y, ds, dq, out, geo, C, N, p.splits, p.per, s);
    return go<64, 64>(x, a, b, dy, y, ds, dq, out, geo, C, N, p.splits, p.per, s);
  }
};

// The bf16 forward's plan, from the shape alone.  The 1x1's tile: 128 x
// 128, or 64 x 128 or 128 x 64 at two blocks an SM, or, where N <= 64, 64 x
// 64 at two; the 3x3's (fwd_3x3_rows's 128 rows): 128 x 128, or 128 x 64 at
// two.  A wave is the blocks that run at once (132 SMs times the blocks an
// SM holds, which is one where the blocks do not fill the card once); it
// costs, for each stage, the products of the blocks an SM holds plus a share
// of 64 x 64 (copies, the transform, the barrier) that two blocks on one SM
// hide once.  The tile with the fewest waves x cost wins, which separates
// the tiles only where M is small; at the slice's shapes they tie, and the
// order below, fitted to block_bwd_ab.py --sweep on the card, decides:
//   - the 3x3, and the 1x1 without the prologue where a column tile takes
//     several stages: 128 x 128 first (the fewest L2 re-reads of x and w),
//     then 64 x 128, 128 x 64, 64 x 64;
//   - the 1x1 with the prologue: 64 x 128 first, whose sixteen warps an SM
//     hide the transform (0.0401 against 0.0452 ms at (8192, 256, 1024));
//   - the 1x1 without it and one stage a column tile (C <= 64): 128 x 64.
// Where a 1x1 column tile is one stage, a block walks two of them (nt = 2)
// if that still gives a wave of blocks, so that one tile's fill and epilogue
// overlap the other's copies ((131072, 64, 256): 0.0787 -> 0.0572 ms; more
// tiles, or more stages a tile, measured slower).  At the slice: 128 x 64
// where N = 64; else the 3x3 128 x 128, the 1x1 with the prologue 64 x 128
// (two tiles a block at C = 64), without it 128 x 128 (128 x 64 and two
// tiles at C = 64).
struct FwdPlan {
  int bm, bn, nt;
};

constexpr int FWD_MAX_NT = 8;  // column tiles a 1x1 block may walk (the planned entry)

int fwd_fit(int bm, int bn) { return bm * bn <= 128 * 64 ? 2 : 1; }

FwdPlan plan_fwd(int M, int C, int N, int taps, bool prologue) {
  const bool one_stage = taps == 1 && C <= PK;
  FwdPlan order[4] = {{128, 128, 1}, {64, 128, 1}, {128, 64, 1}, {64, 64, 1}};
  if (taps == 1 && prologue) {
    order[0] = {64, 128, 1};
    order[1] = {128, 128, 1};
  } else if (one_stage) {
    order[0] = {128, 64, 1};
    order[1] = {128, 128, 1};
    order[2] = {64, 128, 1};
  }
  FwdPlan best{0, 0, 1};
  double best_cost = -1.0;
  for (const FwdPlan& p : order) {
    if ((p.bn == 128 && N <= 64) || (p.bm * p.bn == 64 * 64 && N > 64) ||
        (taps == 9 && p.bm == 64)) {
      continue;
    }
    const long long blocks = static_cast<long long>(ceil_div(M, p.bm)) * ceil_div(N, p.bn);
    const int held = blocks > WAVE_SMS ? fwd_fit(p.bm, p.bn) : 1;
    const long long waves = (blocks + WAVE_SMS * held - 1) / (WAVE_SMS * held);
    const double cost = static_cast<double>(waves) * (held * p.bm * p.bn + 64.0 * 64.0);
    if (best_cost < 0.0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  const int n_tiles = ceil_div(N, best.bn);
  if (one_stage && n_tiles >= 2 &&
      static_cast<long long>(ceil_div(M, best.bm)) * ceil_div(n_tiles, 2) >=
          WAVE_SMS * fwd_fit(best.bm, best.bn)) {
    best.nt = 2;
  }
  return best;
}

// Dynamic shared memory of a forward block: its ring, and the epilogue's
// staged tile and column sums, after the ring where a block walks several
// column tiles, else in it where they are smaller.
template <int TAPS, int BM, int BN>
int fwd_smem_bytes(int C, int nt) {
  const int steps = TAPS == 1 ? nt * ceil_div(C, PK) : 3 * ceil_div(C, PK3);
  const int stage = TAPS == 1 ? 2 * Fwd1x1Stage<BM, BN>::ELEMS : Fwd3x3Stage<BN>::BYTES;
  const int slots = TAPS == 1 ? RING : Fwd3x3Stage<BN>::SLOTS;
  const int ring = stage * (steps < slots ? steps : slots);
  const int epilogue = TAPS == 1 ? epilogue_bytes<BM, BN, FwdTile<BM, BN>::WARPS_M>()
                                 : epilogue_bytes<BM, BN, 8>();
  if (nt > 1) return ring + epilogue;
  return ring > epilogue ? ring : epilogue;
}

template <int TAPS, int BM, int BN, bool PROLOGUE>
auto fwd_kernel() {
  if constexpr (TAPS == 1) {
    return fwd_1x1_bf16<BM, BN, PROLOGUE>;
  } else {
    static_assert(TAPS == 9 && PROLOGUE && BM == 128, "the 3x3: the prologue, 128 rows");
    return fwd_3x3_bf16<BN>;
  }
}

// One bf16 forward launch under a tile; m_tiles: the rows of partials.
template <int TAPS, bool PROLOGUE>
struct FwdLaunch {
  template <int BM, int BN>
  static int go(const void* x, const void* w_nk, const void* a, const void* b, void* y,
                float* part, Geo geo, int C, int N, int nt, cudaStream_t s, int& m_tiles) {
    using bf16 = __nv_bfloat16;
    static_assert(BM >= SUMS_ROWS, "iswm_fb_sums_scratch's rows");
    if (nt < 1 || nt > FWD_MAX_NT || (TAPS == 9 && nt != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = fwd_smem_bytes<TAPS, BM, BN>(C, nt);
    const auto kernel = fwd_kernel<TAPS, BM, BN, PROLOGUE>();
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    m_tiles = ceil_div(geo.M, BM);
    kernel<<<m_tiles * ceil_div(ceil_div(N, BN), nt), THREADS, bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_nk),
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<bf16*>(y), part,
        geo, C, N, nt);
    return 0;
  }

  static int run(FwdPlan p, const void* x, const void* w_nk, const void* a, const void* b,
                 void* y, float* part, Geo geo, int C, int N, cudaStream_t s, int& m_tiles) {
    if (p.bm == 128 && p.bn == 128)
      return go<128, 128>(x, w_nk, a, b, y, part, geo, C, N, p.nt, s, m_tiles);
    if (p.bm == 128 && p.bn == 64)
      return go<128, 64>(x, w_nk, a, b, y, part, geo, C, N, p.nt, s, m_tiles);
    if constexpr (TAPS == 1) {
      if (p.bm == 64 && p.bn == 128)
        return go<64, 128>(x, w_nk, a, b, y, part, geo, C, N, p.nt, s, m_tiles);
      if (p.bm == 64 && p.bn == 64)
        return go<64, 64>(x, w_nk, a, b, y, part, geo, C, N, p.nt, s, m_tiles);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

// The forward: the bf16 kernels under plan `p`, or, for float32, conv_fwd
// (the first version's body, which ignores p); then the finishing sum.
int forward(FwdPlan p, const void* x, const void* w_nk, const void* a, const void* b, void* y,
            float* part, void* sq, bool bf16, int taps, bool prologue, Geo geo, int C, int N,
            cudaStream_t s) {
  int err = 0, m_tiles = 0;
  if (bf16) {
    if (taps == 9 && prologue) {
      err = FwdLaunch<9, true>::run(p, x, w_nk, a, b, y, part, geo, C, N, s, m_tiles);
    } else if (taps == 1) {
      err = prologue ? FwdLaunch<1, true>::run(p, x, w_nk, a, b, y, part, geo, C, N, s, m_tiles)
                     : FwdLaunch<1, false>::run(p, x, w_nk, a, b, y, part, geo, C, N, s, m_tiles);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    auto launch = [&](auto taps_c, auto prologue_c) {
      constexpr int TAPS = decltype(taps_c)::value;
      constexpr bool PROLOGUE = decltype(prologue_c)::value;
      ActLoader<float, TAPS, PROLOGUE> A{static_cast<const float*>(x),
                                         static_cast<const float*>(a),
                                         static_cast<const float*>(b), geo, C};
      MatrixLoader<float, BN> Bw{static_cast<const float*>(w_nk), N, TAPS * C};
      m_tiles = ceil_div(geo.M, BM);
      conv_fwd<float, TAPS, PROLOGUE><<<m_tiles * ceil_div(N, BN), THREADS, 0, s>>>(
          A, Bw, static_cast<float*>(y), part, N);
    };
    if (taps == 9 && prologue) {
      launch(std::integral_constant<int, 9>{}, std::true_type{});
    } else if (taps == 1) {
      if (prologue) launch(std::integral_constant<int, 1>{}, std::true_type{});
      else launch(std::integral_constant<int, 1>{}, std::false_type{});
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err) return err;
  return finish(part, m_tiles, 2 * N, sq, s);
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
// sums (`width` = N or C), for blocks of SUMS_ROWS pixels or more.
long long iswm_fb_sums_scratch(int M, int width) {
  return static_cast<long long>(ceil_div(M, SUMS_ROWS)) * 2 * width;
}
// Parts of the weight gradient's scratch (rows = taps * C): the most that
// conv_wgrad, wgrad_1x1_bf16 and, where rows may be 9 C, wgrad_3x3_bf16 ask for.
int iswm_fb_wgrad_splits(int M, int rows, int N) {
  int parts = wgrad_splits(M, rows, N);
  const int piped = plan_wgrad_1x1(M, rows, N).splits;
  if (piped > parts) parts = piped;
  if (rows % 9 == 0) {
    const int nine = plan_wgrad_3x3(M, rows / 9, N).splits;
    if (nine > parts) parts = nine;
  }
  return parts;
}

// y [M, N] in T and sq [2 N] f32 (s then q).  x [M, C]; w_nk [N][taps * C];
// a, b [C] f32 (unused without prologue).  M = B * H * W; the 1x1 ignores H, W.
// bf16 runs fwd_1x1_bf16 / fwd_3x3_bf16 under plan_fwd's tile, float32 conv_fwd.
int iswm_fb_fwd(const void* x, const void* w_nk, const void* a, const void* b,
                void* y, void* scratch, void* sq, int bf16, int taps, int prologue,
                int M, int H, int W, int C, int N, void* stream) {
  return forward(plan_fwd(M, C, N, taps, prologue != 0), x, w_nk, a, b, y, static_cast<float*>(scratch), sq,
                 bf16 != 0, taps, prologue != 0, Geo{H, W, M}, C, N,
                 static_cast<cudaStream_t>(stream));
}

// The same in bf16 under the plan given as plan[0..2] = BM, BN (128 or 64
// each; BM = 128 for the 3x3) and, for the 1x1, the column tiles a block
// walks (1 .. 8; 1 for the 3x3), for timing plans against each other
// (block_bwd_ab.py --sweep); any other plan returns cudaErrorInvalidValue.
int iswm_fb_fwd_planned(const void* x, const void* w_nk, const void* a, const void* b,
                        void* y, void* scratch, void* sq, int taps, int prologue, int M, int H,
                        int W, int C, int N, const int* plan, void* stream) {
  return forward(FwdPlan{plan[0], plan[1], plan[2]}, x, w_nk, a, b, y, static_cast<float*>(scratch), sq,
                 true, taps, prologue != 0, Geo{H, W, M}, C, N,
                 static_cast<cudaStream_t>(stream));
}

// The bf16 forward's plan: plan[0..3] = BM, BN, column tiles a block, blocks.
void iswm_fb_fwd_plan(int M, int C, int N, int taps, int prologue, int* plan) {
  const FwdPlan p = plan_fwd(M, C, N, taps, prologue != 0);
  plan[0] = p.bm;
  plan[1] = p.bn;
  plan[2] = p.nt;
  plan[3] = ceil_div(M, p.bm) * ceil_div(ceil_div(N, p.bn), p.nt);
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
