// Fused ResNet stem tail for Hopper (sm_90a): BatchNorm statistics,
// normalize + ReLU + 3x3/s2/p1 max-pool, and the fused backward (the two BN
// reductions, then dz contracted straight into the 7x7/s2 conv's weight
// gradient).
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_stem.py:
//   stem_stats            (`_stats_kernel`)     -> stats_partial
//   stem_norm_relu_pool   (`_pool_fwd_kernel`)  -> pool_fwd
//   stem_tail_bwd, call 1 (`_bwd_sums_kernel`)  -> bwd_sums_partial_bf16,
//                                                  bwd_sums_partial for f32
//   stem_tail_bwd, call 2 (`_bwd_wgrad_kernel`) -> bwd_wgrad_partial_bf16,
//                                                  bwd_wgrad_partial for f32
// each followed by sum_partials where it reduces over blocks.
//
// For the conv output z [B, S, S, 64] (NHWC memory, bf16 or f32), the folded
// affine scale/bias [64] f32 and y = relu(z * scale + bias) in f32:
//   stats:   (sum z, sum z^2) per channel, in f32
//   forward: p[b, n, m] = max of y over rows 2n-1..2n+1, cols 2m-1..2m+1
//            (positions outside the image count as 0: y >= 0), in z's type
//   backward, given dp [B, S/2, S/2, 64], mean mu and sigma_inv si:
//     every position of a window that equals the window's maximum receives
//     dp / count (equal-split ties); d_bn = y > 0 ? that sum : 0;
//     yhat = (z - mu) * si;  s1 = sum d_bn (dbeta);  s2 = sum d_bn * yhat
//     (dgamma);  dz = scale * (d_bn - s1/N - yhat * s2/N) rounded to z's type;
//     dW[f, c, ky, kx] = sum dz[b, r, j, f] * x[b, 2r-3+ky, 2j-3+kx, c] in f32
//     for the image x [B, 2S, 2S, 3] (NHWC memory, z's type).  dz is never
//     written to device memory, and no gradient of the image is computed.
//
// What bounds it on this card: device memory for the forward two (each reads
// z once, 67 MB at batch 8 and 512^2 crops; a few operations per element).
// The backward's two read z and dp (and the image) about once too, but are
// bound by the instructions of their shared-memory passes: forming y, the
// windows' maxima and tie counts, and each pixel's shares take some 20
// float32 and integer-pipe instructions per element of z, and the window
// pass alone is half of each kernel's time (PERF.md).  The design, which is not the TPU
// kernels' (no selection matmuls, no sublane rolls, no sequential grid):
//   - a thread handles 8 neighbouring channels of one pixel, one 16-byte load
//     in bf16; 8 threads cover a pixel, so a warp reads 4 pixels' 128-byte
//     rows;
//   - the backward is a gather over tiles of conv pixels.  For bf16 (the
//     training path) a persistent block (one an SM) takes tiles of 8 x 32 and
//     stages, with 16-byte cp.async into a two-slot ring, the z rows and
//     columns that the tile's pool windows touch ((TR + 3) x (TC + 3) pixels,
//     zeros outside the image) and dp's (TR/2 + 1) x (TC/2 + 1) windows; it
//     copies its next tile while it computes this one.  From shared memory a
//     thread then walks a few windows of a window row: each new column's
//     three y = relu(z * scale + bias) are formed once, their maximum and
//     tie count kept, and a window's maximum, count and dp / count follow
//     from its three columns.  Then each thread takes a 2 x 2 block of the
//     tile's pixels, which lie in four windows, and adds the shares in the
//     order of the plain version (higher window row first, then higher
//     column).  No global re-reads, no atomics, no halo exchange;
//   - the bf16 weight gradient keeps the tile's dz (rounded to bf16, as the
//     JAX kernel rounds it) in shared memory in the order the contraction
//     reads it, stages the image window (3 channels, NHWC: a window row is
//     contiguous) with 16-byte cp.async of its aligned cover, and packs it into
//     pairs of rows two apart: the B fragment of mma.sync.m16n8k16 wants two
//     pixels of one tap in one register, and pixels (r, c) and (r + 1, c) read
//     window rows 2r + ky and 2r + 2 + ky at the same column, so one 32-bit
//     load gives it (an im2col tile would cost a store and a load a value; the
//     pair costs one load per two).  A = dz^T comes by ldmatrix.trans.  The
//     GEMM is 64 channels x 152 taps (147 padded) x the block's pixels; the
//     tensor cores' float32 accumulation truncates, so each 64-pixel chain
//     starts from zero and is added into the running sum with IEEE adds;
//   - float32 keeps the first bodies: a 4 x 16 tile whose windows each read z
//     from L1/L2, and a weight gradient on the float32 FMA units (TF32 would
//     miss the 1e-5 the checks hold it to); lane l owns taps l, l+32, .. and
//     warp w channels 8w..8w+7, 40 accumulators a thread;
//   - every sum is deterministic: per-block partials in a fixed order into
//     scratch, then sum_partials adds them in block order.  The grids are
//     functions of the problem size and the card alone, so two launches give
//     the same bits.
// The affine, yhat and dz use separate IEEE multiplies and adds (no FMA
// contraction), so y, the ties and dz equal the plain PyTorch version's bit
// for bit.  Built without fast math.
//
// Contract (checked by the Python wrapper): 64 channels; z, dp, p and x dense
// NHWC, 16-byte aligned, of one type; S even and >= 4; every vector f32 [64]
// on the device; scratch as the *_scratch functions size it.  Launches are
// asynchronous on `stream`; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;            // stem channels
constexpr int G = 8;             // channels a thread handles
constexpr int GROUPS = F / G;    // threads that cover one pixel
constexpr int THREADS = 256;
constexpr int LANES = THREADS / GROUPS;  // pixels a block handles in one pass
constexpr int MAX_PARTIALS = 1024;       // blocks of the two reductions
constexpr int WGRAD_BLOCKS = 264;        // persistent blocks of the weight gradient

constexpr int TR = 4;            // conv rows of a backward tile
constexpr int TC = 16;           // conv columns of a backward tile
constexpr int PR = TR / 2 + 1;   // pool-window rows that touch a tile
constexpr int PC = TC / 2 + 1;   // pool-window columns that touch a tile
constexpr int TILE = TR * TC;    // 64 conv pixels

constexpr int KS = 7;            // the stem conv: 7x7, stride 2, pad 3, 3 channels
constexpr int CIN = 3;
constexpr int TAPS = KS * KS * CIN;      // 147, ordered (ky, kx, c)
constexpr int ROW_TAPS = KS * CIN;       // 21 contiguous values per ky
constexpr int XR = 2 * TR + 5;           // image rows under a tile
constexpr int XC = (2 * TC + 5) * CIN;   // image values per row under a tile
constexpr int XP = 117;                  // row pitch, 21 mod 32: see the header
constexpr int TAPS_PER_LANE = 5;         // 5 * 32 >= 147

static_assert(TILE % LANES == 0, "whole passes over a tile");
static_assert(PR * PC * GROUPS <= THREADS, "one pass over a tile's windows");
static_assert(XP >= XC && XP % 32 == ROW_TAPS, "bank-conflict-free pitch");

__device__ __forceinline__ void load8(const float* p, float (&v)[G]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// Eight bf16 values as floats.
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[G]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[G]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
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

__device__ __forceinline__ float to_f32(float v) { return v; }
// v rounded to T and back: what a stored dz would hold.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

// relu(z * scale + bias) with a separate multiply and add.
__device__ __forceinline__ float relu_affine(float z, float sc, float bi) {
  return fmaxf(__fadd_rn(__fmul_rn(z, sc), bi), 0.f);
}

// y at conv position (r, c) of image `zb` (the thread's channel group already
// added), 0 outside the image.
template <typename T>
__device__ __forceinline__ void y_at(const T* zb, int S, int r, int c,
                                     const float (&sc)[G], const float (&bi)[G],
                                     float (&y)[G]) {
  if (r >= 0 && r < S && c >= 0 && c < S) {
    float v[G];
    load8(zb + (static_cast<size_t>(r) * S + c) * F, v);
#pragma unroll
    for (int i = 0; i < G; ++i) y[i] = relu_affine(v[i], sc[i], bi[i]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) y[i] = 0.f;
  }
}

// The maximum of y over pool window (n, m): rows 2n-1..2n+1, cols 2m-1..2m+1.
template <typename T>
__device__ __forceinline__ void window_max(const T* zb, int S, int n, int m,
                                           const float (&sc)[G], const float (&bi)[G],
                                           float (&mx)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) mx[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float y[G];
    y_at(zb, S, 2 * n - 1 + k / 3, 2 * m - 1 + k % 3, sc, bi, y);
#pragma unroll
    for (int i = 0; i < G; ++i) mx[i] = fmaxf(mx[i], y[i]);
  }
}

// Sum 2 * G values per thread over the block's 32 pixel lanes in a fixed
// order: out[which * F + channel], which = 0 for acc[0..G), 1 for acc[G..2G).
__device__ __forceinline__ void block_reduce_store(const float (&acc)[2 * G],
                                                   float* __restrict__ out) {
  __shared__ float red[LANES][2 * F];
  const int g = threadIdx.x % GROUPS;
  const int lane = threadIdx.x / GROUPS;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    red[lane][g * G + i] = acc[i];
    red[lane][F + g * G + i] = acc[G + i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * F) {
    float s = 0.f;
    for (int l = 0; l < LANES; ++l) s += red[l][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// out[c] = sum over blocks of partials[block][c] in a fixed order: 32 columns
// a block, 8 threads a column that each add every eighth block, then one of
// them adds the eight.
constexpr int FIN_COLS = 32;
constexpr int FIN_LANES = THREADS / FIN_COLS;

__global__ void __launch_bounds__(THREADS)
    sum_partials(const float* __restrict__ partials, int blocks, int width,
                 float* __restrict__ out) {
  __shared__ float red[FIN_LANES][FIN_COLS];
  const int col = threadIdx.x % FIN_COLS;
  const int lane = threadIdx.x / FIN_COLS;
  const int c = blockIdx.x * FIN_COLS + col;
  float s = 0.f;
  if (c < width) {
    for (int b = lane; b < blocks; b += FIN_LANES) {
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

// ---------------------------------------------------------------- statistics

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stats_partial(const T* __restrict__ z, long long pixels,
                  float* __restrict__ partials) {
  const int g = threadIdx.x % GROUPS;
  const int lane = threadIdx.x / GROUPS;
  float acc[2 * G];
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) acc[i] = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * LANES;
  for (long long p = static_cast<long long>(blockIdx.x) * LANES + lane; p < pixels;
       p += step) {
    float v[G];
    load8(z + p * F + g * G, v);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      acc[i] += v[i];
      acc[G + i] += v[i] * v[i];
    }
  }
  block_reduce_store(acc, partials + static_cast<size_t>(blockIdx.x) * 2 * F);
}

// ------------------------------------------------- forward: norm + relu + pool

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pool_fwd(const T* __restrict__ z, const float* __restrict__ scale,
             const float* __restrict__ bias, int B, int S, T* __restrict__ p) {
  const int Sp = S / 2;
  const int g = threadIdx.x % GROUPS;  // constant over the loop: the step is a multiple of 8
  float sc[G], bi[G];
  load8(scale + g * G, sc);
  load8(bias + g * G, bi);
  const long long windows = static_cast<long long>(B) * Sp * Sp;
  const long long step = static_cast<long long>(gridDim.x) * LANES;
  for (long long q = static_cast<long long>(blockIdx.x) * LANES + threadIdx.x / GROUPS;
       q < windows; q += step) {
    const int m = static_cast<int>(q % Sp);
    const int n = static_cast<int>((q / Sp) % Sp);
    const long long b = q / (static_cast<long long>(Sp) * Sp);
    float mx[G];
    window_max(z + b * S * S * F + g * G, S, n, m, sc, bi, mx);
    store8(p + q * F + g * G, mx);
  }
}

// ------------------------------------------------------------------ backward

// For each pool window that touches a tile: its maximum, and dp / count of
// the positions that equal it (-1 and 0 for a window outside the image, so
// that no y >= 0 equals it).
struct Windows {
  float max[PR * PC][F];
  float share[PR * PC][F];
};

struct Tile {
  long long b;  // image
  int r0, c0;   // first conv row and column
};

// Tile t of TR_ x TC_ conv pixels: column tiles first, then row tiles, then images.
template <int TR_ = TR, int TC_ = TC>
__device__ __forceinline__ Tile tile_at(long long t, int S) {
  const int tiles_c = (S + TC_ - 1) / TC_;
  const int tiles_r = (S + TR_ - 1) / TR_;
  Tile tile;
  tile.c0 = static_cast<int>(t % tiles_c) * TC_;
  tile.r0 = static_cast<int>((t / tiles_c) % tiles_r) * TR_;
  tile.b = t / (static_cast<long long>(tiles_c) * tiles_r);
  return tile;
}

template <int TR_ = TR, int TC_ = TC>
__host__ __device__ inline long long tile_count(long long B, int S) {
  return B * ((S + TC_ - 1) / TC_) * ((S + TR_ - 1) / TR_);
}

// The per-channel vectors of the backward, in shared memory so that each phase
// holds in registers only those it uses.
struct Vectors {
  float scale[F], bias[F], mean[F], sigma_inv[F], mean_s1[F], mean_s2[F];
};

__device__ __forceinline__ void fill_vector(float* dst, const float* __restrict__ src) {
  if (threadIdx.x < F) dst[threadIdx.x] = src[threadIdx.x];
}

template <typename T>
__device__ __forceinline__ void fill_windows(const T* __restrict__ z,
                                             const T* __restrict__ dp, int S,
                                             const Tile& tile, const Vectors& vec,
                                             Windows& w) {
  const int Sp = S / 2;
  const int g = threadIdx.x % GROUPS;
  const int q = threadIdx.x / GROUPS;
  if (q >= PR * PC) return;
  float sc[G], bi[G];
  load8(vec.scale + g * G, sc);
  load8(vec.bias + g * G, bi);
  const int n = tile.r0 / 2 + q / PC;
  const int m = tile.c0 / 2 + q % PC;
  float mx[G], share[G];
  if (n < Sp && m < Sp) {
    // two passes over the window (the second is served from L1) keep the
    // nine y vectors out of the registers
    const T* zb = z + tile.b * S * S * F + g * G;
    window_max(zb, S, n, m, sc, bi, mx);
    float count[G];
#pragma unroll
    for (int i = 0; i < G; ++i) count[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float y[G];
      y_at(zb, S, 2 * n - 1 + k / 3, 2 * m - 1 + k % 3, sc, bi, y);
#pragma unroll
      for (int i = 0; i < G; ++i) count[i] += y[i] == mx[i] ? 1.f : 0.f;
    }
    float d[G];
    load8(dp + ((tile.b * Sp + n) * Sp + m) * F + g * G, d);
#pragma unroll
    for (int i = 0; i < G; ++i) share[i] = __fdiv_rn(d[i], fmaxf(count[i], 1.f));
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mx[i] = -1.f;
      share[i] = 0.f;
    }
  }
  store8(&w.max[q][g * G], mx);
  store8(&w.share[q][g * G], share);
}

// d_bn and yhat of conv pixel (rr, cc) of the tile (0 outside the image).
// The windows are visited higher row first, higher column first: the order in
// which the plain version's nine shifted additions reach a pixel.
template <typename T>
__device__ __forceinline__ bool pixel_grads(const T* __restrict__ z, int S,
                                            const Tile& tile, int rr, int cc,
                                            const Windows& w, const Vectors& vec,
                                            float (&d_bn)[G], float (&yhat)[G]) {
  const int g = threadIdx.x % GROUPS;
  const int r = tile.r0 + rr;
  const int c = tile.c0 + cc;
  if (r >= S || c >= S) {
#pragma unroll
    for (int i = 0; i < G; ++i) d_bn[i] = yhat[i] = 0.f;
    return false;
  }
  float v[G], y[G], dy[G];
  load8(z + ((tile.b * S + r) * S + c) * F + g * G, v);
  {
    float sc[G], bi[G];
    load8(vec.scale + g * G, sc);
    load8(vec.bias + g * G, bi);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      y[i] = relu_affine(v[i], sc[i], bi[i]);
      dy[i] = 0.f;
    }
  }
  // an even row lies in one window row, an odd one in two
  const int rows = (rr & 1) ? 2 : 1;
  const int cols = (cc & 1) ? 2 : 1;
  for (int a = 0; a < rows; ++a) {
    const int pn = (rr + 1) / 2 - a;
    for (int e = 0; e < cols; ++e) {
      const int pm = (cc + 1) / 2 - e;
      float mx[G], share[G];
      load8(&w.max[pn * PC + pm][g * G], mx);
      load8(&w.share[pn * PC + pm][g * G], share);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (y[i] == mx[i]) dy[i] = __fadd_rn(dy[i], share[i]);
      }
    }
  }
  float mu[G], si[G];
  load8(vec.mean + g * G, mu);
  load8(vec.sigma_inv + g * G, si);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    d_bn[i] = y[i] > 0.f ? dy[i] : 0.f;
    yhat[i] = __fmul_rn(__fsub_rn(v[i], mu[i]), si[i]);
  }
  return true;
}

// four blocks an SM (64 registers, a few spilled) hide the window loads best
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
    bwd_sums_partial(const T* __restrict__ z, const T* __restrict__ dp, int B, int S,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ sigma_inv,
                     float* __restrict__ partials) {
  __shared__ __align__(16) Windows w;
  __shared__ __align__(16) Vectors vec;
  const int lane = threadIdx.x / GROUPS;
  fill_vector(vec.scale, scale);
  fill_vector(vec.bias, bias);
  fill_vector(vec.mean, mean);
  fill_vector(vec.sigma_inv, sigma_inv);
  float acc[2 * G];
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) acc[i] = 0.f;
  const long long tiles = tile_count(B, S);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile = tile_at(t, S);
    __syncthreads();  // the last tile's readers are done with w
    fill_windows(z, dp, S, tile, vec, w);
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < TILE / LANES; ++pass) {
      const int k = pass * LANES + lane;
      float d_bn[G], yhat[G];
      pixel_grads(z, S, tile, k / TC, k % TC, w, vec, d_bn, yhat);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        acc[i] += d_bn[i];
        acc[G + i] += d_bn[i] * yhat[i];
      }
    }
  }
  block_reduce_store(acc, partials + static_cast<size_t>(blockIdx.x) * 2 * F);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_wgrad_partial(const T* __restrict__ z, const T* __restrict__ dp,
                      const T* __restrict__ x, int B, int S,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const float* __restrict__ mean, const float* __restrict__ sigma_inv,
                      const float* __restrict__ mean_s1, const float* __restrict__ mean_s2,
                      float* __restrict__ partials) {
  __shared__ __align__(16) Windows w;
  __shared__ __align__(16) Vectors vec;
  __shared__ __align__(16) float dz[TILE][F];
  __shared__ float xs[XR * XP];
  const int g = threadIdx.x % GROUPS;
  const int lane = threadIdx.x / GROUPS;
  fill_vector(vec.scale, scale);
  fill_vector(vec.bias, bias);
  fill_vector(vec.mean, mean);
  fill_vector(vec.sigma_inv, sigma_inv);
  fill_vector(vec.mean_s1, mean_s1);
  fill_vector(vec.mean_s2, mean_s2);

  // the contraction's roles: warp -> 8 channels, lane -> 5 taps
  const int warp = threadIdx.x / 32;
  const int tap_lane = threadIdx.x % 32;
  int offset[TAPS_PER_LANE];
#pragma unroll
  for (int i = 0; i < TAPS_PER_LANE; ++i) {
    const int tap = tap_lane + 32 * i;
    offset[i] = tap < TAPS ? (tap / ROW_TAPS) * XP + tap % ROW_TAPS : 0;
  }
  float acc[TAPS_PER_LANE][G];
#pragma unroll
  for (int i = 0; i < TAPS_PER_LANE; ++i) {
#pragma unroll
    for (int f = 0; f < G; ++f) acc[i][f] = 0.f;
  }

  const int H = 2 * S;  // the image's side
  const long long tiles = tile_count(B, S);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile = tile_at(t, S);
    __syncthreads();  // the last tile's contraction is done with w, dz and xs
    fill_windows(z, dp, S, tile, vec, w);
    // image rows 2 r0 - 3 .., columns 2 c0 - 3 .., zero outside (the conv's pad)
    for (int idx = threadIdx.x; idx < XR * XC; idx += THREADS) {
      const int wr = idx / XC;
      const int wc = idx % XC;
      const int ir = 2 * tile.r0 - 3 + wr;
      const int ic = 2 * tile.c0 - 3 + wc / CIN;
      float v = 0.f;
      if (ir >= 0 && ir < H && ic >= 0 && ic < H) {
        v = to_f32(x[((tile.b * H + ir) * H + ic) * CIN + wc % CIN]);
      }
      xs[wr * XP + wc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < TILE / LANES; ++pass) {
      const int k = pass * LANES + lane;
      float d_bn[G], yhat[G], out[G];
      const bool inside = pixel_grads(z, S, tile, k / TC, k % TC, w, vec, d_bn, yhat);
      float sc[G], ms1[G], ms2[G];
      load8(vec.scale + g * G, sc);
      load8(vec.mean_s1 + g * G, ms1);
      load8(vec.mean_s2 + g * G, ms2);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float v = __fmul_rn(
            sc[i], __fsub_rn(__fsub_rn(d_bn[i], ms1[i]), __fmul_rn(yhat[i], ms2[i])));
        out[i] = inside ? round_to<T>(v) : 0.f;
      }
      store8(&dz[k][g * G], out);
    }
    __syncthreads();
    for (int rr = 0; rr < TR; ++rr) {
#pragma unroll 4
      for (int cc = 0; cc < TC; ++cc) {
        const float* xb = xs + 2 * rr * XP + 2 * cc * CIN;
        float d[G];
        load8(&dz[rr * TC + cc][warp * G], d);
#pragma unroll
        for (int i = 0; i < TAPS_PER_LANE; ++i) {
          const float xv = xb[offset[i]];
#pragma unroll
          for (int f = 0; f < G; ++f) acc[i][f] = fmaf(xv, d[f], acc[i][f]);
        }
      }
    }
  }
  // partials[block][f][c][ky][kx]: the weight's own OIHW order
  float* out = partials + static_cast<size_t>(blockIdx.x) * F * TAPS;
#pragma unroll
  for (int i = 0; i < TAPS_PER_LANE; ++i) {
    const int tap = tap_lane + 32 * i;
    if (tap >= TAPS) continue;
    const int ky = tap / ROW_TAPS;
    const int kx = (tap % ROW_TAPS) / CIN;
    const int c = tap % CIN;
#pragma unroll
    for (int f = 0; f < G; ++f) {
      out[(warp * G + f) * TAPS + (c * KS + ky) * KS + kx] = acc[i][f];
    }
  }
}

// -------------------------------------- backward, bf16: the staged tile body

using bf16 = __nv_bfloat16;

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
// Four 8x8 bf16 matrices, each transposed, row i of matrix j from the address
// of lane 8 j + i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Channel group g's 8 floats of a [64] row in shared memory, laid out as the
// groups' first halves, then their second halves: each half is one 16-byte
// access, and the 8 groups of a quarter warp cover 128 contiguous bytes.
__device__ __forceinline__ void store8_split(float* row, int g, const float (&v)[G]) {
  *reinterpret_cast<float4*>(row + 4 * g) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(row + F / 2 + 4 * g) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void load8_split(const float* row, int g, float (&v)[G]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * g);
  const float4 b = *reinterpret_cast<const float4*>(row + F / 2 + 4 * g);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

constexpr int KCHUNK = 64;     // pixels an mma chain runs before its IEEE add
constexpr int WARPS_N = 4;     // the contraction's warps along the taps (2 along the channels)
constexpr int NT = 5;          // 8-tap n-tiles a warp: 4 x 5 x 8 = 160 >= 147
constexpr int N_TILES = (TAPS + 7) / 8;  // 19: the last warp column takes 4
constexpr int SUMS_THREADS = 384;   // threads of a staged #11a block (256 and 512 measured slower)
constexpr int WGRAD_THREADS = 256;  // of a #11b block; its first 8 warps contract
static_assert(WGRAD_THREADS >= 2 * WARPS_N * 32 && WARPS_N * NT >= N_TILES, "the warp grid");
static_assert(SUMS_THREADS % 32 == 0 && WGRAD_THREADS % 32 == 0, "whole warps");

// A tile plan: TR_ x TC_ conv pixels, and where each staged array lies in the
// block's dynamic shared memory.
template <int TR_, int TC_>
struct Plan {
  static constexpr int TR = TR_, TC = TC_, TILE = TR * TC;
  static_assert(TR % 2 == 0 && TC % 8 == 0 && TILE % KCHUNK == 0 && KCHUNK % 32 == 0,
                "2 x 2 pixel blocks, 2-row x 8-column mma steps in pairs, whole chains");
  static constexpr int PR = TR / 2 + 1, PC = TC / 2 + 1, WINDOWS = PR * PC;
  static constexpr int ZR = TR + 3, ZC = TC + 3;  // staged z: rows r0-1 .. r0+TR+1
  static constexpr int XR = 2 * TR + 5;           // image rows under the tile
  static constexpr int XW = (2 * TC + 5) * CIN;   // image values a row
  static constexpr int XCH = (2 * XW + 14 + 15) / 16;  // 16-byte chunks over a row at any alignment
  static constexpr int XPR = 2 * TR + 3;          // rows of packed pairs (R, R + 2)
  static constexpr int XPW = XW + (ROW_TAPS - XW % 32 + 32) % 32;  // 21 mod 32, as XP
  static constexpr int DZ_LD = F + 8;  // bf16 a dz row: ldmatrix's 8 rows hit 8 bank groups
  // bytes
  static constexpr int Z_SLOT = ZR * ZC * F * 2;
  static constexpr int DP_SLOT = WINDOWS * F * 2;
  static constexpr int WIN = WINDOWS * 2 * F * 4;  // max, share; later the packed image
  static constexpr int X_SLOT = XR * XCH * 16;
  static constexpr int OFF_DP = 2 * Z_SLOT;
  static constexpr int OFF_WIN = OFF_DP + 2 * DP_SLOT;
  static constexpr int OFF_VEC = OFF_WIN + WIN;
  static constexpr int SUMS_SMEM = OFF_VEC + static_cast<int>(sizeof(Vectors));
  static constexpr int OFF_DZ = SUMS_SMEM;
  static constexpr int OFF_X = OFF_DZ + TILE * DZ_LD * 2;
  static constexpr int OFF_SHIFT = OFF_X + 2 * X_SLOT;
  static constexpr int WGRAD_SMEM = OFF_SHIFT + 2 * XR * 4;
  static_assert(XPR * XPW * 4 <= WIN, "the packed image fits where the windows were");
};

// Start the copies of a tile's z and dp into a ring slot: z at conv rows
// r0-1 .. r0+TR+1 and columns c0-1 .. c0+TC+1, dp at windows r0/2 .. r0/2+TR/2
// and c0/2 .. c0/2+TC/2; zeros outside.
template <class P, int NT_>
__device__ __forceinline__ void stage_z_dp(const bf16* __restrict__ z,
                                           const bf16* __restrict__ dp, int S,
                                           const Tile& tile, bf16* zs, bf16* dps) {
  const int Sp = S / 2;
  const bf16* zb = z + tile.b * S * S * F;
  for (int i = threadIdx.x; i < P::ZR * P::ZC * GROUPS; i += NT_) {
    const int px = i / GROUPS, g = i % GROUPS;
    const int r = tile.r0 - 1 + px / P::ZC, c = tile.c0 - 1 + px % P::ZC;
    const bool ok = r >= 0 && r < S && c >= 0 && c < S;
    cp_async16(zs + i * G, ok ? zb + (static_cast<long long>(r) * S + c) * F + g * G : z, ok);
  }
  const bf16* db = dp + tile.b * Sp * Sp * F;
  for (int i = threadIdx.x; i < P::WINDOWS * GROUPS; i += NT_) {
    const int q = i / GROUPS, g = i % GROUPS;
    const int n = tile.r0 / 2 + q / P::PC, m = tile.c0 / 2 + q % P::PC;
    const bool ok = n < Sp && m < Sp;
    cp_async16(dps + i * G, ok ? db + (static_cast<long long>(n) * Sp + m) * F + g * G : dp,
               ok);
  }
}

// Start the copies of the tile's image window, rows 2 r0 - 3 .. 2 r0 + 2 TR + 1:
// the 16-byte-aligned cover of each row's XW values (image columns 2 c0 - 3 ..);
// shift[R] is where the row's first value lies in its cover.  Nothing is read
// outside the image's buffer (aligned and a multiple of 16 bytes long); values
// outside the image are masked when the rows are packed.
template <class P, int NT_>
__device__ __forceinline__ void stage_image(const bf16* __restrict__ x, long long x_bytes,
                                            int H, const Tile& tile, bf16* xs, int* shift) {
  const char* base = reinterpret_cast<const char*>(x);
  for (int i = threadIdx.x; i < P::XR * P::XCH; i += NT_) {
    const int R = i / P::XCH, k = i % P::XCH;
    const int ir = 2 * tile.r0 - 3 + R;
    const long long start = ((tile.b * H + ir) * H + 2 * tile.c0 - 3) * (CIN * 2);
    const long long a = (start & ~15LL) + 16 * k;  // floor to 16 bytes, negatives too
    if (k == 0) shift[R] = static_cast<int>(start & 15) / 2;
    const bool ok = ir >= 0 && ir < H && a >= 0 && a < x_bytes;
    cp_async16(xs + i * 8, ok ? base + a : base, ok);
  }
}

// The maximum of a staged column's three y = relu_affine(z) (rows 2 pn ..
// 2 pn + 2, column scol) and how many equal it.  A window inside the image
// ends at row and column S - 1, so only row and column -1 of the first tiles
// lie outside (y = 0 there).
template <class P>
__device__ __forceinline__ void column_max(const bf16* zs, const Tile& tile, int pn, int scol,
                                           int g, const float (&sc)[G], const float (&bi)[G],
                                           float (&mx)[G], float (&count)[G]) {
  float y[3][G];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int sr = 2 * pn + k;
    if (tile.r0 + sr >= 1 && tile.c0 + scol >= 1) {
      load8(zs + (sr * P::ZC + scol) * F + g * G, y[k]);
#pragma unroll
      for (int c = 0; c < G; ++c) y[k][c] = relu_affine(y[k][c], sc[c], bi[c]);
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) y[k][c] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < G; ++c) {
    mx[c] = fmaxf(fmaxf(y[0][c], y[1][c]), y[2][c]);
    count[c] = (y[0][c] == mx[c] ? 1.f : 0.f) + (y[1][c] == mx[c] ? 1.f : 0.f) +
               (y[2][c] == mx[c] ? 1.f : 0.f);
  }
}

// Each window's maximum and dp / count into win[q][max | share] (-1 and 0 for
// a window outside the image), from the staged z and dp.  A thread walks a
// segment of a window row: window m takes column 2m from window m - 1 and
// forms columns 2m+1 and 2m+2, so a column's three y are formed once a walk.
// The window's count is that of the columns whose maximum equals its own.
template <class P, int NT_>
__device__ __forceinline__ void window_pass(const bf16* zs, const bf16* dps, int S,
                                            const Tile& tile, const Vectors& vec,
                                            float* win) {
  constexpr int ROWS = NT_ / GROUPS / P::PR;            // tasks a window row in one round
  constexpr int SPAN = (P::PC + ROWS - 1) / ROWS;        // windows a task walks
  constexpr int SEG = (P::PC + SPAN - 1) / SPAN;         // tasks a window row
  const int Sp = S / 2;
  const int g = threadIdx.x % GROUPS;
  float sc[G], bi[G];
  load8(vec.scale + g * G, sc);
  load8(vec.bias + g * G, bi);
  for (int task = threadIdx.x / GROUPS; task < P::PR * SEG; task += NT_ / GROUPS) {
    const int pn = task / SEG, m0 = (task % SEG) * SPAN;
    const bool row_in = tile.r0 / 2 + pn < Sp;
    float mx_a[G], cnt_a[G];  // column 2m, carried from the last window
    if (row_in) column_max<P>(zs, tile, pn, 2 * m0, g, sc, bi, mx_a, cnt_a);
#pragma unroll
    for (int k = 0; k < SPAN; ++k) {
      const int m = m0 + k;
      if (m >= P::PC) break;
      const int q = pn * P::PC + m;
      float mx[G], share[G];
      if (row_in && tile.c0 / 2 + m < Sp) {
        float mx_b[G], cnt_b[G], mx_c[G], cnt_c[G];
        column_max<P>(zs, tile, pn, 2 * m + 1, g, sc, bi, mx_b, cnt_b);
        column_max<P>(zs, tile, pn, 2 * m + 2, g, sc, bi, mx_c, cnt_c);
        float d[G];
        load8(dps + q * F + g * G, d);
#pragma unroll
        for (int c = 0; c < G; ++c) {
          mx[c] = fmaxf(fmaxf(mx_a[c], mx_b[c]), mx_c[c]);
          const float count = (mx_a[c] == mx[c] ? cnt_a[c] : 0.f) +
                              (mx_b[c] == mx[c] ? cnt_b[c] : 0.f) +
                              (mx_c[c] == mx[c] ? cnt_c[c] : 0.f);
          share[c] = __fdiv_rn(d[c], fmaxf(count, 1.f));
          mx_a[c] = mx_c[c];
          cnt_a[c] = cnt_c[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < G; ++c) {
          mx[c] = -1.f;
          share[c] = 0.f;
        }
      }
      store8_split(win + q * 2 * F, g, mx);
      store8_split(win + q * 2 * F + F, g, share);
    }
  }
}

// d_bn and yhat of every pixel of the tile, a 2 x 2 block of them a thread
// (rows 2a, 2a+1, columns 2b, 2b+1 of the tile).  The block lies in windows
// (a..a+1, b..b+1); they are visited (a+1, b+1), (a+1, b), (a, b+1), (a, b), so
// each pixel adds its shares in pixel_grads' order.  emit(rr, cc, inside,
// d_bn, yhat) takes each pixel (inside: within the image).
template <class P, int NT_, class Emit>
__device__ __forceinline__ void pixel_pass(const bf16* zs, const float* win, int S,
                                           const Tile& tile, const Vectors& vec,
                                           Emit&& emit) {
  const int g = threadIdx.x % GROUPS;
  for (int i = threadIdx.x; i < P::TILE / 4 * GROUPS; i += NT_) {
    const int blk = i / GROUPS, a = blk / (P::TC / 2), b = blk % (P::TC / 2);
    uint4 raw[4];  // pixel p = 2 h + e is (2a + h, 2b + e)
    float y[4][G], dy[4][G];
    {
      float sc[G], bi[G];
      load8(vec.scale + g * G, sc);
      load8(vec.bias + g * G, bi);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        raw[p] = *reinterpret_cast<const uint4*>(
            zs + ((2 * a + p / 2 + 1) * P::ZC + 2 * b + p % 2 + 1) * F + g * G);
        float v[G];
        unpack8(raw[p], v);
#pragma unroll
        for (int c = 0; c < G; ++c) {
          y[p][c] = relu_affine(v[c], sc[c], bi[c]);
          dy[p][c] = 0.f;
        }
      }
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int da = 1 - w / 2, db = 1 - w % 2;  // window (a + da, b + db)
      const float* row = win + ((a + da) * P::PC + b + db) * 2 * F;
      float mx[G], share[G];
      load8_split(row, g, mx);
      load8_split(row + F, g, share);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p / 2 < da || p % 2 < db) continue;  // the window starts below / right of p
#pragma unroll
        for (int c = 0; c < G; ++c) {
          if (y[p][c] == mx[c]) dy[p][c] = __fadd_rn(dy[p][c], share[c]);
        }
      }
    }
    float mu[G], si[G];
    load8(vec.mean + g * G, mu);
    load8(vec.sigma_inv + g * G, si);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int rr = 2 * a + p / 2, cc = 2 * b + p % 2;
      float v[G], d_bn[G], yhat[G];
      unpack8(raw[p], v);
#pragma unroll
      for (int c = 0; c < G; ++c) {
        d_bn[c] = y[p][c] > 0.f ? dy[p][c] : 0.f;
        yhat[c] = __fmul_rn(__fsub_rn(v[c], mu[c]), si[c]);
      }
      emit(rr, cc, tile.r0 + rr < S && tile.c0 + cc < S, d_bn, yhat);
    }
  }
}

template <class P>
__global__ void __launch_bounds__(SUMS_THREADS, 1)
    bwd_sums_partial_bf16(const bf16* __restrict__ z, const bf16* __restrict__ dp, int B,
                          int S, const float* __restrict__ scale,
                          const float* __restrict__ bias, const float* __restrict__ mean,
                          const float* __restrict__ sigma_inv, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);
  bf16* dps = reinterpret_cast<bf16*>(smem + P::OFF_DP);
  float* win = reinterpret_cast<float*>(smem + P::OFF_WIN);
  Vectors& vec = *reinterpret_cast<Vectors*>(smem + P::OFF_VEC);
  fill_vector(vec.scale, scale);
  fill_vector(vec.bias, bias);
  fill_vector(vec.mean, mean);
  fill_vector(vec.sigma_inv, sigma_inv);
  float acc[2 * G];
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) acc[i] = 0.f;
  constexpr int ZE = P::Z_SLOT / 2, DE = P::DP_SLOT / 2;  // bf16 a slot
  const long long tiles = tile_count<P::TR, P::TC>(B, S);
  long long t = blockIdx.x;
  if (t < tiles) stage_z_dp<P, SUMS_THREADS>(z, dp, S, tile_at<P::TR, P::TC>(t, S), zs, dps);
  cp_async_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const int slot = it & 1;
    const long long next = t + gridDim.x;
    if (next < tiles) {  // slot ^ 1 was released by the last tile's closing barrier
      stage_z_dp<P, SUMS_THREADS>(z, dp, S, tile_at<P::TR, P::TC>(next, S),
                                  zs + (slot ^ 1) * ZE, dps + (slot ^ 1) * DE);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const Tile tile = tile_at<P::TR, P::TC>(t, S);
    window_pass<P, SUMS_THREADS>(zs + slot * ZE, dps + slot * DE, S, tile, vec, win);
    __syncthreads();
    pixel_pass<P, SUMS_THREADS>(zs + slot * ZE, win, S, tile, vec,
                  [&](int, int, bool inside, const float (&d_bn)[G], const float (&yhat)[G]) {
                    if (!inside) return;
#pragma unroll
                    for (int c = 0; c < G; ++c) {
                      acc[c] += d_bn[c];
                      acc[G + c] += d_bn[c] * yhat[c];
                    }
                  });
    __syncthreads();  // the slot and the windows are free
  }
  // the threads' sums over each channel group's lanes, in a fixed order,
  // through the free ring
  constexpr int LANES_ = SUMS_THREADS / GROUPS;
  static_assert(LANES_ * 2 * F * 4 <= 2 * P::Z_SLOT, "the lanes' sums fit in the ring");
  cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(smem);
  const int g = threadIdx.x % GROUPS, lane = threadIdx.x / GROUPS;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    red[lane * 2 * F + g * G + i] = acc[i];
    red[lane * 2 * F + F + g * G + i] = acc[G + i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * F) {
    float sum = 0.f;
    for (int l = 0; l < LANES_; ++l) sum += red[l * 2 * F + threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * 2 * F + threadIdx.x] = sum;
  }
}

template <class P>
__global__ void __launch_bounds__(WGRAD_THREADS, 1)
    bwd_wgrad_partial_bf16(const bf16* __restrict__ z, const bf16* __restrict__ dp,
                           const bf16* __restrict__ x, int B, int S,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           const float* __restrict__ mean,
                           const float* __restrict__ sigma_inv,
                           const float* __restrict__ mean_s1,
                           const float* __restrict__ mean_s2, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);
  bf16* dps = reinterpret_cast<bf16*>(smem + P::OFF_DP);
  float* win = reinterpret_cast<float*>(smem + P::OFF_WIN);
  uint32_t* xp = reinterpret_cast<uint32_t*>(smem + P::OFF_WIN);  // after the pixel pass
  Vectors& vec = *reinterpret_cast<Vectors*>(smem + P::OFF_VEC);
  bf16* dz = reinterpret_cast<bf16*>(smem + P::OFF_DZ);
  bf16* xs = reinterpret_cast<bf16*>(smem + P::OFF_X);
  int* shift = reinterpret_cast<int*>(smem + P::OFF_SHIFT);
  fill_vector(vec.scale, scale);
  fill_vector(vec.bias, bias);
  fill_vector(vec.mean, mean);
  fill_vector(vec.sigma_inv, sigma_inv);
  fill_vector(vec.mean_s1, mean_s1);
  fill_vector(vec.mean_s2, mean_s2);
  const int H = 2 * S;  // the image's side
  const long long x_bytes = static_cast<long long>(B) * H * H * CIN * 2;

  // the contraction's roles: warp (mw, nw) owns channels 32 mw .. 32 mw + 31
  // and n-tiles NT nw .. NT nw + NT - 1 (8 taps each)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / WARPS_N, nw = warp % WARPS_N;
  const int gq = lane / 4, tq = lane % 4;  // the mma fragments' row group and pair
  const int mi = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row this lane addresses
  // B fragment of n-tile j: tap n = 8 (NT nw + j) + gq for the pixels of k rows
  // 2 tq, 2 tq + 1 (the word at off[j]) and 2 tq + 8, 2 tq + 9 (8 CIN further)
  int off[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    int tap = 8 * (NT * nw + j) + gq;
    tap = tap < TAPS ? tap : 0;  // padding taps: any word, the column is not kept
    off[j] = (tap / ROW_TAPS) * P::XPW + tap % ROW_TAPS + 2 * CIN * tq;
  }
  float acc[2][NT][4], sum[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = sum[i][j][r] = 0.f;

  constexpr int ZE = P::Z_SLOT / 2, DE = P::DP_SLOT / 2, XE = P::X_SLOT / 2;
  const long long tiles = tile_count<P::TR, P::TC>(B, S);
  long long t = blockIdx.x;
  if (t < tiles) {
    const Tile first = tile_at<P::TR, P::TC>(t, S);
    stage_z_dp<P, WGRAD_THREADS>(z, dp, S, first, zs, dps);
    stage_image<P, WGRAD_THREADS>(x, x_bytes, H, first, xs, shift);
  }
  cp_async_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const int slot = it & 1;
    const long long next = t + gridDim.x;
    if (next < tiles) {  // slot ^ 1 was released by the last tile's closing barrier
      const Tile after = tile_at<P::TR, P::TC>(next, S);
      stage_z_dp<P, WGRAD_THREADS>(z, dp, S, after, zs + (slot ^ 1) * ZE, dps + (slot ^ 1) * DE);
      stage_image<P, WGRAD_THREADS>(x, x_bytes, H, after, xs + (slot ^ 1) * XE,
                                    shift + (slot ^ 1) * P::XR);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const Tile tile = tile_at<P::TR, P::TC>(t, S);
    window_pass<P, WGRAD_THREADS>(zs + slot * ZE, dps + slot * DE, S, tile, vec, win);
    __syncthreads();
    // dz of pixel (rr, cc) goes to row 16 q + 2 (cc % 8) + rr % 2 of mma step
    // q = (rr / 2) (TC / 8) + cc / 8: a step's 16 pixels are 2 rows x 8 columns,
    // k = 2 i + h being pixel (rr0 + h, cc0 + i)
    {
      const int g = threadIdx.x % GROUPS;
      float sc[G], ms1[G], ms2[G];
      load8(vec.scale + g * G, sc);
      load8(vec.mean_s1 + g * G, ms1);
      load8(vec.mean_s2 + g * G, ms2);
      pixel_pass<P, WGRAD_THREADS>(
          zs + slot * ZE, win, S, tile, vec,
          [&](int rr, int cc, bool inside, const float (&d_bn)[G], const float (&yhat)[G]) {
            float out[G];  // store8 rounds it to bf16
#pragma unroll
            for (int c = 0; c < G; ++c) {
              const float v = __fmul_rn(
                  sc[c], __fsub_rn(__fsub_rn(d_bn[c], ms1[c]), __fmul_rn(yhat[c], ms2[c])));
              out[c] = inside ? v : 0.f;
            }
            const int row = 16 * ((rr / 2) * (P::TC / 8) + cc / 8) + 2 * (cc % 8) + rr % 2;
            store8(dz + row * P::DZ_LD + g * G, out);
          });
    }
    __syncthreads();
    // the packed image: xp[R][col] = (x[R][col], x[R + 2][col]), zero outside
    // the image (checked only in a tile at its edge); a warp a row
    {
      const unsigned short* xr = reinterpret_cast<const unsigned short*>(xs + slot * XE);
      const int* sh = shift + slot * P::XR;
      const int ir0 = 2 * tile.r0 - 3, ic0 = 2 * tile.c0 - 3;
      const bool inside = ir0 >= 0 && ir0 + P::XR <= H && ic0 >= 0 && ic0 + P::XW / CIN <= H;
      for (int R = warp; R < P::XPR; R += WGRAD_THREADS / 32) {
        const unsigned short* lo_row = xr + R * P::XCH * 8 + sh[R];
        const unsigned short* hi_row = xr + (R + 2) * P::XCH * 8 + sh[R + 2];
        const bool lo_in = ir0 + R >= 0 && ir0 + R < H;
        const bool hi_in = ir0 + R + 2 >= 0 && ir0 + R + 2 < H;
        for (int col = lane; col < P::XW; col += 32) {
          uint32_t lo = lo_row[col], hi = hi_row[col];
          if (!inside) {
            const int ic = ic0 + col / CIN;
            const bool col_in = ic >= 0 && ic < H;
            lo = col_in && lo_in ? lo : 0u;
            hi = col_in && hi_in ? hi : 0u;
          }
          xp[R * P::XPW + col] = lo | (hi << 16);
        }
      }
    }
    __syncthreads();
    // dW += dz^T . X over the tile, in 16-pixel mma steps, by the first 8
    // warps; a step's fragments load during the last step's products
    if (warp < 2 * WARPS_N) {
      auto fragments = [&](int q, uint32_t (&a)[2][4], uint32_t (&b)[NT][2]) {
        const int rr0 = 2 * (q / (P::TC / 8)), cc0 = 8 * (q % (P::TC / 8));
        const uint32_t* xq = xp + 2 * rr0 * P::XPW + 2 * CIN * cc0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ldsm_x4_trans(a[i], dz + (16 * q + r8 + (mi / 2) * 8) * P::DZ_LD + 32 * mw + 16 * i +
                                  (mi % 2) * 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          b[j][0] = xq[off[j]];
          b[j][1] = xq[off[j] + 8 * CIN];
        }
      };
      auto products = [&](const uint32_t (&a)[2][4], const uint32_t (&b)[NT][2]) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (NT * nw + j >= N_TILES) continue;  // uniform in the warp
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b[j]);
        }
      };
      uint32_t a0[2][4], b0[NT][2], a1[2][4], b1[NT][2];
      fragments(0, a0, b0);
      for (int q = 0; q < P::TILE / 16; q += 2) {
        fragments(q + 1, a1, b1);
        products(a0, b0);
        if (q + 2 < P::TILE / 16) fragments(q + 2, a0, b0);
        products(a1, b1);
        if ((q + 2) % (KCHUNK / 16) == 0) {  // the chain ends: IEEE adds into the sum
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                sum[i][j][r] = __fadd_rn(sum[i][j][r], acc[i][j][r]);
                acc[i][j][r] = 0.f;
              }
        }
      }
    }
    __syncthreads();  // the slot, dz and the packed image are free
  }
  cp_async_wait<0>();
  // partials[block][f][c][ky][kx]: the weight's own OIHW order; sum[i][j][2h + e]
  // is channel 32 mw + 16 i + gq + 8 h, tap 8 (NT nw + j) + 2 tq + e
  if (warp >= 2 * WARPS_N) return;
  float* out = partials + static_cast<size_t>(blockIdx.x) * F * TAPS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int f = 32 * mw + 16 * i + gq + 8 * (r / 2);
        const int tap = 8 * (NT * nw + j) + 2 * tq + r % 2;
        if (tap >= TAPS) continue;
        const int ky = tap / ROW_TAPS, kx = (tap % ROW_TAPS) / CIN, c = tap % CIN;
        out[f * TAPS + (c * KS + ky) * KS + kx] = sum[i][j][r];
      }
}

int reduction_blocks(long long items, long long per_block) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_PARTIALS) blocks = MAX_PARTIALS;
  return static_cast<int>(blocks);
}

int finish(const float* partials, int blocks, int width, void* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(width + FIN_COLS - 1) / FIN_COLS, THREADS, 0, s>>>(
      partials, blocks, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The tile each bf16 backward kernel takes: the fastest of the plans below
// in a sweep on the card (`block_bwd_ab.py --kind stem --sweep`, PERF.md).
constexpr int SUMS_TR = 8, SUMS_TC = 32;
constexpr int WGRAD_TR = 8, WGRAD_TC = 32;

// Blocks of a persistent kernel with `smem` bytes of dynamic shared memory:
// as many as the card holds at once, at most `cap` and one a tile.
template <class Kernel>
int persistent_blocks(Kernel kernel, int threads, int smem, long long tiles, int cap,
                      int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long n = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  n = n < tiles ? n : tiles;
  n = n < cap ? n : cap;
  *blocks = static_cast<int>(n > 0 ? n : 1);
  return 0;
}

template <class P>
struct SumsLaunch {
  static int run(const void* z, const void* dp, int B, int S, const void* scale,
                 const void* bias, const void* mean, const void* sigma_inv, float* part,
                 int* blocks, cudaStream_t s) {
    const int err = persistent_blocks(bwd_sums_partial_bf16<P>, SUMS_THREADS, P::SUMS_SMEM,
                                      tile_count<P::TR, P::TC>(B, S), MAX_PARTIALS, blocks);
    if (err) return err;
    bwd_sums_partial_bf16<P><<<*blocks, SUMS_THREADS, P::SUMS_SMEM, s>>>(
        static_cast<const bf16*>(z), static_cast<const bf16*>(dp), B, S,
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(mean), static_cast<const float*>(sigma_inv), part);
    return 0;
  }
};

template <class P>
struct WgradLaunch {
  static int run(const void* z, const void* dp, const void* x, int B, int S, const void* scale,
                 const void* bias, const void* mean, const void* sigma_inv,
                 const void* mean_s1, const void* mean_s2, float* part, int* blocks,
                 cudaStream_t s) {
    const int err = persistent_blocks(bwd_wgrad_partial_bf16<P>, WGRAD_THREADS, P::WGRAD_SMEM,
                                      tile_count<P::TR, P::TC>(B, S), WGRAD_BLOCKS, blocks);
    if (err) return err;
    bwd_wgrad_partial_bf16<P><<<*blocks, WGRAD_THREADS, P::WGRAD_SMEM, s>>>(
        static_cast<const bf16*>(z), static_cast<const bf16*>(dp), static_cast<const bf16*>(x),
        B, S, static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(mean), static_cast<const float*>(sigma_inv),
        static_cast<const float*>(mean_s1), static_cast<const float*>(mean_s2), part);
    return 0;
  }
};

// Launch<Plan<tr, tc>>::run(args...) for the plans built here; an error for
// any other tile.
template <template <class> class Launch, class... Args>
int with_plan(int tr, int tc, Args... args) {
  if (tr == 8 && tc == 16) return Launch<Plan<8, 16>>::run(args...);
  if (tr == 8 && tc == 32) return Launch<Plan<8, 32>>::run(args...);
  if (tr == 16 && tc == 16) return Launch<Plan<16, 16>>::run(args...);
  if (tr == 4 && tc == 32) return Launch<Plan<4, 32>>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define ISWM_DISPATCH(BF16, ...) \
  if (BF16) {                    \
    using T = __nv_bfloat16;     \
    __VA_ARGS__;                 \
  } else {                       \
    using T = float;             \
    __VA_ARGS__;                 \
  }

extern "C" {

// Floats of scratch that the two reductions and the weight gradient need.
int iswm_stem_reduce_scratch() { return MAX_PARTIALS * 2 * F; }
int iswm_stem_wgrad_scratch() { return WGRAD_BLOCKS * F * TAPS; }

// out: 128 floats, (sum z)[64] then (sum z^2)[64], over `pixels` = B * S * S.
int iswm_stem_stats(const void* z, int bf16, long long pixels, void* scratch,
                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int blocks = reduction_blocks(pixels, 16 * LANES);
  ISWM_DISPATCH(bf16, stats_partial<T><<<blocks, THREADS, 0, s>>>(
                          static_cast<const T*>(z), pixels, part))
  return finish(part, blocks, 2 * F, out, s);
}

// p [B, S/2, S/2, 64] in z's type.
int iswm_stem_pool_fwd(const void* z, int bf16, int B, int S, const void* scale,
                       const void* bias, void* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long windows = static_cast<long long>(B) * (S / 2) * (S / 2);
  long long blocks = (windows + LANES - 1) / LANES;
  if (blocks > 65536) blocks = 65536;
  if (blocks < 1) blocks = 1;
  ISWM_DISPATCH(bf16, pool_fwd<T><<<static_cast<int>(blocks), THREADS, 0, s>>>(
                          static_cast<const T*>(z), static_cast<const float*>(scale),
                          static_cast<const float*>(bias), B, S, static_cast<T*>(p)))
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward's tiles: out = {sums rows, sums columns, wgrad rows,
// wgrad columns}.
void iswm_stem_bwd_tiles(int* out) {
  out[0] = SUMS_TR;
  out[1] = SUMS_TC;
  out[2] = WGRAD_TR;
  out[3] = WGRAD_TC;
}

// iswm_stem_bwd_sums for bf16 with a tile of tr x tc conv pixels (8 x 16,
// 8 x 32, 16 x 16 or 4 x 32).
int iswm_stem_bwd_sums_tiled(const void* z, const void* dp, int B, int S, const void* scale,
                             const void* bias, const void* mean, const void* sigma_inv,
                             void* scratch, void* out, int tr, int tc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int blocks = 0;
  const int rc = with_plan<SumsLaunch>(tr, tc, z, dp, B, S, scale, bias, mean, sigma_inv, part,
                                       &blocks, s);
  if (rc) return rc;
  return finish(part, blocks, 2 * F, out, s);
}

// out: 128 floats, s1[64] (dbeta) then s2[64] (dgamma).
int iswm_stem_bwd_sums(const void* z, const void* dp, int bf16, int B, int S,
                       const void* scale, const void* bias, const void* mean,
                       const void* sigma_inv, void* scratch, void* out,
                       void* stream) {
  if (bf16) {
    return iswm_stem_bwd_sums_tiled(z, dp, B, S, scale, bias, mean, sigma_inv, scratch, out,
                                    SUMS_TR, SUMS_TC, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int blocks = reduction_blocks(tile_count(B, S), 1);
  bwd_sums_partial<float><<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(dp), B, S,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(mean), static_cast<const float*>(sigma_inv), part);
  return finish(part, blocks, 2 * F, out, s);
}

// iswm_stem_bwd_wgrad for bf16 with a tile of tr x tc conv pixels.
int iswm_stem_bwd_wgrad_tiled(const void* z, const void* dp, const void* x, int B, int S,
                              const void* scale, const void* bias, const void* mean,
                              const void* sigma_inv, const void* mean_s1,
                              const void* mean_s2, void* scratch, void* dw, int tr, int tc,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int blocks = 0;
  const int rc = with_plan<WgradLaunch>(tr, tc, z, dp, x, B, S, scale, bias, mean, sigma_inv,
                                        mean_s1, mean_s2, part, &blocks, s);
  if (rc) return rc;
  return finish(part, blocks, F * TAPS, dw, s);
}

// dw: 64 * 3 * 7 * 7 floats in OIHW order.  mean_s1 = s1 / N, mean_s2 = s2 / N.
int iswm_stem_bwd_wgrad(const void* z, const void* dp, const void* x, int bf16,
                        int B, int S, const void* scale, const void* bias,
                        const void* mean, const void* sigma_inv,
                        const void* mean_s1, const void* mean_s2, void* scratch,
                        void* dw, void* stream) {
  if (bf16) {
    return iswm_stem_bwd_wgrad_tiled(z, dp, x, B, S, scale, bias, mean, sigma_inv, mean_s1,
                                     mean_s2, scratch, dw, WGRAD_TR, WGRAD_TC, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  long long tiles = tile_count(B, S);
  const int blocks = static_cast<int>(tiles < WGRAD_BLOCKS ? tiles : WGRAD_BLOCKS);
  bwd_wgrad_partial<float><<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(dp),
      static_cast<const float*>(x), B, S, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mean),
      static_cast<const float*>(sigma_inv), static_cast<const float*>(mean_s1),
      static_cast<const float*>(mean_s2), part);
  return finish(part, blocks, F * TAPS, dw, s);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
