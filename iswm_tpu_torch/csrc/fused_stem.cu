// Fused ResNet stem tail for Hopper (sm_90a): BatchNorm statistics,
// normalize + ReLU + 3x3/s2/p1 max-pool, and the fused backward (the two BN
// reductions, then dz contracted straight into the 7x7/s2 conv's weight
// gradient).
//
// Replaces the TPU kernels of iswm_tpu/ops/pallas/fused_stem.py:
//   stem_stats            (`_stats_kernel`)     -> stats_partial
//   stem_norm_relu_pool   (`_pool_fwd_kernel`)  -> pool_fwd
//   stem_tail_bwd, call 1 (`_bwd_sums_kernel`)  -> bwd_sums_partial
//   stem_tail_bwd, call 2 (`_bwd_wgrad_kernel`) -> bwd_wgrad_partial
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
// What bounds it on this card: device memory for the first three (each reads
// z once, 67 MB at batch 8 and 512^2 crops; a few operations per element).
// The weight gradient is 2 * 147 * 64 operations per conv pixel and runs on
// the float32 FMA units, which bound it.  The design, which is not the TPU
// kernels' (no selection matmuls, no sublane rolls, no sequential grid):
//   - a thread handles 8 neighbouring channels of one pixel, one 16-byte load
//     in bf16; 8 threads cover a pixel, so a warp reads 4 pixels' 128-byte
//     rows;
//   - the backward is a gather.  A block takes a tile of 4 x 16 conv pixels.
//     First it recomputes, for the 3 x 9 pool windows that touch the tile,
//     the maximum and dp / count into shared memory (9 loads of z each, from
//     L1/L2).  Then each conv pixel reads its own z and looks up the one, two
//     or four windows it lies in.  No atomics, no halo exchange;
//   - the weight gradient keeps the tile's dz (64 pixels x 64 channels) and
//     the 13 x 37 x 3 image window in shared memory and contracts them with
//     FMAs: warp w owns channels 8w..8w+7, lane l owns taps l, l+32, .. of the
//     147, 40 accumulators a thread, held across all the tiles of a
//     persistent block.  The row pitch of the window (117) makes a warp's 32
//     tap reads hit 32 different banks;
//   - every sum is deterministic: per-block partials in a fixed order into
//     scratch, then sum_partials adds them in block order.  The grids are
//     functions of the problem size alone, so two launches give the same bits.
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to T and back: what a stored dz would hold.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

__device__ __forceinline__ Tile tile_at(long long t, int S) {
  const int tiles_c = (S + TC - 1) / TC;
  const int tiles_r = (S + TR - 1) / TR;
  Tile tile;
  tile.c0 = static_cast<int>(t % tiles_c) * TC;
  tile.r0 = static_cast<int>((t / tiles_c) % tiles_r) * TR;
  tile.b = t / (static_cast<long long>(tiles_c) * tiles_r);
  return tile;
}

__host__ __device__ inline long long tile_count(long long B, int S) {
  return B * ((S + TC - 1) / TC) * ((S + TR - 1) / TR);
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

// out: 128 floats, s1[64] (dbeta) then s2[64] (dgamma).
int iswm_stem_bwd_sums(const void* z, const void* dp, int bf16, int B, int S,
                       const void* scale, const void* bias, const void* mean,
                       const void* sigma_inv, void* scratch, void* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int blocks = reduction_blocks(tile_count(B, S), 1);
  ISWM_DISPATCH(bf16, bwd_sums_partial<T><<<blocks, THREADS, 0, s>>>(
                          static_cast<const T*>(z), static_cast<const T*>(dp), B, S,
                          static_cast<const float*>(scale),
                          static_cast<const float*>(bias),
                          static_cast<const float*>(mean),
                          static_cast<const float*>(sigma_inv), part))
  return finish(part, blocks, 2 * F, out, s);
}

// dw: 64 * 3 * 7 * 7 floats in OIHW order.  mean_s1 = s1 / N, mean_s2 = s2 / N.
int iswm_stem_bwd_wgrad(const void* z, const void* dp, const void* x, int bf16,
                        int B, int S, const void* scale, const void* bias,
                        const void* mean, const void* sigma_inv,
                        const void* mean_s1, const void* mean_s2, void* scratch,
                        void* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  long long tiles = tile_count(B, S);
  const int blocks = static_cast<int>(tiles < WGRAD_BLOCKS ? tiles : WGRAD_BLOCKS);
  ISWM_DISPATCH(bf16, bwd_wgrad_partial<T><<<blocks, THREADS, 0, s>>>(
                          static_cast<const T*>(z), static_cast<const T*>(dp),
                          static_cast<const T*>(x), B, S,
                          static_cast<const float*>(scale),
                          static_cast<const float*>(bias),
                          static_cast<const float*>(mean),
                          static_cast<const float*>(sigma_inv),
                          static_cast<const float*>(mean_s1),
                          static_cast<const float*>(mean_s2), part))
  return finish(part, blocks, F * TAPS, dw, s);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
