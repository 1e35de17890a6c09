// int8 convolutions for Hopper (sm_90a): the activation quantize, a dense
// implicit-GEMM int8 conv on the tensor cores, and a grouped / depthwise int8
// conv on the CUDA cores.
//
//   quantize:  x_q = clip(rint(x / x_scale), -127, 127)      (x: bf16 or f32)
//   conv:      out[b, oy, ox, n] f32 = (float(acc) * x_scale) * w_scale[n]
//                                      (+ bias[n])
//              acc = sum over (kh, kw, c) of x_q[b, iy, ix, c] * w_q[n, kh, kw, c]
//              iy = oy * sh - ph + kh * dh, ix = ox * sw - pw + kw * dw
//
// Replaces what the JAX package leaves to XLA on the int8_exec_xla serving
// path (no pallas_call there): iswm_tpu/ops/int8_xla.py `quantize_activations`
// (:23), `quantized_conv_xla` (:66, lax.conv_general_dilated with int8
// operands and an int32 accumulator), `int8_packed_stem_conv` (:107) and
// `int8_shifted_dilated_conv` (:158).  The last two are TPU lowerings of a
// plain conv (a space-to-depth pack of the 7x7 / stride-2 stem, the valid-tap
// split of an atrous 3x3): here both are this conv at their own geometry, with
// the same numbers, since a tap in the zero padding adds 0.
//
// What bounds it on this card: at the serving slice's 3x3 shapes (ResNet-50,
// OS 16, 8 tiles of 512^2) the int8 work is 2 M N K = 77 GOP an ASPP branch
// (M = 8192, K = 18,432, N = 256), 0.04 ms at 1,979 TOP/s against 0.005 ms to
// move its 16 MB of codes, so the dense conv is bound by the tensor cores; the
// quantize and the grouped conv move bytes and do little else.  This first
// design is simple:
//   - `igemm_kernel`: a block owns a 128 x 64 output tile and walks K = (tap,
//     channel) in steps of 64 through a 3-stage cp.async ring of the A tile
//     [128 rows, 64 bytes] (gathered from the NHWC codes: a row is an output
//     pixel, a 16-byte chunk one tap's run of 16 channels, zero-filled where the
//     tap lies in the padding or past K) and the B tile [64 rows of w, 64
//     bytes]; 8 warps of 32 x 32 take ldmatrix fragments into
//     `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (rows of 80 bytes, so
//     ldmatrix's 8 rows of 16 bytes hit 8 distinct bank groups).  A channel
//     count that is no multiple of 16 (the stem's 3) gathers byte by byte
//     through registers into the same ring.  The epilogue writes float32 from
//     the accumulators.  No wgmma, no TMA, no split of K: a later redesign;
//   - `direct_kernel`: one thread an output value, the output channel fastest
//     (a depthwise conv's neighbouring threads read neighbouring channels), int32
//     multiply-adds, four channels a `dp4a` where the group's channels allow;
//   - `quantize_kernel`: 16 bytes of x a thread where the row allows, over
//     rows of any stride (a channel slice of an NHWC tensor).
//
// Exactness: the int32 sums are exact in any order (|acc| <= K 127^2 < 2^31
// for K < 133,000); every float step matches the plain version bit for bit: a
// true IEEE division (__fdiv_rn; do not build with --use_fast_math), rounding
// half to even (rintf), and the epilogue as __fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA.
//
// Contract (checked by the Python wrapper, ops/kernels/int8_conv.py): x_q NHWC
// int8 contiguous and 16-byte aligned; w_q [N, ldw] int8 rows of (kh, kw, c)
// with ldw >= K a multiple of 16, zero past K; w_scale [N] f32; bias [N] f32
// or null; out [B, Ho, Wo, N] f32 contiguous.  Launches are asynchronous on
// `stream`; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output pixels of a tile
constexpr int BN = 64;      // output channels of a tile
constexpr int BK = 64;      // K bytes of a stage
constexpr int LDS = BK + 16;  // bytes of a shared-memory row
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each

struct Geom {
  int B, H, W, C, Ho, Wo, N, KH, KW, sh, sw, ph, pw, dh, dw, K, ldw;
};

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
// Four 8x8 b16 matrices (8 rows of 16 bytes), row i of matrix j from the
// address of lane 8 j + i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// ------------------------------------------------------------------ quantize
__device__ __forceinline__ int8_t q8(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x rows [P, C] with `ld` elements between rows -> out [P, C] contiguous.
// VEC: each thread takes 16 bytes of x (8 bf16 or 4 f32 values); needs C and
// ld multiples of the vector and x 16-byte aligned.
// 32-bit indices (the wrapper keeps P C < 2^31): a 64-bit division costs
// tens of instructions an element.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x, float s,
                                                       int8_t* __restrict__ out, int P, int C,
                                                       long long ld) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int per_row = C / V;
  const int total = P * per_row;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int p = i / per_row;
    const int c = (i - p * per_row) * V;
    const T* src = x + p * ld + c;
    int8_t* dst = out + static_cast<long long>(p) * C + c;
    if constexpr (VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* v = reinterpret_cast<const T*>(&raw);
      alignas(8) int8_t b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = q8(to_f32(v[j]), s);
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(b);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(b);
      }
    } else {
      *dst = q8(to_f32(*src), s);
    }
  }
}

// ----------------------------------------------------------- implicit GEMM
// The A tile of K step kt into `sa` [BM][LDS]: thread t gathers chunk column
// t % 4 of rows t / 4 and t / 4 + 64.  VEC (C % 16 == 0): a chunk is 16
// channels of one tap, one cp.async; else byte by byte through registers.
template <bool VEC>
__device__ __forceinline__ void load_a(int8_t* sa, const int8_t* __restrict__ x, const Geom& g,
                                       int kt, const long long (&base)[2], const int (&iy0)[2],
                                       const int (&ix0)[2], const bool (&mv)[2]) {
  const int t = threadIdx.x;
  const int c16 = t & 3;
  const int k = kt * BK + c16 * 16;
  if constexpr (VEC) {
    const bool kv = k < g.K;
    int tap = 0, ci = 0, kh = 0, kw = 0;
    if (kv) {
      tap = k / g.C;
      ci = k - tap * g.C;
      kh = tap / g.KW;
      kw = tap - kh * g.KW;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (t >> 2) + 64 * r;
      const int iy = iy0[r] + kh * g.dh, ix = ix0[r] + kw * g.dw;
      const bool valid = kv && mv[r] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const int8_t* src =
          valid ? x + base[r] + (static_cast<long long>(iy) * g.W + ix) * g.C + ci : x;
      cp_async16(sa + row * LDS + c16 * 16, src, valid);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (t >> 2) + 64 * r;
      int tap = k / g.C;
      int ci = k - tap * g.C;
      int kh = tap / g.KW;
      int kw = tap - kh * g.KW;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int iy = iy0[r] + kh * g.dh, ix = ix0[r] + kw * g.dw;
        if (k + j < g.K && mv[r] && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const uint8_t v = static_cast<uint8_t>(
              x[base[r] + (static_cast<long long>(iy) * g.W + ix) * g.C + ci]);
          words[j >> 2] |= static_cast<uint32_t>(v) << (8 * (j & 3));
        }
        if (++ci == g.C) {
          ci = 0;
          if (++kw == g.KW) {
            kw = 0;
            ++kh;
          }
        }
      }
      *reinterpret_cast<uint4*>(sa + row * LDS + c16 * 16) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

// The B tile of K step kt into `sb` [BN][LDS]: thread t copies chunk t % 4 of
// weight row n0 + t / 4 (zeros past N and past ldw).
__device__ __forceinline__ void load_b(int8_t* sb, const int8_t* __restrict__ w, const Geom& g,
                                       int kt, int n0) {
  const int t = threadIdx.x;
  const int n = n0 + (t >> 2);
  const int k = kt * BK + (t & 3) * 16;
  const bool valid = n < g.N && k < g.ldw;
  cp_async16(sb + (t >> 2) * LDS + (t & 3) * 16,
             valid ? w + static_cast<long long>(n) * g.ldw + k : w, valid);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) igemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, float xs,
    float* __restrict__ out, Geom g) {
  __shared__ __align__(128) int8_t smem[STAGES][(BM + BN) * LDS];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int M = g.B * g.Ho * g.Wo;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp & 3, wn = warp >> 2;

  // the two output pixels whose A rows this thread gathers
  long long base[2];
  int iy0[2], ix0[2];
  bool mv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + (t >> 2) + 64 * r;
    mv[r] = m < M;
    const int mm = mv[r] ? m : 0;
    const int b = mm / (g.Ho * g.Wo);
    const int rem = mm - b * g.Ho * g.Wo;
    const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
    base[r] = static_cast<long long>(b) * g.H * g.W * g.C;
    iy0[r] = oy * g.sh - g.ph;
    ix0[r] = ox * g.sw - g.pw;
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (g.ldw + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_a<VEC>(smem[s], x, g, s, base, iy0, ix0, mv);
      load_b(smem[s] + BM * LDS, w, g, s, n0);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nt = kt + STAGES - 1;
    if (nt < KT) {
      load_a<VEC>(smem[nt % STAGES], x, g, nt, base, iy0, ix0, mv);
      load_b(smem[nt % STAGES] + BM * LDS, w, g, nt, n0);
    }
    cp_async_commit();
    const int8_t* sa = smem[kt % STAGES];
    const int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], sa + (wm * 32 + 16 * i + (lane & 15)) * LDS + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(r, sb + (wn * 32 + 16 * jj + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 32 +
                       ((lane >> 3) & 1) * 16);
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment (i, j) holds rows wm 32 + 16 i + lane / 4 (+ 8) and
  // columns wn 32 + 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + 8 * j + 2 * (lane & 3);
    if (n >= g.N) continue;
    const bool two = n + 1 < g.N;
    const float ws0 = w_scale[n], ws1 = two ? w_scale[n + 1] : 0.0f;
    const float b0 = bias ? bias[n] : 0.0f, b1 = bias && two ? bias[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + 16 * i + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        float v0 = dequant(acc[i][j][2 * h], xs, ws0);
        float v1 = dequant(acc[i][j][2 * h + 1], xs, ws1);
        if (bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        float* o = out + static_cast<long long>(m) * g.N + n;
        if (two && (g.N & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------- grouped / direct
// One thread an output value (m, n), n fastest, 32-bit indices (the wrapper
// keeps M N < 2^31).  w rows [N, KH KW Cg] of (kh, kw, c); Cg = C / groups,
// group of n = n / (N / groups).  DP4A: Cg % 4 == 0 and C % 4 == 0 (4-byte
// aligned words of x and w).
template <bool DP4A>
__global__ void __launch_bounds__(256) direct_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, float xs,
    float* __restrict__ out, Geom g, int groups) {
  const int total = g.B * g.Ho * g.Wo * g.N;
  const int cg = g.C / groups, ng = g.N / groups;
  const int kw_len = g.KH * g.KW * cg;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int m = i / g.N;
    const int n = i - m * g.N;
    const int b = m / (g.Ho * g.Wo);
    const int rem = m - b * g.Ho * g.Wo;
    const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
    const int c0 = (n / ng) * cg;
    const int8_t* wn = w + static_cast<long long>(n) * kw_len;
    int acc = 0;
    for (int kh = 0; kh < g.KH; ++kh) {
      const int iy = oy * g.sh - g.ph + kh * g.dh;
      if (iy < 0 || iy >= g.H) continue;
      for (int kw = 0; kw < g.KW; ++kw) {
        const int ix = ox * g.sw - g.pw + kw * g.dw;
        if (ix < 0 || ix >= g.W) continue;
        const int8_t* xp =
            x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C + c0;
        const int8_t* wp = wn + (kh * g.KW + kw) * cg;
        if constexpr (DP4A) {
          for (int c = 0; c < cg; c += 4)
            acc = __dp4a(*reinterpret_cast<const int*>(xp + c),
                         *reinterpret_cast<const int*>(wp + c), acc);
        } else {
          for (int c = 0; c < cg; ++c) acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
        }
      }
    }
    float v = dequant(acc, xs, w_scale[n]);
    if (bias) v = __fadd_rn(v, bias[n]);
    out[i] = v;
  }
}

int grid_for(long long work) {
  long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

extern "C" {

// x rows [P, C] (row stride ld elements), x_is_bf16 1 for bf16, 0 for f32;
// out [P, C] int8 contiguous.  Returns cudaGetLastError().
int iswm_int8_quantize(const void* x, int x_is_bf16, float x_scale, void* out, int P, int C,
                       long long ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = x_is_bf16 ? 2 : 4;
  const int v = 16 / esize;
  const bool vec = C % v == 0 && ld % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = grid_for(static_cast<long long>(P) * (vec ? C / v : C));
  int8_t* o = static_cast<int8_t*>(out);
  if (x_is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (vec) quantize_kernel<__nv_bfloat16, true><<<grid, 256, 0, s>>>(xb, x_scale, o, P, C, ld);
    else quantize_kernel<__nv_bfloat16, false><<<grid, 256, 0, s>>>(xb, x_scale, o, P, C, ld);
  } else {
    const auto* xf = static_cast<const float*>(x);
    if (vec) quantize_kernel<float, true><<<grid, 256, 0, s>>>(xf, x_scale, o, P, C, ld);
    else quantize_kernel<float, false><<<grid, 256, 0, s>>>(xf, x_scale, o, P, C, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// geom[17] = B, H, W, C, Ho, Wo, N, KH, KW, sh, sw, ph, pw, dh, dw, K, ldw.
// Dense conv (groups 1): x_q [B, H, W, C], w_q [N, ldw], bias may be null.
int iswm_int8_conv_igemm(const void* x_q, const void* w_q, const void* w_scale,
                         const void* bias, float x_scale, void* out, const int* geom,
                         void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3],  geom[4],  geom[5],  geom[6],  geom[7], geom[8],
               geom[9], geom[10], geom[11], geom[12], geom[13], geom[14], geom[15], geom[16]};
  const int M = g.B * g.Ho * g.Wo;
  const dim3 grid((g.N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (g.C % 16 == 0) igemm_kernel<true><<<grid, THREADS, 0, s>>>(x, w, ws, bs, x_scale, o, g);
  else igemm_kernel<false><<<grid, THREADS, 0, s>>>(x, w, ws, bs, x_scale, o, g);
  return static_cast<int>(cudaGetLastError());
}

// Grouped conv: as above with w_q [N, KH KW C / groups] (ldw unused).
int iswm_int8_conv_direct(const void* x_q, const void* w_q, const void* w_scale,
                          const void* bias, float x_scale, void* out, const int* geom,
                          int groups, void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3],  geom[4],  geom[5],  geom[6],  geom[7], geom[8],
               geom[9], geom[10], geom[11], geom[12], geom[13], geom[14], geom[15], geom[16]};
  const long long total = static_cast<long long>(g.B) * g.Ho * g.Wo * g.N;
  const int grid = grid_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  const int cg = g.C / groups;
  if (cg % 4 == 0 && g.C % 4 == 0)
    direct_kernel<true><<<grid, 256, 0, s>>>(x, w, ws, bs, x_scale, o, g, groups);
  else
    direct_kernel<false><<<grid, 256, 0, s>>>(x, w, ws, bs, x_scale, o, g, groups);
  return static_cast<int>(cudaGetLastError());
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
