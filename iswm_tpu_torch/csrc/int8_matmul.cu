// int8 x int8 -> int32 matmul with the activation quantize fused in front
// and the dequantize fused behind, for Hopper (sm_90a).
//
//   out[M, N] f32 = float(q(x) @ w) * x_scale * w_scale[n]
//   q(x) = clip(rint(x / x_scale), -127, 127)        (x: [M, K] bf16 or f32)
//
// Replaces the TPU kernel iswm_tpu/ops/pallas/int8_matmul.py `int8_matmul`
// (body `_kernel`), which serving runs for every eligible 1x1 conv
// (iswm_tpu/infer/quantization.py, backend "pallas"), and, with x already
// int8, `int8_matmul_prequant` (body `_kernel_prequant`) of the same file:
// the kernel is a template on x's element type, and for int8_t the x-tile is
// copied as it is, so that entry is this kernel without the quantize
// prologue (its time beside the other's is what the prologue costs).
//
// What bounds it on this card: at the serving shapes (M = 8k..131k pixels,
// K, N = 128..2048) the int8 tensor-core work is small next to the bytes
// moved (x is read in bf16, out is written in f32), so the kernel is bound
// by device memory and, because every N-tile re-quantizes its x-tile, by
// the IEEE divisions of the prologue.  This first version keeps the design
// simple and exact:
//   - one 128x128 output tile per block, 8 warps of 64x32;
//   - each 64-deep K step loads the x-tile, quantizes it in registers into
//     int8 in shared memory, copies the int8 weight tile beside it, and runs
//     `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (inline PTX, not
//     wgmma/TMA: those are for the PRs that make it fast);
//   - blocks walk N fastest, so the blocks that share an x-tile run
//     together and find it in L2;
//   - rows past M are masked in the kernel (no padding of x).
// Shared-memory rows are 80 bytes (64 + 16) so that the 32-bit fragment
// loads of a warp hit 32 distinct banks.
//
// Exactness: the int32 sum is exact, and every float step matches the
// plain version bit for bit: a true IEEE division (__fdiv_rn, never a
// reciprocal; do not build with --use_fast_math), rounding half to even
// (rintf, as jnp.round and torch.round), and the epilogue multiplied left
// to right, (float(acc) * x_scale) * w_scale[n].
//
// Contract (checked by the Python wrapper): K % 128 == 0, N % 128 == 0,
// x (bf16, f32 or int8 codes) row-major [M, K] and 16-byte aligned, w_t = w^T row-major [N, K] int8,
// w_scale [N] f32, out [M, N] f32.  The launch is asynchronous on `stream`;
// the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;
constexpr int WN = 32;
constexpr int MF = WM / 16;  // m16 fragments per warp
constexpr int NF = WN / 8;   // n8 fragments per warp

__device__ __forceinline__ uint32_t quantize4(float a, float b, float c,
                                              float d, float s) {
  float v[4] = {a, b, c, d};
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(__fdiv_rn(v[i], s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q) << (8 * i);
  }
  return packed;
}

// Eight consecutive x values -> eight int8 codes packed in a uint2.
__device__ __forceinline__ uint2 load_quantize8(const float* p, float s) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint2(quantize4(a.x, a.y, a.z, a.w, s),
                    quantize4(b.x, b.y, b.z, b.w, s));
}

__device__ __forceinline__ uint2 load_quantize8(const __nv_bfloat16* p,
                                                float s) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  return make_uint2(quantize4(f0.x, f0.y, f1.x, f1.y, s),
                    quantize4(f2.x, f2.y, f3.x, f3.y, s));
}

// Already int8: eight codes copied as they are (no prologue).
__device__ __forceinline__ uint2 load_quantize8(const int8_t* p, float) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const T* __restrict__ x,
                       const int8_t* __restrict__ w_t,
                       const float* __restrict__ w_scale, float x_scale,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) uint8_t As[BM * LDS];
  __shared__ __align__(16) uint8_t Bs[BN * LDS];

  const int n_tiles = N / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm0 = (warp / 4) * WM;
  const int wn0 = (warp % 4) * WN;

  int acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x-tile: 8 values per thread and step, quantized into shared memory.
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      const int m = m0 + r;
      uint2 q = make_uint2(0u, 0u);
      if (m < M) q = load_quantize8(x + (size_t)m * K + k0 + c, x_scale);
      *reinterpret_cast<uint2*>(As + r * LDS + c) = q;
    }
    // weight tile: 16 int8 per thread and step.
    for (int v = tid; v < BN * BK / 16; v += THREADS) {
      const int r = v / (BK / 16);
      const int c = (v % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(Bs + r * LDS + c) =
          *reinterpret_cast<const uint4*>(w_t + (size_t)(n0 + r) * K + k0 + c);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MF][4];
      uint32_t b[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const uint8_t* p = As + (wm0 + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint8_t* p = Bs + (wn0 + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: (float(acc) * x_scale) * w_scale[n], rows past M masked.
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int n = n0 + wn0 + j * 8 + t * 2;
    const float ws0 = w_scale[n];
    const float ws1 = w_scale[n + 1];
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + h * 8;
        if (m < M) {
          float2 o;
          o.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), x_scale),
                          ws0);
          o.y = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), x_scale), ws1);
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) = o;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x_is_bf16: 1 for bf16 x, 0 for f32 x.  Returns cudaGetLastError().
int iswm_int8_matmul(const void* x, int x_is_bf16, const void* w_t,
                     const void* w_scale, float x_scale, void* out, int M,
                     int K, int N, void* stream) {
  const int m_tiles = (M + BM - 1) / BM;
  const dim3 grid(m_tiles * (N / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_t),
        static_cast<const float*>(w_scale), x_scale, static_cast<float*>(out),
        M, K, N);
  } else {
    int8_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_t),
        static_cast<const float*>(w_scale), x_scale, static_cast<float*>(out),
        M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// x_q [M, K] int8, row-major and 16-byte aligned; the rest as above.
int iswm_int8_matmul_prequant(const void* x_q, const void* w_t,
                              const void* w_scale, float x_scale, void* out,
                              int M, int K, int N, void* stream) {
  const int m_tiles = (M + BM - 1) / BM;
  const dim3 grid(m_tiles * (N / BN));
  int8_matmul_kernel<int8_t>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_t),
          static_cast<const float*>(w_scale), x_scale,
          static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
