// int8 convolutions for Hopper (sm_90a): the activation quantize, a dense
// implicit-GEMM int8 conv on the tensor cores, a grouped / depthwise int8
// conv on the CUDA cores, and the int8 backward of quantization-aware
// training: its data gradient (the dense conv over the cotangent) and its
// weight gradient (a product over pixels on the tensor cores).
//
//   quantize:  x_q = clip(rint(x / x_scale), -127, 127)      (x: bf16 or f32)
//   conv:      out[b, oy, ox, n] = (float(acc) * x_scale) * w_scale[n]
//                                  (+ bias[n]), stored as float32 or as its
//                                  bf16 rounding (__float2bfloat16_rn)
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
// The backward replaces what the JAX package's QAT leaves to XLA
// (iswm_tpu/ops/int8_train.py, no pallas_call): `_int8_dgrad` (:202, an int8
// conv of the cotangent g_q with the rotated, I/O-swapped per-tensor codes,
// lhs_dilation = stride), `_quant_g` (:273) and `_dyn_quant_x` (:31) and
// `_int8_wgrad` (:232) / `_dil_bwd` (:458, the forward's codes x_q
// contracted with g_q over (B, H, W)):
//   dgrad:     dx[b, iy, ix, c] = float(acc) * (g_s * w_s), the dense conv of
//              g_q dilated by the stride, stride 1, the transpose padding,
//              x's extent; at a stride above 1 split by output parity (no
//              zeros inserted): class (a, b) = dx[:, a::sh, b::sw] is a
//              stride-1 conv of g_q over the taps of the rotated kernel that
//              land on it, all classes in one launch
//   wgrad:     dw[n, c, kh, kw] = float(acc) * (x_s * g_s), acc the sum over
//              the output pixels of g_q[., n] x_q[the tap's pixel, c]
//   quantize:  with its amax = max |x| reduced in the same launch (dynamic),
//              alone (in a process group, before the all-reduce), or beside
//              the codes of a given amax (delayed)
//   weights:   the data gradient's rotated per-tensor codes made on the card
//
// What bounds each kernel on this card, at the serving slice's shapes
// (ResNet-50 and MobileNetV2, OS 16, 8 tiles of 512^2; block_bwd_ab.py --kind
// igemm / direct, edits taking parts out, PERF.md):
//   - the dense conv: its operations bound the 3x3s and the ASPP branches on
//     paper (77 GOP an ASPP branch: 0.04 ms at 1,979 TOP/s), but a 128 x BN
//     tile must bring (128 + BN) x 128 bytes from L2 a K stage, and at those
//     shapes the copies, the products and the stores each take a share of
//     the time: the copies come to about 4-5 TB/s out of L2 (their bytes
//     over the measured times).  The 1x1s (K = 64-512, 131,072 pixels) are
//     bound by a block's prologue and epilogue;
//   - the depthwise conv (9 multiply-adds an output value) by bytes;
//   - the quantize by bytes.
//
// The kernels, and which shapes each takes (the wrapper,
// ops/kernels/int8_conv.py, picks the body and the plan and counts each):
//   - `igemm_wgmma_kernel` (dense, C % 16 == 0: every serving site but the
//     stem).  A block owns a rectangle of 128 output pixels of one image
//     (TH x TW, TW = 128 ... 8) and BN output channels (256, 128, 64 or 8),
//     the plan's (a cost model fitted to every plan's time, in the wrapper).
//     K runs as (tap, channel) in stages of 128 bytes through a ring of 3-4
//     slots in dynamic shared memory, each slot the A tile [128 rows][128
//     bytes] and the B tile [BN rows][128 bytes] in wgmma's 64-byte swizzle,
//     copied one or two stages ahead.  A: gathered by 16-byte cp.async, each
//     thread's (tap, channel) place advanced by counting (no division after
//     the block's first).  B: where C % 64 == 0 and K >= 1,024, two TMA boxes
//     of 64 bytes x BN rows a stage, completed on an mbarrier (a quarter of
//     the copy cost of the same bytes by cp.async at the 3x3s and the ASPP
//     branches); else cp.async.  The two warpgroups (64 rows each) issue four
//     `wgmma.mma_async m64nBNk32 .s32.s8.s8` a stage and keep one group in
//     flight, while the same threads issue the next stages' copies.
//     Tile-level tap skipping: a block lists the taps that read inside the
//     input for at least one pixel of its rectangle (the tile form of the
//     JAX package's valid-tap split; exact, a padding tap adds 0) and walks
//     only their K: at 32^2 the ASPP branches keep 0.92 / 0.75 / 0.44 of
//     their K (d = 6 / 12 / 18).  The epilogue dequantizes in registers,
//     stages the values in the output type through shared memory and writes
//     16-byte rows of float32 or bf16.  Where the tiles give the card too few
//     blocks (the ASPP branches, M = 8), K is split across blocks: each
//     writes its exact int32 partial to a workspace slice, and
//     `igemm_split_finish` adds them in order and runs the epilogue once;
//   - `igemm_bytes_kernel` (dense, C % 16 != 0: the --int8_stem 7x7, C = 3,
//     K = 147): 128 consecutive output pixels x 64 channels, K gathered byte
//     by byte through registers (a tap's 3 channels fill no 16-byte chunk)
//     into a 3-stage ring of mma.sync m16n8k32 tiles;
//   - `direct_tiled_kernel` (depthwise 3x3, C = N = groups, C % 16 == 0,
//     stride and dilation 1 or 2 on both axes: MobileNetV2's 16 sites).  A
//     block owns TH x 16 output pixels x CB channels (CB = 64, 32 or 16, the
//     largest that divides C), stages the input window (tile and halo) into
//     shared memory by 16-byte cp.async, zeros in the padding; a thread holds
//     its 4 channels' 3x3 weights in registers, one byte a word per channel,
//     and computes 4 consecutive output pixels with one __dp4a a channel and
//     tap, each window word read once for the taps and pixels that use it;
//     16-byte float32 stores, or bf16 pairs of neighbouring threads joined
//     by a shuffle into 16-byte stores;
//   - `direct_kernel` (every other grouped conv, Cg > 1 or another kernel
//     size): one thread an output value, `dp4a` where the group's channels
//     allow;
//   - `quantize_kernel` (namespace quant): two 16-byte vectors in flight a
//     thread (one where a tensor is too small to fill the card), rows of any
//     stride (a channel slice of an NHWC tensor) walked by counting, the
//     quotient from a reciprocal where that is exact (see q8_code).  Its
//     reducing modes take max |x| on the raw bits and combine the blocks'
//     maxima with one atomicMax in a stream's workspace; the dynamic mode is
//     one cooperative launch of the blocks the card holds: pass 1 the max, a
//     grid barrier, pass 2 the codes, walked backwards so that what pass 1
//     left in L2 is read again first.  Bound by bytes: x read once on paper
//     (twice from memory for a tensor past L2's share), the codes written;
//   - the data gradient runs `igemm_wgmma_kernel` (or, at a stride of 1 and
//     channels no multiple of 16, the bytewise body): its epilogue's scale
//     is the product of two amaxes' scales and its per-channel scales are 1
//     (an exact product).  At a stride above 1 the kernel's Parity template
//     runs every output parity class of dx in one launch (blockIdx.y), each
//     over its own taps of the rotated kernel at their offsets into the
//     undilated cotangent, its epilogue writing the class's pixels of dx (16-
//     byte rows of channels, pixels sh, sw apart); a class of no tap (three
//     of four at a 1x1 of stride 2) writes its zeros.  Its weights come from
//     `rotated_codes_kernel`: one cooperative launch, the float kernel's
//     amax, a grid barrier, the rotated codes;
//   - the weight gradient's `wgmma` body (namespace wgrad: C and N multiples
//     of 16, an output map of 64 pixels or more): both operands made
//     pixel-major once a call, their tiles copied by TMA into `wgmma`, int32
//     partials added by a finishing pass; see its comment;
//   - `wgrad_mma_kernel` (the weight gradient's other sites: the pooled
//     part's M = 8, channel counts the wgmma body does not take; C and N
//     multiples of 4): see its comment; the pixels split across blocks into
//     int32 partials, `wgrad_finish` adds them and writes OIHW.  Bound by its
//     instructions (the transposes, the barrier) more than by its products.
//
// Exactness: the int32 sums are exact in any order (|acc| <= K 127^2 < 2^31
// for K < 133,000), so skipped padding taps, K splits and any product order
// give the same sums; every float step matches the plain version bit for
// bit: a true IEEE division (__fdiv_rn; do not build with --use_fast_math),
// rounding half to even (rintf), the epilogue as __fmul_rn / __fadd_rn,
// which the compiler never contracts into an FMA, and the bf16 store as
// __float2bfloat16_rn of that float32 value (the plain version's .to()).
//
// Where x_scale comes from: the host passes it as a float (serving, its
// calibrated scales), or the `_amax` entries of the quantize and the dense
// conv read one float32 amax in device memory and form x_scale = amax > 0 ?
// amax / 127 : 1 there, with an IEEE division (quantization-aware training,
// whose dynamic or delayed amax is a device tensor: no host read a conv).
// Both run the same kernels, templated on the scale's source (HostScale,
// AmaxScale); the dense conv's epilogue reads the amax once a block.  The
// backward's entries take two amaxes and multiply their scales (AmaxScale's
// second pointer).
//
// Contract (checked by the Python wrapper): x_q NHWC int8 contiguous and
// 16-byte aligned; w_q [N, ldw] int8 rows of (kh, kw, c) with ldw >= K a
// multiple of 16, zero past K; w_scale [N] f32; bias [N] f32 or null; out
// [B, Ho, Wo, N] f32 or bf16 contiguous; a workspace of splits * M * N int32
// where the plan splits K.  Launches are asynchronous on `stream`; each C
// entry returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (the function is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// The epilogue of every conv: (float(acc) * x_scale) * w_scale (+ bias).
__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}
__device__ __forceinline__ float epilogue(int acc, float xs, float ws, const float* bias, int n) {
  const float v = dequant(acc, xs, ws);
  return bias ? __fadd_rn(v, bias[n]) : v;
}
// The activation scale: a float from the host, or formed from one float32
// amax in device memory as the JAX package's QAT forms it
// (jnp.where(amax > 0, amax / 127.0, 1.0), iswm_tpu/ops/int8_train.py).
struct HostScale {
  float s;
  __device__ __forceinline__ float get() const { return s; }
};
__device__ __forceinline__ float scale_of_amax(const float* amax) {
  const float a = *amax;
  return a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
}
// One amax (the forward's activation scale), or the product of the scales
// of two (the backward's: g_s * w_s for the data gradient, x_s * g_s for the
// weight gradient), taken before it multiplies the sum, as the JAX package's
// `acc * (g_s * w_s)` and `acc * (x_s * g_s)`.
struct AmaxScale {
  const float* amax;
  const float* amax2;  // null: one amax
  __device__ __forceinline__ float get() const {
    const float s = scale_of_amax(amax);
    return amax2 ? __fmul_rn(s, scale_of_amax(amax2)) : s;
  }
};
template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// 16 bytes of output values: 4 float32 or 8 bf16.
template <typename OutT>
__device__ __forceinline__ void store16(OutT* dst, const float* v);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}
// 2 output values, 8- or 4-byte aligned.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// ------------------------------------------------------------------ quantize
// code = clip(rint(v / s), -127, 127) with v / s the IEEE quotient.  The
// quotient is taken as v * r (r = 1 / s, correctly rounded, once a thread):
// within |q| 2^-23 of v / s, so rint(q) is rint(v / s) unless q lies within
// |q| 2^-21 of a tie (k + 1/2), where __fdiv_rn gives the quotient (about one
// value in a million; NaN, infinities and r = NaN, for an s whose reciprocal
// is not a normal float, all take that path).  Bit-equal to rint(__fdiv_rn(v,
// s)) for every v.
__device__ __forceinline__ int q8_code(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  float n = rintf(q);
  if (!(fmaf(fabsf(q), 0x1p-21f, fabsf(__fsub_rn(q, n))) < 0.5f)) n = rintf(__fdiv_rn(v, s));
  return __float2int_rn(fminf(fmaxf(n, -127.0f), 127.0f));
}
// 1 / s for q8_code: NaN (every value by the IEEE division) outside [2^-120, 2^120]
__device__ __forceinline__ float q8_recip(float s) {
  return s >= 0x1p-120f && s <= 0x1p120f ? __frcp_rn(s) : __int_as_float(0x7fffffff);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// |v|'s bits: non-negative floats order as unsigned ints (a NaN above +inf)
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ unsigned abs_bits(__nv_bfloat16 v) {
  return (static_cast<unsigned>(__bfloat16_as_ushort(v)) & 0x7fffu) << 16;
}

// The grid's workspace (one a stream): the max's bits, the grid barrier's
// arrivals, the blocks done; all 0 between launches (the last block resets).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

namespace quant {

constexpr int THREADS = 256;
// 16-byte vectors in flight a thread, at most (2 measured faster than 4 at a
// QAT step's and a serving chunk's shapes: block_bwd_ab.py --kind quantize)
constexpr int UNROLL = 2;
// DYNAMIC: amax = max |x| into amax_out, then the codes with its scale (one
// cooperative launch, a grid barrier between the passes); AMAX: amax alone;
// DELAYED: the codes with the scale of a given amax, and max |x| into
// amax_out in the same read; QUANT: the codes alone (a host or device scale)
enum Mode { QUANT = 0, DYNAMIC = 1, AMAX = 2, DELAYED = 3 };

// The grid's max from every thread's max |x| bits m: the block's, then one
// atomicMax into ws[0].  With `barrier` (a cooperative launch: every block
// resident) each block then waits for every other's (ws[1] counts them) and
// gets the grid's max; else 0.
__device__ __forceinline__ float grid_max(unsigned m, unsigned* ws, bool barrier) {
  __shared__ unsigned warp_max[THREADS / 32];
  __shared__ float amax;
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(ws, m);
    amax = 0.0f;
    if (barrier) {
      add_acq_rel(ws + 1, 1u);
      while (ld_acquire(ws + 1) < gridDim.x) {
      }
      amax = __uint_as_float(ld_acquire(ws));
    }
  }
  __syncthreads();
  return amax;
}
// The end of a block that took part in grid_max: the last block done (ws[2]
// counts them) writes the grid's max to amax_out and leaves ws zeroed.
__device__ __forceinline__ void grid_done(unsigned* ws, float* amax_out) {
  if (threadIdx.x == 0 && add_acq_rel(ws + 2, 1u) == gridDim.x - 1) {
    *amax_out = __uint_as_float(ld_acquire(ws));
    ws[0] = 0u;
    ws[1] = 0u;
    ws[2] = 0u;
  }
}
// this thread's max |x| bits m with 16 bytes of T values (bf16: two halves a lane)
template <typename T>
__device__ __forceinline__ unsigned vec_max(unsigned m, const uint4& v) {
  if constexpr (sizeof(T) == 2) {
    m = __vmaxu2(m, v.x & 0x7fff7fffu);
    m = __vmaxu2(m, v.y & 0x7fff7fffu);
    m = __vmaxu2(m, v.z & 0x7fff7fffu);
    return __vmaxu2(m, v.w & 0x7fff7fffu);
  } else {
    m = max(max(m, v.x & 0x7fffffffu), v.y & 0x7fffffffu);
    return max(max(m, v.z & 0x7fffffffu), v.w & 0x7fffffffu);
  }
}
// m of vec_max as a float's bits
template <typename T>
__device__ __forceinline__ unsigned vec_max_bits(unsigned m) {
  return sizeof(T) == 2 ? max(m & 0xffffu, m >> 16) << 16 : m;
}

// x rows [P, C] with `ld` elements between rows -> out [P, C] contiguous (a
// contiguous x comes as one row).  VEC: 16 bytes of x a vector (8 bf16 or 4
// f32 values); needs C and ld multiples of the vector and 16-byte alignment.
// An iteration of the grid takes u x THREADS vectors a block (u <= UNROLL,
// the launch's: fewer for a small tensor, so that its blocks fill the card),
// a warp's loads consecutive; each thread walks its vectors' (row, column)
// places by counting (one 32-bit division a vector at the start, none
// after; the wrapper keeps P C < 2^31).  The max goes on the raw bits (two
// bf16 halves at once).  DYNAMIC's second pass walks backwards: what the
// first pass read last, still in L2, is read again first.
template <typename T, bool VEC, int MODE, typename S>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const T* __restrict__ x, S scale, int8_t* __restrict__ out, int P, int C,
                    long long ld, int u, float* __restrict__ amax_out, unsigned* __restrict__ ws) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int U = UNROLL;
  constexpr bool REDUCE = MODE != QUANT;
  const unsigned per_row = static_cast<unsigned>(C / V);
  const unsigned total = static_cast<unsigned>(P) * per_row;  // < 2^31
  const unsigned span = gridDim.x * u * THREADS;  // vectors an iteration of the grid
  const int iters = static_cast<int>((total + span - 1) / span);
  const int dp = static_cast<int>(span / per_row), dc = static_cast<int>(span % per_row);
  int p[U], c[U];
  auto place = [&](int it) {  // vector k of this thread at iteration it (k >= u: none)
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned i = static_cast<unsigned>(it) * span + (blockIdx.x * u + k) * THREADS +
                         threadIdx.x;  // < 2^32: total + span
      p[k] = k < u ? static_cast<int>(i / per_row) : P;
      c[k] = static_cast<int>(i - static_cast<unsigned>(p[k]) * per_row);
    }
  };
  auto step = [&](int dir) {  // the next (dir 1) or the previous (-1) iteration
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k >= u) continue;
      c[k] += dir * dc;
      p[k] += dir * dp;
      if (c[k] >= static_cast<int>(per_row)) {
        c[k] -= per_row;
        ++p[k];
      } else if (c[k] < 0) {
        c[k] += per_row;
        --p[k];
      }
    }
  };
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  auto load = [&](Raw (&raw)[U]) {
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (p[k] < P)
        raw[k] = *reinterpret_cast<const Raw*>(x + static_cast<long long>(p[k]) * ld +
                                               static_cast<long long>(c[k]) * V);
  };
  unsigned m = 0u;  // this thread's max |x| bits (VEC bf16: two halves)
  auto take_max = [&](const Raw (&raw)[U]) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (p[k] >= P) continue;
      if constexpr (VEC) m = vec_max<T>(m, raw[k]);
      else m = max(m, abs_bits(raw[k]));
    }
  };
  auto codes = [&](const Raw (&raw)[U], float s, float r) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (p[k] >= P) continue;
      int8_t* dst = out + static_cast<long long>(p[k]) * C + static_cast<long long>(c[k]) * V;
      if constexpr (!VEC) {
        *dst = static_cast<int8_t>(q8_code(to_f32(raw[k]), s, r));
      } else {
        const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
        uint32_t b[V / 4];
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          int q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v;
            if constexpr (V == 8) {  // two bf16 a word, the low half first
              const uint32_t word = w[(4 * j + e) >> 1];
              v = __uint_as_float(e & 1 ? word & 0xffff0000u : word << 16);
            } else {
              v = __uint_as_float(w[4 * j + e]);
            }
            q[e] = q8_code(v, s, r);
          }
          b[j] = (q[0] & 0xff) | (q[1] & 0xff) << 8 | (q[2] & 0xff) << 16 |
                 static_cast<uint32_t>(q[3]) << 24;
        }
        if constexpr (V == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(b[0], b[1]);
        else *reinterpret_cast<uint32_t*>(dst) = b[0];
      }
    }
  };

  float s = 1.0f, r = 1.0f;
  if constexpr (MODE == QUANT || MODE == DELAYED) {
    s = scale.get();
    r = q8_recip(s);
  }
  Raw raw[U];
  place(0);
  for (int it = 0; it < iters; ++it) {  // the first (or only) pass
    load(raw);
    if constexpr (REDUCE) take_max(raw);
    if constexpr (MODE == QUANT || MODE == DELAYED) codes(raw, s, r);
    if (it + 1 < iters) step(1);
  }
  if constexpr (!REDUCE) return;

  if constexpr (VEC) m = vec_max_bits<T>(m);
  const float a = grid_max(m, ws, MODE == DYNAMIC);
  if constexpr (MODE == DYNAMIC) {
    s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
    r = q8_recip(s);
    if (iters > 0) {  // the second pass, backwards from this thread's last place
      place(iters - 1);
      for (int it = iters - 1; it >= 0; --it) {
        load(raw);
        codes(raw, s, r);
        if (it > 0) step(-1);
      }
    }
  }
  grid_done(ws, amax_out);
}

}  // namespace quant

// ------------------------------------------------------ dense conv on wgmma
// A wgmma operand in shared memory, K-major with the 64-byte swizzle: rows
// of 64 bytes whose 16-byte chunk c sits at c ^ ((row / 2) % 4), in atoms
// of 8 rows (512 bytes, 512-byte aligned) `sbo` bytes apart along M (or N).
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t{1} << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{2} << 62;
}
__device__ __forceinline__ int sw64(int row, int kbyte) {
  return row * 64 + ((((kbyte >> 4) & 3) ^ ((row >> 1) & 3)) << 4) + (kbyte & 15);
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
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// mbarriers and the tensor memory accelerator (TMA): a 2-D box of the
// weights [N rows][ldw bytes] copied into shared memory in the 64-byte
// swizzle, its bytes counted on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// D[64 x N] s32 += A[64 x 32] s8 x B[N x 32]^T s8, both K-major in shared
// memory, one warpgroup; D in the mma.sync layout of each warp's 16 rows, n8
// block i in d[4 i .. 4 i + 3].  One overload a tile width N.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b));
}

namespace dense {

constexpr int BM = 128;        // output pixels of a tile: two warpgroups of 64 rows
constexpr int BK = 128;        // K bytes of a stage: two 64-byte swizzle blocks
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 64;   // KH KW (checked by the wrapper)

__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * BK; }
// values of a staged epilogue row (int32, float or bf16): 16-byte rows whose
// fragment stores spread over the banks
__host__ __device__ constexpr int tile_ld(int bn) { return bn + 8; }
// Dynamic shared memory of a block: the ring, which the epilogue's staged
// int32 tile reuses.
__host__ __device__ constexpr int smem_bytes(int bn, int slots) {
  return slots * stage_bytes(bn) > BM * tile_ld(bn) * 4 ? slots * stage_bytes(bn)
                                                        : BM * tile_ld(bn) * 4;
}

// The data gradient split by output parity (a stride above 1): class (a,
// b) is dx[:, a::sh, b::sw, :], a stride-1 conv of the undilated cotangent
// over the taps (i, j) of the rotated kernel whose (a + before - i dh) ... is
// a multiple of the stride (the wrapper's `dgrad_classes`), each at its own
// offset (dy, dx) into g.  Classes in blockIdx.y, their taps in a table; a
// class of no tap writes its zeros.  NoParity: every other launch.
constexpr int MAX_CLASSES = 16;  // sh sw
struct NoParity {
  static constexpr bool split = false;
};
struct Parity {
  static constexpr bool split = true;
  int sh, sw, H, W;             // the stride; dx's extent
  int4 cls[MAX_CLASSES];        // a, b, the class's extent Hc, Wc
  int tap0[MAX_CLASSES + 1];    // class k's taps: tap[tap0[k] .. tap0[k + 1])
  int4 tap[MAX_TAPS];           // dy, dx, K offset (tap (i, j)'s (i KW + j) C), 0
};

// Whether some o in [o0, o1] has 0 <= o s + off < n: the output positions a
// tap offset `off` reads inside the input are ceil(-off / s) .. floor((n - 1
// - off) / s).
__device__ __forceinline__ bool axis_hits(int o0, int o1, int s, int off, int n) {
  const int lo = off >= 0 ? 0 : (-off + s - 1) / s;
  if (n - 1 - off < 0) return false;
  const int hi = (n - 1 - off) / s;
  return (lo > o0 ? lo : o0) <= (hi < o1 ? hi : o1);
}

// One block: output rectangle `tile` (TH x TW pixels of image b) x channels
// [n0, n0 + BN), over the K stages [s0, s1) of its split.  Stage s of the
// block is K' bytes [s BK, (s + 1) BK) of its valid taps' K, K' = taps C:
// thread t copies 16-byte chunk column j = t % 8 of it (tap v, channel c) for
// A rows t / 8 + 32 i and B rows t / 8 + 32 i.
// Blocks an SM can hold by shared memory (1 KB reserved a block; the static
// tables take at most 4 KB): the register cap of __launch_bounds__.
__host__ __device__ constexpr int min_blocks(int bn, int slots) {
  return 2 * (smem_bytes(bn, slots) + 4096 + 1024) <= 233472 ? 2 : 1;
}

template <int BN, int SLOTS, bool TMA_B, typename OutT, typename S, typename PAR>
__global__ void __launch_bounds__(THREADS, min_blocks(BN, SLOTS))
    igemm_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const __grid_constant__ CUtensorMap w_map,
                       const float* __restrict__ w_scale, const float* __restrict__ bias,
                       S scale, OutT* __restrict__ out, int* __restrict__ partial, Geom g,
                       int tw_log2, int splits, const __grid_constant__ PAR par) {
  static_assert(SLOTS >= 3, "a slot multiplied, one in flight, one loading");
  constexpr int STAGE = stage_bytes(BN);
  constexpr int LD = tile_ld(BN);
  constexpr int AROWS = BM / 32;             // A rows a thread copies
  constexpr int BROWS = (BN + 31) / 32;      // B rows a thread copies (some idle at BN 8)
  extern __shared__ __align__(1024) unsigned char smem[];  // whole swizzle atoms
  __shared__ int4 taps[MAX_TAPS];  // a valid tap: dy, dx, its K offset, its x offset
  __shared__ int tap_count;
  __shared__ __align__(8) uint64_t full[SLOTS];  // TMA_B: a slot's weights have landed
  __shared__ __align__(16) float s_scale[BN];
  __shared__ __align__(16) float s_bias[BN];

  const int t = threadIdx.x;
  const int TW = 1 << tw_log2, TH = BM >> tw_log2;
  const int NT = (g.N + BN - 1) / BN;
  int Ho = g.Ho, Wo = g.Wo;  // the output's extent (PAR: the class's)
  int4 cls = make_int4(0, 0, 0, 0);
  if constexpr (PAR::split) {
    cls = par.cls[blockIdx.y];
    Ho = cls.z;
    Wo = cls.w;
  }
  const int tiles_x = (Wo + TW - 1) >> tw_log2, tiles_y = (Ho + TH - 1) / TH;
  int bid = blockIdx.x;
  const int nt = bid % NT;
  bid /= NT;
  const int split = bid % splits;
  bid /= splits;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  if constexpr (PAR::split) {
    if (b >= g.B) return;  // past this class's blocks (the grid fits the largest)
  }
  const int oy0 = ty * TH, ox0 = tx * TW, n0 = nt * BN;

  if (t < 32) {  // warp 0: lane l judges taps l and l + 32, a ballot orders them
    const int oy1 = min(oy0 + TH, Ho) - 1, ox1 = min(ox0 + TW, Wo) - 1;
    int before = 0;
#pragma unroll
    for (int half = 0; half < MAX_TAPS / 32; ++half) {
      const int tap = t + 32 * half;
      bool hit;
      int4 entry;
      if constexpr (PAR::split) {  // the class's taps (stride 1, no padding)
        const int first = par.tap0[blockIdx.y];
        hit = tap < par.tap0[blockIdx.y + 1] - first;
        const int4 e = par.tap[hit ? first + tap : 0];
        hit = hit && axis_hits(oy0, oy1, 1, e.x, g.H) && axis_hits(ox0, ox1, 1, e.y, g.W);
        entry = make_int4(e.x, e.y, e.z, (e.x * g.W + e.y) * g.C);
      } else {
        const int kh = tap / g.KW, kw = tap - kh * g.KW;
        hit = tap < g.KH * g.KW && axis_hits(oy0, oy1, g.sh, kh * g.dh - g.ph, g.H) &&
              axis_hits(ox0, ox1, g.sw, kw * g.dw - g.pw, g.W);
        entry = make_int4(kh * g.dh, kw * g.dw, tap * g.C, (kh * g.dh * g.W + kw * g.dw) * g.C);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) taps[before + __popc(mask & ((1u << t) - 1))] = entry;
      before += __popc(mask);
    }
    if (t == 0) tap_count = before;
  }
  if constexpr (TMA_B) {
    if (t == 0) {
      for (int i = 0; i < SLOTS; ++i) mbar_init(&full[i], 2);  // threads 0 and 4 arrive
      mbar_fence_init();
    }
  }
  __syncthreads();
  const int ntaps = tap_count;
  const int steps_all = (ntaps * g.C + BK - 1) / BK;
  const int s0 = static_cast<int>(static_cast<long long>(split) * steps_all / splits);
  const int s1 = static_cast<int>(static_cast<long long>(split + 1) * steps_all / splits);
  const int steps = s1 - s0;

  // this thread's A rows: where each output pixel's tap (0, 0) lies
  const int j = t & 7, row0 = t >> 3;
  const int8_t* rp[AROWS];
  int iy0[AROWS], ix0[AROWS];
  bool mv[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const int r = row0 + 32 * i;
    const int oy = oy0 + (r >> tw_log2), ox = ox0 + (r & (TW - 1));
    mv[i] = oy < Ho && ox < Wo;
    iy0[i] = oy * g.sh - g.ph;
    ix0[i] = ox * g.sw - g.pw;
    rp[i] = x + (static_cast<long long>(b * g.H + iy0[i]) * g.W + ix0[i]) * g.C;
  }
  // this thread's place in K': valid tap v, channel c of chunk column j
  int kp = s0 * BK + 16 * j;
  int v = kp / g.C;
  int c = kp - v * g.C;
  auto advance = [&]() {
    c += BK;
    while (c >= g.C) {
      c -= g.C;
      ++v;
    }
  };
  auto load = [&](int slot) {
    unsigned char* sa = smem + slot * STAGE;
    unsigned char* sb = sa + BM * BK;
    const bool kv = v < ntaps;
    const int4 tap = kv ? taps[v] : make_int4(0, 0, 0, 0);
    const int kb = j >> 2, kc = (j & 3) * 16;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int iy = iy0[i] + tap.x, ix = ix0[i] + tap.y;
      const bool ok = kv && mv[i] && static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
      cp_async16(sa + kb * (BM * 64) + sw64(row0 + 32 * i, kc), ok ? rp[i] + tap.w + c : x, ok);
    }
    if constexpr (TMA_B) {
      // threads 0 and 4 (chunk columns 0 and 4) copy the stage's two 64-byte
      // K halves of the BN weight rows, each within one tap (C % 64 == 0);
      // rows past N land as zeros; a half past K is left as it was (its A is 0)
      if ((t & ~4) == 0) {
        if (kv) {
          mbar_arrive_tx(&full[slot], BN * 64);
          tma_load_2d(sb + kb * (BN * 64), &w_map, tap.z + c, n0, &full[slot]);
        } else {
          mbar_arrive(&full[slot]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BROWS; ++i) {
        const int r = row0 + 32 * i;
        if (BN % 32 == 0 || r < BN) {
          const int n = n0 + r;
          const bool ok = kv && n < g.N;
          cp_async16(sb + kb * (BN * 64) + sw64(r, kc),
                     ok ? w + static_cast<long long>(n) * g.ldw + tap.z + c : w, ok);
        }
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int wg = t >> 7;
  auto products = [&](int slot) {
    const unsigned char* sa = smem + slot * STAGE + wg * (64 * 64);
    const unsigned char* sb = smem + slot * STAGE + BM * BK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {  // K advances inside the swizzle's rows by the address
      wgmma_s8(acc, smem_desc_sw64(sa + (kk >> 1) * (BM * 64) + (kk & 1) * 32, 512),
               smem_desc_sw64(sb + (kk >> 1) * (BN * 64) + (kk & 1) * 32, 512));
    }
    wgmma_commit();
  };

  // The ring: stage s in slot s % SLOTS, copied SLOTS - 2 stages ahead, one
  // cp.async group a stage (empty past the end).  At the top of stage i the
  // group of stage i is the (i + 1)-th of (SLOTS - 2) + i, and the slot the
  // next copy fills last held stage i - 2, whose products are done (the wait
  // for one group in flight at the end of stage i - 1, then the barrier).
#pragma unroll
  for (int st = 0; st < SLOTS - 2; ++st) {
    if (st < steps) {
      load(st);
      advance();
    }
    cp_async_commit();
  }
  // the epilogue's scales, while the first stages are in flight (the first
  // barrier of the loop, or the one before the epilogue, publishes them)
  for (int i = t; i < BN; i += THREADS) {
    const int n = n0 + i;
    s_scale[i] = n < g.N ? w_scale[n] : 0.0f;
    s_bias[i] = bias && n < g.N ? bias[n] : 0.0f;
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<SLOTS - 3>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (TMA_B) mbar_wait(&full[i % SLOTS], (i / SLOTS) & 1);
    if (i + SLOTS - 2 < steps) {
      load((i + SLOTS - 2) % SLOTS);
      advance();
    }
    cp_async_commit();
    products(i % SLOTS);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup done with the ring: it becomes the staged tile

  // out (or the split's partial) row of tile row r: -1 where r lies outside
  // the output
  auto out_row = [&](int r) -> long long {
    const int oy = oy0 + (r >> tw_log2), ox = ox0 + (r & (TW - 1));
    if (oy >= Ho || ox >= Wo) return -1;
    if constexpr (PAR::split)  // the class's pixel (oy, ox) is dx's (a + oy sh, b + ox sw)
      return (static_cast<long long>(b) * par.H + cls.x + oy * par.sh) * par.W + cls.y +
             ox * par.sw;
    return (static_cast<long long>(b) * Ho + oy) * Wo + ox;
  };
  // The tile goes out through shared memory as rows of LD values: warp w's
  // 16 rows of its warpgroup, n8 block q in acc[4 q ..]: rows lane / 4 (+ 8),
  // columns 8 q + 2 (lane % 4) (+ 1).  Whole: the epilogue's values in OutT,
  // then 16-byte copies of the rows.  Split: the int32 sums, then int4
  // copies into the split's slice of the partials.
  const int warp = t >> 5, lane = t & 31;
  const int frow = wg * 64 + (warp & 3) * 16 + (lane >> 2), fcol = 2 * (lane & 3);
  if (splits == 1) {
    OutT* tile = reinterpret_cast<OutT*>(smem);
    const float xs = scale.get();
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = 8 * q + fcol;
      const float2 ws = *reinterpret_cast<const float2*>(s_scale + col);
      const float2 bs = *reinterpret_cast<const float2*>(s_bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = dequant(acc[4 * q + 2 * h], xs, ws.x);
        float v1 = dequant(acc[4 * q + 2 * h + 1], xs, ws.y);
        if (bias) {
          v0 = __fadd_rn(v0, bs.x);
          v1 = __fadd_rn(v1, bs.y);
        }
        store2(tile + (frow + 8 * h) * LD + col, v0, v1);
      }
    }
    __syncthreads();
    constexpr int V = 16 / static_cast<int>(sizeof(OutT));  // values a 16-byte copy
    if (g.N % V == 0) {  // 16-byte aligned rows of out
      constexpr int CPR = BN / V;
      for (int q = t; q < BM * CPR; q += THREADS) {
        const int r = q / CPR, cc = (q - r * CPR) * V;
        const long long m = out_row(r);
        if (m < 0 || n0 + cc >= g.N) continue;
        *reinterpret_cast<uint4*>(out + m * g.N + n0 + cc) =
            *reinterpret_cast<const uint4*>(tile + r * LD + cc);
      }
    } else {
      for (int q = t; q < BM * BN; q += THREADS) {
        const int r = q / BN, cc = q - r * BN;
        const long long m = out_row(r);
        if (m < 0 || n0 + cc >= g.N) continue;
        out[m * g.N + n0 + cc] = tile[r * LD + cc];
      }
    }
  } else {
    int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      *reinterpret_cast<int2*>(tile + frow * LD + 8 * q + fcol) =
          make_int2(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<int2*>(tile + (frow + 8) * LD + 8 * q + fcol) =
          make_int2(acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();
    long long pixels = static_cast<long long>(Ho) * Wo;  // of an image of the output
    if constexpr (PAR::split) pixels = static_cast<long long>(par.H) * par.W;
    int* part = partial + split * g.B * pixels * g.N;
    if (g.N % 4 == 0) {
      constexpr int CPR = BN / 4;
      for (int q = t; q < BM * CPR; q += THREADS) {
        const int r = q / CPR, cc = (q - r * CPR) * 4;
        const long long m = out_row(r);
        if (m < 0 || n0 + cc >= g.N) continue;
        *reinterpret_cast<int4*>(part + m * g.N + n0 + cc) =
            *reinterpret_cast<const int4*>(tile + r * LD + cc);
      }
    } else {
      for (int q = t; q < BM * BN; q += THREADS) {
        const int r = q / BN, cc = q - r * BN;
        const long long m = out_row(r);
        if (m < 0 || n0 + cc >= g.N) continue;
        part[m * g.N + n0 + cc] = tile[r * LD + cc];
      }
    }
  }
}

// After a K split: the splits' int32 partials [splits][M N], added in split
// order (exact), then the epilogue once.
template <typename OutT, typename S>
__global__ void __launch_bounds__(256)
    igemm_split_finish(const int* __restrict__ partial, int splits, int mn, int N,
                       const float* __restrict__ w_scale, const float* __restrict__ bias,
                       S scale, OutT* __restrict__ out) {
  const float xs = scale.get();
  for (int i = blockIdx.x * 256 + threadIdx.x; i < mn; i += gridDim.x * 256) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += partial[static_cast<long long>(s) * mn + i];
    const int n = i % N;
    out[i] = to_out<OutT>(epilogue(acc, xs, w_scale[n], bias, n));
  }
}

}  // namespace dense

// ------------------------------------------- dense conv, bytewise gather
// For C % 16 != 0 (the stem's C = 3): a block owns 128 consecutive output
// pixels x 64 channels and walks K in steps of 64 bytes through a 3-stage
// ring; each thread gathers its chunk of 16 K bytes byte by byte through
// registers, and 8 warps of 32 x 32 take ldmatrix fragments into mma.sync
// m16n8k32 (rows of 80 bytes, so that ldmatrix's 8 rows of 16 bytes hit 8
// distinct bank groups).
namespace bytewise {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each

// The A tile of K step kt into `sa` [BM][LDS]: thread t gathers chunk column
// t % 4 of rows t / 4 and t / 4 + 64.
__device__ __forceinline__ void load_a(int8_t* sa, const int8_t* __restrict__ x, const Geom& g,
                                       int kt, const long long (&base)[2], const int (&iy0)[2],
                                       const int (&ix0)[2], const bool (&mv)[2]) {
  const int t = threadIdx.x;
  const int c16 = t & 3;
  const int k = kt * BK + c16 * 16;
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

template <typename OutT, typename S>
__global__ void __launch_bounds__(THREADS) igemm_bytes_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, S scale,
    OutT* __restrict__ out, Geom g) {
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
      load_a(smem[s], x, g, s, base, iy0, ix0, mv);
      load_b(smem[s] + BM * LDS, w, g, s, n0);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nt = kt + STAGES - 1;
    if (nt < KT) {
      load_a(smem[nt % STAGES], x, g, nt, base, iy0, ix0, mv);
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
  const float xs = scale.get();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + 8 * j + 2 * (lane & 3);
    if (n >= g.N) continue;
    const bool two = n + 1 < g.N;
    const float ws0 = w_scale[n], ws1 = two ? w_scale[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + 16 * i + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        const float v0 = epilogue(acc[i][j][2 * h], xs, ws0, bias, n);
        OutT* o = out + static_cast<long long>(m) * g.N + n;
        if (!two) {
          o[0] = to_out<OutT>(v0);
          continue;
        }
        const float v1 = epilogue(acc[i][j][2 * h + 1], xs, ws1, bias, n + 1);
        if (g.N & 1) {
          o[0] = to_out<OutT>(v0);
          o[1] = to_out<OutT>(v1);
        } else {
          store2(o, v0, v1);
        }
      }
    }
  }
}

}  // namespace bytewise

// ------------------------------------------------------- grouped / direct
namespace direct {

// Depthwise 3x3 (C = N = groups), stride S and dilation D on both axes, C a
// multiple of CB.  A block: output pixels TH x 16 of one image x channels
// [c0, c0 + CB).  Thread t: channels c0 + 4 (t % G) .. + 3 and pixels 4 lx ..
// 4 lx + 3 of tile row ly (lane t / G = ly * 4 + lx).  The window of the
// block's input rows and columns (tile and halo), CB bytes a pixel, is staged
// once by cp.async, zeros in the padding.
template <int S, int D, int CB, typename OutT>
__global__ void __launch_bounds__(256) direct_tiled_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, float xs,
    OutT* __restrict__ out, Geom g) {
  constexpr int G = CB / 4;          // channel quads
  constexpr int LANES = 256 / G;     // pixel lanes
  constexpr int P = 4;               // pixels a thread, consecutive along x
  constexpr int TW = 16, LX = TW / P;
  constexpr int TH = LANES / LX;     // 4 (CB 64), 8 (32), 16 (16)
  constexpr int WH = (TH - 1) * S + 2 * D + 1, WW = (TW - 1) * S + 2 * D + 1;
  constexpr int CHUNKS = CB / 16;    // 16-byte chunks a window pixel
  constexpr int NC = (P - 1) * S + 2 * D + 1;  // window columns a thread's pixels read in a row
  __shared__ __align__(16) int8_t win[WH * WW * CB];

  const int cblocks = g.C / CB;
  const int tiles_x = (g.Wo + TW - 1) / TW, tiles_y = (g.Ho + TH - 1) / TH;
  int bid = blockIdx.x;
  const int cb = bid % cblocks;
  bid /= cblocks;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int c0 = cb * CB, oy0 = ty * TH, ox0 = tx * TW;
  const int iy_base = oy0 * S - g.ph, ix_base = ox0 * S - g.pw;
  const int t = threadIdx.x;

  for (int q = t; q < WH * WW * CHUNKS; q += 256) {
    const int pix = q / CHUNKS, cc = q - pix * CHUNKS;
    const int wy = pix / WW, wx = pix - wy * WW;
    const int iy = iy_base + wy, ix = ix_base + wx;
    const bool ok = static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
    cp_async16(win + pix * CB + cc * 16,
               ok ? x + (static_cast<long long>(b * g.H + iy) * g.W + ix) * g.C + c0 + cc * 16
                  : x,
               ok);
  }
  cp_async_commit();

  // this thread's weights, while the window lands: tap k of channel c0 + 4
  // gq + e as byte e of wm[k][e], the other bytes 0, so that one __dp4a
  // multiply-adds one channel
  const int gq = t % G, lane = t / G;
  const int ly = lane / LX, lx = lane - ly * LX;
  const int n = c0 + 4 * gq;
  int wm[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wm[k][e] = static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(w[(n + e) * 9 + k]))
                                  << (8 * e));
  cp_async_wait<0>();
  __syncthreads();

  int acc[P][4];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int8_t* rowp = win + ((ly * S + kh * D) * WW + lx * P * S) * CB + 4 * gq;
    int xv[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) xv[q] = *reinterpret_cast<const int*>(rowp + q * CB);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = __dp4a(xv[i * S + kw * D], wm[kh * 3 + kw][e], acc[i][e]);
  }

  float ws[4], bs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ws[e] = w_scale[n + e];
    bs[e] = bias ? bias[n + e] : 0.0f;
  }
  const int oy = oy0 + ly;
  OutT* orow = out + (static_cast<long long>(b) * g.Ho + oy) * g.Wo * g.C;
  float v[P][4];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[i][e] = dequant(acc[i][e], xs, ws[e]);
      if (bias) v[i][e] = __fadd_rn(v[i][e], bs[e]);
    }
  if constexpr (sizeof(OutT) == 4) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int ox = ox0 + lx * P + i;
      if (oy < g.Ho && ox < g.Wo) store16(orow + static_cast<long long>(ox) * g.C + n, v[i]);
    }
  } else {
    // bf16: neighbouring threads (channel quads 2 h, 2 h + 1) join their 4
    // values of a pixel into 8 channels, 16 bytes: the even thread stores
    // pixel i, the odd pixel i + 1
    const bool odd = gq & 1;
#pragma unroll
    for (int i = 0; i < P; i += 2) {
      const uint2 mine[2] = {make_uint2(pack_bf16(v[i][0], v[i][1]), pack_bf16(v[i][2], v[i][3])),
                             make_uint2(pack_bf16(v[i + 1][0], v[i + 1][1]),
                                        pack_bf16(v[i + 1][2], v[i + 1][3]))};
      const uint2 send = odd ? mine[0] : mine[1];
      uint2 got;
      got.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
      got.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
      const int ox = ox0 + lx * P + i + (odd ? 1 : 0);
      if (oy < g.Ho && ox < g.Wo) {
        const uint4 word = odd ? make_uint4(got.x, got.y, mine[1].x, mine[1].y)
                               : make_uint4(mine[0].x, mine[0].y, got.x, got.y);
        *reinterpret_cast<uint4*>(orow + static_cast<long long>(ox) * g.C + n - (odd ? 4 : 0)) =
            word;
      }
    }
  }
}

// Every other grouped conv: one thread an output value (m, n), n fastest,
// 32-bit indices (the wrapper keeps M N < 2^31).  w rows [N, KH KW Cg] of
// (kh, kw, c); Cg = C / groups, group of n = n / (N / groups).  DP4A: Cg % 4
// == 0 and C % 4 == 0 (4-byte aligned words of x and w).
template <bool DP4A, typename OutT>
__global__ void __launch_bounds__(256) direct_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, float xs,
    OutT* __restrict__ out, Geom g, int groups) {
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
    out[i] = to_out<OutT>(epilogue(acc, xs, w_scale[n], bias, n));
  }
}

}  // namespace direct

// ------------------------------------------------- the backward's two convs
namespace backward {

// The data gradient's weights, one cooperative launch: max |w| of the float
// kernel w [N][C][KH][KW] (element strides st[0..3], dense: its numel values
// read in any order, 16 bytes a load where they allow) into amax_out, a grid
// barrier (quant::grid_max), then the rotated, I/O-swapped per-tensor codes
// as the dense body's rows out [C][ldw]: out[c][(i KW + j) NP + n] =
// q8(w[n][c][KH - 1 - i][KW - 1 - j]) for n < N, 0 for N <= n < NP and past
// KH KW NP, with the scale of that amax (s = amax > 0 ? amax / 127 : 1).  A
// tile: 64 (c, tap) places of out x 32 n, read along w's contiguous dim (q: c
// fastest where st[1] == 1, channels last, else the tap) into shared memory,
// written as 8-byte runs of n (w's row n holds its C KH KW values in q's
// order: no division on the load side); the blocks walk the tiles; every
// block zeroes a share of the rows' padding.
template <typename T>
__global__ void __launch_bounds__(256)
    rotated_codes_kernel(const T* __restrict__ w, float* __restrict__ amax_out,
                         unsigned* __restrict__ ws, int8_t* __restrict__ out, int N, int C, int KH,
                         int KW, int NP, int ldw, long long sn, long long sc) {
  __shared__ int8_t tile[64][33];
  const int taps = KH * KW, Q = C * taps, t = threadIdx.x;
  const long long numel = static_cast<long long>(N) * Q;
  const int threads = gridDim.x * 256;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  unsigned m = 0u;
  if (numel % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    for (long long i = blockIdx.x * 256 + t; i < numel / V; i += threads)
      m = quant::vec_max<T>(m, wv[i]);
    m = quant::vec_max_bits<T>(m);
  } else {
    for (long long i = blockIdx.x * 256 + t; i < numel; i += threads) m = max(m, abs_bits(w[i]));
  }
  const float a = quant::grid_max(m, ws, true);
  const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f, r = q8_recip(s);

  const bool c_fast = sc == 1 && C > 1;
  auto where = [&](int q, int& c, int& tap) {
    if (c_fast) {
      tap = q / C;
      c = q - tap * C;
    } else {
      c = q / taps;
      tap = q - c * taps;
    }
  };
  const int tiles_q = (Q + 63) / 64, tiles = tiles_q * ((NP + 31) / 32);
  for (int k = blockIdx.x; k < tiles; k += gridDim.x) {
    const int q0 = (k % tiles_q) * 64, n0 = (k / tiles_q) * 32;
    {
      const int n = n0 + (t >> 3);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int qi = (t & 7) * 8 + e, q = q0 + qi;
        tile[qi][t >> 3] = static_cast<int8_t>(
            n < N && q < Q ? q8_code(to_f32(w[n * sn + q]), s, r) : 0);
      }
    }
    __syncthreads();
    const int qi = t >> 2, q = q0 + qi, nn = n0 + (t & 3) * 8;
    if (q < Q && nn < NP) {
      int c, tap;
      where(q, c, tap);
      const int kh = tap / KW, kw = tap - kh * KW;
      int8_t* dst = out + static_cast<long long>(c) * ldw +
                    ((KH - 1 - kh) * KW + (KW - 1 - kw)) * NP + nn;
      const int8_t* src = &tile[qi][(t & 3) * 8];
      if ((NP & 7) == 0) {
        uint32_t b[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          b[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * (e & 3));
        *reinterpret_cast<uint2*>(dst) = make_uint2(b[0], b[1]);
      } else {
        for (int e = 0; e < 8 && nn + e < NP; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();  // the tile is read before the next one is written
  }
  const int pad = ldw - taps * NP;  // < 16 bytes a row
  for (int i = blockIdx.x * 256 + t; i < C * 16; i += threads)
    if ((i & 15) < pad) out[static_cast<long long>(i >> 4) * ldw + taps * NP + (i & 15)] = 0;
  quant::grid_done(ws, amax_out);
}

// The weight gradient: dw[n, kh, kw, c] = sum over the output pixels (b, oy,
// ox) of g[b, oy, ox, n] x[b, oy sh - ph + kh dh, ox sw - pw + kw dw, c], a
// tap outside x adding 0.  A product over pixels, which NHWC keeps apart
// (channels are contiguous): both operands have to be made pixel-major (K-
// major) for an int8 MMA, and ldmatrix's .trans moves 16-bit elements, not
// bytes.  A block owns one tap, BM = 128 output channels n x BN = 128 input
// channels c, and a contiguous range of the pixels (a split); it walks them
// in steps of BK = 64.  A step: each thread loads four 4 x 4 byte blocks (4
// pixels x 4 channels of g and of x, 32-bit loads, a warp's 32 bytes of 4
// pixel rows at once) into registers, transposes each with byte permutes
// (prmt) and stores them as rows of 64 pixel bytes a channel (rows of 80
// bytes, the bytewise body's layout, so that ldmatrix fragments of the two
// tiles feed mma.sync m16n8k32 as there); the stores are rotated a word per
// lane so that a warp's 32 land in 32 banks.  Two buffers: the next step's
// loads are in flight during this step's products.  8 warps of 64 n x 32 c,
// one A fragment live at a time, so that two blocks fit an SM (128
// registers: 15% faster than one block an SM, where loading the words two
// steps ahead gained nothing; block_bwd_ab.py --kind wgrad).
// The int32 sums go to `partial` (wrapping two's-complement adds, no
// saturation: exact in any order), and wgrad_finish adds the splits.
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;
constexpr int THREADS = 256;

__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  // rows r[i] of bytes (i, 0..3) -> rows of bytes (0..3, j)
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}
// r[j] <- r[(j + rot) % 4], by selects (no local memory)
__device__ __forceinline__ void rotate4(uint32_t (&r)[4], int rot) {
  if (rot & 1) {
    const uint32_t t = r[0];
    r[0] = r[1];
    r[1] = r[2];
    r[2] = r[3];
    r[3] = t;
  }
  if (rot & 2) {
    uint32_t t = r[0];
    r[0] = r[2];
    r[2] = t;
    t = r[1];
    r[1] = r[3];
    r[3] = t;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    wgrad_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ gq,
                     int* __restrict__ partial, Geom g, int splits) {
  __shared__ __align__(128) int8_t smem[2][2 * BM * LDS];  // a buffer: g^T [BM] then x^T [BN]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int taps = g.KH * g.KW;
  const int NT = (g.N + BM - 1) / BM, CT = (g.C + BN - 1) / BN;
  int bid = blockIdx.x;
  const int ct = bid % CT;
  bid /= CT;
  const int nt = bid % NT;
  bid /= NT;
  const int tap = bid % taps;
  const int split = bid / taps;
  const int kh = tap / g.KW, kw = tap - kh * g.KW;
  const int dy = kh * g.dh - g.ph, dx = kw * g.dw - g.pw;
  const int n0 = nt * BM, c0 = ct * BN;
  const int hw = g.Ho * g.Wo, P = g.B * hw;
  const int steps_all = (P + BK - 1) / BK;
  const int s0 = static_cast<int>(static_cast<long long>(split) * steps_all / splits);
  const int s1 = static_cast<int>(static_cast<long long>(split + 1) * steps_all / splits);

  // this thread's 4 x 4 blocks: pixels 4 pq .. 4 pq + 3 of a step, word
  // columns wc and wc + 16 (channels 4 wc ..) of g's and of x's tile
  const int wcl = lane >> 2;
  const int pq = (warp & 3) * 4 + (lane & 3), wc = (warp >> 2) * 8 + wcl;
  const int rot = (wcl + (wcl >> 2)) & 3;
  int p = s0 * BK + 4 * pq;  // the pixel of row 0 at the current step
  int pb[4], py[4], px[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = p + r;
    pb[r] = q / hw;
    py[r] = (q - pb[r] * hw) / g.Wo;
    px[r] = q - pb[r] * hw - py[r] * g.Wo;
  }
  uint32_t rg[2][4], rx[2][4];
  auto fetch = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool pv = p + r < P;
      const int iy = py[r] * g.sh + dy, ix = px[r] * g.sw + dx;
      const bool xv = pv && static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
      const int8_t* grow = gq + static_cast<long long>(p + r) * g.N;
      const int8_t* xrow = x + ((static_cast<long long>(pb[r]) * g.H + iy) * g.W + ix) * g.C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 4 * (wc + 16 * h);
        rg[h][r] = pv && n0 + col < g.N ? *reinterpret_cast<const uint32_t*>(grow + n0 + col) : 0u;
        rx[h][r] = xv && c0 + col < g.C ? *reinterpret_cast<const uint32_t*>(xrow + c0 + col) : 0u;
      }
    }
    p += BK;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      px[r] += BK;
      while (px[r] >= g.Wo) {
        px[r] -= g.Wo;
        if (++py[r] == g.Ho) {
          py[r] = 0;
          ++pb[r];
        }
      }
    }
  };
  auto store = [&](int buf) {
    int8_t* sa = smem[buf];
    int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      transpose4x4(rg[h]);
      transpose4x4(rx[h]);
      rotate4(rg[h], rot);
      rotate4(rx[h], rot);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // word j is channel row 4 (wc + 16 h) + (j + rot) % 4
        const int row = 4 * (wc + 16 * h) + ((j + rot) & 3);
        *reinterpret_cast<uint32_t*>(sa + row * LDS + 4 * pq) = rg[h][j];
        *reinterpret_cast<uint32_t*>(sb + row * LDS + 4 * pq) = rx[h][j];
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int wm = warp & 1, wn = warp >> 1;  // rows 64 wm .. of n, columns 32 wn .. of c
  auto products = [&](int buf) {
    const int8_t* sa = smem[buf];
    const int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t bf[4][2];
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
      for (int i = 0; i < 4; ++i) {  // one A fragment live at a time (2 blocks an SM)
        uint32_t af[4];
        ldsm_x4(af, sa + (wm * 64 + 16 * i + (lane & 15)) * LDS + kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j]);
      }
    }
  };

  if (s0 < s1) fetch();
  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    store(buf);
    __syncthreads();  // the last reads of this buffer were two steps ago
    if (s + 1 < s1) fetch();
    products(buf);
  }

  // fragment (i, j): rows n of lane / 4 (+ 8), columns c of 2 (lane % 4) (+ 1)
  int* part = partial + static_cast<long long>(split * taps + tap) * g.N * g.C;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * 64 + 16 * i + (lane >> 2) + 8 * h;
        const int c = c0 + wn * 32 + 8 * j + 2 * (lane & 3);
        if (n < g.N && c < g.C)
          *reinterpret_cast<int2*>(part + static_cast<long long>(n) * g.C + c) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// dw in OIHW: out[((n C + c) KH + kh) KW + kw] = float(sum over the splits
// of partial[split][kh KW + kw][n][c]) * scale, the splits added in order as
// unsigned (wrapping) ints.
template <typename OutT>
__global__ void __launch_bounds__(256)
    wgrad_finish(const int* __restrict__ partial, int splits, Geom g, AmaxScale scale,
                 OutT* __restrict__ out) {
  const float s = scale.get();
  const int taps = g.KH * g.KW;
  const long long plane = static_cast<long long>(g.N) * g.C;
  const int total = g.N * g.C * taps;
  for (int o = blockIdx.x * 256 + threadIdx.x; o < total; o += gridDim.x * 256) {
    const int tap = o % taps, nc = o / taps;
    const int* src = partial + tap * plane + nc;
    unsigned acc = 0u;
    for (int k = 0; k < splits; ++k) acc += static_cast<unsigned>(src[k * taps * plane]);
    out[o] = to_out<OutT>(__fmul_rn(__int2float_rn(static_cast<int>(acc)), s));
  }
}

}  // namespace backward

// ------------------------------------ the weight gradient on wgmma and TMA
// The weight gradient's body for every site whose channel counts are
// multiples of 16 and whose output map has 64 pixels or more (every routed
// site of a ResNet-50 QAT step but the two of the ASPP's pooled part, M = 8,
// which keep `wgrad_mma_kernel` above, as do channel counts it cannot take).
// A K stage is 128 pixel bytes: R = 128 / TW output rows of TW pixels (TW =
// 32, 64 or 128, the map's width rounded up; a wider map walks chunks of 128
// along its rows) of one image.  Three launches:
//   - `planar_kernel` makes both operands pixel-major ("planar") once a call,
//     laid out so that every stage of every tap is 128 contiguous bytes of a
//     channel's row: g^T [N][B][Ho'][pitch] (Ho' = Ho rounded up to R, zeros
//     past Ho and Wo) and x^T [C][B np][Hc][pitch] in np copies, one for each
//     (py, px, s) some tap reads: copy (py, px, s) holds at (row y' + m,
//     column u) the code of pixel (y' sh + py, (u + s) sw + px), zeros where
//     there is none: the stride's parity plane (py, px) with the tap's column
//     shift s taken out and m = R - 1 zero rows above and below (a stage a
//     tap walks reads at most R - 1 rows past x's).  pitch = TW (or a
//     multiple of 128 past 128 columns), so a stage's R rows run on.  A 3x3
//     keeps three copies, a 1x1 of stride 2 one plane of four.  64 positions
//     x 128 channels a block: 16-byte loads of NHWC rows into a swizzled
//     tile, 4 x 4 byte transposes (prmt), coalesced 4-byte stores of channel
//     rows;
//   - `wgrad_tma_kernel`: a block owns one tap, a tile of BM rows (the
//     smaller of N and C: 64 where it is 64 or less, else 128) x BN = 256
//     columns (the larger), and one work item: split k of the tap's stages,
//     of `splits` a tap; the blocks run split by split, every tap's split k
//     together (blocks in flight read the same pixels of g).  A stage is one TMA box of each operand, 128 bytes x its rows, through
//     2-D maps of the copies (a row a channel) in the 128-byte swizzle: g's
//     at the stage's pixels, x's at the same pixels in the tap's copy, its
//     rows shifted by the tap's row offset; four `wgmma.mma_async m64nNk32
//     .s32.s8.s8` a stage and consumer warpgroup.  One producer warp keeps a
//     4-slot ring in flight on `full` / `empty` mbarriers; the consumers hold
//     no load, index or bounds check in their loop.  The map's out-of-bounds
//     zero fill covers the channel rows past N or C.  A tap walks only the
//     stages whose rows and columns read inside x for some pixel (the
//     tile-level tap skip: the ASPP branches at d = 12 / 18 keep about half
//     of theirs); the splits a tap come from the wrapper's planner
//     (`wgrad_plan`, fitted to `block_bwd_ab.py --kind wgrad --sweep`); an
//     item may hold no stage (a short tap's), its partial then 0.  A block
//     stores its int32 tile into its item's partial [item][M][J];
//   - `wgrad_tma_finish` adds each tap's items' partials in order (wrapping,
//     exact) and writes float(acc) * scale in OIHW, through 32 x 32 tiles in
//     shared memory: 16-byte loads, OIHW written in runs.
// What bounds it: its products on paper (850.8 GOP a ResNet-50 step); the
// copies out of L2 ((BM + BN) x 128 bytes a stage against BM x BN x 256
// operations) and the planar copies' bytes (x, three times at a 3x3, and g
// read and written once).  The copies, and not boxes of x at the taps'
// shifted coordinates, because a TMA box starts on 16 bytes along its row
// and a box of 32 bytes a row ran at a third of a 128-byte box's rate;
// partials, and not atomic adds into one sum a tap, because L2's atomics
// cost more than the partials' bytes (PERF.md).
namespace wgrad {

constexpr int STAGES = 4;      // ring slots
constexpr int BK = 128;        // pixel bytes of a stage
constexpr int BN = 256;        // columns of a tile (the larger of N and C)
constexpr int THREADS = 288;   // two consumer warpgroups, one producer warp
constexpr int MAX_TAPS = 49;
constexpr int MAX_PLANES = 16;  // x's copies

// One tap's place in the schedule (the wrapper's plan).
struct Tap {
  int shift_y, plane;         // x's row offset, its copy
  int rg_lo, nrg, cc_lo, ncc;  // the output row groups and column chunks it walks
  int item0, items;            // its work items: [item0, item0 + items), items = splits
};
struct Plan {
  int taps, np, m_tiles, j_tiles, M, J, B, x_is_a;
  int R, TW, pitch, hc, ho_pad, margin;  // the copies' layout
  Tap tap[MAX_TAPS];
};

__host__ __device__ constexpr int smem_bytes(int bm) { return STAGES * (bm + BN) * BK; }

// A K-major wgmma operand in the 128-byte swizzle (128 bytes a row, atoms of
// 8 rows 1,024 bytes apart).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t{1} << 16 |
         uint64_t{1024 >> 4} << 32 | uint64_t{1} << 62;
}

// One operand's planar copies: NHWC codes [B, H, W, C] -> [C][len], len = B
// np rows pitch, position ((b np + i) rows + r) pitch + u of copy i = (py[i],
// px[i], s[i]) holding the code of pixel ((r - margin) sh + py, (u + s) sw +
// px), 0 where there is none.
struct Side {
  const int8_t* src;
  int8_t* dst;
  int H, W, C, sh, sw, np, rows, margin, pitch, len, q_tiles, blocks;
  int py[MAX_PLANES], px[MAX_PLANES], s[MAX_PLANES];
};
struct Sides {
  Side s[2];  // x, then g
};

// 64 positions x 128 channels a block: 16-byte loads of the NHWC rows into a
// tile whose 16-byte chunk j of row p sits at j ^ ((p / 4) % 8) (a warp's
// transposing reads then hit 32 banks), 4 x 4 byte transposes, 4-byte stores
// of channel rows (32 bytes a row and warp store).
__global__ void __launch_bounds__(256) planar_kernel(const __grid_constant__ Sides sides) {
  __shared__ __align__(16) unsigned char tile[64 * 128];
  int bid = blockIdx.x;
  const int which = bid < sides.s[0].blocks ? 0 : 1;
  if (which) bid -= sides.s[0].blocks;
  const Side& sd = sides.s[which];
  const int tq = bid % sd.q_tiles, tc = bid / sd.q_tiles;
  const int q0 = tq * 64, c0 = tc * 128;
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = t + 256 * u;
    const int p = idx >> 3, j = idx & 7;
    const int q = q0 + p;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < sd.len && c0 + 16 * j < sd.C) {
      const int row = q / sd.pitch, col = q - row * sd.pitch;
      const int bp = row / sd.rows, r = row - bp * sd.rows;
      const int b = bp / sd.np, pl = bp - b * sd.np;
      const int y = r - sd.margin, x = col + sd.s[pl];
      const int iy = y * sd.sh + sd.py[pl], ix = x * sd.sw + sd.px[pl];
      if (y >= 0 && x >= 0 && iy < sd.H && ix < sd.W)
        v = *reinterpret_cast<const uint4*>(
            sd.src + ((static_cast<long long>(b) * sd.H + iy) * sd.W + ix) * sd.C + c0 + 16 * j);
    }
    *reinterpret_cast<uint4*>(tile + p * 128 + 16 * (j ^ ((p >> 2) & 7))) = v;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    // a warp: positions 4 pw .. (8 pw values) x 4 channel quads of one chunk
    const int idx = t + 256 * u;
    const int wi = idx >> 5, lane = idx & 31;
    const int pw = (lane >> 2) | ((wi & 1) << 3), cq = ((wi >> 1) << 2) | (lane & 3);
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(tile + (4 * pw + i) * 128 +
                                                16 * ((cq >> 2) ^ (pw & 7)) + 4 * (cq & 3));
    backward::transpose4x4(r);  // r[k]: channel 4 cq + k at positions 4 pw .. 4 pw + 3
    const int q = q0 + 4 * pw;
    if (q < sd.len) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 4 * cq + k;
        if (c < sd.C)
          *reinterpret_cast<uint32_t*>(sd.dst + static_cast<long long>(c) * sd.len + q) = r[k];
      }
    }
  }
}

// One block: tap, rows [m0, m0 + BM) x columns [j0, j0 + BN) of the tap's
// D[M][J] (M = N, J = C; or M = C, J = N where x is the A operand), the
// stages [s0, s1) of its work item.
template <int BM>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, const __grid_constant__ Plan plan,
                     int* __restrict__ partial) {
  constexpr int STAGE = (BM + BN) * BK;
  constexpr int WN = BM == 128 ? BN : BN / 2;  // columns of a consumer warpgroup
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const int t = threadIdx.x;
  int bid = blockIdx.x;
  const int jt = bid % plan.j_tiles;
  bid /= plan.j_tiles;
  const int mt = bid % plan.m_tiles;
  bid /= plan.m_tiles;
  const int tap = bid % plan.taps;
  const int split = bid / plan.taps;
  const Tap& tp = plan.tap[tap];
  const int item = tp.item0 + split;
  const int stages = plan.B * tp.nrg * tp.ncc;
  const int s0 = static_cast<int>(static_cast<long long>(split) * stages / tp.items);
  const int s1 = static_cast<int>(static_cast<long long>(split + 1) * stages / tp.items);
  const int steps = s1 - s0;
  const int m0 = mt * BM, j0 = jt * BN;

  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrival with the stage's bytes
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (t >= 256) {  // the producer warp: lane 0 issues every copy
    if (t == 256) {
      const int per_b = tp.nrg * tp.ncc;
      for (int i = 0; i < steps; ++i) {
        const int slot = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) - 1) & 1);
        const int st = s0 + i;
        const int b = st / per_b, rest = st - b * per_b;
        const int oy = (tp.rg_lo + rest / tp.ncc) * plan.R;
        const int ox = (tp.cc_lo + rest % tp.ncc) * plan.TW;
        // the stage's pixels in g's copy, and in x's at the tap's row offset
        const int g_at = (b * plan.ho_pad + oy) * plan.pitch + ox;
        const int x_at = ((b * plan.np + tp.plane) * plan.hc + oy + tp.shift_y + plan.margin) *
                             plan.pitch + ox;
        unsigned char* sa = smem + slot * STAGE;
        mbar_arrive_tx(&full[slot], STAGE);
        tma_load_2d(sa, &a_map, plan.x_is_a ? x_at : g_at, m0, &full[slot]);
        tma_load_2d(sa + BM * BK, &b_map, plan.x_is_a ? g_at : x_at, j0, &full[slot]);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes A rows 64 wg .. (BM = 128) or B rows
  // 128 wg .. (BM = 64)
  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int a_off = BM == 128 ? wg * 64 * BK : 0;
  const int b_off = BM * BK + (BM == 128 ? 0 : wg * (BN / 2) * BK);
  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    mbar_wait(&full[slot], (i / STAGES) & 1);
    const unsigned char* st = smem + slot * STAGE;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)
      wgmma_s8(acc, smem_desc_sw128(st + a_off + 32 * k), smem_desc_sw128(st + b_off + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: its slot is free
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // n8 block q of the warp's 16 rows: rows lane / 4 (+ 8), columns 8 q + 2
  // (lane % 4) (+ 1)
  int* part = partial + static_cast<long long>(item) * plan.M * plan.J;
  const int row = m0 + (BM == 128 ? wg * 64 : 0) + warp * 16 + (lane >> 2);
  const int col = j0 + (BM == 128 ? 0 : wg * (BN / 2)) + 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < WN / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h, j = col + 8 * q;
      if (m < plan.M && j < plan.J)
        *reinterpret_cast<int2*>(part + static_cast<long long>(m) * plan.J + j) =
            make_int2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
}

// dw in OIHW: each tap's items added in order as unsigned (wrapping) ints,
// then float(acc) * scale.  A block a 32 x 32 tile of D (rows m, columns j)
// for up to 9 taps at a time: 16-byte loads of the partials' rows into a
// shared tile [tap][m][j], then OIHW runs of (c, tap) (or (n, tap) where x
// is the A operand) written in order (J % 4 == 0).
constexpr int FT = 32;            // rows and columns of a finishing tile
constexpr int FTAPS = 9;          // taps a pass
constexpr int FSTRIDE = FT * (FT + 1) + 1;  // words of a tap's tile (banks apart)

template <typename OutT>
__global__ void __launch_bounds__(256)
    wgrad_tma_finish(const int* __restrict__ partial, const __grid_constant__ Plan plan, int C,
                     AmaxScale scale, OutT* __restrict__ out) {
  __shared__ int tile[FTAPS * FSTRIDE];
  const float s = scale.get();
  const int M = plan.M, J = plan.J, taps = plan.taps, t = threadIdx.x;
  const long long mj = static_cast<long long>(M) * J;
  const int tiles_j = (J + FT - 1) / FT;
  const int m0 = blockIdx.x / tiles_j * FT, j0 = blockIdx.x % tiles_j * FT;
  for (int t0 = 0; t0 < taps; t0 += FTAPS) {
    const int nt = min(FTAPS, taps - t0);
    const int r = t >> 3, q = (t & 7) * 4;  // row r, columns q .. q + 3
    for (int k = 0; k < nt; ++k) {
      const Tap& tp = plan.tap[t0 + k];
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && j0 + q < J) {
        const int* src = partial + (m0 + r) * static_cast<long long>(J) + j0 + q;
        for (int i = 0; i < tp.items; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + (tp.item0 + i) * mj);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      int* row = tile + k * FSTRIDE + r * (FT + 1) + q;
      row[0] = static_cast<int>(acc.x);
      row[1] = static_cast<int>(acc.y);
      row[2] = static_cast<int>(acc.z);
      row[3] = static_cast<int>(acc.w);
    }
    __syncthreads();
    // out[(n C + c) taps + tap]: a run of (c, tap) for each n = m (or of
    // (n, tap)... for each c = m where x is the A operand: then n = j)
    for (int e = t; e < FT * FT * nt; e += 256) {
      const int a = e / (FT * nt), rest = e - a * (FT * nt);
      const int b = rest / nt, k = rest - b * nt;
      const int m = plan.x_is_a ? m0 + b : m0 + a, j = plan.x_is_a ? j0 + a : j0 + b;
      if (m < M && j < J) {
        const int n = plan.x_is_a ? j : m, c = plan.x_is_a ? m : j;
        const int v = tile[k * FSTRIDE + (m - m0) * (FT + 1) + (j - j0)];
        out[(static_cast<long long>(n) * C + c) * taps + t0 + k] =
            to_out<OutT>(__fmul_rn(__int2float_rn(v), s));
      }
    }
    __syncthreads();
  }
}

}  // namespace wgrad

int grid_for(long long work) {
  long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

Geom geom_of(const int* geom) {
  return Geom{geom[0], geom[1],  geom[2],  geom[3],  geom[4],  geom[5],  geom[6],  geom[7], geom[8],
              geom[9], geom[10], geom[11], geom[12], geom[13], geom[14], geom[15], geom[16]};
}

template <typename OutT, typename S, typename PAR>
using DenseKernel = void (*)(const int8_t*, const int8_t*, const CUtensorMap, const float*,
                             const float*, S, OutT*, int*, Geom, int, int, const PAR);

// The built (BN, slots) pairs, with the weights by cp.async or by TMA; null
// for another.
template <bool TMA_B, typename OutT, typename S, typename PAR>
DenseKernel<OutT, S, PAR> dense_kernel_of(int bn, int slots) {
  using namespace dense;
  if (bn == 256 && slots == 4) return igemm_wgmma_kernel<256, 4, TMA_B, OutT, S, PAR>;
  if (bn == 128 && slots == 3) return igemm_wgmma_kernel<128, 3, TMA_B, OutT, S, PAR>;
  if (bn == 128 && slots == 4) return igemm_wgmma_kernel<128, 4, TMA_B, OutT, S, PAR>;
  if (bn == 64 && slots == 4) return igemm_wgmma_kernel<64, 4, TMA_B, OutT, S, PAR>;
  if (bn == 8 && slots == 4) return igemm_wgmma_kernel<8, 4, TMA_B, OutT, S, PAR>;
  return nullptr;
}
template <typename OutT, typename S, typename PAR>
DenseKernel<OutT, S, PAR> dense_kernel(int bn, int slots, bool tma) {
  return tma ? dense_kernel_of<true, OutT, S, PAR>(bn, slots)
             : dense_kernel_of<false, OutT, S, PAR>(bn, slots);
}

// The weights [N rows][ldw bytes] as a TMA map of boxes of 64 bytes x BN
// rows in the 64-byte swizzle, zeros outside.  cuTensorMapEncodeTiled is a
// libcuda entry: found by dlsym in the libcuda.so.1 the process has loaded,
// so that the build links nothing more.
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
Encode encode_fn() {
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) encode = reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return encode;
}

int weight_map(CUtensorMap* map, const int8_t* w, int N, int ldw, int bn) {
  const Encode encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldw), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A planar copy [rows][len] as a 2-D TMA map of boxes of 128 bytes x
// box_rows in the 128-byte swizzle (rows past `rows` read as zeros).
int planar_map(CUtensorMap* map, const int8_t* base, int len, int rows, int box_rows) {
  const Encode encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(len)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The dense conv's launch (and its K split's finish); PAR: the data
// gradient's parity classes (`classes` of them in blockIdx.y, out dx [B, H,
// W, N]), NoParity for every other launch.
template <typename OutT, typename S, typename PAR = dense::NoParity>
int run_dense(const Geom& g, const int* plan, const int8_t* x, const int8_t* w, const float* ws,
              const float* bs, S xs, OutT* out, int* partial, cudaStream_t s,
              const PAR& par = PAR{}, int classes = 1) {
  if (plan[0] == 1) {  // the bytewise body
    if (PAR::split) return static_cast<int>(cudaErrorInvalidValue);
    const int M = g.B * g.Ho * g.Wo;
    const dim3 grid((g.N + bytewise::BN - 1) / bytewise::BN, (M + bytewise::BM - 1) / bytewise::BM);
    bytewise::igemm_bytes_kernel<OutT, S><<<grid, bytewise::THREADS, 0, s>>>(x, w, ws, bs, xs, out,
                                                                             g);
    return static_cast<int>(cudaGetLastError());
  }
  const int tw_log2 = plan[1], bn = plan[2], slots = plan[3], splits = plan[4];
  const bool tma = plan[5] != 0;
  const DenseKernel<OutT, S, PAR> kernel = dense_kernel<OutT, S, PAR>(bn, slots, tma);
  if (kernel == nullptr || tw_log2 < 3 || tw_log2 > 7 || splits < 1 ||
      g.KH * g.KW > dense::MAX_TAPS || g.C % (tma ? 64 : 16) || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};  // unused by the cp.async body
  if (tma) {
    const int rc = weight_map(&map, w, g.N, g.ldw, bn);
    if (rc) return rc;
  }
  const int tw = 1 << tw_log2, th = dense::BM >> tw_log2;
  long long blocks = 0, mn = static_cast<long long>(g.B) * g.Ho * g.Wo * g.N;
  for (int k = 0; k < classes; ++k) {  // the grid fits the largest class
    int ho = g.Ho, wo = g.Wo;
    if constexpr (PAR::split) {
      ho = par.cls[k].z;
      wo = par.cls[k].w;
      mn = static_cast<long long>(g.B) * par.H * par.W * g.N;
    }
    const long long n = static_cast<long long>(g.B) * ((ho + th - 1) / th) * ((wo + tw - 1) / tw) *
                        splits * ((g.N + bn - 1) / bn);
    blocks = n > blocks ? n : blocks;
  }
  if (blocks > 0x7fffffffLL || mn > 0x7fffffffLL || classes < 1 ||
      (PAR::split ? classes > dense::MAX_CLASSES : classes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB dynamic shared memory must be asked for; the attribute is per
  // device, so it is asked before every launch
  const int smem = dense::smem_bytes(bn, slots);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks), classes);
  kernel<<<grid, dense::THREADS, smem, s>>>(x, w, map, ws, bs, xs, out, partial, g, tw_log2,
                                             splits, par);
  if (splits > 1)
    dense::igemm_split_finish<OutT, S><<<grid_for(mn), 256, 0, s>>>(
        partial, splits, static_cast<int>(mn), g.N, ws, bs, xs, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int run_direct(const Geom& g, int groups, int body, const int8_t* x, const int8_t* w,
               const float* ws, const float* bs, float xs, OutT* out, cudaStream_t s) {
  using namespace direct;
  if (body == 1) {
    const int grid = grid_for(static_cast<long long>(g.B) * g.Ho * g.Wo * g.N);
    const int cg = g.C / groups;
    if (cg % 4 == 0 && g.C % 4 == 0)
      direct_kernel<true, OutT><<<grid, 256, 0, s>>>(x, w, ws, bs, xs, out, g, groups);
    else
      direct_kernel<false, OutT><<<grid, 256, 0, s>>>(x, w, ws, bs, xs, out, g, groups);
    return static_cast<int>(cudaGetLastError());
  }
  // the tiled depthwise body: 3x3, C = N = groups, C % 16 == 0, stride and
  // dilation 1 or 2, the same on both axes
  if (!(groups == g.C && g.N == g.C && g.C % 16 == 0 && g.KH == 3 && g.KW == 3 &&
        g.sh == g.sw && g.dh == g.dw && (g.sh == 1 || g.sh == 2) && (g.dh == 1 || g.dh == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb = g.C % 64 == 0 ? 64 : g.C % 32 == 0 ? 32 : 16;
  const int th = 256 / cb;  // 256 / (cb / 4) lanes of 4 pixels, 4 lanes a row of 16
  const long long blocks = static_cast<long long>(g.B) * ((g.Ho + th - 1) / th) *
                           ((g.Wo + 15) / 16) * (g.C / cb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(const int8_t*, const int8_t*, const float*, const float*, float, OutT*,
                          Geom);
  const int code = (g.sh - 1) * 2 + (g.dh - 1);
  Kernel kernel;
  switch (cb) {
#define ISWM_PICK(CB)                                                          \
  case CB:                                                                     \
    kernel = code == 0   ? direct_tiled_kernel<1, 1, CB, OutT>                 \
             : code == 1 ? direct_tiled_kernel<1, 2, CB, OutT>                 \
             : code == 2 ? direct_tiled_kernel<2, 1, CB, OutT>                 \
                         : direct_tiled_kernel<2, 2, CB, OutT>;                \
    break;
    ISWM_PICK(64)
    ISWM_PICK(32)
    default:
    ISWM_PICK(16)
#undef ISWM_PICK
  }
  kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(x, w, ws, bs, xs, out, g);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the quantize (quant::Mode) on x rows [P, C] (ld apart):
// one iteration of UNROLL x THREADS vectors a block, up to the blocks the
// card holds at once; DYNAMIC by a cooperative launch, whose grid barrier
// needs every block resident.
// Blocks of `kernel` (THREADS threads) the card holds at once, into *blocks.
template <typename K>
int resident_blocks(K kernel, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *blocks = per_sm * sms;
  return e != cudaSuccess ? static_cast<int>(e) : *blocks < 1 ? cudaErrorInvalidValue : 0;
}

// One launch of the quantize (quant::Mode) on x rows [P, C] (ld apart):
// one iteration of u x THREADS vectors a block, up to the blocks the card
// holds at once; DYNAMIC by a cooperative launch, whose grid barrier needs
// every block resident.
template <typename T, bool VEC, int MODE, typename S>
int launch_quantize(const T* x, S scale, int8_t* out, int P, int C, long long ld, float* amax_out,
                    unsigned* ws, cudaStream_t s) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  const long long vectors = static_cast<long long>(P) * (C / V);
  const auto kernel = quant::quantize_kernel<T, VEC, MODE, S>;
  static int resident = 0;  // blocks the card holds at once (one card model a process)
  if (resident == 0) {
    const int rc = resident_blocks(kernel, quant::THREADS, &resident);
    if (rc) return rc;
  }
  // vectors a thread an iteration: as many as fill the blocks the card holds
  const long long fill = static_cast<long long>(resident) * quant::THREADS;
  int u = static_cast<int>((vectors + fill - 1) / fill);
  u = u < 1 ? 1 : u > quant::UNROLL ? quant::UNROLL : u;
  const long long want = (vectors + u * quant::THREADS - 1) / (u * quant::THREADS);
  const int grid = static_cast<int>(want < resident ? (want > 0 ? want : 1) : resident);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (MODE == quant::DYNAMIC) {
    void* args[] = {&x, &scale, &out, &P, &C, &ld, &u, &amax_out, &ws};
    return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                        grid, quant::THREADS, args, 0, s));
  }
  kernel<<<grid, quant::THREADS, 0, s>>>(x, scale, out, P, C, ld, u, amax_out, ws);
  return static_cast<int>(cudaGetLastError());
}

// x rows [P, C] (ld apart; rows that run on are taken as one), bf16 or f32,
// 16-byte vectors where the rows allow.  out: the codes (null for AMAX);
// amax_out and ws: the reducing modes'.
template <int MODE, typename S>
int quantize(const void* x, int x_is_bf16, S scale, void* out, int P, int C, long long ld,
             float* amax_out, unsigned* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || C < 1 || (MODE != quant::AMAX && out == nullptr) ||
      (MODE != quant::QUANT && (amax_out == nullptr || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ld == C || P == 1) {  // one row (the wrapper keeps P C < 2^31)
    C *= P;
    ld = C;
    P = 1;
  }
  const int v = x_is_bf16 ? 8 : 4;
  const bool vec = C % v == 0 && ld % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int8_t* o = static_cast<int8_t*>(out);
  if (x_is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    return vec ? launch_quantize<__nv_bfloat16, true, MODE>(xb, scale, o, P, C, ld, amax_out, ws, s)
               : launch_quantize<__nv_bfloat16, false, MODE>(xb, scale, o, P, C, ld, amax_out, ws,
                                                              s);
  }
  const auto* xf = static_cast<const float*>(x);
  return vec ? launch_quantize<float, true, MODE>(xf, scale, o, P, C, ld, amax_out, ws, s)
             : launch_quantize<float, false, MODE>(xf, scale, o, P, C, ld, amax_out, ws, s);
}

template <typename S>
int conv_igemm(const void* x_q, const void* w_q, const void* w_scale, const void* bias, S scale,
               void* out, int out_bf16, const int* geom, const int* plan, void* partial,
               void* stream) {
  const Geom g = geom_of(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  int* part = static_cast<int*>(partial);
  if (out_bf16)
    return run_dense(g, plan, x, w, ws, bs, scale, static_cast<__nv_bfloat16*>(out), part, s);
  return run_dense(g, plan, x, w, ws, bs, scale, static_cast<float*>(out), part, s);
}

// The data gradient's weights (backward::rotated_codes_kernel): one
// cooperative launch of as many blocks as there are tiles, up to the blocks
// the card holds at once.
template <typename T>
int launch_rotated(const T* w, int N, int C, int KH, int KW, const long long* st, int NP,
                   int ldw, int8_t* out, float* amax_out, unsigned* ws, cudaStream_t s) {
  const auto kernel = backward::rotated_codes_kernel<T>;
  static int resident = 0;
  if (resident == 0) {
    const int rc = resident_blocks(kernel, 256, &resident);
    if (rc) return rc;
  }
  const long long tiles = static_cast<long long>((C * KH * KW + 63) / 64) * ((NP + 31) / 32);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  long long sn = st[0], sc = st[1];
  // a dense kernel, row n's values in q's order: OIHW (c, then the tap) or
  // channels last (the tap, then c)
  const bool oihw = st[3] == 1 && st[2] == KW && st[1] == KH * KW;
  const bool last = st[1] == 1 && st[3] == C && st[2] == KW * C;
  if (st[0] != static_cast<long long>(C) * KH * KW || !(oihw || last))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&w, &amax_out, &ws, &out, &N, &C, &KH, &KW, &NP, &ldw, &sn, &sc};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                                      256, args, 0, s));
}

int rotated_codes(const void* w, int w_is_bf16, int N, int C, int KH, int KW,
                  const long long* st, int NP, int ldw, int8_t* out, float* amax_out,
                  unsigned* ws, cudaStream_t s) {
  const long long numel = static_cast<long long>(N) * C * KH * KW;
  if (N < 1 || C < 1 || KH < 1 || KW < 1 || NP < N || ldw < KH * KW * NP ||
      ldw - KH * KW * NP >= 16 || numel >= 0x7fffffffLL || out == nullptr ||
      amax_out == nullptr || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_is_bf16)
    return launch_rotated(static_cast<const __nv_bfloat16*>(w), N, C, KH, KW, st, NP, ldw, out,
                          amax_out, ws, s);
  return launch_rotated(static_cast<const float*>(w), N, C, KH, KW, st, NP, ldw, out, amax_out,
                        ws, s);
}

// The parity table of the data gradient's launch from the wrapper's ints:
// classes, sh, sw, H, W; (a, b, Hc, Wc) x MAX_CLASSES; tap0 x (MAX_CLASSES +
// 1); (dy, dx, K offset) x MAX_TAPS.
bool parity_of(const int* p, dense::Parity& par, int& classes) {
  using dense::MAX_CLASSES;
  using dense::MAX_TAPS;
  classes = p[0];
  par.sh = p[1];
  par.sw = p[2];
  par.H = p[3];
  par.W = p[4];
  if (classes < 1 || classes > MAX_CLASSES || classes > par.sh * par.sw) return false;
  const int* c = p + 5;
  const int* t0 = c + 4 * MAX_CLASSES;
  const int* t = t0 + MAX_CLASSES + 1;
  for (int k = 0; k < MAX_CLASSES; ++k)
    par.cls[k] = make_int4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
  for (int k = 0; k <= MAX_CLASSES; ++k) {
    par.tap0[k] = t0[k];
    if (k > 0 && k <= classes && t0[k] < t0[k - 1]) return false;
  }
  if (t0[0] != 0 || t0[classes] > MAX_TAPS) return false;
  for (int k = 0; k < MAX_TAPS; ++k)
    par.tap[k] = make_int4(t[3 * k], t[3 * k + 1], t[3 * k + 2], 0);
  return true;
}

template <typename OutT>
int run_wgrad(const Geom& g, int splits, const int8_t* x, const int8_t* gq, int* partial,
              AmaxScale scale, OutT* out, cudaStream_t s) {
  using namespace backward;
  if (g.C % 4 || g.N % 4 || splits < 1 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(splits) * g.KH * g.KW * ((g.N + BM - 1) / BM) *
                           ((g.C + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_mma_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(x, gq, partial, g, splits);
  const long long outputs = static_cast<long long>(g.N) * g.C * g.KH * g.KW;
  wgrad_finish<OutT><<<grid_for(outputs), 256, 0, s>>>(partial, splits, g, scale, out);
  return static_cast<int>(cudaGetLastError());
}

using WgradKernel = void (*)(const CUtensorMap, const CUtensorMap, const wgrad::Plan, int*);

// The wgmma body (see namespace wgrad).  plan[]: BM, BN, TW, x_is_a,
// m_tiles, j_tiles, items, taps, np, hc, pitch, ho_pad, margin, the copies'
// py[16], px[16], s[16], then 8 ints a tap: shift_y, plane, rg_lo, nrg,
// cc_lo, ncc, item0, items.
template <typename OutT>
int run_wgrad_tma(const Geom& g, const int* p, const int8_t* x, const int8_t* gq, int8_t* xt,
                  int8_t* gt, int* partial, AmaxScale scale, OutT* out, cudaStream_t s) {
  using namespace wgrad;
  const int bm = p[0], bn = p[1], tw = p[2], x_is_a = p[3], m_tiles = p[4], j_tiles = p[5];
  const int items = p[6], taps = p[7], np = p[8], hc = p[9], pitch = p[10], ho_pad = p[11];
  const int margin = p[12];
  const WgradKernel kernel = bm == 128 ? wgrad_tma_kernel<128> : wgrad_tma_kernel<64>;
  const int rows = BK / tw;
  if ((bm != 64 && bm != 128) || bn != BN || (tw != 32 && tw != 64 && tw != 128) ||
      taps != g.KH * g.KW || taps > MAX_TAPS || items % taps || np < 1 || np > MAX_PLANES || g.C % 16 ||
      g.N % 16 || pitch % tw || (rows > 1 && pitch != tw) || ho_pad % rows || ho_pad < g.Ho ||
      margin != rows - 1 || items < 1 || partial == nullptr || xt == nullptr || gt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long len_x = static_cast<long long>(g.B) * np * hc * pitch;
  const long long len_g = static_cast<long long>(g.B) * ho_pad * pitch;
  const long long blocks = static_cast<long long>(items) * m_tiles * j_tiles;  // splits * taps
  if (len_x >= 0x7fffffffLL || len_g >= 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  // the planar copies of x and g, one launch
  Sides sides{};
  Side& sx = sides.s[0];
  sx = Side{x, xt, g.H, g.W, g.C, g.sh, g.sw, np, hc, margin, pitch, static_cast<int>(len_x),
            static_cast<int>((len_x + 63) / 64), 0, {}, {}, {}};
  for (int i = 0; i < MAX_PLANES; ++i) {
    sx.py[i] = p[13 + i];
    sx.px[i] = p[13 + MAX_PLANES + i];
    sx.s[i] = p[13 + 2 * MAX_PLANES + i];
  }
  sx.blocks = sx.q_tiles * ((g.C + 127) / 128);
  Side& sg = sides.s[1];
  sg = Side{gq, gt, g.Ho, g.Wo, g.N, 1, 1, 1, ho_pad, 0, pitch, static_cast<int>(len_g),
            static_cast<int>((len_g + 63) / 64), 0, {}, {}, {}};
  sg.blocks = sg.q_tiles * ((g.N + 127) / 128);
  planar_kernel<<<sx.blocks + sg.blocks, 256, 0, s>>>(sides);

  // the two maps: a row of a copy a channel
  CUtensorMap xm{}, gm{};
  int rc = planar_map(&xm, xt, static_cast<int>(len_x), g.C, x_is_a ? bm : bn);
  if (rc) return rc;
  rc = planar_map(&gm, gt, static_cast<int>(len_g), g.N, x_is_a ? bn : bm);
  if (rc) return rc;

  Plan plan{};
  plan.taps = taps;
  plan.np = np;
  plan.m_tiles = m_tiles;
  plan.j_tiles = j_tiles;
  plan.M = x_is_a ? g.C : g.N;
  plan.J = x_is_a ? g.N : g.C;
  plan.B = g.B;
  plan.x_is_a = x_is_a;
  plan.R = rows;
  plan.TW = tw;
  plan.pitch = pitch;
  plan.hc = hc;
  plan.ho_pad = ho_pad;
  plan.margin = margin;
  for (int i = 0; i < taps; ++i) {
    const int* q = p + 13 + 3 * MAX_PLANES + 8 * i;
    plan.tap[i] = Tap{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
    if (q[6] != i * (items / taps) || q[7] != items / taps) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(bm);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(x_is_a ? xm : gm, x_is_a ? gm : xm,
                                                              plan, partial);
  const int finish_tiles = ((plan.M + FT - 1) / FT) * ((plan.J + FT - 1) / FT);
  wgrad_tma_finish<OutT><<<finish_tiles, 256, 0, s>>>(partial, plan, g.C, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x rows [P, C] (row stride ld elements), x_is_bf16 1 for bf16, 0 for f32;
// out [P, C] int8 contiguous.  Returns cudaGetLastError().
int iswm_int8_quantize(const void* x, int x_is_bf16, float x_scale, void* out, int P, int C,
                       long long ld, void* stream) {
  return quantize<quant::QUANT>(x, x_is_bf16, HostScale{x_scale}, out, P, C, ld, nullptr, nullptr,
                                stream);
}

// As iswm_int8_quantize, with x_scale formed on the device from the float32
// amax at `amax` (x_scale = amax > 0 ? amax / 127 : 1).
int iswm_int8_quantize_amax(const void* x, int x_is_bf16, const float* amax, void* out, int P,
                            int C, long long ld, void* stream) {
  return quantize<quant::QUANT>(x, x_is_bf16, AmaxScale{amax, nullptr}, out, P, C, ld, nullptr,
                                nullptr, stream);
}

// The quantize that reduces its own amax, one launch: mode 1 (dynamic) the
// amax max |x| into amax_out and the codes with its scale; 2 the amax alone
// (out null); 3 (delayed) the codes with the scale of the amax at amax_in and
// max |x| into amax_out.  ws: the stream's workspace (4 words, zero before
// the first launch; each launch leaves it zero).
int iswm_int8_quantize_reduce(const void* x, int x_is_bf16, int mode, const float* amax_in,
                              void* out, int P, int C, long long ld, float* amax_out, void* ws,
                              void* stream) {
  auto* w = static_cast<unsigned*>(ws);
  const AmaxScale scale{amax_in, nullptr};
  switch (mode) {
    case quant::DYNAMIC:
      return quantize<quant::DYNAMIC>(x, x_is_bf16, scale, out, P, C, ld, amax_out, w, stream);
    case quant::AMAX:
      return quantize<quant::AMAX>(x, x_is_bf16, scale, nullptr, P, C, ld, amax_out, w, stream);
    case quant::DELAYED:
      if (amax_in == nullptr) break;
      return quantize<quant::DELAYED>(x, x_is_bf16, scale, out, P, C, ld, amax_out, w, stream);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The data gradient's weights: the float kernel w [N, C, KH, KW] (element
// strides strides[4]: contiguous or channels last) -> its per-tensor amax
// (amax_out) and the rotated, I/O-swapped codes as rows out [C, ldw] of (i,
// j, n), n padded to NP with zeros (w_rot[c, i, j, n] = w[n, c, KH - 1 - i,
// KW - 1 - j]), zeros past KH KW NP: one cooperative launch.  ws as
// iswm_int8_quantize_reduce's.
int iswm_int8_rotated_codes(const void* w, int w_is_bf16, int N, int C, int KH, int KW,
                            const long long* strides, int NP, int ldw, void* out,
                            float* amax_out, void* ws, void* stream) {
  return rotated_codes(w, w_is_bf16, N, C, KH, KW, strides, NP, ldw, static_cast<int8_t*>(out),
                       amax_out, static_cast<unsigned*>(ws), static_cast<cudaStream_t>(stream));
}

// geom[17] = B, H, W, C, Ho, Wo, N, KH, KW, sh, sw, ph, pw, dh, dw, K, ldw.
// Dense conv (groups 1): x_q [B, H, W, C], w_q [N, ldw], bias may be null;
// out f32 (out_bf16 0) or bf16 (1).  plan[6] = body (0 wgmma, 1 bytewise),
// log2 of the tile's width, BN, ring slots, K splits, weights by TMA (1, for
// C % 64 == 0) or by cp.async (0) (the last five for the wgmma body);
// `partial` holds splits * M * N int32 where splits > 1.
int iswm_int8_conv_igemm(const void* x_q, const void* w_q, const void* w_scale,
                         const void* bias, float x_scale, void* out, int out_bf16,
                         const int* geom, const int* plan, void* partial, void* stream) {
  return conv_igemm(x_q, w_q, w_scale, bias, HostScale{x_scale}, out, out_bf16, geom, plan,
                    partial, stream);
}

// As iswm_int8_conv_igemm, with x_scale formed on the device from the
// float32 amax at `amax`, as iswm_int8_quantize_amax forms it.
int iswm_int8_conv_igemm_amax(const void* x_q, const void* w_q, const void* w_scale,
                              const void* bias, const float* amax, void* out, int out_bf16,
                              const int* geom, const int* plan, void* partial, void* stream) {
  return conv_igemm(x_q, w_q, w_scale, bias, AmaxScale{amax, nullptr}, out, out_bf16, geom, plan,
                    partial, stream);
}

// The data gradient of a conv (the JAX package's _int8_dgrad): the dense
// body over the int8 cotangent g_q [B, gh, gw, N] with the rotated, I/O-
// swapped per-tensor codes w_q [C, ldw] of (kh, kw, n).  parity null (a
// stride of 1): one conv at `geom` (stride 1, the transpose padding, out [B,
// H, W, C] of x's extent).  Else (parity_of's ints) the parity classes in one
// launch, `geom` g's extent as H, W, stride 1, no padding, out dx [B, H, W,
// C] of the table's extent.  The epilogue is float(acc) * (g_s * w_s), the
// scales formed from the amaxes: `ones` is C float32 ones in the per-channel
// place (an exact product).
int iswm_int8_conv_dgrad(const void* g_q, const void* w_q, const void* ones, const float* g_amax,
                         const float* w_amax, void* out, int out_bf16, const int* geom,
                         const int* plan, const int* parity, void* partial, void* stream) {
  if (parity == nullptr)
    return conv_igemm(g_q, w_q, ones, nullptr, AmaxScale{g_amax, w_amax}, out, out_bf16, geom,
                      plan, partial, stream);
  dense::Parity par;
  int classes = 0;
  if (!parity_of(parity, par, classes)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom_of(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(g_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(ones);
  int* part = static_cast<int*>(partial);
  const AmaxScale scale{g_amax, w_amax};
  if (out_bf16)
    return run_dense(g, plan, x, w, ws, nullptr, scale, static_cast<__nv_bfloat16*>(out), part, s,
                     par, classes);
  return run_dense(g, plan, x, w, ws, nullptr, scale, static_cast<float*>(out), part, s, par,
                   classes);
}

// The weight gradient of a conv (the JAX package's _int8_wgrad and the
// weight half of _dil_bwd): dw [N, C, KH, KW] (OIHW) in float32 or bf16 of
// the forward's int8 codes x_q [B, H, W, C] and the int8 cotangent g_q [B,
// Ho, Wo, N] at the forward's `geom` (geom[0..14]: B, H, W, C, Ho, Wo, N,
// KH, KW, sh, sw, ph, pw, dh, dw), C and N multiples of 4: the pixels split
// `splits` ways into `partial` [splits][KH KW][N][C] int32, then one
// finishing pass with the epilogue float(acc) * (x_s * g_s).
int iswm_int8_conv_wgrad(const void* x_q, const void* g_q, const float* x_amax,
                         const float* g_amax, void* out, int out_bf16, const int* geom,
                         int splits, void* partial, void* stream) {
  const Geom g = geom_of(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* gq = static_cast<const int8_t*>(g_q);
  int* part = static_cast<int*>(partial);
  const AmaxScale scale{x_amax, g_amax};
  if (out_bf16)
    return run_wgrad(g, splits, x, gq, part, scale, static_cast<__nv_bfloat16*>(out), s);
  return run_wgrad(g, splits, x, gq, part, scale, static_cast<float*>(out), s);
}

// The weight gradient's wgmma body (run_wgrad_tma): as iswm_int8_conv_wgrad
// with C and N multiples of 16, x_t and g_t the planar copies' room (C len_x
// and N len_g bytes, 16-byte aligned), `plan` the wrapper's (kc.wgrad_plan)
// and `partial` items * N * C int32 (16-byte aligned).
int iswm_int8_conv_wgrad_tma(const void* x_q, const void* g_q, void* x_t, void* g_t,
                             const float* x_amax, const float* g_amax, void* out, int out_bf16,
                             const int* geom, const int* plan, void* partial, void* stream) {
  const Geom g = geom_of(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* gq = static_cast<const int8_t*>(g_q);
  auto* xt = static_cast<int8_t*>(x_t);
  auto* gt = static_cast<int8_t*>(g_t);
  int* part = static_cast<int*>(partial);
  const AmaxScale scale{x_amax, g_amax};
  if (out_bf16)
    return run_wgrad_tma(g, plan, x, gq, xt, gt, part, scale, static_cast<__nv_bfloat16*>(out), s);
  return run_wgrad_tma(g, plan, x, gq, xt, gt, part, scale, static_cast<float*>(out), s);
}

// Grouped conv: as above with w_q [N, KH KW C / groups] (ldw unused); body 0
// the tiled depthwise 3x3, 1 the one-thread-an-output body.
int iswm_int8_conv_direct(const void* x_q, const void* w_q, const void* w_scale,
                          const void* bias, float x_scale, void* out, int out_bf16,
                          const int* geom, int groups, int body, void* stream) {
  const Geom g = geom_of(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  if (out_bf16)
    return run_direct(g, groups, body, x, w, ws, bs, x_scale, static_cast<__nv_bfloat16*>(out), s);
  return run_direct(g, groups, body, x, w, ws, bs, x_scale, static_cast<float*>(out), s);
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
