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
// the kernel is a template on x's element type, and for int8_t the codes are
// copied into shared memory as they are, so that entry is this kernel
// without the quantize (its time beside the other's is what the quantize
// costs).
//
// What bounds it on this card: at the serving shapes (M = 8k..131k pixels,
// K, N = 128..2048) the int8 tensor-core work is small next to the bytes
// (x in bf16, out in f32, 4 M N bytes: most of the call's), so the kernel
// is bound by device memory, and on the way there by three costs of the
// first version: every 128-wide column tile quantized its x rows again
// (3.5 IEEE divisions an element over a serving chunk, 16 at N = 2048), no
// copy overlapped the products, and the float32 results went out as 32-byte
// pieces straight from the accumulators.  This design:
//   - a block owns a strip of BM rows (32, 64 or 128) and a K range, keeps
//     the strip's int8 codes [BM, K range] in dynamic shared memory, and
//     walks the 128-wide column tiles of its N group against it: each x
//     element is quantized once per N group (the planner allows 1 or 2
//     groups), where the first version quantized it once per column tile;
//   - cp.async rings run over the block's whole sequence of (column tile,
//     64-deep K step): one of 4 or 3 stages of the weight tile w_t [128, 64]
//     (int8, from L2: w is at most 4 MB) and, during the first column tile,
//     one of up to 4 stages of the strip's raw x [BM, 64]; the thread that
//     copied an x chunk quantizes it from shared memory into the strip one
//     step ahead, while the tensor cores multiply the current step.  int8 x
//     is copied into the strip directly.  The weight ring runs on across
//     column tiles, so the next tile's weights are in flight during a
//     tile's epilogue;
//   - at BM = 128 and 64 the products are `wgmma.mma_async ... .s32.s8.s8`
//     from shared memory (two warpgroups: 64 rows x 128 columns each, or
//     the 64 rows x 64 columns each), strip and weight stages in wgmma's
//     64-byte swizzle, one step's group left in flight (the weight ring has
//     a slot more for it); at BM = 32 (the M = 8 and small-M plans), 8
//     warps of 16 x 32 take ldmatrix fragments (an m16n8k32 s8 fragment is,
//     byte for byte, the b16 fragment of ldmatrix) into
//     `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`, with rows of K
//     range + 16 bytes (strip) and 80 bytes (weight stages) so that
//     ldmatrix's 8 rows of 16 bytes hit 8 distinct bank groups.  (wgmma from
//     unswizzled core matrices took 1.18-1.23 ms for #2 over a chunk,
//     mma.sync 0.95, the swizzled 0.94, on an H100; block_bwd_ab.py --kind int8);
//   - the epilogue goes through shared memory: each warp stages 16 rows x 32
//     int32 sums at a time in its own slab and writes them as float32 rows
//     of 128 bytes, 16 bytes a thread (the slabs share the space of the x
//     stages, which are done by the end of the first column tile);
//   - where the rows give the card too few blocks (M = 8 at the ASPP pool),
//     K is split across blocks: each adds its exact int32 partial
//     sums into `out` read as int32 (zeroed first), and a finishing pass
//     turns them into float32 in place.  Integer adds in any order give the
//     same bits; nothing is carried in float before the sum is complete;
//   - plan_int8 picks BM, the stages, the N groups and the K split per shape
//     (below); iswm_int8_matmul_plan reports it.
//
// Exactness: the int32 sum is exact, and every float step matches the
// plain version bit for bit: a true IEEE division (__fdiv_rn, never a
// reciprocal; do not build with --use_fast_math), rounding half to even
// (as jnp.round and torch.round; see quantize), and the epilogue multiplied left
// to right, (float(acc) * x_scale) * w_scale[n].  |acc| <= K 127^2 fits
// int32 for K < 133,000.
//
// Contract (checked by the Python wrapper): K % 128 == 0, N % 128 == 0,
// x (bf16, f32 or int8 codes) row-major [M, K] and 16-byte aligned, w_t = w^T row-major [N, K] int8,
// w_scale [N] f32, out [M, N] f32.  The launch is asynchronous on `stream`;
// the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps, two warpgroups
constexpr int BN = 128;               // columns of a tile
constexpr int PK = 64;                // K depth of a stage (bytes of int8)
constexpr int WLD = PK + 16;          // bytes of a weight-stage row
constexpr int SLAB_LD = 32 + 8;       // int32s of an epilogue slab row (2 wavefronts a store)
constexpr int SLAB = 16 * SLAB_LD * 4;  // bytes of one warp's slab
constexpr int SLABS = 8 * SLAB;
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may ask for
constexpr int SM_SMEM = 233472;       // of an SM, with 1 KB reserved a block
constexpr int SMS = 132;              // SMs of an H100 SXM

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// slots of the x ring beside a weight ring of `stages`
__host__ __device__ constexpr int x_stages(int stages) { return stages < 4 ? stages : 4; }

// q(v) = clip(rint(v / s), -127, 127) for NV values, packed four to a
// word: the IEEE division, clipped, then rounded half to even by adding
// 1.5 * 2^23, whose float has unit spacing, so that the code is the low byte
// of the sum's bits (clipping first gives the same code, rint(127.5) = 128
// included; a NaN quotient clips to -127 either way).  This spares rintf
// and the float-to-int conversion, which the card runs at a quarter rate.
template <int NV>
__device__ __forceinline__ void quantize(const float (&v)[NV], float s,
                                         uint32_t (&packed)[NV / 4]) {
#pragma unroll
  for (int w = 0; w < NV / 4; ++w) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float q = fminf(fmaxf(__fdiv_rn(v[4 * w + i], s), -127.0f), 127.0f);
      b[i] = __float_as_uint(__fadd_rn(q, 12582912.0f));
    }
    packed[w] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                            0x5410);
  }
}

// 16 raw bytes of x -> their int8 codes at `dst` in the strip.
__device__ __forceinline__ void store_codes(const uint4& raw, int8_t* dst, float s,
                                            const float*) {
  const float v[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                      __uint_as_float(raw.w)};
  uint32_t p[1];
  quantize(v, s, p);
  *reinterpret_cast<uint32_t*>(dst) = p[0];
}

__device__ __forceinline__ void store_codes(const uint4& raw, int8_t* dst, float s,
                                            const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
  uint32_t p[2];
  quantize(v, s, p);
  *reinterpret_cast<uint2*>(dst) = make_uint2(p[0], p[1]);
}

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

// A wgmma operand in shared memory, K-major with the 64-byte swizzle: rows
// of 64 bytes whose 16-byte chunk c sits at c ^ ((row / 2) % 4), in atoms
// of 8 rows (512 bytes, 512-byte aligned) `sbo` bytes apart along M (or N).
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* p, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t{1} << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{2} << 62;
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
// Makes this thread's shared-memory writes (stores, landed cp.async copies)
// visible to wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving the accumulators across an async wgmma.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// D[64 x 128] s32 += A[64 x 32] s8 x B[128 x 32]^T s8, both K-major in
// shared memory, one warpgroup; D in the mma.sync layout of each warp's 16
// rows, n8 block i in d[4 i .. 4 i + 3].
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
// The same for 64 columns: D[64 x 64] in 32 registers.
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A block's plan: rows of its strip, stages of the ring, N groups (each
// quantizes the strip once), K splits.
struct Plan {
  int bm, stages, groups, splits;
};

// Bytes of the strip and of a weight stage: wgmma's (BM >= 64) swizzled
// matrices are dense; mma.sync's rows are padded for ldmatrix.
__host__ __device__ constexpr int strip_bytes(int bm, int k_range) {
  return bm * (k_range + (bm >= 64 ? 0 : 16));
}
__host__ __device__ constexpr int w_stage_bytes(int bm) { return BN * (bm >= 64 ? PK : WLD); }
__host__ __device__ constexpr int w_slots(int bm, int stages) { return stages + (bm >= 64); }

// Dynamic shared memory of a block: the strip, the weight ring, and the x
// ring (bf16 / f32 only), which the epilogue slabs reuse.
int smem_bytes(int bm, int stages, int k_range, int x_bytes) {
  const int xring = x_bytes == 1 ? 0 : x_stages(stages) * bm * PK * x_bytes;
  return strip_bytes(bm, k_range) + w_slots(bm, stages) * w_stage_bytes(bm) +
         (xring > SLABS ? xring : SLABS);
}

// The plan for (M, K, N) and x's element size, on SMS SMs: of the
// candidates (BM in {128, 64, 32}, a weight ring of 4 or 3 stages, 1 or 2 N
// groups, K split in powers of two into whole steps, within SMEM_MAX) the
// least estimated time; a tie goes to the larger BM, the more stages, the
// fewer groups and splits.  The estimate is in SM cycles, with constants
// fitted to every plan's time at the serving shapes on an H100
// (block_bwd_ab.py --kind int8 --sweep; PERF.md): with the busiest SM's
// blocks run r = min(occ, its blocks) at a time (occ: 2 where the shared
// memory allows and BM < 128, else 1),
//   step   = max(700, r c)             c = 400, 415, 975 at BM = 32, 64, 128
//                                      (x 1.26 with 3 stages): a step of one
//                                      block is bound by latency, of two by
//                                      the SM's shared-memory and tensor rates
//   step0  = max(700, r (c + 20 BM))   a step of the first column tile,
//                                      which also quantizes (float x)
//   block  = K steps (step0 + (tiles - 1) step) + tiles r 92 BM (stores)
//   cost   = ceil(blocks per SM / r) (block + 1260)
//          + with a K split 11000 + 12 M N / 1909 (zeroing, atomics and the
//            finishing pass: 12 bytes a value at 1909 bytes a cycle)
double plan_cost(int M, int K, int N, int x_bytes, const Plan& p) {
  const int smem = smem_bytes(p.bm, p.stages, K / p.splits, x_bytes);
  const int occ = p.bm == 128 || 2 * (smem + 1024) > SM_SMEM ? 1 : 2;
  const int tiles = ceil_div(N / BN, p.groups), ksteps = K / PK / p.splits;
  const long long blocks = static_cast<long long>(ceil_div(M, p.bm)) * p.groups * p.splits;
  const long long per_sm = (blocks + SMS - 1) / SMS;
  const int r = per_sm < occ ? static_cast<int>(per_sm) : occ;
  const double c = (p.bm == 32 ? 400.0 : p.bm == 64 ? 415.0 : 975.0) * (p.stages == 3 ? 1.26 : 1.0);
  const double q = x_bytes > 1 ? 20.0 * p.bm : 0.0;
  const double step = r * c > 700.0 ? r * c : 700.0;
  const double step0 = r * (c + q) > 700.0 ? r * (c + q) : 700.0;
  const double block = ksteps * (step0 + (tiles - 1) * step) + tiles * r * 92.0 * p.bm;
  double cost = static_cast<double>((per_sm + r - 1) / r) * (block + 1260.0);
  if (p.splits > 1) cost += 11000.0 + 12.0 * M * static_cast<double>(N) / 1909.0;
  return cost;
}

Plan plan_int8(int M, int K, int N, int x_bytes) {
  const int ks = K / PK;
  Plan best{0, 0, 0, 0};
  double best_cost = 0.0;
  const int sides[3] = {128, 64, 32};
  const int rings[2] = {4, 3};
  for (const int bm : sides) {
    for (const int stages : rings) {
      for (int groups = 1; groups <= 2 && groups <= N / BN; ++groups) {
        for (int splits = 1; splits <= ks; splits *= 2) {
          const Plan p{bm, stages, groups, splits};
          if (ks % splits || smem_bytes(bm, stages, K / splits, x_bytes) > SMEM_MAX) continue;
          const double cost = plan_cost(M, K, N, x_bytes, p);
          if (best.bm == 0 || cost < best_cost) {
            best = p;
            best_cost = cost;
          }
        }
      }
    }
  }
  return best;
}

// One block: rows [m0, m0 + BM) against column tiles [t0, t0 + tiles) of
// its N group, over the K range of its split.  Step j of the block is
// column tile j / ksteps, K step j % ksteps.  Two rings: the weight tile of
// step j in slot j % WSLOTS, and, in the first column tile, the raw x of
// step j in slot j % XR (for int8 x, the codes, copied into the strip).
// Both are one cp.async group a step; the x copies run XR - 1 steps ahead,
// the weight copies STAGES - 1.
template <typename T, int BM, int STAGES>
__global__ void __launch_bounds__(THREADS, BM == 128 ? 1 : 2)
    int8_strip_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_t,
                      const float* __restrict__ w_scale, float x_scale,
                      float* __restrict__ out, int M, int K, int N, int groups,
                      int splits) {
  constexpr bool QUANT = sizeof(T) != 1;
  // wgmma where BM >= 64: two warpgroups of 64 rows x 128 columns (BM =
  // 128) or of the 64 rows x 64 columns each (BM = 64); mma.sync at BM = 32
  constexpr bool WG = BM >= 64;
  constexpr int WGN = BM == 128 ? 128 : 64;  // a warpgroup's columns
  constexpr int XR = x_stages(STAGES);
  constexpr int WM = BM / 2;          // mma.sync: 2 x 4 warps of WM x 32
  constexpr int MF = WM / 16;         // m16 fragments a warp
  constexpr int NF = 4;               // n8 fragments a warp
  constexpr int WSTAGE = w_stage_bytes(BM);
  constexpr int WSLOTS = w_slots(BM, STAGES);  // wgmma's: one more, for the step still in flight
  constexpr int XCH = PK * static_cast<int>(sizeof(T)) / 16;  // 16-byte x chunks a stage row
  constexpr int XN = BM * XCH;        // x chunks a stage
  constexpr int XPT = QUANT ? XN / THREADS : 1;  // x chunks a thread quantizes a stage
  constexpr int XSTAGE = BM * PK * static_cast<int>(sizeof(T));
  static_assert(XR >= 3 && STAGES >= XR, "a stage multiplied, one quantized, one in flight");
  static_assert(!QUANT || XN % THREADS == 0, "whole quantize rounds");
  extern __shared__ __align__(1024) unsigned char smem[];  // whole swizzle atoms

  const int k_range = K / splits;
  const int ksteps = k_range / PK;
  const int sld = k_range + 16;  // mma.sync's strip row
  const int nt = N / BN;
  const int per = ceil_div(nt, groups);
  int b = blockIdx.x;
  const int split = b % splits;
  b /= splits;
  const int group = b % groups;
  const int m0 = (b / groups) * BM;
  const int kb = split * k_range;
  const int t0 = group * per;
  const int tiles = min(per, nt - t0);
  const int steps = tiles * ksteps;

  int8_t* strip = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + strip_bytes(BM, k_range);
  unsigned char* xring = ring + WSLOTS * WSTAGE;  // later the epilogue slabs
  // where byte kbyte of row r lies: in the strip, and in a weight stage (row n)
  // (wgmma's: the 64-byte swizzle, each 64-byte K step of the strip a
  // [BM][64] block, a weight stage one [BN][64] block)
  auto sw64 = [](int r, int kbyte) {
    return r * 64 + ((((kbyte >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (kbyte & 15);
  };
  auto strip_at = [&](int r, int kbyte) {
    return WG ? (kbyte >> 6) * (BM * 64) + sw64(r, kbyte & 63) : r * sld + kbyte;
  };
  auto w_at = [&](int n, int kbyte) { return WG ? sw64(n, kbyte) : n * WLD + kbyte; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm0 = (warp / 4) * WM;
  const int wn0 = (warp % 4) * 32;

  // A step's place, kept by counting rather than dividing: the index
  // arithmetic of a step is otherwise as long as its products at BM = 32.
  struct Walk {
    int k = 0, tile = 0;  // K step, column tile within the group
  };
  auto advance = [&](Walk& at) {
    if (++at.k == ksteps) {
      at.k = 0;
      ++at.tile;
    }
  };
  auto load_w = [&](const Walk& at, int slot) {
    unsigned char* sw = ring + slot * WSTAGE;
    const int8_t* src = w_t + static_cast<size_t>((t0 + at.tile) * BN) * K + kb + at.k * PK;
#pragma unroll
    for (int i = 0; i < BN * (PK / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (PK / 16), cc = (c % (PK / 16)) * 16;
      cp_async16(sw + w_at(r, cc), src + static_cast<size_t>(r) * K + cc, true);
    }
  };
  auto load_x = [&](int k) {  // K step k of the first column tile; rows past M are zeros
    const int k0 = kb + k * PK;
#pragma unroll
    for (int i = 0; i < ceil_div(XN, THREADS); ++i) {
      const int c = tid + i * THREADS;
      if (XN % THREADS && c >= XN) break;
      const int r = c / XCH, cc = c % XCH;
      const bool ok = m0 + r < M;
      const T* src = x + (ok ? static_cast<size_t>(m0 + r) * K + k0 + cc * (16 / sizeof(T)) : 0);
      void* dst = QUANT ? static_cast<void*>(xring + (k % XR) * XSTAGE +
                                             r * PK * static_cast<int>(sizeof(T)) + cc * 16)
                        : static_cast<void*>(strip + strip_at(r, k * PK + cc * 16));
      cp_async16(dst, src, ok);
    }
  };
  // the raw x chunks this thread copied for K step k, and their codes into
  // the strip
  uint4 raw[XPT];
  auto fetch_x = [&](int k) {
    if constexpr (QUANT) {
      const unsigned char* sx = xring + (k % XR) * XSTAGE;
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int c = tid + i * THREADS;
        raw[i] = *reinterpret_cast<const uint4*>(sx + (c / XCH) * PK * sizeof(T) + (c % XCH) * 16);
      }
    }
  };
  auto quantize_x = [&](int k) {
    if constexpr (QUANT) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int c = tid + i * THREADS;
        store_codes(raw[i], strip + strip_at(c / XCH, k * PK + (c % XCH) * (16 / sizeof(T))),
                    x_scale, static_cast<const T*>(nullptr));
      }
    }
  };

  // the sums: mma.sync's fragment (i, jj) in acc[4 (NF i + jj) ..], or
  // wgmma's n8 block i of the warp's 16 rows in acc[4 i ..]; 64 at BM = 128
  int acc[MF * NF * 4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < MF * NF * 4; ++i) acc[i] = 0;
  };
  // mma.sync: the fragments of mma step kk (32 deep) of K step k, A from
  // the strip, B from a ring slot, and their products
  using FragA = uint32_t[MF][4];
  using FragB = uint32_t[NF][2];
  auto fragments = [&](int k, int slot, int kk, FragA& af, FragB& bfr) {
    const int8_t* sa = strip + k * PK + kk * 32;
    const unsigned char* sb = ring + slot * WSTAGE + kk * 32;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      ldsm_x4(af[i], sa + (wm0 + 16 * i + lane % 16) * sld + (lane / 16) * 16);
    }
#pragma unroll
    for (int jj = 0; jj < NF; jj += 2) {
      uint32_t r[4];
      ldsm_x4(r, sb + (wn0 + 8 * jj + lane % 8 + (lane / 16) * 8) * WLD + ((lane / 8) % 2) * 16);
      bfr[jj][0] = r[0];
      bfr[jj][1] = r[1];
      bfr[jj + 1][0] = r[2];
      bfr[jj + 1][1] = r[3];
    }
  };
  auto products = [&](const FragA& af, const FragB& bfr) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        int(&d)[4] = *reinterpret_cast<int(*)[4]>(acc + 4 * (NF * i + jj));
        mma_s8(d, af[i], bfr[jj]);
      }
  };
  // wgmma: K step k's two 32-deep products of the warpgroup's 64 rows
  // against the 128 columns of a ring slot, issued and committed (waited
  // for before the accumulators or the slot are touched)
  auto wg_products = [&](int k, int slot) {
    if constexpr (WG) {
      int(&d)[MF * NF * 4] = acc;
      const int wg = warp / 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // K advances inside the swizzle's rows by the start address
        const int a_rows = BM == 128 ? 64 * wg : 0, b_rows = BM == 128 ? 0 : 64 * wg;
        wgmma_s8(d, smem_desc_sw64(strip + k * (BM * 64) + 64 * a_rows + kk * 32, 512),
                 smem_desc_sw64(ring + slot * WSTAGE + 64 * b_rows + kk * 32, 512));
      }
      wgmma_commit();
    }
  };
  // a column tile's sums, 16 rows x 32 columns at a time through the warp's
  // slab: rows of 32 int32 out as 128-byte float32 rows, 16 bytes a thread;
  // with a K split, added into out as int32 instead.  A pass's rows and
  // columns: mma.sync's m16 fragment p of the warp tile, or wgmma's 32
  // columns p of the warp's 16 rows.
  auto epilogue = [&](int tile) {
    int* slab = reinterpret_cast<int*>(xring + warp * SLAB);
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int p = 0; p < (WG ? WGN / 32 : MF); ++p) {
      const int row0 = WG ? (BM == 128 ? 64 * (warp / 4) : 0) + 16 * (warp % 4) : wm0 + 16 * p;
      const int col0 = WG ? (BM == 128 ? 0 : 64 * (warp / 4)) + 32 * p : wn0;
      const int n = tile * BN + col0 + 4 * (lane % 8);
      const int* a = acc + 4 * (WG ? 4 * p : NF * p);
      float ws[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ws[e] = splits == 1 ? w_scale[n + e] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        *reinterpret_cast<int2*>(slab + g * SLAB_LD + 8 * jj + 2 * t) =
            make_int2(a[4 * jj], a[4 * jj + 1]);
        *reinterpret_cast<int2*>(slab + (g + 8) * SLAB_LD + 8 * jj + 2 * t) =
            make_int2(a[4 * jj + 2], a[4 * jj + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 4 * q + lane / 8;
        const int m = m0 + row0 + row;
        const int4 v = *reinterpret_cast<const int4*>(slab + row * SLAB_LD + 4 * (lane % 8));
        if (m >= M) continue;
        if (splits == 1) {
          float4 o;
          o.x = __fmul_rn(__fmul_rn(__int2float_rn(v.x), x_scale), ws[0]);
          o.y = __fmul_rn(__fmul_rn(__int2float_rn(v.y), x_scale), ws[1]);
          o.z = __fmul_rn(__fmul_rn(__int2float_rn(v.z), x_scale), ws[2]);
          o.w = __fmul_rn(__fmul_rn(__int2float_rn(v.w), x_scale), ws[3]);
          *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) = o;
        } else {
          int* o = reinterpret_cast<int*>(out) + static_cast<size_t>(m) * N + n;
          atomicAdd(o, v.x);
          atomicAdd(o + 1, v.y);
          atomicAdd(o + 2, v.z);
          atomicAdd(o + 3, v.w);
        }
      }
      __syncwarp();
    }
  };

  // The prologue: STAGES - 1 groups, group i with the weights of step i and
  // the x of K step i for i < XR - 1.  Then at the top of step j, the group
  // of step j + 1's weights is the (j + 1)-th; that of K step j + 1's x is
  // the (j + 1)-th while j + 1 < XR - 1 and the (j + 1 + STAGES - XR)-th
  // after, so XR - 3 groups may stay pending while x is being copied and
  // STAGES - 3 after.
  clear();
  Walk loading, at;  // the next step whose weights are copied; the step multiplied
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) {
      load_w(loading, st);
      advance(loading);
    }
    if (st < XR - 1 && st < ksteps) load_x(st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // this thread's copies of step 0 have landed
  fetch_x(0);
  quantize_x(0);
  for (int j = 0; j < steps; ++j) {
    const bool next_x = j + 1 < ksteps;
    if (next_x) {
      cp_async_wait<XR - 3>();     // K step j + 1's x and step j + 1's weights have landed
    } else {
      cp_async_wait<STAGES - 3>();  // step j + 1's weights have landed
    }
    if constexpr (WG) fence_proxy_async();  // this thread's copies and codes, for wgmma
    __syncthreads();  // ... for every thread; the strip's K step j is whole; slots of j - 1 free
    if (j + STAGES - 1 < steps) {
      load_w(loading, (j + STAGES - 1) % WSLOTS);
      advance(loading);
    }
    if (j + XR - 1 < ksteps) load_x(j + XR - 1);
    cp_async_commit();
    if (next_x) fetch_x(j + 1);
    if constexpr (WG) {
      wg_products(at.k, j % WSLOTS);
      if (next_x) quantize_x(j + 1);  // beside the tensor cores' work
      wgmma_wait<1>();  // step j - 1's products are done: its slot is free
    } else {
      FragA a0, a1;  // both mma steps' fragments first, so that the
      FragB b0, b1;  // products do not wait on shared memory in between
      fragments(at.k, j % STAGES, 0, a0, b0);
      fragments(at.k, j % STAGES, 1, a1, b1);
      products(a0, b0);
      if (next_x) quantize_x(j + 1);
      products(a1, b1);
    }
    if (at.k == ksteps - 1) {  // the last K step of a column tile
      if constexpr (WG) {
        wgmma_wait<0>();
        fence_operands(acc);
      }
      epilogue(t0 + at.tile);
      clear();
    }
    advance(at);
  }
  cp_async_wait<0>();
}

// After a K split: out holds the int32 sums; each becomes
// (float(acc) * x_scale) * w_scale[n] in place.
__global__ void __launch_bounds__(THREADS)
    finish_split(float* __restrict__ out, const float* __restrict__ w_scale, float x_scale,
                 long long quads, int N) {
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < quads;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const int4 v = reinterpret_cast<const int4*>(out)[i];
    const int n = static_cast<int>((i * 4) % N);
    float4 o;
    o.x = __fmul_rn(__fmul_rn(__int2float_rn(v.x), x_scale), w_scale[n]);
    o.y = __fmul_rn(__fmul_rn(__int2float_rn(v.y), x_scale), w_scale[n + 1]);
    o.z = __fmul_rn(__fmul_rn(__int2float_rn(v.z), x_scale), w_scale[n + 2]);
    o.w = __fmul_rn(__fmul_rn(__int2float_rn(v.w), x_scale), w_scale[n + 3]);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

template <typename T>
using StripKernel = void (*)(const T*, const int8_t*, const float*, float, float*, int, int,
                             int, int, int);

template <typename T, int BM>
StripKernel<T> pick(int stages) {
  return stages == 4 ? int8_strip_kernel<T, BM, 4> : int8_strip_kernel<T, BM, 3>;
}

template <typename T>
StripKernel<T> pick(int bm, int stages) {
  return bm == 128 ? pick<T, 128>(stages) : bm == 64 ? pick<T, 64>(stages) : pick<T, 32>(stages);
}

// Whether a plan can run (M, K, N) with x of x_bytes a value.
bool fits(const Plan& p, int K, int N, int x_bytes) {
  const int ks = K / PK;
  return (p.bm == 32 || p.bm == 64 || p.bm == 128) && (p.stages == 3 || p.stages == 4) &&
         p.groups >= 1 && p.groups <= 2 && p.groups <= N / BN && p.splits >= 1 &&
         ks % p.splits == 0 && smem_bytes(p.bm, p.stages, K / p.splits, x_bytes) <= SMEM_MAX;
}

// Launches a plan (with a K split: zeroes out, launches, finishes).
template <typename T>
int run(const Plan& p, const void* x, const void* w_t, const void* w_scale, float x_scale,
        void* out, int M, int K, int N, cudaStream_t s) {
  if (!fits(p, K, N, sizeof(T))) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(p.bm, p.stages, K / p.splits, sizeof(T));
  const StripKernel<T> kernel = pick<T>(p.bm, p.stages);
  // above 48 KB dynamic shared memory must be asked for; the attribute is
  // per device, so it is asked before every launch
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* o = static_cast<float*>(out);
  if (p.splits > 1) {
    e = cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(ceil_div(M, p.bm)) * p.groups * p.splits;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w_t),
      static_cast<const float*>(w_scale), x_scale, o, M, K, N, p.groups, p.splits);
  if (p.splits > 1) {
    const long long quads = static_cast<long long>(M) * N / 4;
    long long grid = (quads + THREADS - 1) / THREADS;
    if (grid > 8 * SMS) grid = 8 * SMS;
    finish_split<<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
        o, static_cast<const float*>(w_scale), x_scale, quads, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_is_bf16: 1 for bf16 x, 0 for f32 x.  Returns cudaGetLastError().
int iswm_int8_matmul(const void* x, int x_is_bf16, const void* w_t,
                     const void* w_scale, float x_scale, void* out, int M,
                     int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? run<__nv_bfloat16>(plan_int8(M, K, N, 2), x, w_t, w_scale, x_scale, out,
                                        M, K, N, s)
                   : run<float>(plan_int8(M, K, N, 4), x, w_t, w_scale, x_scale, out, M, K, N,
                                s);
}

// x_q [M, K] int8, row-major and 16-byte aligned; the rest as above.
int iswm_int8_matmul_prequant(const void* x_q, const void* w_t,
                              const void* w_scale, float x_scale, void* out,
                              int M, int K, int N, void* stream) {
  return run<int8_t>(plan_int8(M, K, N, 1), x_q, w_t, w_scale, x_scale, out, M, K, N,
                     static_cast<cudaStream_t>(stream));
}

// Either entry under a plan given as plan[0..3] = BM, stages, N groups, K
// splits, for timing the plans against each other (block_bwd_ab.py --kind
// int8 --sweep); x_bytes 2 (bf16), 4 (f32) or 1 (int8 codes).  A plan that
// does not fit the shape returns cudaErrorInvalidValue.
int iswm_int8_matmul_planned(const void* x, int x_bytes, const void* w_t, const void* w_scale,
                             float x_scale, void* out, int M, int K, int N, const int* plan,
                             void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_bytes) {
    case 2: return run<__nv_bfloat16>(p, x, w_t, w_scale, x_scale, out, M, K, N, s);
    case 4: return run<float>(p, x, w_t, w_scale, x_scale, out, M, K, N, s);
    case 1: return run<int8_t>(p, x, w_t, w_scale, x_scale, out, M, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan of a call: plan[0..5] = BM, stages, N groups, K splits, blocks,
// dynamic shared memory bytes a block.  x_bytes: 2 (bf16), 4 (f32), 1 (int8
// codes).  Returns 0, or 1 where no plan fits.
int iswm_int8_matmul_plan(int M, int K, int N, int x_bytes, int* plan) {
  const Plan p = plan_int8(M, K, N, x_bytes);
  if (p.bm == 0) return 1;
  plan[0] = p.bm;
  plan[1] = p.stages;
  plan[2] = p.groups;
  plan[3] = p.splits;
  plan[4] = ceil_div(M, p.bm) * p.groups * p.splits;
  plan[5] = smem_bytes(p.bm, p.stages, K / p.splits, x_bytes);
  return 0;
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
