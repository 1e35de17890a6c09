// Binary confusion matrix (tn, fp, fn, tp) of integer labels and predictions,
// for Hopper (sm_90a).
//
//   out[2, 2] f32, rows = true class, columns = predicted class
//   a pixel counts when its label is 0 or 1 (255 and every other value are
//   excluded); its prediction counts as class 1 only when it equals 1.
//
// Replaces the TPU kernel iswm_tpu/ops/pallas/confusion.py
// `binary_confusion_matrix` (body `_kernel`), which walks 128-lane row tiles
// in order and carries four float32 sums from one grid step to the next.
//
// What bounds it on this card: bytes.  Each label and each prediction is
// read once and four numbers are written; there is no arithmetic to speak
// of.  So the design is a streaming reduction:
//   - the flattened pixels are walked with a grid-stride loop, labels and
//     predictions read in the element type they arrive in (uint8, int32 or
//     int64 each, nine instantiations), so no cast pass runs before the
//     kernel and no padding is needed for a ragged size;
//   - every thread counts the four cases in 32-bit integer registers, a warp
//     adds them by shuffle, a block through shared memory, and the block
//     writes four 64-bit partial counts;
//   - a second, one-block kernel adds the blocks' partials and writes the
//     float32 matrix.  Integer sums are the same in any order, so the result
//     is deterministic without atomics and without a zeroed buffer.
// The counts are exact 64-bit integers until the final conversion, so the
// matrix is exact wherever its entries are representable in float32, for
// any number of pixels (the TPU kernel's float32 running sums are exact only
// up to 2^24 pixels per call).
//
// Contract (checked by the Python wrapper): gt and pred contiguous with n
// elements each, partials holds 4 * iswm_confusion_max_blocks() uint64, out
// holds 4 float32.  The launches are asynchronous on `stream`; the C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1056;  // 8 blocks on each of the 132 SMs
constexpr int UNROLL = 4;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename TG, typename TP>
__global__ void __launch_bounds__(THREADS)
    confusion_partials_kernel(const TG* __restrict__ gt,
                              const TP* __restrict__ pred, long long n,
                              unsigned long long* __restrict__ partials) {
  // per thread at most n / (blocks * THREADS) + UNROLL pixels: 32 bits hold
  // the count for any n below 2^50
  unsigned tn = 0, fp = 0, fn = 0, tp = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
    long long g[UNROLL];
    long long p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      g[u] = (long long)gt[i + u * stride];
      p[u] = (long long)pred[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned is_one = g[u] == 1;
      const unsigned is_zero = g[u] == 0;
      const unsigned hit = p[u] == 1;
      tp += is_one & hit;
      fn += is_one & (hit ^ 1u);
      fp += is_zero & hit;
      tn += is_zero & (hit ^ 1u);
    }
  }
  for (; i < n; i += stride) {
    const long long g = (long long)gt[i];
    const unsigned is_one = g == 1;
    const unsigned is_zero = g == 0;
    const unsigned hit = (long long)pred[i] == 1;
    tp += is_one & hit;
    fn += is_one & (hit ^ 1u);
    fp += is_zero & hit;
    tn += is_zero & (hit ^ 1u);
  }

  __shared__ unsigned warp_counts[THREADS / 32][4];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  tn = warp_sum(tn);
  fp = warp_sum(fp);
  fn = warp_sum(fn);
  tp = warp_sum(tp);
  if (lane == 0) {
    warp_counts[warp][0] = tn;
    warp_counts[warp][1] = fp;
    warp_counts[warp][2] = fn;
    warp_counts[warp][3] = tp;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_counts[w][threadIdx.x];
    partials[(size_t)blockIdx.x * 4 + threadIdx.x] = total;
  }
}

// One block: thread t adds entry (t % 4) of the blocks t / 4, t / 4 + 64, ...;
// then the 64 sums of each entry are added through shared memory.
__global__ void __launch_bounds__(THREADS)
    confusion_finish_kernel(const unsigned long long* __restrict__ partials,
                            int blocks, float* __restrict__ out) {
  __shared__ unsigned long long sums[THREADS];
  const int entry = threadIdx.x % 4;
  unsigned long long total = 0;
  for (int b = threadIdx.x / 4; b < blocks; b += THREADS / 4)
    total += partials[(size_t)b * 4 + entry];
  sums[threadIdx.x] = total;
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned long long all = 0;
    for (int t = threadIdx.x; t < THREADS; t += 4) all += sums[t];
    out[threadIdx.x] = (float)all;  // round to nearest, exact below 2^24
  }
}

template <typename TG>
void launch_for_pred(const void* gt, const void* pred, int pred_kind,
                     long long n, unsigned long long* partials, int blocks,
                     cudaStream_t s) {
  const TG* g = static_cast<const TG*>(gt);
  switch (pred_kind) {
    case 0:
      confusion_partials_kernel<TG, uint8_t><<<blocks, THREADS, 0, s>>>(
          g, static_cast<const uint8_t*>(pred), n, partials);
      break;
    case 1:
      confusion_partials_kernel<TG, int32_t><<<blocks, THREADS, 0, s>>>(
          g, static_cast<const int32_t*>(pred), n, partials);
      break;
    default:
      confusion_partials_kernel<TG, int64_t><<<blocks, THREADS, 0, s>>>(
          g, static_cast<const int64_t*>(pred), n, partials);
      break;
  }
}

}  // namespace

extern "C" {

int iswm_confusion_max_blocks() { return MAX_BLOCKS; }

// gt_kind / pred_kind: 0 = uint8, 1 = int32, 2 = int64.  n >= 1.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unknown kind).
int iswm_binary_confusion(const void* gt, int gt_kind, const void* pred,
                          int pred_kind, long long n, void* partials,
                          void* out, void* stream) {
  if (gt_kind < 0 || gt_kind > 2 || pred_kind < 0 || pred_kind > 2 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)THREADS * UNROLL;
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  switch (gt_kind) {
    case 0:
      launch_for_pred<uint8_t>(gt, pred, pred_kind, n, part, blocks, s);
      break;
    case 1:
      launch_for_pred<int32_t>(gt, pred, pred_kind, n, part, blocks, s);
      break;
    default:
      launch_for_pred<int64_t>(gt, pred, pred_kind, n, part, blocks, s);
      break;
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  confusion_finish_kernel<<<1, THREADS, 0, s>>>(part, blocks,
                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* iswm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
