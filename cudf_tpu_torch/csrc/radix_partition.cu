// Kernels B, C and D: the radix-partition groupby tier for large key
// domains (up to 2^27 keys), driven by kernels/radix_partition.py.
//
// B  digit_histogram   replaces cudf_tpu/kernels/radix_partition.py
//    digit_histogram (Pallas body _hist_kernel).  One block per tile of
//    `tile` keys counts the digit (key >> shift) & (2^nbits - 1) into a
//    shared-memory histogram; negative keys are left out.  Bound: the
//    4-byte key read per row; with B = 128 buckets shared-atomic
//    contention is low, and the block writes its B counts once.
//
// C  radix_scatter     replaces radix_partition.py radix_scatter (Pallas
//    body _partition_kernel with an in-kernel bitonic sort and the
//    covering-row DMAs of _scatter_runs), the reference's merge_tiles = 1
//    route; the main path takes its merge_tiles = 4 route, kernels F and
//    G (csrc/tile_sort.cu, csrc/merge_scatter.cu).  Hopper scatters single
//    elements, so no sort is needed: each block re-derives its tile's
//    digits and takes each element's output slot from a shared cursor
//    per bucket, seeded with the exclusive scan of the histogram over
//    (bucket, tile).  The partition is exact: no SENTINEL fill, no
//    run-edge garbage, and the valid rows are the first sum(hist) of the
//    output.  ORDER INSIDE A (tile, bucket) RUN IS UNSPECIFIED: slots go
//    in shared-atomic order.  Bound: bytes moved per row (read and write
//    the key and every payload); writes land in runs of about
//    tile / B elements, so larger tiles coalesce better.
//
// D  bucket_aggregate  replaces radix_partition.py bucket_aggregate in its
//    `float` and `int` modes (Pallas body _agg_kernel, _dd_block_update).
//    Blocks walk (window, row-chunk) steps from a step table, so a skewed
//    window spreads over many blocks.  Each block keeps one window of
//    8192 bins in shared memory (int64 or double sums, uint32 counts —
//    a step holds fewer than 2^32 rows — 96 KB, two blocks per SM) and
//    merges its non-empty bins into the global sums / counts with
//    atomics.  The wrapper zeroes those outputs up front, which replaces
//    zero_empty_windows.  Bound: the key and value read per row; the
//    per-step zero-and-merge of 8192 bins is amortised over agg_rows rows.

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kHistThreads = 512;
constexpr int kScatterThreads = 512;
constexpr int kAggThreads = 1024;
constexpr int kWindowBits = 13;
constexpr int kSpan = 1 << kWindowBits;

__global__ void __launch_bounds__(kHistThreads)
digit_histogram_kernel(const int32_t* __restrict__ keys, long long n, int shift,
                       int nbits, long long tile, int32_t* __restrict__ hist) {
  extern __shared__ unsigned int s_hist[];
  const int B = 1 << nbits;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_hist[b] = 0u;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = start + tile < n ? start + tile : n;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int k = keys[i];
    if (k < 0) continue;
    atomicAdd(&s_hist[(k >> shift) & (B - 1)], 1u);
  }
  __syncthreads();
  int32_t* row = hist + static_cast<long long>(blockIdx.x) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) row[b] = static_cast<int32_t>(s_hist[b]);
}

// Columns: the keys at 0, the payloads after them (common.cuh).
__global__ void __launch_bounds__(kScatterThreads)
radix_scatter_kernel(long long n, int shift, int nbits, long long tile,
                     const int32_t* __restrict__ offsets, Columns c) {
  extern __shared__ unsigned int s_cursor[];
  const int B = 1 << nbits;
  const int32_t* row = offsets + static_cast<long long>(blockIdx.x) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_cursor[b] = static_cast<unsigned>(row[b]);
  __syncthreads();
  const int32_t* keys = static_cast<const int32_t*>(c.src[0]);
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = start + tile < n ? start + tile : n;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int k = keys[i];
    if (k < 0) continue;
    const unsigned pos = atomicAdd(&s_cursor[(k >> shift) & (B - 1)], 1u);
    static_cast<int32_t*>(c.dst[0])[pos] = k;
    for (int j = 1; j < c.count; ++j) {
      if (c.width[j] == 8) {
        static_cast<unsigned long long*>(c.dst[j])[pos] =
            static_cast<const unsigned long long*>(c.src[j])[i];
      } else {
        static_cast<unsigned int*>(c.dst[j])[pos] =
            static_cast<const unsigned int*>(c.src[j])[i];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
bucket_aggregate_kernel(const int32_t* __restrict__ keys, const T* __restrict__ vals,
                        const int32_t* __restrict__ step_win,
                        const long long* __restrict__ step_lo,
                        const long long* __restrict__ step_hi,
                        typename Accum<T>::type* __restrict__ sums,
                        unsigned long long* __restrict__ counts) {
  using S = typename Accum<T>::type;
  const int g = step_win[blockIdx.x];
  if (g < 0) return;  // an idle step of the upper-bound grid
  extern __shared__ unsigned long long smem[];
  S* s_sum = reinterpret_cast<S*>(smem);
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(smem + kSpan);
  for (int b = threadIdx.x; b < kSpan; b += blockDim.x) {
    s_sum[b] = S(0);
    s_cnt[b] = 0u;
  }
  __syncthreads();
  const long long base = static_cast<long long>(g) << kWindowBits;
  const long long hi = step_hi[blockIdx.x];
  for (long long i = step_lo[blockIdx.x] + threadIdx.x; i < hi; i += blockDim.x) {
    const long long local = static_cast<long long>(keys[i]) - base;
    if (local < 0 || local >= kSpan) continue;
    atomic_add(&s_sum[local], static_cast<S>(vals[i]));
    atomicAdd(&s_cnt[local], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kSpan; b += blockDim.x) {
    const unsigned int c = s_cnt[b];
    if (c == 0u) continue;
    atomic_add(&sums[base + b], s_sum[b]);
    if (counts != nullptr) atomicAdd(&counts[base + b], static_cast<unsigned long long>(c));
  }
}

template <typename T>
cudaError_t launch_aggregate(const int32_t* keys, const void* vals, const int32_t* win,
                             const long long* lo, const long long* hi, long long steps,
                             void* sums, void* counts, cudaStream_t stream) {
  const size_t smem = kSpan * (sizeof(unsigned long long) + sizeof(unsigned int));
  auto kernel = bucket_aggregate_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(steps), kAggThreads, smem, stream>>>(
      keys, static_cast<const T*>(vals), win, lo, hi,
      static_cast<typename Accum<T>::type*>(sums),
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n]; hist int32[ceil(n / tile), 2^nbits].
extern "C" int cudf_digit_histogram(const void* keys, long long n, int shift, int nbits,
                                    long long tile, void* hist, void* stream) {
  using namespace cudf_tpu_torch;
  const size_t smem = sizeof(unsigned int) << nbits;
  cudaError_t err = cudaFuncSetAttribute(
      digit_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n + tile - 1) / tile;
  digit_histogram_kernel<<<static_cast<unsigned>(tiles), kHistThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, shift, nbits, tile,
      static_cast<int32_t*>(hist));
  return cudaGetLastError();
}

// offsets int32[ceil(n / tile), 2^nbits] output slot of each (tile,
// bucket) run; src / dst / widths are host arrays of n_payloads (<= 4)
// device pointers and element widths (4 or 8 bytes).
extern "C" int cudf_radix_scatter(const void* keys, long long n, int shift, int nbits,
                                  long long tile, const void* offsets, void* out_keys,
                                  int n_payloads, const void* src, const void* dst,
                                  const void* widths, void* stream) {
  using namespace cudf_tpu_torch;
  Columns c{};
  if (!make_columns(&c, keys, out_keys, n_payloads, src, dst, widths)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(unsigned int) << nbits;
  cudaError_t err = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n + tile - 1) / tile;
  radix_scatter_kernel<<<static_cast<unsigned>(tiles), kScatterThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      n, shift, nbits, tile, static_cast<const int32_t*>(offsets), c);
  return cudaGetLastError();
}

// Per step s: window step_win[s] (-1: idle) over rows [step_lo[s],
// step_hi[s]) of keys / vals.  sums[G * 8192] int64 or double, counts
// uint64 or null, both zeroed by the caller.
extern "C" int cudf_bucket_aggregate(const void* keys, const void* vals, int value_kind,
                                     const void* step_win, const void* step_lo,
                                     const void* step_hi, long long steps, void* sums,
                                     void* counts, void* stream) {
  using namespace cudf_tpu_torch;
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(step_win);
  const auto* lo = static_cast<const long long*>(step_lo);
  const auto* hi = static_cast<const long long*>(step_hi);
  auto s = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case kInt32: return launch_aggregate<int32_t>(k, vals, w, lo, hi, steps, sums, counts, s);
    case kInt64: return launch_aggregate<long long>(k, vals, w, lo, hi, steps, sums, counts, s);
    case kFloat32: return launch_aggregate<float>(k, vals, w, lo, hi, steps, sums, counts, s);
    case kFloat64: return launch_aggregate<double>(k, vals, w, lo, hi, steps, sums, counts, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cudf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
