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
// D  bucket_aggregate  replaces radix_partition.py bucket_aggregate in all
//    four modes (Pallas body _agg_kernel, _dd_block_update): float and
//    int, and the join build's id and idpay, which are int sums of
//    build_row_id + 1 and of a payload's bits.  One launch sums up to
//    kMaxAggColumns value columns of mixed kinds and counts the rows once
//    (idpay is one launch of id + payload).  Bound: the key and every
//    value read once per row, and every output slot written once.  What
//    holds it on the card is the SM's rate of shared-memory atomics, a
//    count and one or more a column per row (PERF.md): the design keeps
//    to those, native 32-bit ones wherever it can.
//    - Blocks walk (window, row-chunk) steps from a step table, so a
//      skewed window spreads over many blocks.  A block keeps one window
//      of 8192 bins in shared memory: uint32 counts (a step holds fewer
//      than 2^32 rows) and an 8-byte slot per column and key.  At three
//      columns that is 28 B x 8192 = 229,376 B, one block an SM; four do
//      not fit, so the wrapper splits more columns over launches of at
//      most three (the later ones count nothing).  Splitting a window's
//      key span in two halves instead would read every row twice.
//    - 64-bit shared atomics are CAS loops on sm_90a (common.cuh), so
//      integer slots take native 32-bit adds with a carry word; only
//      float sums keep the loop.  Counts are native 32-bit increments.
//    - Each thread issues the loads of kAggBatch rows, key and values,
//      before its first atomic; loads do not wait on the keys.
//    - A window that one step covers whole is owned by its block: the
//      block stores all of its slots, zeros included, with plain
//      coalesced stores, so the outputs are allocated empty.  The slots of
//      every other window (empty windows, which have no step, and windows
//      of more than agg_rows rows) are zeroed first by zero_windows_kernel
//      on the same stream, and their steps add their non-empty bins with
//      global atomics (native REDG for int64 and double).  chip_smoke.py
//      times G1 q5 also at one step a window (no global atomics, one
//      block a window): the combine costs little there, and steps of
//      agg_rows rows keep a skewed window spread over many blocks.
//    - Order is free: the sorted route's runs, kernel C's shuffled ones
//      and an unpartitioned single window give the same sums.  Float sums
//      are taken in atomic order, which varies from run to run (rtol
//      1e-12 against the plain version).

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kHistThreads = 512;
constexpr int kScatterThreads = 512;
constexpr int kAggThreads = 1024;   // 512 when two blocks fit in an SM's shared memory
constexpr int kAggBatch = 4;        // rows a thread loads before its first atomic
constexpr int kMaxAggColumns = 3;   // kernels/radix_partition.py MAX_AGG_COLUMNS
constexpr int kZeroThreads = 256;
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

// Up to kMaxAggColumns value columns summed in one kernel D launch.
struct AggColumns {
  const void* vals[kMaxAggColumns];
  unsigned long long* sums[kMaxAggColumns];  // int64 or double [G * kSpan]
  int kind[kMaxAggColumns];
  int count;
};

__host__ __device__ constexpr size_t agg_smem_bytes(int columns) {
  return static_cast<size_t>(kSpan) * (8 * columns + 4);
}

// Zeroes every slot of each window that no single step owns: empty
// windows and windows of more than agg_rows rows (kernel D adds into
// those with atomics).  One block a window, 16-byte stores.
__global__ void __launch_bounds__(kZeroThreads)
zero_windows_kernel(const long long* __restrict__ base, long long agg_rows, AggColumns c,
                    unsigned long long* __restrict__ counts) {
  const long long rows = base[blockIdx.x + 1] - base[blockIdx.x];
  if (rows > 0 && rows <= agg_rows) return;
  const long long first = static_cast<long long>(blockIdx.x) << kWindowBits;
  const ulonglong2 z = make_ulonglong2(0ull, 0ull);
  for (int b = threadIdx.x; b < kSpan / 2; b += blockDim.x) {
    if (counts != nullptr) reinterpret_cast<ulonglong2*>(counts + first)[b] = z;
#pragma unroll
    for (int j = 0; j < kMaxAggColumns; ++j) {
      if (j < c.count) reinterpret_cast<ulonglong2*>(c.sums[j] + first)[b] = z;
    }
  }
}

__global__ void __launch_bounds__(kAggThreads)
bucket_aggregate_kernel(const int32_t* __restrict__ keys, AggColumns c,
                        const int32_t* __restrict__ step_win,
                        const long long* __restrict__ step_lo,
                        const long long* __restrict__ step_hi,
                        const long long* __restrict__ base,
                        unsigned long long* __restrict__ counts) {
  const int g = step_win[blockIdx.x];
  if (g < 0) return;  // an idle step of the upper-bound grid
  extern __shared__ __align__(16) unsigned long long smem[];  // c.count x kSpan slots, then kSpan counts
  unsigned* s_cnt = reinterpret_cast<unsigned*>(smem + c.count * kSpan);
  uint4* words = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < static_cast<int>(agg_smem_bytes(c.count) / 16); i += blockDim.x) {
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const long long first = static_cast<long long>(g) << kWindowBits;
  const long long lo = step_lo[blockIdx.x], hi = step_hi[blockIdx.x];
  const long long stride = blockDim.x;
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += kAggBatch * stride) {
    int local[kAggBatch];
    unsigned long long v[kAggBatch][kMaxAggColumns];
#pragma unroll
    for (int u = 0; u < kAggBatch; ++u) {  // every load of the batch first
      const long long i = i0 + u * stride;
      local[u] = -1;
      if (i < hi) {
        local[u] = __ldg(keys + i);
#pragma unroll
        for (int j = 0; j < kMaxAggColumns; ++j) {
          if (j < c.count) v[u][j] = load_bits(c.vals[j], i, c.kind[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAggBatch; ++u) {
      const long long k = static_cast<long long>(local[u]) - first;
      if (i0 + u * stride >= hi || k < 0 || k >= kSpan) continue;
      atomicAdd(&s_cnt[k], 1u);
#pragma unroll
      for (int j = 0; j < kMaxAggColumns; ++j) {
        if (j < c.count) shared_add(smem + j * kSpan + k, v[u][j], c.kind[j]);
      }
    }
  }
  __syncthreads();

  const bool owner = lo == base[g] && hi == base[g + 1];  // this step is the whole window
  for (int b = threadIdx.x; b < kSpan; b += blockDim.x) {
    const unsigned n = s_cnt[b];
    if (owner) {
      if (counts != nullptr) counts[first + b] = n;
#pragma unroll
      for (int j = 0; j < kMaxAggColumns; ++j) {   // unrolled: c stays in the parameter bank
        if (j < c.count) c.sums[j][first + b] = smem[j * kSpan + b];
      }
    } else if (n != 0u) {
      if (counts != nullptr) atomicAdd(counts + first + b, static_cast<unsigned long long>(n));
#pragma unroll
      for (int j = 0; j < kMaxAggColumns; ++j) {
        if (j < c.count) {
          global_add(c.sums[j] + first + b, smem[j * kSpan + b], is_float_kind(c.kind[j]));
        }
      }
    }
  }
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
// step_hi[s]) of keys and the n_cols (1..3) value columns, whose device
// pointers and value kinds are the host arrays vals and kinds; the steps
// cut each window base[g]..base[g+1] into chunks of agg_rows.  sums: a
// host array of n_cols int64 or double [G * 8192] outputs, counts uint64
// [G * 8192] or null; the launch writes every slot of them (zeroes the
// windows no step owns, then aggregates).
extern "C" int cudf_bucket_aggregate(const void* keys, int n_cols, const void* vals,
                                     const void* kinds, const void* step_win,
                                     const void* step_lo, const void* step_hi, long long steps,
                                     const void* base, int num_windows, long long agg_rows,
                                     const void* sums, void* counts, void* stream) {
  using namespace cudf_tpu_torch;
  if (n_cols < 1 || n_cols > kMaxAggColumns || num_windows < 1 || agg_rows < 1) {
    return cudaErrorInvalidValue;
  }
  AggColumns c{};
  c.count = n_cols;
  for (int j = 0; j < n_cols; ++j) {
    c.vals[j] = static_cast<const void* const*>(vals)[j];
    c.sums[j] = static_cast<unsigned long long* const*>(sums)[j];
    c.kind[j] = static_cast<const int*>(kinds)[j];
    if (c.kind[j] < kInt32 || c.kind[j] > kFloat64) return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(counts);
  const auto* b = static_cast<const long long*>(base);
  zero_windows_kernel<<<static_cast<unsigned>(num_windows), kZeroThreads, 0, s>>>(
      b, agg_rows, c, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = agg_smem_bytes(n_cols);
  err = cudaFuncSetAttribute(bucket_aggregate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(agg_smem_bytes(kMaxAggColumns)));
  if (err != cudaSuccess) return err;
  const int threads = 2 * smem <= kMaxBlockShared ? kAggThreads / 2 : kAggThreads;
  bucket_aggregate_kernel<<<static_cast<unsigned>(steps), threads, smem, s>>>(
      static_cast<const int32_t*>(keys), c, static_cast<const int32_t*>(step_win),
      static_cast<const long long*>(step_lo), static_cast<const long long*>(step_hi), b, cnt);
  return cudaGetLastError();
}

// Kernel D's registers, resident blocks per SM, threads and dynamic shared
// memory (bytes) at n_cols value columns on the current device.
extern "C" int cudf_bucket_aggregate_occupancy(int n_cols, int* registers, int* blocks_per_sm,
                                               int* threads, int* smem_bytes, void* stream) {
  using namespace cudf_tpu_torch;
  (void)stream;
  if (n_cols < 1 || n_cols > kMaxAggColumns) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bucket_aggregate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(agg_smem_bytes(kMaxAggColumns)));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, bucket_aggregate_kernel);
  if (err != cudaSuccess) return err;
  const size_t smem = agg_smem_bytes(n_cols);
  *threads = 2 * smem <= kMaxBlockShared ? kAggThreads / 2 : kAggThreads;
  *smem_bytes = static_cast<int>(smem);
  *registers = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bucket_aggregate_kernel,
                                                       *threads, smem);
}

extern "C" const char* cudf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
