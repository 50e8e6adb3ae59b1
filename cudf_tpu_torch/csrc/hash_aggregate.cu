// Kernel A: low-cardinality groupby aggregation over int32 group codes.
//
// Replaces cudf_tpu/kernels/hash_aggregate.py onehot_groupby_aggregate
// (Pallas body _kernel, _dd_update).  The TPU kernel builds one-hot tiles
// for the MXU and carries bf16 term splits and double-float pairs because
// the TPU has neither scatter nor atomics.  Here every block keeps K bins
// in shared memory and updates them with shared atomics.  One launch
// takes up to kMaxColumns value columns of mixed kinds under one mask and
// reads the keys (and the mask) once for all of them; per bin:
//   count uint32 (widened when merged: a block sees fewer than 2^32 rows),
//   sum   an 8-byte slot a column: int64 (integer values, exact) or double,
//   min / max, for the columns that ask, as order-preserving uint64 keys
//   (common.cuh order_key); NaN is skipped, as pandas skips it, so a
//   group of only NaN keeps the identities, which the wrapper decodes to
//   NaN.
// A final pass merges each block's bins into the global outputs with
// global atomics (native REDG on sm_90a); the wrapper allocates those
// outputs zeroed (sums, counts) or at the identity (mins = all ones,
// maxs = 0).  The wrapper splits more columns than one block's shared
// memory holds at one replica over several launches, and lets only the
// first of them write the counts.
//
// What bounds it on the H100: its bound is the bytes read per row (4 key
// + 4..8 a value column + 1 validity byte when a mask is given), but what
// holds it is the SM's rate of shared-memory atomics, one or more a row
// and column (PERF.md).  What the design does:
// - One launch for all the columns under a mask: the keys and the mask
//   are read once, and a row is counted once.
// - 64-bit shared atomics are CAS loops on sm_90a (common.cuh), so
//   counts are native 32-bit increments and integer sums native 32-bit
//   adds with a carry word; float sums and min/max keep the loop.
// - Each thread issues the loads of kBatch rows (keys, mask bytes, every
//   column) before its first atomic, at 32 registers, so that four
//   512-thread blocks fit an SM: more warps hide the atomics' latency
//   better than more rows a thread (four rows a thread at 64 registers,
//   two blocks an SM, was slower).
// - At small K every thread hits the same few bins: the bins have up to
//   one replica per warp (as many as fit in kReplicaBudget), so only the
//   lanes of one warp contend.  Lanes that share a key are not combined
//   first (__match_any_sync and a shuffle reduction a key): at the main
//   path's K = 100 a warp's 32 rows hold ~27.5 distinct keys, too few
//   repeats to pay for a reduction per distinct key.
// Float sums are taken in atomic order, which varies from run to run.

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;           // 32 registers a thread: 2048 threads an SM
constexpr int kMaxReplicas = kThreads / 32;
constexpr int kBatch = 2;                 // rows a thread loads before its first atomic
constexpr int kMaxColumns = 4;            // kernels/hash_aggregate.py MAX_COLUMNS
constexpr size_t kReplicaBudget = 48 * 1024;

struct OnehotColumns {
  const void* vals[kMaxColumns];
  unsigned long long* sums[kMaxColumns];  // int64 or double [K]
  unsigned long long* mins[kMaxColumns];  // order keys [K], null: no min/max
  unsigned long long* maxs[kMaxColumns];
  int kind[kMaxColumns];
  int count;
};

// 8-byte slots a bin holds: a sum a column and two order keys a min/max column.
int slots_per_bin(const OnehotColumns& c) {
  int slots = 0;
  for (int j = 0; j < c.count; ++j) slots += c.mins[j] != nullptr ? 3 : 1;
  return slots;
}

size_t layout_bytes(int K, int slots, int replicas) {
  return static_cast<size_t>(replicas) * K * (8 * slots + 4);
}

int choose_replicas(int K, int slots) {
  const int r = static_cast<int>(kReplicaBudget / layout_bytes(K, slots, 1));
  return r < 1 ? 1 : (r > kMaxReplicas ? kMaxReplicas : r);
}

// Shared memory: plane p of R * K 8-byte slots at smem + p * R * K (a
// column's sum plane, then its min and max planes when it has them), then
// R * K uint32 counts.  Replica r of bin k is entry r * K + k of a plane.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
onehot_aggregate_kernel(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
                        long long n, int K, int replicas, OnehotColumns c,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem[];
  const int bins = replicas * K;
  int plane[kMaxColumns];                     // the sum plane; min at +1, max at +2
  int planes = 0;
#pragma unroll
  for (int j = 0; j < kMaxColumns; ++j) {
    plane[j] = planes;
    if (j < c.count) planes += c.mins[j] != nullptr ? 3 : 1;
  }
  unsigned* s_cnt = reinterpret_cast<unsigned*>(smem + planes * bins);
#pragma unroll
  for (int j = 0; j < kMaxColumns; ++j) {     // unrolled: plane[] stays in registers
    if (j >= c.count) continue;
    const bool mm = c.mins[j] != nullptr;
    for (int i = threadIdx.x; i < bins; i += blockDim.x) {
      smem[plane[j] * bins + i] = 0ull;
      if (mm) {
        smem[(plane[j] + 1) * bins + i] = ~0ull;
        smem[(plane[j] + 2) * bins + i] = 0ull;
      }
    }
  }
  for (int i = threadIdx.x; i < bins; i += blockDim.x) s_cnt[i] = 0u;
  __syncthreads();

  const int off = ((threadIdx.x >> 5) % replicas) * K;
  const long long tile = static_cast<long long>(kBatch) * blockDim.x;
  for (long long t0 = blockIdx.x * tile + threadIdx.x; t0 < n; t0 += gridDim.x * tile) {
    int key[kBatch];
    unsigned long long v[kBatch][kMaxColumns];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {        // every load of the batch first
      const long long i = t0 + u * static_cast<long long>(blockDim.x);
      key[u] = -1;
      if (i < n) {
        key[u] = __ldg(keys + i);
        if (valid != nullptr && __ldg(valid + i) == 0) key[u] = -1;
#pragma unroll
        for (int j = 0; j < kMaxColumns; ++j) {
          if (j < c.count) v[u][j] = load_bits(c.vals[j], i, c.kind[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (static_cast<unsigned>(key[u]) >= static_cast<unsigned>(K)) continue;
      const int b = off + key[u];
      atomicAdd(&s_cnt[b], 1u);
#pragma unroll
      for (int j = 0; j < kMaxColumns; ++j) {
        if (j >= c.count) continue;
        shared_add(smem + plane[j] * bins + b, v[u][j], c.kind[j]);
        if (c.mins[j] == nullptr) continue;
        unsigned long long o;
        if (is_float_kind(c.kind[j])) {
          const double f = float_value(v[u][j], c.kind[j]);
          if (f != f) continue;              // min / max skip NaN
          o = order_key(f);
        } else {
          o = order_key(int_value(v[u][j], c.kind[j]));
        }
        atomicMin(smem + (plane[j] + 1) * bins + b, o);
        atomicMax(smem + (plane[j] + 2) * bins + b, o);
      }
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    unsigned long long cnt = 0ull;
    for (int r = 0; r < replicas; ++r) cnt += s_cnt[r * K + k];
    if (cnt == 0ull) continue;
    if (counts != nullptr) atomicAdd(counts + k, cnt);
#pragma unroll
    for (int j = 0; j < kMaxColumns; ++j) {
      if (j >= c.count) continue;
      const bool fp = is_float_kind(c.kind[j]);
      const unsigned long long* p = smem + plane[j] * bins + k;
      unsigned long long s = p[0];
      for (int r = 1; r < replicas; ++r) s = slot_sum(s, p[r * K], fp);
      global_add(c.sums[j] + k, s, fp);
      if (c.mins[j] == nullptr) continue;
      unsigned long long mn = ~0ull, mx = 0ull;
      for (int r = 0; r < replicas; ++r) {
        const unsigned long long a = p[bins + r * K], z = p[2 * bins + r * K];
        mn = a < mn ? a : mn;
        mx = z > mx ? z : mx;
      }
      atomicMin(c.mins[j] + k, mn);
      atomicMax(c.maxs[j] + k, mx);
    }
  }
}

bool make_onehot_columns(OnehotColumns* c, int n_cols, const void* vals, const void* kinds,
                         const void* sums, const void* mins, const void* maxs) {
  if (n_cols < 1 || n_cols > kMaxColumns) return false;
  c->count = n_cols;
  for (int j = 0; j < n_cols; ++j) {
    c->vals[j] = static_cast<const void* const*>(vals)[j];
    c->kind[j] = static_cast<const int*>(kinds)[j];
    c->sums[j] = static_cast<unsigned long long* const*>(sums)[j];
    c->mins[j] = static_cast<unsigned long long* const*>(mins)[j];
    c->maxs[j] = static_cast<unsigned long long* const*>(maxs)[j];
    if (c->kind[j] < kInt32 || c->kind[j] > kFloat64) return false;
    if ((c->mins[j] == nullptr) != (c->maxs[j] == nullptr)) return false;
  }
  return true;
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n] group codes; valid uint8[n] or null; n_cols value columns
// given by host arrays: vals (device pointers), kinds (ValueKind), sums
// (int64 or double [K], zeroed), mins / maxs (uint64 order keys [K] at
// all ones / zero, or null for a column without min/max); counts uint64
// [K] zeroed, or null.  Returns cudaGetLastError().
extern "C" int cudf_onehot_aggregate(const void* keys, const void* valid, long long n, int K,
                                     int n_cols, const void* vals, const void* kinds,
                                     const void* sums, const void* mins, const void* maxs,
                                     void* counts, void* stream) {
  using namespace cudf_tpu_torch;
  OnehotColumns c{};
  if (K < 1 || !make_onehot_columns(&c, n_cols, vals, kinds, sums, mins, maxs)) {
    return cudaErrorInvalidValue;
  }
  const int slots = slots_per_bin(c);
  const int replicas = choose_replicas(K, slots);
  const size_t smem = layout_bytes(K, slots, replicas);
  if (smem > kMaxBlockShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(onehot_aggregate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxBlockShared));
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(onehot_aggregate_kernel, kThreads, smem,
                                 (n + kBatch - 1) / kBatch);
  onehot_aggregate_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid), n, K, replicas,
      c, static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

// Kernel A's registers, resident blocks per SM, threads, dynamic shared
// memory (bytes) and bin replicas at K groups and `slots` 8-byte slots a
// bin (a column's sum: 1, with min/max: 3) on the current device.
extern "C" int cudf_onehot_aggregate_occupancy(int K, int slots, int* registers,
                                               int* blocks_per_sm, int* threads,
                                               int* smem_bytes, int* replicas, void* stream) {
  using namespace cudf_tpu_torch;
  (void)stream;
  if (K < 1 || slots < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(onehot_aggregate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxBlockShared));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, onehot_aggregate_kernel);
  if (err != cudaSuccess) return err;
  *replicas = choose_replicas(K, slots);
  const size_t smem = layout_bytes(K, slots, *replicas);
  if (smem > kMaxBlockShared) return cudaErrorInvalidValue;
  *threads = kThreads;
  *smem_bytes = static_cast<int>(smem);
  *registers = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, onehot_aggregate_kernel,
                                                       kThreads, smem);
}
