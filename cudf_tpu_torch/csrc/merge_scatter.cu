// Kernel G: merge and scatter of the sorted partition route, driven by
// kernels/radix_partition.py.
//
// G  merge_scatter  replaces cudf_tpu/kernels/radix_partition.py
//    merge_scatter (Pallas body _merge_partition_kernel, DMAs
//    _scatter_runs, prefill _scatter_init).  Input: kernel F's output
//    with alternate set, i.e. every tile of `tile` keys sorted by
//    sort_key, odd tiles descending.  A supertile of super_tile =
//    merge_tiles * tile rows becomes one stably sorted sequence (ties by
//    tile, then position), and each (supertile, bucket) run of it is
//    written at offsets[supertile, bucket]: the same partition as kernel
//    C, with every run sorted.  Negative keys are dropped.
//
//    The reference merges with bitonic-merge stages in VMEM (it cannot
//    compile a full supertile sort) and ships each run as 128-lane rows
//    that cover it: chunked DMAs with a three-tier cascade, SENTINEL
//    prefill, and neighbouring buckets' keys as run-edge garbage.  None
//    of that has a counterpart here: Hopper writes single elements, so
//    runs are exact.  One block per supertile loads its order keys into
//    shared memory, each tile ascending (a descending tile read
//    backwards), and ranks every element in the merged order: its
//    position in its own tile plus, in each other tile, the count of keys
//    before it (upper_bound for earlier tiles, lower_bound for later
//    ones), by binary search in shared memory.  The rank-to-input map is
//    staged in shared memory, each bucket's first rank found by searching
//    the bucket's least order key in every tile, and the block then walks
//    the ranks in order: consecutive ranks of a bucket go to consecutive
//    output slots, so the writes of each run are coalesced, and the reads
//    come from merge_tiles ascending streams.  Bound: bytes, each column
//    read once and written once, plus the offsets; the binary searches
//    (log2(tile) steps per other tile and element) are shared-memory work
//    beyond that.  The bucket of a key must be the top bits of its order
//    key, as it is for keys below 2^(shift + nbits) or under a mask of
//    shift + nbits bits; a row that breaks this is not written.

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kMergeThreads = 512;
constexpr int kMaxSuperTile = 16384;
constexpr int kMaxMergeBits = 10;

// count of s[0..len) below x (lower_bound) or at most x (upper_bound)
__device__ __forceinline__ int count_below(const unsigned* s, int len, unsigned long long x,
                                           bool or_equal) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long v = s[mid];
    if (v < x || (or_equal && v == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void copy_column(const Columns& c, int col, long long from,
                                            long long to) {
  if (c.width[col] == 8) {
    static_cast<unsigned long long*>(c.dst[col])[to] =
        static_cast<const unsigned long long*>(c.src[col])[from];
  } else {
    static_cast<unsigned*>(c.dst[col])[to] = static_cast<const unsigned*>(c.src[col])[from];
  }
}

__global__ void __launch_bounds__(kMergeThreads)
merge_scatter_kernel(long long n, int shift, int nbits, int super_tile, int tile,
                     int mask_bits, const int32_t* __restrict__ offsets, long long out_rows,
                     Columns c) {
  extern __shared__ unsigned smem[];
  const int B = 1 << nbits;
  unsigned* s_key = smem;                                               // [super_tile]
  unsigned short* s_src = reinterpret_cast<unsigned short*>(s_key + super_tile);
  int* s_start = reinterpret_cast<int*>(s_key + super_tile + (super_tile + 1) / 2);  // [B + 1]
  int* s_delta = s_start + B + 1;                                       // [B]

  const long long start = static_cast<long long>(blockIdx.x) * super_tile;
  const int len = static_cast<int>(n - start < super_tile ? n - start : super_tile);
  const int n_tiles = (len + tile - 1) / tile;
  const long long first_tile = start / tile;     // odd global tiles descend
  const int32_t* keys = static_cast<const int32_t*>(c.src[0]) + start;

  // 1. order keys, each tile ascending
  for (int i = threadIdx.x; i < len; i += kMergeThreads) {
    const int t = i / tile, t0 = t * tile;
    const int tlen = len - t0 < tile ? len - t0 : tile;
    const int q = ((first_tile + t) & 1) ? t0 + tlen - 1 - (i - t0) : i;
    s_key[q] = sort_key(keys[i], mask_bits);
  }
  __syncthreads();

  // 2. rank of each element in the merged supertile -> its input position
  for (int e = threadIdx.x; e < len; e += kMergeThreads) {
    const unsigned u = s_key[e];
    const int a = e / tile, a0 = a * tile;
    int rank = e - a0;
    for (int b = 0; b < n_tiles; ++b) {
      if (b == a) continue;
      const int b0 = b * tile;
      const int blen = len - b0 < tile ? len - b0 : tile;
      rank += count_below(s_key + b0, blen, u, b < a);
    }
    const int alen = len - a0 < tile ? len - a0 : tile;
    const int src = ((first_tile + a) & 1) ? a0 + alen - 1 - (e - a0) : e;
    s_src[rank] = static_cast<unsigned short>(src);
  }

  // 3. each bucket's first rank: the count of order keys below its least
  for (int d = threadIdx.x; d <= B; d += kMergeThreads) {
    const unsigned long long least =
        mask_bits == 0 ? 0x80000000ull + (static_cast<unsigned long long>(d) << shift)
                       : (static_cast<unsigned long long>(d) << shift) + 1ull;
    int below = 0;
    for (int b = 0; b < n_tiles; ++b) {
      const int b0 = b * tile;
      below += count_below(s_key + b0, len - b0 < tile ? len - b0 : tile, least, false);
    }
    s_start[d] = below;
    if (d < B) {
      s_delta[d] = offsets[static_cast<long long>(blockIdx.x) * B + d];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < B; d += kMergeThreads) s_delta[d] -= s_start[d];
  __syncthreads();

  // 4. walk the ranks of non-negative keys: each run is written in order
  const int r_end = s_start[B];
  for (int r = s_start[0] + threadIdx.x; r < r_end; r += kMergeThreads) {
    const int src = s_src[r];
    const int key = keys[src];
    const int d = (key >> shift) & (B - 1);
    if (key < 0 || r < s_start[d] || r >= s_start[d + 1]) continue;
    const long long to = static_cast<long long>(s_delta[d]) + r;
    if (to < 0 || to >= out_rows) continue;
    static_cast<int32_t*>(c.dst[0])[to] = key;
    for (int col = 1; col < c.count; ++col) copy_column(c, col, start + src, to);
  }
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n]: tile_sort's output with alternate set.  offsets
// int32[ceil(n / super_tile), 2^nbits]: the first output slot of each
// (supertile, bucket) run.  out_keys and the payloads' dst hold out_rows
// rows; rows no run covers are left as they are.  src / dst / widths as
// for cudf_tile_sort.
extern "C" int cudf_merge_scatter(const void* keys, long long n, int shift, int nbits,
                                  int super_tile, int tile, int mask_bits, const void* offsets,
                                  void* out_keys, long long out_rows, int n_payloads,
                                  const void* src, const void* dst, const void* widths,
                                  void* stream) {
  using namespace cudf_tpu_torch;
  Columns c{};
  if (!make_columns(&c, keys, out_keys, n_payloads, src, dst, widths)) {
    return cudaErrorInvalidValue;
  }
  if (nbits < 1 || nbits > kMaxMergeBits || tile < 1 || super_tile < tile ||
      super_tile % tile != 0 || super_tile > kMaxSuperTile || mask_bits < 0 ||
      mask_bits > 30 || shift < 0 || shift + nbits > 31) {
    return cudaErrorInvalidValue;
  }
  const int B = 1 << nbits;
  const size_t smem = sizeof(unsigned) * (super_tile + (super_tile + 1) / 2) +
                      sizeof(int) * (2 * B + 1);
  cudaError_t err = cudaFuncSetAttribute(
      merge_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + super_tile - 1) / super_tile;
  merge_scatter_kernel<<<static_cast<unsigned>(blocks), kMergeThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      n, shift, nbits, super_tile, tile, mask_bits, static_cast<const int32_t*>(offsets),
      out_rows, c);
  return cudaGetLastError();
}
