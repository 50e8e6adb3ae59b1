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
//    runs are exact.
//
//    Bound: bytes, each column read once and written once, plus the
//    offsets.  The merge is shared-memory work on top; the design keeps
//    it short and every device-memory store coalesced:
//    1. Load: one block per supertile copies its keys into shared memory
//       by cp.async (s_key, input order; no registers held) and writes
//       s_idx, the input position of each element with every tile
//       ascending (a descending tile read backwards).
//    2. Merge path: log2(super_tile / tile) levels of stable 2-way
//       merges of neighbouring runs of s_idx (tiles 0+1 and 2+3, then the
//       two halves).  Each thread owns kItems consecutive output ranks of
//       a level, finds where they start in the two runs with one co-rank
//       (diagonal) search, and merges them with both heads in registers
//       (ties to the lower run: the lower tile, then the lower position).
//       A step is the same for every lane (take a head, load the next
//       element of the side taken), so a warp never runs both sides'
//       loads; the outputs wait in registers until every thread has read
//       the level, and kItems is odd, so a warp's threads hit distinct
//       shared-memory banks.
//    3. Run starts from the merged order: the bucket is the top bits of
//       the order key (keys below 2^(shift + nbits), or mask_bits =
//       shift + nbits), so a bucket's run starts where its bucket differs
//       from the previous rank's; negative keys sort first and are
//       dropped.  The last level finds them as it merges: one comparison
//       a rank turns s_delta[b] from offsets[supertile, b] into offsets -
//       the first rank.
//    4. Write: consecutive ranks on consecutive threads, so a warp stores
//       consecutive slots of a run; keys come from s_key, and each row's
//       payloads are read from its input position (merge_tiles ascending
//       streams), kLoads loads a thread in flight, one loop per column
//       width.  Stores by input position instead (coalesced reads,
//       scattered stores) wrote partial sectors and cost twice as much.
//    A row that breaks the top-bits condition is not checked for: its
//    slot is wrong but stays inside out_rows.  Shared memory: 6 bytes a
//    row plus 4 a bucket (97 KB at 16384 rows and 2^7 buckets), so two
//    512-thread blocks fit on an SM and one block's merge overlaps the
//    other's loads and stores.
//
//    With fill set (a first pass's out_rows), a small kernel first writes
//    key -1 and zero payloads over each bucket's region from the last
//    supertile's run to the next region's start, and from the last
//    region's run to out_rows (a launch of its own over the whole grid,
//    since it holds every row past the last region): every row no run
//    covers in a single-region layout (partition_offsets without
//    region_of_tile), plus the last supertile's runs, which G then
//    overwrites.  The outputs need no full-size prefill.

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kMergeThreads = 512;
// Output ranks a thread owns in each merge level.  Odd, so that the
// threads of a warp, kItems ranks apart, fall into distinct shared-memory
// banks (32 or 16 apart, they fell into 2 to 4).
constexpr int kItems = 33;
// Column loads in flight a thread.  4: at 8 or 16 the write phase's
// registers spill past the 64 that two 512-thread blocks an SM leave.
constexpr int kLoads = 4;
constexpr int kMaxSuperTile = 16384;          // s_idx holds 16-bit positions
static_assert(kMergeThreads * kItems >= kMaxSuperTile, "a block covers a supertile");
constexpr int kMaxMergeBits = 10;
constexpr int kFillThreads = 256;
constexpr int kFillBlocksPerBucket = 4;

__device__ __forceinline__ int min_int(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int max_int(int a, int b) { return a > b ? a : b; }

// Two neighbouring runs of width w that one merge level joins: A is
// [a0, a0 + la), B is [a0 + la, a0 + la + lb) (empty for a lone last run).
struct Pair {
  int a0, la, lb;
  __device__ __forceinline__ Pair(int r, int w, int len) {
    a0 = r / (2 * w) * (2 * w);
    la = min_int(w, len - a0);
    lb = max_int(0, min_int(w, len - a0 - la));
  }
};

// Where the supertile's runs start (step 3 of the note): s_delta[b] holds
// offsets[supertile, b] and becomes offsets - the first rank of bucket b.
struct RunStarts {
  int* s_delta;
  int shift, bmask;
  // rank r holds key, the rank before it prev (negative: none, or dropped)
  __device__ __forceinline__ void see(int prev, int key, int r) const {
    if (key >= 0 && (prev < 0 || ((prev ^ key) >> shift) & bmask)) {
      s_delta[(key >> shift) & bmask] -= r;
    }
  }
  // the output slot of rank r's key, -1 for none
  __device__ __forceinline__ int slot(int key, int r, long long out_rows) const {
    if (key < 0) return -1;
    const long long to = static_cast<long long>(s_delta[(key >> shift) & bmask]) + r;
    return to >= 0 && to < out_rows ? static_cast<int>(to) : -1;
  }
};

// One level of stable 2-way merges of runs of width w in s_idx, in place:
// each thread's outputs wait in registers (16 bits each) until every
// thread has read the level.  The last level (one pair, or one run to copy
// when w >= len) also finds the run starts from the keys it merges.
template <bool kLast>
__device__ __forceinline__ void merge_level(const int* s_key, unsigned short* s_idx, int len,
                                            int w, int mask_bits, const RunStarts& runs) {
  const int r0 = threadIdx.x * kItems;
  unsigned packed[(kItems + 1) / 2];
#pragma unroll
  for (int k = 0; k < (kItems + 1) / 2; ++k) packed[k] = 0;
  if (r0 < len) {
    Pair p(r0, w, len);
    int b0 = p.a0 + p.la;
    // co-rank: how many of the first d merged elements come from A
    const int d = r0 - p.a0;
    int lo = max_int(0, d - p.lb), hi = min_int(d, p.la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const unsigned ka = sort_key(s_key[s_idx[p.a0 + mid]], mask_bits);
      const unsigned kb = sort_key(s_key[s_idx[b0 + d - 1 - mid]], mask_bits);
      if (ka <= kb) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = d - lo;
    int end = p.a0 + p.la + p.lb;
    // heads: position, original key and order key of A's and B's next element
    unsigned ia = 0, ib = 0, ka = 0, kb = 0;
    int xa = 0, xb = 0;
    if (i < p.la) { ia = s_idx[p.a0 + i]; xa = s_key[ia]; ka = sort_key(xa, mask_bits); }
    if (j < p.lb) { ib = s_idx[b0 + j]; xb = s_key[ib]; kb = sort_key(xb, mask_bits); }
    int prev = -1;                          // the key of rank r0 - 1 (last level only)
    if (kLast && d > 0) {
      const int pa = i > 0 ? s_key[s_idx[p.a0 + i - 1]] : 0;
      const int pb = j > 0 ? s_key[s_idx[b0 + j - 1]] : 0;
      // B's element came last unless A's sorts after it
      prev = j == 0 || (i > 0 && sort_key(pa, mask_bits) > sort_key(pb, mask_bits)) ? pa : pb;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = r0 + k;
      if (r < len) {
        if (!kLast && r == end) {           // the chunk runs into the next pair
          p = Pair(r, w, len);
          b0 = p.a0 + p.la;
          end = p.a0 + p.la + p.lb;
          i = j = 0;
          ia = s_idx[p.a0];
          ka = sort_key(s_key[ia], mask_bits);
          if (p.lb > 0) { ib = s_idx[b0]; kb = sort_key(s_key[ib], mask_bits); }
        }
        // one step, the same for every lane: take A's head or B's, then
        // load the next element of the side taken
        const bool take_a = i < p.la && (j >= p.lb || ka <= kb);
        const unsigned v = take_a ? ia : ib;
        const int x = take_a ? xa : xb;
        i += take_a;
        j += !take_a;
        const int next = take_a ? p.a0 + i : b0 + j;
        if (take_a ? i < p.la : j < p.lb) {
          const unsigned in = s_idx[next];
          const int xn = s_key[in];
          const unsigned kn = sort_key(xn, mask_bits);
          if (take_a) { ia = in; xa = xn; ka = kn; } else { ib = in; xb = xn; kb = kn; }
        }
        if (kLast) {
          runs.see(prev, x, r);
          prev = x;
        }
        packed[k / 2] |= v << (16 * (k & 1));
      }
    }
  }
  __syncthreads();                          // every thread has read this level
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = r0 + k;
    if (r < len) {
      s_idx[r] = static_cast<unsigned short>(packed[k / 2] >> (16 * (k & 1)));
    }
  }
  __syncthreads();
}

// cp.async copies of 4 or 16 bytes from device to shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}

// One batch of a payload column in merged order: every row of the batch
// is loaded (from its input position) before any is stored (at its slot),
// so kLoads loads are in flight a thread.  to[k] < 0: nothing to write.
template <typename T>
__device__ __forceinline__ void copy_batch(const T* __restrict__ src, T* __restrict__ dst,
                                           const int (&s)[kLoads], const int (&to)[kLoads]) {
  T v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (to[k] >= 0) v[k] = src[s[k]];
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (to[k] >= 0) dst[to[k]] = v[k];
  }
}

__global__ void __launch_bounds__(kMergeThreads, 2)
merge_scatter_kernel(long long n, int shift, int nbits, int super_tile, int tile,
                     int mask_bits, const int32_t* __restrict__ offsets, long long out_rows,
                     Columns c) {
  extern __shared__ __align__(16) int smem[];
  const int B = 1 << nbits;
  int* s_key = smem;                                                      // [super_tile]
  unsigned short* s_idx = reinterpret_cast<unsigned short*>(s_key + super_tile);
  int* s_delta = s_key + super_tile + (super_tile + 1) / 2;               // [B]

  const long long start = static_cast<long long>(blockIdx.x) * super_tile;
  const int len = static_cast<int>(n - start < super_tile ? n - start : super_tile);
  const long long first_tile = start / tile;     // odd global tiles descend
  const int32_t* keys = static_cast<const int32_t*>(c.src[0]) + start;

  // 1. keys in input order by cp.async; s_idx: input positions, each tile
  //    ascending; the offsets row
  int i = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    for (; 4 * i + 3 < len; i += blockDim.x) cp_async16(s_key + 4 * i, keys + 4 * i);
    i = (len & ~3) + threadIdx.x;
  }
  for (; i < len; i += blockDim.x) cp_async4(s_key + i, keys + i);
  asm volatile("cp.async.commit_group;\n");
  for (int d = threadIdx.x; d < B; d += blockDim.x) {
    s_delta[d] = offsets[static_cast<long long>(blockIdx.x) * B + d];
  }
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const int t0 = p / tile * tile;
    const int tlen = min_int(tile, len - t0);
    const int src = ((first_tile + p / tile) & 1) ? t0 + tlen - 1 - (p - t0) : p;
    s_idx[p] = static_cast<unsigned short>(src);
  }
  asm volatile("cp.async.wait_all;\n");
  __syncthreads();

  // 2. merge path, one level per doubling of the sorted runs; 3. the last
  //    level finds the run starts
  const RunStarts runs{s_delta, shift, B - 1};
  int w = tile;
  for (; 2 * w < len; w *= 2) merge_level<false>(s_key, s_idx, len, w, mask_bits, runs);
  merge_level<true>(s_key, s_idx, len, w, mask_bits, runs);

  // 4. the runs in batches of kLoads ranks a thread, consecutive ranks on
  //    consecutive threads (a warp stores consecutive slots of a run):
  //    keys from shared memory, then each payload column
  int32_t* out_keys = static_cast<int32_t*>(c.dst[0]);
  for (int rb = threadIdx.x; rb < len; rb += kLoads * blockDim.x) {
    int s[kLoads], to[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int r = rb + k * blockDim.x;
      to[k] = -1;
      if (r < len) {
        s[k] = s_idx[r];
        const int key = s_key[s[k]];
        to[k] = runs.slot(key, r, out_rows);
        if (to[k] >= 0) out_keys[to[k]] = key;
      }
    }
    for (int col = 1; col < c.count; ++col) {
      if (c.width[col] == 8) {
        copy_batch(static_cast<const unsigned long long*>(c.src[col]) + start,
                   static_cast<unsigned long long*>(c.dst[col]), s, to);
      } else {
        copy_batch(static_cast<const unsigned*>(c.src[col]) + start,
                   static_cast<unsigned*>(c.dst[col]), s, to);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void fill_range(T* dst, long long lo, long long hi, T value) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi; i += step) dst[i] = value;
}

// Key -1 and zero payloads over the rows a single-region layout may leave
// uncovered: range b is [offsets[last, b], offsets[0, b + 1]), and out_rows
// ends the last bucket's range, which holds every row past the last
// region.  tail 0: range blockIdx.y < B - 1; tail 1: range B - 1, over the
// whole grid.
__global__ void merge_fill_kernel(const int32_t* __restrict__ offsets, long long last_row,
                                  int B, long long out_rows, int tail, Columns c) {
  const int b = tail ? B - 1 : blockIdx.y;
  const long long lo = offsets[last_row * B + b];
  const long long hi = b + 1 < B ? offsets[b + 1] : out_rows;
  fill_range(static_cast<int*>(c.dst[0]), lo, hi, -1);
  for (int col = 1; col < c.count; ++col) {
    if (c.width[col] == 8) {
      fill_range(static_cast<unsigned long long*>(c.dst[col]), lo, hi, 0ull);
    } else {
      fill_range(static_cast<unsigned*>(c.dst[col]), lo, hi, 0u);
    }
  }
}

size_t merge_smem(int super_tile, int nbits) {
  return sizeof(int) * (super_tile + (super_tile + 1) / 2 + (1 << nbits));
}

int merge_threads(int super_tile) {
  const int warps = (super_tile + kItems * 32 - 1) / (kItems * 32);
  return warps * 32;
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n]: tile_sort's output with alternate set.  offsets
// int32[ceil(n / super_tile), 2^nbits]: the first output slot of each
// (supertile, bucket) run.  out_keys and the payloads' dst hold out_rows
// rows.  fill 0: rows no run covers are left as they are; fill 1: they
// get key -1 and zero payloads, for offsets of a single-region layout
// (see the note above).  src / dst / widths as for cudf_tile_sort.
extern "C" int cudf_merge_scatter(const void* keys, long long n, int shift, int nbits,
                                  int super_tile, int tile, int mask_bits, const void* offsets,
                                  void* out_keys, long long out_rows, int fill, int n_payloads,
                                  const void* src, const void* dst, const void* widths,
                                  void* stream) {
  using namespace cudf_tpu_torch;
  Columns c{};
  if (!make_columns(&c, keys, out_keys, n_payloads, src, dst, widths)) {
    return cudaErrorInvalidValue;
  }
  if (nbits < 1 || nbits > kMaxMergeBits || tile < 1 || super_tile < tile ||
      super_tile % tile != 0 || super_tile > kMaxSuperTile || mask_bits < 0 ||
      mask_bits > 30 || shift < 0 || shift + nbits > 31 || n < 1) {
    return cudaErrorInvalidValue;
  }
  const int B = 1 << nbits;
  const long long blocks = (n + super_tile - 1) / super_tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fill) {
    const int32_t* offs = static_cast<const int32_t*>(offsets);
    merge_fill_kernel<<<dim3(kFillBlocksPerBucket, B - 1), kFillThreads, 0, s>>>(
        offs, blocks - 1, B, out_rows, 0, c);
    merge_fill_kernel<<<kFillBlocksPerBucket * sm_count(), kFillThreads, 0, s>>>(
        offs, blocks - 1, B, out_rows, 1, c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = merge_smem(super_tile, nbits);
  cudaError_t err = cudaFuncSetAttribute(
      merge_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  merge_scatter_kernel<<<static_cast<unsigned>(blocks), merge_threads(super_tile), smem, s>>>(
      n, shift, nbits, super_tile, tile, mask_bits, static_cast<const int32_t*>(offsets),
      out_rows, c);
  return cudaGetLastError();
}

// Resident merge_scatter blocks per SM at this supertile and digit width
// (the occupancy calculator's figure), the threads and the dynamic shared
// memory of each; the stream is not used.
extern "C" int cudf_merge_scatter_occupancy(int super_tile, int nbits, int* blocks_per_sm,
                                            int* threads, int* smem_bytes,
                                            void* /*stream*/) {
  using namespace cudf_tpu_torch;
  if (super_tile < 1 || super_tile > kMaxSuperTile || nbits < 1 || nbits > kMaxMergeBits) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = merge_smem(super_tile, nbits);
  cudaError_t err = cudaFuncSetAttribute(
      merge_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *threads = merge_threads(super_tile);
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, merge_scatter_kernel,
                                                       *threads, smem);
}
