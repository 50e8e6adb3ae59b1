// Kernels B, C and D: the radix-partition groupby tier for large key
// domains (up to 2^27 keys), driven by kernels/radix_partition.py.
//
// B  digit_histogram   replaces cudf_tpu/kernels/radix_partition.py:93
//    digit_histogram (Pallas body _hist_kernel).  Per tile of `tile`
//    keys, the count of each digit (key >> shift) & (2^nbits - 1) in a
//    shared-memory histogram; negative keys are left out.  Bound: bytes,
//    the 4-byte key read once and the histogram written once (~0.12 ms
//    at 1e8 keys).  What held the first version at half of that was
//    memory latency: one 4-byte load a thread in flight before each
//    atomic.  Now each of 256 threads issues kHistBatch 16-byte loads (16
//    keys) before its first atomic, and counts a run of equal digits in
//    a register, adding it to the shared bin only when the digit changes:
//    sorted input (the sorted route's second pass) takes about one shared
//    atomic per four keys, random input one per key.  (Counting J1
//    medium's 2^4 digits by warp ballots instead, one lane a bin, was
//    slower: PERF.md.)  A tile whose blocks
//    would not fill the card (the scatter route's 2^14 buckets: 191 tiles
//    of 524,288 keys at 1e8) is cut into `parts` blocks of part_len keys
//    (kernels/radix_partition.py tile_parts); each adds its non-zero bins
//    into the tile's row, zeroed first, with global atomics.
//
// C  radix_scatter     replaces cudf_tpu/kernels/radix_partition.py:336
//    radix_scatter (Pallas body _partition_kernel with an in-kernel
//    bitonic sort and the covering-row DMAs of _scatter_runs), the
//    reference's merge_tiles = 1 route; the main path takes its
//    merge_tiles = 4 route, kernels F and G (csrc/tile_sort.cu,
//    csrc/merge_scatter.cu).  STABLE: each (tile, bucket) run holds its
//    rows in input order, so the first sum(hist) rows of every output
//    equal radix_scatter_plain's (a stable argsort by digit) bit for bit,
//    and there is no SENTINEL fill and no run-edge garbage.  Bound:
//    bytes, the key and every payload read once and written once, plus
//    `offsets` (0.956 ms at G1 K = 1e6 with int32 + f64 payloads, ~0.46
//    at J1 big with one int32 payload).
//    - What holds it: the write fan-out.  A block can hold only a few
//      thousand rows, so at 2^7 buckets each run it writes is ~32 rows,
//      and the card writes 128 interleaved streams a tile; the same
//      ranking at 2 buckets takes about half the time (PERF.md).  The
//      first version took each row's slot from a shared atomic cursor,
//      one row a thread at a time (10x its bound), and at 2^14 buckets
//      every row was its own partial-sector write.
//    - A block of 512 threads walks its tile in chunks of kRankTile =
//      4096 rows; the scatter route's tiles are one chunk
//      (kernels/radix_partition.py choose_tile), so the blocks running
//      at once write neighbouring runs of each bucket, and 1e8 rows make
//      24,415 blocks.
//      Each payload column of the chunk is copied to shared memory by
//      cp.async first, then every key load is issued; the copies land
//      while the chunk is ranked stably by digit, with negative keys and
//      the chunk's padding as one more digit after the last, by the
//      ballot-matched warp ranks and block scan of kernel F (common.cuh
//      radix_pass): one 8-bit pass, so at most kScatterBits = 7 digit
//      bits a launch.  Wider digits (the 2^14 route) are two launches,
//      low bits then high, each stable, as an LSD radix sort
//      (radix_scatter in kernels/radix_partition.py).
//    - In ranked order a digit's rows form one run; its head, found from
//      its neighbour, takes the run's first slot from the digit's shared
//      cursor, every row adds its place in the run, and the run's last
//      row advances the cursor: no atomics.  The cursors are seeded with
//      the tile's offsets and carried across its chunks.
//    - After one wait for the copies, every column is written in ranked
//      order through the local index (the keys staged from the registers
//      that ranked them), so consecutive threads store consecutive slots
//      of one run.
//    - Two blocks an SM: 63 registers, 40 KB of ranking buffers, the
//      cursors and 4096 rows of each payload (48 KB at G1's int32 + f64).
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
//    - Order is free: the sorted route's runs, kernel C's runs in input
//      order, any other order of a window's rows and an unpartitioned
//      single window give the same sums.  Float sums
//      are taken in atomic order, which varies from run to run (rtol
//      1e-12 against the plain version).

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kHistThreads = 256;
constexpr int kHistBatch = 4;       // 16-byte key loads a thread issues before its first atomic
constexpr unsigned kNoSlot = 0xffffffffu;
constexpr int kScatterBits = 7;     // kernel C: one 8-bit ranking pass (kernels/radix_partition.py)
constexpr int kAggThreads = 1024;   // 512 when two blocks fit in an SM's shared memory
constexpr int kAggBatch = 4;        // rows a thread loads before its first atomic
constexpr int kMaxAggColumns = 3;   // kernels/radix_partition.py MAX_AGG_COLUMNS
constexpr int kZeroThreads = 256;
constexpr int kWindowBits = 13;
constexpr int kSpan = 1 << kWindowBits;

// Adds one key to a thread's open run (cur, cnt) of equal digits; a run
// goes into the shared histogram when the digit changes.
__device__ __forceinline__ void count_key(int k, int shift, unsigned mask, unsigned* s_hist,
                                          unsigned& cur, unsigned& cnt) {
  if (k < 0) return;
  const unsigned d = (static_cast<unsigned>(k) >> shift) & mask;
  if (d == cur) {
    ++cnt;
    return;
  }
  if (cnt != 0u) atomicAdd(s_hist + cur, cnt);
  cur = d;
  cnt = 1u;
}

// Rows [lo, hi) of part p of tile t, block t * parts + p.
struct PartRows {
  long long t, lo, hi;
  int part;
};
__device__ __forceinline__ PartRows part_rows(long long n, long long tile, long long part_len,
                                              int parts) {
  PartRows r;
  r.t = blockIdx.x / parts;
  r.part = static_cast<int>(blockIdx.x % parts);
  const long long end = min((r.t + 1) * tile, n);
  r.lo = min(r.t * tile + r.part * part_len, end);
  r.hi = min(r.lo + part_len, end);
  return r;
}

// hist [tiles, 2^nbits]: with one part a tile, a block stores its tile's
// row; with more, each adds its non-zero counts into the row, zeroed
// before the launch.
__global__ void __launch_bounds__(kHistThreads)
digit_histogram_kernel(const int32_t* __restrict__ keys, long long n, int shift, int nbits,
                       long long tile, long long part_len, int parts,
                       int32_t* __restrict__ hist) {
  extern __shared__ unsigned s_hist[];
  const int B = 1 << nbits;
  const unsigned mask = static_cast<unsigned>(B - 1);
  for (int b = threadIdx.x; b < B; b += blockDim.x) s_hist[b] = 0u;
  __syncthreads();
  const PartRows r = part_rows(n, tile, part_len, parts);
  // rows before the first 16-byte boundary and after the last go one a thread
  const long long mis = static_cast<long long>((reinterpret_cast<uintptr_t>(keys + r.lo) >> 2) & 3u);
  const long long a = min(r.hi, r.lo + ((4 - mis) & 3));
  const long long nv = (r.hi - a) >> 2;
  const long long b = a + 4 * nv;
  unsigned cur = 0u, cnt = 0u;
  if (threadIdx.x < a - r.lo) count_key(__ldg(keys + r.lo + threadIdx.x), shift, mask, s_hist, cur, cnt);
  if (threadIdx.x < r.hi - b) count_key(__ldg(keys + b + threadIdx.x), shift, mask, s_hist, cur, cnt);
  const int4* vec = reinterpret_cast<const int4*>(keys + a);
  for (long long v0 = threadIdx.x; v0 < nv; v0 += kHistBatch * kHistThreads) {
    int4 q[kHistBatch];
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {   // every load of the batch first
      const long long v = v0 + u * kHistThreads;
      q[u] = v < nv ? __ldg(vec + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      count_key(q[u].x, shift, mask, s_hist, cur, cnt);
      count_key(q[u].y, shift, mask, s_hist, cur, cnt);
      count_key(q[u].z, shift, mask, s_hist, cur, cnt);
      count_key(q[u].w, shift, mask, s_hist, cur, cnt);
    }
  }
  if (cnt != 0u) atomicAdd(s_hist + cur, cnt);
  __syncthreads();
  int32_t* row = hist + r.t * B;
  if (parts > 1) {
    for (int d = threadIdx.x; d < B; d += blockDim.x) {
      const unsigned c = s_hist[d];
      if (c != 0u) atomicAdd(row + d, static_cast<int32_t>(c));
    }
  } else {
    for (int d = threadIdx.x; d < B; d += blockDim.x) row[d] = static_cast<int32_t>(s_hist[d]);
  }
}

// Kernel C's cursors in dynamic shared memory, rounded up to 16 bytes:
// the payload stages follow them.
__host__ __device__ __forceinline__ size_t cursor_bytes(int nbits) {
  return ((sizeof(unsigned) << nbits) + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ int chunk_pos(int j) {
  return (threadIdx.x >> 5) * kRankWarpItems + j * 32 + (threadIdx.x & 31);
}

// Starts the copies of rows [start, start + len) of a 4- or 8-byte column
// into stage (input order): 16 bytes a copy where the rows' address is
// 16-byte aligned, else one row a copy.
__device__ __forceinline__ void prefetch_column(const void* src, int width, char* stage,
                                                long long start, int len) {
  const char* from = static_cast<const char*>(src) + start * width;
  const int bytes = len * width;
  int b = threadIdx.x * 16;
  if ((reinterpret_cast<uintptr_t>(from) & 15) == 0) {
    for (; b + 16 <= bytes; b += kRankThreads * 16) cp_async16(stage + b, from + b);
    b = (bytes & ~15) + threadIdx.x * width;
  } else {
    b = threadIdx.x * width;
  }
  for (; b < bytes; b += kRankThreads * width) {
    if (width == 8) {
      cp_async8(stage + b, from + b);
    } else {
      cp_async4(stage + b, from + b);
    }
  }
}

// Writes a staged column in ranked order: item j (ranked position
// chunk_pos(j)) from its input position idx[j] to its slot.
template <typename T>
__device__ __forceinline__ void write_column(void* dst_v, const T* stage,
                                             const unsigned short (&idx)[kRankItems],
                                             const unsigned (&slot)[kRankItems]) {
  T* dst = static_cast<T*>(dst_v);
#pragma unroll
  for (int j = 0; j < kRankItems; ++j) {
    if (slot[j] != kNoSlot) dst[slot[j]] = stage[idx[j]];
  }
}

// Columns: the keys at 0, the payloads after them (common.cuh).  Dynamic
// shared memory: the 2^nbits cursors, then each payload's stage of
// kRankTile rows.  One block a tile.
__global__ void __launch_bounds__(kRankThreads, 2)
radix_scatter_kernel(long long n, int shift, int nbits, long long tile,
                     const int32_t* __restrict__ offsets, Columns c) {
  __shared__ RankSmem rank;                  // after the slots, rank.key stages the keys
  extern __shared__ __align__(16) unsigned s_cursor[];
  const int B = 1 << nbits;
  char* stage = reinterpret_cast<char*>(s_cursor) + cursor_bytes(nbits);
  const PartRows r = part_rows(n, tile, tile, 1);
  for (int d = threadIdx.x; d < B; d += blockDim.x) {
    s_cursor[d] = static_cast<unsigned>(offsets[r.t * B + d]);
  }
  // (the ranking's __syncthreads publish the cursors before their first read)
  const unsigned invalid = static_cast<unsigned>(B);   // negative keys and padding rank last
  const int32_t* keys = static_cast<const int32_t*>(c.src[0]);
  for (long long start = r.lo; start < r.hi; start += kRankTile) {
    const int len = static_cast<int>(min(r.hi - start, static_cast<long long>(kRankTile)));
    // every payload row of the chunk on its way to shared memory, then every key load
    for (int col = 1, off = 0; col < c.count; off += kRankTile * c.width[col++]) {
      prefetch_column(c.src[col], c.width[col], stage + off, start, len);
    }
    int raw[kRankItems];
    unsigned k[kRankItems];
    unsigned short idx[kRankItems];
#pragma unroll
    for (int j = 0; j < kRankItems; ++j) {
      raw[j] = chunk_pos(j) < len ? __ldg(keys + start + chunk_pos(j)) : -1;
    }
#pragma unroll
    for (int j = 0; j < kRankItems; ++j) {
      idx[j] = static_cast<unsigned short>(chunk_pos(j));
      k[j] = raw[j] < 0 ? invalid : (static_cast<unsigned>(raw[j]) >> shift) & (invalid - 1u);
    }
    radix_pass(rank, k, idx, 0, nbits + 1, false);
    // item j holds ranked position chunk_pos(j); rank.key the ranked digits
    unsigned slot[kRankItems];
    unsigned tails = 0u;
#pragma unroll
    for (int j = 0; j < kRankItems; ++j) {
      const int p = chunk_pos(j);
      const bool valid = k[j] < invalid;
      const bool head = p == 0 || rank.key[p - 1] != k[j];
      if (valid && (p == kRankTile - 1 || rank.key[p + 1] != k[j])) tails |= 1u << j;
      if (valid && head) s_cursor[k[j]] -= static_cast<unsigned>(p);  // the run's first slot - p
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRankItems; ++j) {
      slot[j] = k[j] < invalid ? s_cursor[k[j]] + static_cast<unsigned>(chunk_pos(j)) : kNoSlot;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRankItems; ++j) {
      if ((tails >> j) & 1u) s_cursor[k[j]] = slot[j] + 1u;
      if (chunk_pos(j) < len) rank.key[chunk_pos(j)] = static_cast<unsigned>(raw[j]);
    }
    cp_async_wait_all();
    __syncthreads();
    write_column<unsigned>(c.dst[0], rank.key, idx, slot);
    for (int col = 1, off = 0; col < c.count; off += kRankTile * c.width[col++]) {
      if (c.width[col] == 8) {
        write_column(c.dst[col], reinterpret_cast<const unsigned long long*>(stage + off), idx,
                     slot);
      } else {
        write_column(c.dst[col], reinterpret_cast<const unsigned*>(stage + off), idx, slot);
      }
    }
    __syncthreads();                         // before the next chunk reuses the buffers
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

namespace cudf_tpu_torch {
namespace {

bool valid_cut(long long n, int nbits, long long tile, long long part_len, int parts) {
  if (nbits < 1 || nbits > 15 || tile < 1 || parts < 1 || part_len < 1) return false;
  const long long tiles = (n + tile - 1) / tile;
  return part_len * parts >= tile && tiles * parts < (1ll << 31);
}

// Kernel C's dynamic shared memory: the cursors, then a chunk of each payload.
size_t scatter_smem_bytes(int nbits, const Columns& c) {
  size_t bytes = cursor_bytes(nbits);
  for (int col = 1; col < c.count; ++col) bytes += static_cast<size_t>(kRankTile) * c.width[col];
  return bytes;
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n]; hist int32[ceil(n / tile), 2^nbits], every entry written.
// Each tile is counted by `parts` blocks of part_len keys (parts *
// part_len >= tile); with more than one, hist is zeroed first and the
// blocks add into it.
extern "C" int cudf_digit_histogram(const void* keys, long long n, int shift, int nbits,
                                    long long tile, long long part_len, int parts, void* hist,
                                    void* stream) {
  using namespace cudf_tpu_torch;
  if (!valid_cut(n, nbits, tile, part_len, parts)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + tile - 1) / tile;
  cudaError_t err;
  if (parts > 1) {
    err = cudaMemsetAsync(hist, 0, static_cast<size_t>(tiles) * sizeof(int32_t) << nbits, s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = sizeof(unsigned) << nbits;
  err = cudaFuncSetAttribute(digit_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  digit_histogram_kernel<<<static_cast<unsigned>(tiles * parts), kHistThreads, smem, s>>>(
      static_cast<const int32_t*>(keys), n, shift, nbits, tile, part_len, parts,
      static_cast<int32_t*>(hist));
  return cudaGetLastError();
}

// offsets int32[ceil(n / tile), 2^nbits] output slot of each (tile,
// bucket) run, nbits <= kScatterBits; src / dst / widths are host arrays
// of n_payloads (<= 4) device pointers and element widths (4 or 8 bytes).
extern "C" int cudf_radix_scatter(const void* keys, long long n, int shift, int nbits,
                                  long long tile, const void* offsets, void* out_keys,
                                  int n_payloads, const void* src, const void* dst,
                                  const void* widths, void* stream) {
  using namespace cudf_tpu_torch;
  Columns c{};
  if (!make_columns(&c, keys, out_keys, n_payloads, src, dst, widths) ||
      !valid_cut(n, nbits, tile, tile, 1) || nbits > kScatterBits) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = scatter_smem_bytes(nbits, c);
  cudaError_t err = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n + tile - 1) / tile;
  radix_scatter_kernel<<<static_cast<unsigned>(tiles), kRankThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      n, shift, nbits, tile, static_cast<const int32_t*>(offsets), c);
  return cudaGetLastError();
}

// Kernel B (which 0) or C (which 1, with payloads of payload_bytes a row
// in all) at 2^nbits buckets: registers, resident blocks per SM, threads
// and shared memory (static and dynamic, bytes) a block on the current
// device.
extern "C" int cudf_partition_occupancy(int which, int nbits, int payload_bytes, int* registers,
                                        int* blocks_per_sm, int* threads, int* smem_bytes,
                                        void* stream) {
  using namespace cudf_tpu_torch;
  (void)stream;
  if (which < 0 || which > 1 || nbits < 1 || nbits > (which == 0 ? 15 : kScatterBits) ||
      payload_bytes < 0) {
    return cudaErrorInvalidValue;
  }
  const void* fn = which == 0 ? reinterpret_cast<const void*>(digit_histogram_kernel)
                              : reinterpret_cast<const void*>(radix_scatter_kernel);
  const size_t smem = which == 0 ? sizeof(unsigned) << nbits
                                 : cursor_bytes(nbits) + static_cast<size_t>(kRankTile) * payload_bytes;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *threads = which == 0 ? kHistThreads : kRankThreads;
  *registers = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes + smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, *threads, smem);
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
