// Kernel H: window_probe, the join tier's probe, driven by
// kernels/radix_partition.py.
//
// H  window_probe  replaces cudf_tpu/kernels/radix_partition.py
//    window_probe (Pallas body _probe_kernel).  The TPU has no gather, so
//    the reference looks each key up with one-hot bf16 matmuls over 8-bit
//    chunks of (build_row_id + 1) and three bf16 payload terms, batching
//    RB rows per matmul.  Hopper gathers single elements, so here a
//    lookup is one load: table[key].
//
//    Each block takes a chunk of consecutive probe rows (16384, or fewer
//    where that would leave under two blocks an SM) and walks the windows
//    that overlap it, in order, reading base on the device (no host sync,
//    no step table): each lane of a warp reads one window's bounds, so a
//    step covers 32 windows, and every warp reads the same ones, so the
//    block takes the same branches throughout.  A window with at least
//    stage_min of its rows in the chunk is staged: its slice of each of
//    the m <= 4 stacked tables (8192 int64 entries, build_row_id + 1 or
//    0) is read with coalesced loads, narrowed to int32 and held in
//    shared memory, with the payload slice beside it, and the window's
//    rows then look their keys up there.  Rows of windows with fewer rows
//    in the chunk, and rows past base[G], are probed directly: the key's
//    window g = key >> 13 is checked against base[g] <= row < base[g+1],
//    and the table entries are read through L1/L2 (ld.global.nc, the low
//    32-bit word of each int64), issued together with those two base
//    loads.  Every thread keeps 8 rows in flight (4 with two or more
//    tables): it loads their keys, then issues all their lookups, then
//    stores all their outputs.  The kernel writes every output row
//    (bid -1 and payload 0 where there is no match), so the wrapper
//    allocates them uninitialised.
//
//    Bound: bytes.  Per probe row it reads the 4-byte key and writes m
//    4-byte bids (and the 4- or 8-byte payload); each table entry a row
//    touches is read once from device memory.  At J1 big (1e8 probe rows,
//    1.34e8 slots, ~6,100 rows to a window of 8,192 slots) that is about
//    1.24 GB, 0.37 ms at 3.35 TB/s.  Staging turns the table reads of a
//    busy window into one coalesced sweep, and at J1 small and medium (one
//    and 16 windows, thousands of rows a slot) into a sweep of L2 per
//    chunk, so that only keys and outputs stream from device memory; the
//    direct path serves sparse windows, where a sweep would read slots no
//    row touches.
#include <climits>

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kProbeThreads = 512;
constexpr int kProbeChunk = 1 << 14;                     // rows per block, at most
constexpr int kProbeMinChunk = 1 << 12;
// rows in flight per thread: 8, or 4 with m >= 2 tables (64 registers)
template <int M> constexpr int kProbeUnroll = M == 1 ? 8 : 4;
constexpr int kWindowBits = 13;
constexpr int kSpan = 1 << kWindowBits;
constexpr int kMaxTables = 4;
constexpr int kStageUnroll = kSpan / kProbeThreads;     // slots per thread and table

struct Probe {
  const int32_t* keys;       // [n]
  const long long* base;     // [G + 1]
  int G;
  const long long* tables;   // [m, G * kSpan]
  long long table_size;      // G * kSpan
  const long long* pay;      // [G * kSpan] payload bits, or null
  int pay_width;             // 4 or 8
  int32_t* bids;             // [m, n]
  void* pay_out;             // [n], or null
  long long n;
  long long stage_min;       // rows of a window in a chunk that make it staged
  long long chunk;           // rows per block
};

__device__ __forceinline__ void put_pay(const Probe& p, long long i, long long bits) {
  if (p.pay_width == 8) {
    static_cast<long long*>(p.pay_out)[i] = bits;
  } else {
    static_cast<int32_t*>(p.pay_out)[i] = static_cast<int32_t>(bits);
  }
}

// The first window whose rows reach past `row` (G when none does).
__device__ __forceinline__ int window_of(const long long* base, int G, long long row) {
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(base + mid + 1) > row) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Rows [lo, hi), each checked against its key's window and looked up in
// device memory.
template <int M>
__device__ void probe_direct(const Probe& p, long long lo, long long hi) {
  constexpr int U = kProbeUnroll<M>;
  for (long long r0 = lo; r0 < hi; r0 += U * kProbeThreads) {
    int k[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = r0 + j * kProbeThreads + threadIdx.x;
      k[j] = i < hi ? __ldg(p.keys + i) : -1;
    }
    // ids and base entries lie below 2^31: their low 32-bit words suffice
    const int* ids = reinterpret_cast<const int*>(p.tables);
    const int* base = reinterpret_cast<const int*>(p.base);
    int e[U][M], b0[U], b1[U];
    long long bits[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bool ok = k[j] >= 0 && k[j] < p.table_size;
      const int kk = ok ? k[j] : 0;
      b0[j] = __ldg(base + 2 * (kk >> kWindowBits));
      b1[j] = __ldg(base + 2 * ((kk >> kWindowBits) + 1));
#pragma unroll
      for (int t = 0; t < M; ++t) e[j][t] = ok ? __ldg(ids + 2 * (t * p.table_size + kk)) : 0;
      bits[j] = ok && p.pay != nullptr ? __ldg(p.pay + kk) : 0;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = r0 + j * kProbeThreads + threadIdx.x;
      if (i >= hi) continue;
      const bool in = k[j] >= 0 && k[j] < p.table_size && b0[j] <= i && i < b1[j];
#pragma unroll
      for (int t = 0; t < M; ++t) {
        p.bids[t * p.n + i] = in ? e[j][t] - 1 : -1;
      }
      if (p.pay_out != nullptr) put_pay(p, i, in && e[j][0] > 0 ? bits[j] : 0);
    }
  }
}

// Window g's table slices into shared memory: ids narrowed to int32,
// payload bits at their width.
template <int M>
__device__ void stage_window(const Probe& p, int g, int* s_ids, void* s_pay) {
  const long long first = static_cast<long long>(g) * kSpan;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const long long* src = p.tables + t * p.table_size + first;
    long long v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) v[u] = __ldg(src + u * kProbeThreads + threadIdx.x);
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      s_ids[t * kSpan + u * kProbeThreads + threadIdx.x] = static_cast<int>(v[u]);
    }
  }
  if (p.pay == nullptr) return;
  long long v[kStageUnroll];
#pragma unroll
  for (int u = 0; u < kStageUnroll; ++u) v[u] = __ldg(p.pay + first + u * kProbeThreads + threadIdx.x);
#pragma unroll
  for (int u = 0; u < kStageUnroll; ++u) {
    const int s = u * kProbeThreads + threadIdx.x;
    if (p.pay_width == 8) {
      static_cast<long long*>(s_pay)[s] = v[u];
    } else {
      static_cast<int*>(s_pay)[s] = static_cast<int>(v[u]);
    }
  }
}

// Rows [lo, hi) of window g, looked up in its staged slices.
template <int M>
__device__ void probe_staged(const Probe& p, int g, long long lo, long long hi,
                             const int* s_ids, const void* s_pay) {
  constexpr int U = kProbeUnroll<M>;
  for (long long r0 = lo; r0 < hi; r0 += U * kProbeThreads) {
    int k[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = r0 + j * kProbeThreads + threadIdx.x;
      k[j] = i < hi ? __ldg(p.keys + i) : -1;
    }
    int e[U][M];
    long long bits[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bool in = (k[j] >> kWindowBits) == g;       // a negative key never is
      const int s = k[j] & (kSpan - 1);
#pragma unroll
      for (int t = 0; t < M; ++t) e[j][t] = in ? s_ids[t * kSpan + s] : 0;
      bits[j] = 0;
      if (p.pay_out != nullptr && in) {
        bits[j] = p.pay_width == 8 ? static_cast<const long long*>(s_pay)[s]
                                   : static_cast<const int*>(s_pay)[s];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = r0 + j * kProbeThreads + threadIdx.x;
      if (i >= hi) continue;
#pragma unroll
      for (int t = 0; t < M; ++t) p.bids[t * p.n + i] = e[j][t] - 1;
      if (p.pay_out != nullptr) put_pay(p, i, e[j][0] > 0 ? bits[j] : 0);
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kProbeThreads, 2)
window_probe_kernel(Probe p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);             // [M][kSpan]
  void* s_pay = s_ids + M * kSpan;                        // [kSpan] of pay_width bytes
  const long long lo = static_cast<long long>(blockIdx.x) * p.chunk;
  const long long hi = p.n - lo < p.chunk ? p.n : lo + p.chunk;
  const long long rows = __ldg(p.base + p.G);
  const int lane = threadIdx.x & 31;
  long long done = lo;                                    // rows before it are written
  if (lo < rows) {
    const long long last = (hi < rows ? hi : rows) - 1;
    for (int g0 = window_of(p.base, p.G, lo); g0 < p.G; g0 += 32) {
      const int g = g0 + lane;                            // the same lanes in every warp
      long long w0 = LLONG_MAX, w1 = 0;
      if (g < p.G) {
        w0 = __ldg(p.base + g);
        w1 = __ldg(p.base + g + 1);
      }
      const long long s_lo = w0 > lo ? w0 : lo;
      const long long s_hi = w1 < hi ? w1 : hi;
      unsigned staged = __ballot_sync(0xffffffffu, w0 <= last && s_hi - s_lo >= p.stage_min);
      const bool past = __any_sync(0xffffffffu, w0 > last);
      while (staged != 0) {
        const int b = __ffs(staged) - 1;
        staged &= staged - 1;
        const long long a = __shfl_sync(0xffffffffu, s_lo, b);
        const long long z = __shfl_sync(0xffffffffu, s_hi, b);
        probe_direct<M>(p, done, a);
        stage_window<M>(p, g0 + b, s_ids, s_pay);
        __syncthreads();
        probe_staged<M>(p, g0 + b, a, z, s_ids, s_pay);
        __syncthreads();                                  // before the next window's staging
        done = z;
      }
      if (past) break;
    }
  }
  probe_direct<M>(p, done, hi);
}

template <int M>
cudaError_t launch_probe(const Probe& p, cudaStream_t stream) {
  const size_t smem = sizeof(int) * M * kSpan + (p.pay != nullptr ? kSpan * p.pay_width : 0);
  cudaError_t err = cudaFuncSetAttribute(
      window_probe_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (p.n + p.chunk - 1) / p.chunk;
  window_probe_kernel<M><<<static_cast<unsigned>(blocks), kProbeThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n], window g's rows [base[g], base[g+1]) (base int64[G + 1]).
// tables int64[m, G * 8192] (m <= 4), entry build_row_id + 1 or 0;
// pay_table int64[G * 8192] of payload bits or null (then m == 1),
// pay_width 4 or 8.  Writes every row of bids int32[m, n] and pay_out[n].
// stage_min >= 1: rows of one window in a block's chunk from which the
// window is staged in shared memory.
extern "C" int cudf_window_probe(const void* keys, long long n, const void* base, int G,
                                 const void* tables, int m, const void* pay_table,
                                 int pay_width, long long stage_min, void* bids,
                                 void* pay_out, void* stream) {
  using namespace cudf_tpu_torch;
  if (m < 1 || m > kMaxTables || G < 1 || stage_min < 1) return cudaErrorInvalidValue;
  if (pay_table != nullptr && (m != 1 || (pay_width != 4 && pay_width != 8) ||
                               pay_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0) return cudaSuccess;
  Probe p{static_cast<const int32_t*>(keys), static_cast<const long long*>(base), G,
          static_cast<const long long*>(tables), static_cast<long long>(G) * kSpan,
          static_cast<const long long*>(pay_table), pay_width, static_cast<int32_t*>(bids),
          pay_out, n, stage_min, kProbeChunk};
  while (p.chunk > kProbeMinChunk && (n + p.chunk - 1) / p.chunk < 2LL * sm_count()) {
    p.chunk >>= 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_probe<1>(p, s);
    case 2: return launch_probe<2>(p, s);
    case 3: return launch_probe<3>(p, s);
    default: return launch_probe<4>(p, s);
  }
}
