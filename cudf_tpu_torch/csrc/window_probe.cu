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
//    The grid is kernel D's: blocks walk (window, row-chunk) steps of the
//    partitioned probe rows from the same step table.  For each row whose
//    key lies in its step's window, the block reads the window's entry
//    (build_row_id + 1, 0 for empty) from each of the m <= 4 stacked
//    tables and writes bid = entry - 1, so an empty slot gives -1; with a
//    payload table it copies the matched row's payload bits (4 or 8
//    bytes).  Rows out of their window, and rows past the last window,
//    keep the wrapper's prefill (bid -1, payload 0).  The tables are
//    kernel D's outputs, zeroed up front, so an empty window reads as "no
//    match" and needs no occupancy bit.
//
//    Bound: bytes.  Per probe row it reads the 4-byte key and writes the
//    4-byte bid (and the 4- or 8-byte payload); each table entry a row
//    touches is read once from device memory.  At J1 big (1e8 probe rows,
//    1.34e8 table slots) that is about 1.9 GB, 0.56 ms at 3.35 TB/s.
//    Keys are read and bids written coalesced; the table is read through
//    L1/L2 (__ldg), not staged in shared memory: a window's table is
//    64 KB of int64 and at J1 big a window has about 6,100 probe rows, so
//    staging would read every window's whole table and cost a 64 KB fill
//    and a barrier per step (three blocks per SM at most), while the rows
//    of one step, partitioned, touch one 64 KB window that stays in L2
//    and each cached sector serves several lookups.
#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kProbeThreads = 512;
constexpr int kWindowBits = 13;
constexpr int kMaxTables = 4;

__global__ void __launch_bounds__(kProbeThreads)
window_probe_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ step_win,
                    const long long* __restrict__ step_lo,
                    const long long* __restrict__ step_hi,
                    const long long* __restrict__ tables, int m, long long table_size,
                    const long long* __restrict__ pay_table, int pay_width,
                    int32_t* __restrict__ bids, long long n, void* __restrict__ pay_out) {
  const int g = step_win[blockIdx.x];
  if (g < 0) return;  // an idle step of the upper-bound grid
  const long long hi = step_hi[blockIdx.x];
  for (long long i = step_lo[blockIdx.x] + threadIdx.x; i < hi; i += blockDim.x) {
    const int k = keys[i];
    if (k < 0 || (k >> kWindowBits) != g) continue;  // out of window: no match
    long long first = 0;
    for (int t = 0; t < m; ++t) {
      const long long e = __ldg(&tables[t * table_size + k]);
      if (t == 0) first = e;
      bids[t * n + i] = static_cast<int32_t>(e - 1);
    }
    if (pay_table != nullptr && first > 0) {
      const long long bits = __ldg(&pay_table[k]);
      if (pay_width == 8) {
        static_cast<long long*>(pay_out)[i] = bits;
      } else {
        static_cast<int32_t*>(pay_out)[i] = static_cast<int32_t>(bits);
      }
    }
  }
}

}  // namespace
}  // namespace cudf_tpu_torch

// Per step s: window step_win[s] (-1: idle) over rows [step_lo[s],
// step_hi[s]) of keys int32[n].  tables int64[m, table_size] (m <= 4),
// entry build_row_id + 1 or 0; pay_table int64[table_size] of payload
// bits or null, pay_width 4 or 8.  bids int32[m, n] and pay_out[n]
// prefilled by the caller with -1 and 0.
extern "C" int cudf_window_probe(const void* keys, const void* step_win, const void* step_lo,
                                 const void* step_hi, long long steps, const void* tables,
                                 int m, long long table_size, const void* pay_table,
                                 int pay_width, void* bids, long long n, void* pay_out,
                                 void* stream) {
  using namespace cudf_tpu_torch;
  if (m < 1 || m > kMaxTables) return cudaErrorInvalidValue;
  if (pay_table != nullptr && (m != 1 || (pay_width != 4 && pay_width != 8) ||
                               pay_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (steps <= 0) return cudaSuccess;
  window_probe_kernel<<<static_cast<unsigned>(steps), kProbeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(step_win),
      static_cast<const long long*>(step_lo), static_cast<const long long*>(step_hi),
      static_cast<const long long*>(tables), m, table_size,
      static_cast<const long long*>(pay_table), pay_width, static_cast<int32_t*>(bids), n,
      pay_out);
  return cudaGetLastError();
}
