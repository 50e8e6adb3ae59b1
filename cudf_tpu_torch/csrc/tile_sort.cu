// Kernels E and F: the per-tile sort of the sorted partition route,
// driven by kernels/tile_sort.py.
//
// E  tile_sort       replaces cudf_tpu/kernels/bitonic.py tile_sort, and
// F  tile_sort_data  replaces bitonic.py tile_sort_data (Pallas body
//    _sort_kernel / _sort_kernel_data over the bitonic_sort network).
//    Both sort each tile of `tile` int32 keys, carrying riders (E) or
//    payloads (F) with them; odd tiles descend under `alternate`, and
//    `mask_bits` orders by the key's low bits with negative keys first.
//    The two are one function here: E's riders and F's payloads are the
//    same flat columns, so both wrappers call this kernel.
//
//    The TPU has no scatter, so the reference sorts with an O(T log^2 T)
//    compare-exchange network of lane gathers and sublane rolls, and is
//    unstable.  Hopper scatters within shared memory, so one block per
//    tile runs a stable LSD radix sort of (sort_key, local index) pairs
//    held in registers, 8 bits a pass, over the order key's significant
//    bits only: 4 passes over 32 bits, 3 under a mask of 20 bits (21
//    significant: 8 + 8 + 5), 4 under 27.  A pass ranks each item as
//    cub's BlockRadixRankMatch does: every warp walks its items in order,
//    eight ballots group the lanes that share a digit, and the lowest
//    of them advances the warp's own 256 counters in shared memory, so
//    an item's rank inside its warp is the counter before the group plus
//    its lanes below it.  One scan over (digit, warp), digit-major, turns
//    the counters into each warp's first slot per digit; items scatter to
//    their ranks in shared memory and are read back in rank order.  The
//    sort is stable, so ties keep input order (exactness at least the
//    reference's) and the kernel matches a stable torch.sort bit for bit.
//    Items sit warp-striped (item j of lane l in warp w is position
//    w * 256 + j * 32 + l), so the keys load coalesced from device memory
//    and every pass reads back coalesced from shared memory (the ranking,
//    match_digit / block_exclusive_scan / radix_pass, is in common.cuh:
//    kernel C ranks with it too).  Each column
//    is then staged whole in shared memory with coalesced loads and
//    written out in rank order (reversed for a descending tile),
//    gathering through the local index: every global access is coalesced.
//    Bound: bytes, each column read once and written once; the passes
//    over shared memory are the kernel's own cost beyond that.  Tiles hold
//    at most kRankTile = 4096 keys; a short tile is padded with keys above
//    every real one, or equal to the greatest and after it, which the
//    stable sort keeps last.

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

union TileSmem {
  RankSmem sort;
  unsigned long long stage[kRankTile];   // one column, after the sort
};

template <typename T>
__device__ __forceinline__ void permute_column(const void* src_v, void* dst_v, T* stage,
                                               long long start, int len, bool reverse,
                                               const unsigned short (&idx)[kRankItems]) {
  const T* src = static_cast<const T*>(src_v) + start;
  T* dst = static_cast<T*>(dst_v) + start;
  T v[kRankItems];                             // all of a thread's loads in flight
#pragma unroll
  for (int j = 0; j < kRankItems; ++j) {
    const int i = j * kRankThreads + static_cast<int>(threadIdx.x);
    if (i < len) v[j] = src[i];
  }
#pragma unroll
  for (int j = 0; j < kRankItems; ++j) {
    const int i = j * kRankThreads + static_cast<int>(threadIdx.x);
    if (i < len) stage[i] = v[j];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kRankItems; ++j) {
    const int r = warp * kRankWarpItems + j * 32 + lane;
    if (r < len) dst[reverse ? len - 1 - r : r] = stage[idx[j]];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRankThreads, 2)
tile_sort_kernel(long long n, int tile, int alternate, int mask_bits, Columns c) {
  __shared__ TileSmem smem;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const int len = static_cast<int>(n - start < tile ? n - start : tile);
  const int bits = sort_key_bits(mask_bits);
  const unsigned pad = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int32_t* keys = static_cast<const int32_t*>(c.src[0]) + start;
  unsigned k[kRankItems];
  unsigned short idx[kRankItems];
#pragma unroll
  for (int j = 0; j < kRankItems; ++j) {       // warp-striped, coalesced
    const int p = warp * kRankWarpItems + j * 32 + lane;
    idx[j] = static_cast<unsigned short>(p);
    k[j] = p < len ? sort_key(keys[p], mask_bits) : pad;
  }
  for (int shift = 0; shift < bits; shift += kRankDigitBits) {
    const int nbits = bits - shift < kRankDigitBits ? bits - shift : kRankDigitBits;
    radix_pass(smem.sort, k, idx, shift, nbits, shift + nbits >= bits);
  }
  __syncthreads();                             // the columns reuse the sort's buffers

  const bool reverse = alternate && (blockIdx.x & 1);
  for (int col = 0; col < c.count; ++col) {
    if (c.width[col] == 8) {
      permute_column<unsigned long long>(c.src[col], c.dst[col], smem.stage, start, len,
                                         reverse, idx);
    } else {
      permute_column<unsigned>(c.src[col], c.dst[col], reinterpret_cast<unsigned*>(smem.stage),
                               start, len, reverse, idx);
    }
  }
}

}  // namespace
}  // namespace cudf_tpu_torch

// keys int32[n] sorted per tile of `tile` (<= 4096) keys into out_keys;
// src / dst / widths are host arrays of n_payloads (<= 4) device pointers
// and element widths (4 or 8 bytes) that move with the keys.
// alternate: odd tiles descend.  mask_bits: 0 (the signed key) or 1..30.
extern "C" int cudf_tile_sort(const void* keys, long long n, int tile, int alternate,
                              int mask_bits, void* out_keys, int n_payloads, const void* src,
                              const void* dst, const void* widths, void* stream) {
  using namespace cudf_tpu_torch;
  Columns c{};
  if (!make_columns(&c, keys, out_keys, n_payloads, src, dst, widths)) {
    return cudaErrorInvalidValue;
  }
  if (tile < 1 || tile > kRankTile || mask_bits < 0 || mask_bits > 30) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (n + tile - 1) / tile;
  tile_sort_kernel<<<static_cast<unsigned>(tiles), kRankThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(n, tile, alternate, mask_bits, c);
  return cudaGetLastError();
}
