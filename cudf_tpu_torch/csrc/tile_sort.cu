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
//    tile runs a stable LSD radix sort (cub's block-scope BlockRadixSort,
//    4-bit digits) of (sort_key, local index) pairs held in registers:
//    8 passes over 32 bits, or ceil((m + 1) / 4) under a mask of m bits.
//    The sort is stable, so ties keep input order (exactness at least the
//    reference's) and the kernel matches a stable torch.sort bit for bit.
//    Each column is then staged whole in shared memory with coalesced
//    loads and written out in rank order (reversed for a descending
//    tile), gathering through the local index: every global access is
//    coalesced.  Bound: bytes, each column read once and written once;
//    the passes over shared memory are the kernel's own cost beyond that.
//    Tiles hold at most kMaxTile = 4096 keys (the 32 KB staging buffer of
//    8-byte columns, shared with the sort's scratch); a short tile is
//    padded with keys above every real one, which the stable sort keeps
//    last.

#include <cub/block/block_radix_sort.cuh>

#include "common.cuh"

namespace cudf_tpu_torch {
namespace {

constexpr int kSortThreads = 512;
constexpr int kSortItems = 8;
constexpr int kMaxTile = kSortThreads * kSortItems;

using TileSort = cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, unsigned short>;

template <typename T>
__device__ __forceinline__ void permute_column(const void* src_v, void* dst_v, T* stage,
                                               long long start, int len, bool reverse,
                                               const unsigned short (&src_pos)[kSortItems]) {
  const T* src = static_cast<const T*>(src_v) + start;
  T* dst = static_cast<T*>(dst_v) + start;
  for (int i = threadIdx.x; i < len; i += kSortThreads) stage[i] = src[i];
  __syncthreads();
  // after SortBlockedToStriped item j of thread t has rank j * threads + t
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int r = j * kSortThreads + static_cast<int>(threadIdx.x);
    if (r < len) dst[reverse ? len - 1 - r : r] = stage[src_pos[j]];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(long long n, int tile, int alternate, int mask_bits, Columns c) {
  __shared__ union {
    typename TileSort::TempStorage sort;
    unsigned long long stage[kMaxTile];
  } smem;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const int len = static_cast<int>(n - start < tile ? n - start : tile);
  const int bits = sort_key_bits(mask_bits);
  const unsigned pad = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;

  int* skeys = reinterpret_cast<int*>(smem.stage);
  const int32_t* keys = static_cast<const int32_t*>(c.src[0]) + start;
  for (int i = threadIdx.x; i < len; i += kSortThreads) skeys[i] = keys[i];
  __syncthreads();
  unsigned k[kSortItems];
  unsigned short pos[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {       // blocked: thread t holds t*8 .. t*8+7
    const int i = static_cast<int>(threadIdx.x) * kSortItems + j;
    pos[j] = static_cast<unsigned short>(i);
    k[j] = i < len ? sort_key(skeys[i], mask_bits) : pad;
  }
  __syncthreads();                             // the sort reuses the staging buffer
  TileSort(smem.sort).SortBlockedToStriped(k, pos, 0, bits);
  __syncthreads();

  const bool reverse = alternate && (blockIdx.x & 1);
  for (int col = 0; col < c.count; ++col) {
    if (c.width[col] == 8) {
      permute_column<unsigned long long>(c.src[col], c.dst[col], smem.stage, start, len,
                                         reverse, pos);
    } else {
      permute_column<unsigned>(c.src[col], c.dst[col], reinterpret_cast<unsigned*>(smem.stage),
                               start, len, reverse, pos);
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
  if (tile < 1 || tile > kMaxTile || mask_bits < 0 || mask_bits > 30) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (n + tile - 1) / tile;
  tile_sort_kernel<<<static_cast<unsigned>(tiles), kSortThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(n, tile, alternate, mask_bits, c);
  return cudaGetLastError();
}
